"""Checkpoint save and resume (counterpart of
``audiocaption_tpu/training/checkpoint.py``; the reference's
``save_checkpoint`` / ``resume_checkpoint``).

A checkpoint is one pickle of host values: {variables, epoch,
monitor_state, not_improve_cnt, tokenizer (the word -> id dict),
lr_count, optimizer (optional)}, the JAX package's payload.  Here
``variables`` is a flat dict of numpy arrays in the model's reference
key space (for the flagship ``model.model.encoder.backbone.eff_net.*``,
``model.model.decoder.*``; for every other encoder ``encoder.*``,
``decoder.*``: what ``models.convert.load_reference_state_dict``
reads), so the HF API loads it as it loads a reference checkpoint.
:func:`load_checkpoint` also reads a checkpoint the JAX package wrote
(its ``variables`` the flax tree {params, batch_stats}) and returns its
weights in the same key space (``models.convert.state_dict_from_jax``).
"""

from __future__ import annotations

import pickle
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from audiocaption_tpu_torch.models.convert import (
    bahattn_captioner_state_dict_from_jax, captioner_parts,
    captioner_state_dict_from_jax, cdur5_trm_state_dict_from_jax,
    cnn14rnn_trm_state_dict_from_jax, sed_state_dict_from_jax,
    state_dict_from_jax, style_state_dict_from_jax)


def model_variables(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """A ``Captioner``'s encoder and decoder weights and buffers (and a
    ``StyleCaptioner``'s reference encoder and style bank), as host numpy
    arrays in its reference key space (``models.convert.captioner_parts``)."""
    out = {}
    for prefix, module in captioner_parts(model):
        for k, v in module.state_dict().items():
            out[prefix + k] = v.detach().cpu().numpy().copy()
    return out


def save_checkpoint(path: str, variables: Mapping, *, epoch: int = 0,
                    optimizer: Optional[Dict] = None,
                    monitor_state: Optional[Dict] = None,
                    not_improve_cnt: int = 0,
                    tokenizer_state: Optional[Dict] = None,
                    lr_count: int = 0, extra: Optional[Dict] = None) -> None:
    """Write the payload.  ``variables``: name -> array or tensor (see
    :func:`model_variables`); ``optimizer``: an optimizer's
    ``state_dict()``, its tensors copied to the host; ``extra``: more
    top-level entries (the SED run's ``classes_num``, ``val_tag_acc``)."""
    payload = {
        "variables": {k: np.asarray(v.detach().cpu() if torch.is_tensor(v)
                                    else v) for k, v in variables.items()},
        "epoch": epoch,
        "monitor_state": monitor_state,
        "not_improve_cnt": not_improve_cnt,
        "tokenizer": tokenizer_state,
        "lr_count": lr_count,
    }
    if optimizer is not None:
        payload["optimizer"] = _to_host(optimizer)
    if extra:
        payload.update(extra)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(payload, f, protocol=4)


def _to_host(tree: Any) -> Any:
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def load_checkpoint(path: str) -> Dict:
    """Read a checkpoint this package or the JAX package wrote (a pickle
    written by a trusted run: unpickling runs code).  ``variables`` comes
    back in the reference key space as numpy arrays either way."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    variables = payload.get("variables")
    if isinstance(variables, Mapping) and "params" in variables:
        payload["variables"] = jax_variables_to_reference(variables)
    return payload


def strip_optimizer(ckpt_path: str, out_path: Optional[str] = None) -> str:
    """Drop the optimizer state from a checkpoint either package wrote,
    written to ``out_path`` (default: in place) as the same pickle without
    it (``audiocaption_tpu/training/checkpoint.py::strip_optimizer``; the
    reference's ``python_scripts/utils/remove_optimizer.py``).  The
    payload is not converted: a JAX checkpoint stays a JAX checkpoint.
    -> the path written."""
    with open(ckpt_path, "rb") as f:
        payload = pickle.load(f)
    payload.pop("optimizer", None)
    out_path = out_path or ckpt_path
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "wb") as f:
        pickle.dump(payload, f, protocol=4)
    return out_path


def jax_variables_to_reference(variables: Mapping) -> Dict[str, np.ndarray]:
    """A JAX EffB2-Transformer, cnn14rnn_trm, Cdur5 KD-student, Cnn14-GRU +
    GRU-decoder (the temporal captioner), any captioner of the extended
    or item-8 encoders or GRU decoders (``captioner_state_dict_from_jax``),
    a style captioner or a Cnn8-RNN SED tree {params, batch_stats} (numpy
    leaves) -> its reference key space; the GRUs' and the decoder's depth,
    the weight tying and a conditioned decoder's parameters are read off
    the tree."""
    params = variables["params"]
    dec, enc = params.get("decoder", {}), params.get("encoder", {})
    if "fc_audioset" in params:
        return sed_state_dict_from_jax(variables)
    if "word_embedding" in dec and "attn" in dec and "rnn" in enc:
        gru = enc["rnn"]["network"]
        return dict(bahattn_captioner_state_dict_from_jax(
            variables, rnn_num_layers=sum(
                k.startswith("w_ih_l") and not k.endswith("_reverse")
                for k in gru),
            rnn_bidirectional=any(k.endswith("_reverse") for k in gru)),
            **style_state_dict_from_jax(params))
    if not dec or not enc:
        raise ValueError("only JAX captioner (encoder + decoder) or SED "
                         "checkpoints convert to this package's key space")
    if "attn_proj_dense" not in dec or not (
            "conv_stem" in enc or "rnn" in enc or "b1" in enc):
        # the extended encoders and the GRU decoders keep the JAX names
        return {k: v.numpy() for k, v in captioner_state_dict_from_jax(
            variables).items()}
    nlayers = sum(k.startswith("layer") for k in dec)
    tie = "classifier" not in dec
    if "cnn" in enc and "rnn" in enc:
        gru = enc["rnn"]["network"]
        sd = cnn14rnn_trm_state_dict_from_jax(
            variables, rnn_num_layers=sum(
                k.startswith("w_ih_l") and not k.endswith("_reverse")
                for k in gru),
            rnn_bidirectional=any(k.endswith("_reverse") for k in gru),
            nlayers=nlayers, tie_weights=tie)
    elif "b1" in enc and "gru" in enc:
        sd = cdur5_trm_state_dict_from_jax(variables, nlayers=nlayers,
                                           tie_weights=tie)
    else:
        sd = state_dict_from_jax(variables, nlayers=nlayers, tie_weights=tie)
    return {k: v.numpy() for k, v in sd.items()}


class AsyncCheckpointer:
    """Runs checkpoint jobs on one worker thread, so pickling and the
    SWA update overlap the next epoch's steps.  Jobs run in submission
    order; ``submit`` first joins the previous job (at most one in
    flight, and its exception surfaces there); ``wait`` joins before
    anyone reads what a job wrote."""

    def __init__(self):
        self._ex = ThreadPoolExecutor(max_workers=1,
                                      thread_name_prefix="ckpt")
        self._fut = None

    def submit(self, job: Callable[[], Any]) -> float:
        """Queue ``job``; returns the seconds spent waiting for the
        previous one."""
        t0 = time.time()
        self.wait()
        self._fut = self._ex.submit(job)
        return time.time() - t0

    def wait(self) -> None:
        """Join the job in flight, re-raising its exception."""
        if self._fut is not None:
            fut, self._fut = self._fut, None
            fut.result()

    def close(self) -> None:
        self.wait()
        self._ex.shutdown()


def merge_variables(target: Dict, source: Mapping) -> Dict:
    """``target`` (name -> array or tensor) with the ``source`` entries
    of the same name and shape copied in, in ``target``'s dtype (the
    reference's partial load)."""
    out = {}
    for k, dst in target.items():
        src = source.get(k)
        if src is not None and tuple(np.shape(dst)) == tuple(np.shape(src)):
            out[k] = _cast_like(src, dst)
        else:
            out[k] = dst
    return out


def _cast_like(src, dst):
    if torch.is_tensor(dst):
        return torch.as_tensor(np.asarray(src)).to(dst.dtype)
    return np.asarray(src, dtype=np.asarray(dst).dtype)


class MetricImprover:
    """min / max monitor of a validation metric."""

    def __init__(self, mode: str = "max"):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', not {mode!r}")
        self.mode = mode
        self.best = float("inf") if mode == "min" else float("-inf")

    def __call__(self, value: float) -> bool:
        improved = (value < self.best if self.mode == "min"
                    else value > self.best)
        if improved:
            self.best = value
        return improved

    def state_dict(self) -> Dict:
        return {"mode": self.mode, "best": self.best}

    def load_state_dict(self, state: Dict) -> None:
        self.mode = state["mode"]
        self.best = state["best"]
