"""The program under test and the reference, built from one
configuration file and given the same weights from the seed.

The weights are drawn by the benchmark (``seeded.weights``) over the
reference's names and shapes, kept by the benchmark, and copied into
the program's model, whose parameter names are the reference
implementation's too.  The reference later gets its own copy: nothing
the program computed from them."""

from __future__ import annotations

import dataclasses
import importlib
import inspect
from typing import Dict

import torch

from harness import seeded


def reference_module(config: Dict):
    return importlib.import_module(f"reference.{config['reference']}")


def seeded_weights(config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    with torch.device("meta"):
        ref = reference_module(config).Captioner(config)
    return seeded.weights(ref, seed, device, fixed=ref.fixed(),
                          jitter={"decoder.": config["decoder_jitter"]})


def reference_model(config: Dict, weights: Dict[str, torch.Tensor], device):
    """The plain reference on ``device`` with (a copy of) ``weights``."""
    with torch.device(device):
        ref = reference_module(config).Captioner(config)
    ref.load_state_dict(weights, strict=True)
    return ref.to(device).eval()


# the program's argument names that the configuration spells otherwise
RENAMES = {"tie_weights": "decoder_tie_weights",
           "decoder_we_tie_weights": "decoder_tie_weights",
           "fc_emb_dim": "memory_dim", "attn_emb_dim": "memory_dim"}


def from_config(names, config: Dict) -> Dict:
    """The program's arguments ``names`` that the configuration gives,
    each read from its one key there (``compute_dtype`` as a torch
    dtype)."""
    args = {}
    for name in names:
        key = RENAMES.get(name, name)
        if key in config:
            args[name] = (getattr(torch, config[key])
                          if name == "compute_dtype" else config[key])
    return args


def program_model(config: Dict, weights: Dict[str, torch.Tensor], device):
    """The port's captioner by the configuration's ``builder`` (a function
    of ``audiocaption_tpu_torch.models.zoo``, given every argument the
    configuration holds), with the seeded weights, on ``device``, in eval
    mode.  The device comes from the port's ``resolve_device``, as its
    entry points take it: on the card that also sets the port's precision
    (TF32 off)."""
    from audiocaption_tpu_torch.device import resolve_device
    from audiocaption_tpu_torch.models import zoo
    device = resolve_device(device)
    build = getattr(zoo, config["builder"])
    with torch.device(device):
        model = build(**from_config(inspect.signature(build).parameters,
                                    config))
    model.to(device)
    load(model, weights)
    return model.eval()


def load(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into ``model``: every persistent leaf of the model
    must be given, and nothing else."""
    missing, unexpected = model.load_state_dict(weights, strict=False)
    if missing or unexpected:
        raise RuntimeError(f"weights do not fit the program's model: "
                           f"missing {missing[:5]}, unexpected "
                           f"{unexpected[:5]}")


def hf_api_model(config: Dict, weights: Dict[str, torch.Tensor], device):
    """``hf_api.Effb2TrmCaptioningModel`` with an ``Effb2TrmConfig`` read
    from the configuration, the seeded weights copied in (before any
    decode, so that its kernel decoders pack these weights)."""
    from audiocaption_tpu_torch import hf_api
    fields = [f.name for f in dataclasses.fields(hf_api.Effb2TrmConfig)]
    api = hf_api.Effb2TrmCaptioningModel(
        hf_api.Effb2TrmConfig(**from_config(fields, config)), device=device)
    load(api.model, weights)
    api.model.eval()
    return api
