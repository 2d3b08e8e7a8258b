"""Weights carried across: the JAX package's variable tree -> the
reference checkpoint key space, and that key space -> the port's modules.

``state_dict_from_jax`` takes the JAX ``{"params", "batch_stats"}`` tree
as nested numpy dicts and returns the flat state dict that the reference
HF checkpoints ship (``model.model.encoder.backbone.eff_net.*``,
``model.model.decoder.*``).  Layout changes:

  Linear     kernel [in, out]        -> weight [out, in]
  Conv2d     kernel [kh, kw, I, O]   -> weight [O, I, kh, kw]
  MHA        q/k/v kernels           -> packed in_proj_weight [3E, E]
  BatchNorm  scale/bias + mean/var   -> weight/bias/running_mean/running_var
  PE         [max_len, E]            -> pos_encoder.pe [max_len, 1, E]

``load_reference_state_dict`` loads such a dict (a converted JAX tree or
a downloaded reference checkpoint) into the port's ``Captioner``.

``tempgru_state_dict_from_jax`` does the same for the temporal captioner
and its SED model, into the ``wsntxxn/cnn14rnn-tempgru`` key space
(``cap_model.encoder.{cnn,rnn}.*``, ``cap_model.decoder.*``,
``sed_model.*``), which the port's ``TemporalCaptionModel`` loads with a
plain strict ``load_state_dict``.  More layout changes:

  GRU        w_ih [in, 3H]           -> weight_ih_l{k}[_reverse] [3H, in]
             cell w_hh [H, 3H]       -> weight_hh_l{k}[_reverse] [3H, H]
  Embedding  embedding [V, E]        -> weight [V, E]
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

ENCODER_PREFIX = "model.model.encoder.backbone.eff_net."
DECODER_PREFIX = "model.model.decoder."


def _n(x) -> np.ndarray:
    return np.asarray(x)


def _linear(p, prefix, out):
    out[f"{prefix}.weight"] = _n(p["kernel"]).T
    if "bias" in p:
        out[f"{prefix}.bias"] = _n(p["bias"])


def _conv2d(p, prefix, out):
    out[f"{prefix}.weight"] = np.transpose(_n(p["kernel"]), (3, 2, 0, 1))
    if "bias" in p:
        out[f"{prefix}.bias"] = _n(p["bias"])


def _batchnorm(p, s, prefix, out):
    out[f"{prefix}.weight"] = _n(p["scale"])
    out[f"{prefix}.bias"] = _n(p["bias"])
    out[f"{prefix}.running_mean"] = _n(s["mean"])
    out[f"{prefix}.running_var"] = _n(s["var"])
    out[f"{prefix}.num_batches_tracked"] = np.asarray(0, np.int64)


def _layernorm(p, prefix, out):
    out[f"{prefix}.weight"] = _n(p["scale"])
    out[f"{prefix}.bias"] = _n(p["bias"])


def _embedding(p, prefix, out):
    out[f"{prefix}.weight"] = _n(p["embedding"])


def _gru(p, prefix, num_layers, bidirectional, out):
    for layer in range(num_layers):
        for d in range(2 if bidirectional else 1):
            suf = f"l{layer}" + ("_reverse" if d == 1 else "")
            cell = p[f"cell_{suf}"]
            out[f"{prefix}.weight_ih_{suf}"] = _n(p[f"w_ih_{suf}"]).T
            out[f"{prefix}.bias_ih_{suf}"] = _n(p[f"b_ih_{suf}"])
            out[f"{prefix}.weight_hh_{suf}"] = _n(cell["w_hh"]).T
            out[f"{prefix}.bias_hh_{suf}"] = _n(cell["b_hh"])


def _conv_block(p, s, prefix, out):
    _conv2d(p["conv1"], f"{prefix}.conv1", out)
    _conv2d(p["conv2"], f"{prefix}.conv2", out)
    _batchnorm(p["bn1"], s["bn1"], f"{prefix}.bn1", out)
    _batchnorm(p["bn2"], s["bn2"], f"{prefix}.bn2", out)


def _mha(p, prefix, out):
    out[f"{prefix}.in_proj_weight"] = np.concatenate(
        [_n(p[n]["kernel"]).T for n in ("q_proj", "k_proj", "v_proj")], 0)
    if "bias" in p["q_proj"]:
        out[f"{prefix}.in_proj_bias"] = np.concatenate(
            [_n(p[n]["bias"]) for n in ("q_proj", "k_proj", "v_proj")], 0)
    _linear(p["out_proj"], f"{prefix}.out_proj", out)


def _effb2(params, stats, prefix, out):
    _conv2d(params["conv_stem"], f"{prefix}._conv_stem", out)
    _batchnorm(params["bn0"], stats["bn0"], f"{prefix}._bn0", out)
    # walk the tree's own blocks, so a pruned encoder converts as well
    n_blocks = sum(k.startswith("block") for k in params)
    for i in range(n_blocks):
        bp, bs = params[f"block{i}"], stats[f"block{i}"]
        tp = f"{prefix}._blocks.{i}"
        if "expand_conv" in bp:
            _conv2d(bp["expand_conv"], f"{tp}._expand_conv", out)
            _batchnorm(bp["bn0"], bs["bn0"], f"{tp}._bn0", out)
        _conv2d(bp["depthwise_conv"], f"{tp}._depthwise_conv", out)
        _batchnorm(bp["bn1"], bs["bn1"], f"{tp}._bn1", out)
        _conv2d(bp["se_reduce"], f"{tp}._se_reduce", out)
        _conv2d(bp["se_expand"], f"{tp}._se_expand", out)
        _conv2d(bp["project_conv"], f"{tp}._project_conv", out)
        _batchnorm(bp["bn2"], bs["bn2"], f"{tp}._bn2", out)
    _conv2d(params["conv_head"], f"{prefix}._conv_head", out)
    _batchnorm(params["bn1"], stats["bn1"], f"{prefix}._bn1", out)


def _transformer_decoder(params, prefix, nlayers, tie_weights, out):
    out[f"{prefix}.word_embedding.weight"] = _n(
        params["word_embedding"]["embedding"])
    _linear(params["attn_proj_dense"], f"{prefix}.attn_proj.0", out)
    _layernorm(params["attn_proj_norm"], f"{prefix}.attn_proj.3", out)
    if "pe" in params:
        out[f"{prefix}.pos_encoder.pe"] = _n(params["pe"])[:, None, :]
    for i in range(nlayers):
        lp = params[f"layer{i}"]
        tp = f"{prefix}.model.layers.{i}"
        _mha(lp["self_attn"], f"{tp}.self_attn", out)
        _mha(lp["cross_attn"], f"{tp}.multihead_attn", out)
        _linear(lp["linear1"], f"{tp}.linear1", out)
        _linear(lp["linear2"], f"{tp}.linear2", out)
        for n in ("norm1", "norm2", "norm3"):
            _layernorm(lp[n], f"{tp}.{n}", out)
    if not tie_weights and "classifier" in params:
        _linear(params["classifier"], f"{prefix}.classifier", out)


def effb2_state_dict_from_jax(params: Mapping, stats: Mapping
                              ) -> Dict[str, torch.Tensor]:
    """JAX ``EfficientNetB2`` or ``PrunedEfficientNetB2`` params and batch
    stats -> the port encoder's state dict (efficientnet_pytorch names, no
    prefix)."""
    out: Dict[str, np.ndarray] = {}
    _effb2(params, stats, "", out)
    return {k[1:]: torch.from_numpy(np.array(v)) for k, v in out.items()}


def decoder_state_dict_from_jax(params: Mapping, nlayers: int = 2,
                                tie_weights: bool = True
                                ) -> Dict[str, torch.Tensor]:
    """JAX ``TransformerDecoder`` params -> the port decoder's state dict
    (reference names without the ``model.model.decoder.`` prefix)."""
    out: Dict[str, np.ndarray] = {}
    _transformer_decoder(params, "", nlayers, tie_weights, out)
    return {k[1:]: torch.from_numpy(np.array(v)) for k, v in out.items()}


def state_dict_from_jax(variables: Mapping, nlayers: int = 2,
                        tie_weights: bool = True) -> Dict[str, torch.Tensor]:
    """JAX EffB2-Transformer variables (nested numpy dicts) -> reference
    checkpoint state dict of torch tensors."""
    out: Dict[str, np.ndarray] = {}
    _effb2(variables["params"]["encoder"], variables["batch_stats"]["encoder"],
           ENCODER_PREFIX[:-1], out)
    _transformer_decoder(variables["params"]["decoder"], DECODER_PREFIX[:-1],
                         nlayers, tie_weights, out)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def load_known(module: torch.nn.Module,
               sd: Mapping[str, torch.Tensor]) -> None:
    """Load ``sd`` into ``module`` as the JAX converters read a
    checkpoint: keys the module has no tensor for are dropped (a
    reference checkpoint also carries, for instance, the unused
    classifier ``eff_net._fc.*`` and the feature extractor's
    ``melspec_extractor.*`` buffers); a tensor the module needs and
    ``sd`` lacks raises."""
    own = module.state_dict()
    missing = sorted(set(own) - set(sd))
    if missing:
        raise RuntimeError(f"Missing key(s) in state_dict: {len(missing)} "
                           f"tensor(s) the model needs, {missing[:8]}")
    module.load_state_dict({
        k: v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
        for k, v in sd.items() if k in own})


def load_reference_state_dict(model: torch.nn.Module,
                              sd: Mapping[str, torch.Tensor]) -> None:
    """Load a reference-key-space state dict into a ``Captioner``: every
    encoder and decoder tensor must be present; keys outside them are
    dropped (:func:`load_known`)."""
    enc, dec = {}, {}
    for k, v in sd.items():
        if k.startswith(ENCODER_PREFIX):
            enc[k[len(ENCODER_PREFIX):]] = v
        elif k.startswith(DECODER_PREFIX):
            dec[k[len(DECODER_PREFIX):]] = v
    if "pos_encoder.pe" not in dec:   # older trees without a PE table
        dec["pos_encoder.pe"] = model.decoder.pos_encoder.pe
    load_known(model.encoder, enc)
    load_known(model.decoder, dec)


def _cnn(params, stats, prefix, n_blocks, out):
    _batchnorm(params["bn0"], stats["bn0"], f"{prefix}.bn0", out)
    for i in range(1, n_blocks + 1):
        _conv_block(params[f"conv_block{i}"], stats[f"conv_block{i}"],
                    f"{prefix}.conv_block{i}", out)


def tempgru_state_dict_from_jax(variables: Mapping, sed_variables: Mapping,
                                rnn_num_layers: int = 3
                                ) -> Dict[str, torch.Tensor]:
    """JAX Cnn14RnnTempAttnGru variables and Cnn8-RNN SED variables (nested
    numpy dicts) -> the reference checkpoint's state dict of tensors."""
    out: Dict[str, np.ndarray] = {}
    enc_p = variables["params"]["encoder"]
    enc_s = variables["batch_stats"]["encoder"]
    _cnn(enc_p["cnn"], enc_s["cnn"], "cap_model.encoder.cnn", 6, out)
    if "fc1" in enc_p["cnn"]:
        _linear(enc_p["cnn"]["fc1"], "cap_model.encoder.cnn.fc1", out)
    _gru(enc_p["rnn"]["network"], "cap_model.encoder.rnn.network",
         rnn_num_layers, True, out)
    dec, d = variables["params"]["decoder"], "cap_model.decoder"
    _embedding(dec["word_embedding"], f"{d}.word_embedding", out)
    _gru(dec["model"], f"{d}.model", 1, False, out)
    _linear(dec["attn"]["h2attn"], f"{d}.attn.h2attn", out)
    out[f"{d}.attn.v"] = _n(dec["attn"]["v"])
    for name in ("fc_proj", "ctx_proj", "classifier"):
        _linear(dec[name], f"{d}.{name}", out)
    _embedding(dec["temporal_embedding"], f"{d}.temporal_embedding", out)
    sed_p, sed_s = sed_variables["params"], sed_variables["batch_stats"]
    _cnn(sed_p, sed_s, "sed_model", 4, out)
    _linear(sed_p["fc1"], "sed_model.fc1", out)
    _gru(sed_p["rnn"], "sed_model.rnn", 1, True, out)
    _linear(sed_p["fc_audioset"], "sed_model.fc_audioset", out)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}
