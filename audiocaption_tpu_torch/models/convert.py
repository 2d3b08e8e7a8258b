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

``cnn14rnn_trm_state_dict_from_jax`` converts the JAX cnn14rnn_trm
(Cnn14 -> BiGRU encoder, transformer decoder) into the reference
trainer's key space (``encoder.cnn.*``, ``encoder.rnn.network.*``,
``decoder.*``); :func:`reference_prefixes` says which key space a
``Captioner`` uses.

``cdur5_trm_state_dict_from_jax`` converts the JAX KD student (Cdur5
CRNN encoder, transformer decoder) into ``encoder.b{1..5}.{bn,conv}.*``,
``encoder.gru.*``, ``decoder.*``.  Neither package has the reference's
own Cdur5 key names, so this key space is the port's module names, which
follow the JAX tree; ``kd_head_state_dict_from_jax`` converts an encoder-KD
head (``stdnt_proj``, ``tchr_proj``, ``logit_scale``).

``jax_tree_state_dict`` converts any JAX module tree whose port
counterpart keeps the JAX names (the PANNs Cnn6 / Cnn10 and Cnn14 names
are also the reference's): Cnn6 / Cnn10, MobileNetV2, Cdur8, the audio
transformer, Cnn14Transformer, Cnn14Classifier, every GRU decoder and
``HmClassifier``, leaf by leaf (a Dense, a Conv, a BatchNorm (its stats
beside it), a LayerNorm, an Embed, a GRU or GRU cell stack, a
``MultiheadAttention``, a raw parameter).  ``captioner_state_dict_from_jax``
converts a whole captioner so (a transformer decoder by
``decoder_state_dict_from_jax``'s names) into ``encoder.*`` /
``decoder.*``; an item-8 encoder (HTS-AT, MobileNetV3, UiT,
ESResNeXt-FBSP) by its family's converter below
(``encoder_state_dict_from_jax``), into the reference checkpoint keys
that the port's modules carry.

A conditioned transformer decoder's parameters keep the JAX names (the
JAX loader gives them no reference key): ``decoder.event_embedding.weight``,
``decoder.keyword_proj.*``, ``decoder.word_keyword_norm.*``.  A style
captioner's reference encoder and style bank sit beside the encoder and
decoder under ``ref_encoder.`` and ``style_bank.``
(:func:`captioner_parts`, :func:`style_state_dict_from_jax`).

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

from typing import Dict, List, Mapping, Tuple

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
    # the conditioned decoders' parameters, under the JAX names
    if "event_embedding" in params:
        _embedding(params["event_embedding"], f"{prefix}.event_embedding",
                   out)
    if "keyword_proj" in params:
        _linear(params["keyword_proj"], f"{prefix}.keyword_proj", out)
        _layernorm(params["word_keyword_norm"],
                   f"{prefix}.word_keyword_norm", out)


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


def cnn14rnn_trm_state_dict_from_jax(variables: Mapping,
                                     rnn_num_layers: int = 3,
                                     rnn_bidirectional: bool = True,
                                     nlayers: int = 2,
                                     tie_weights: bool = False
                                     ) -> Dict[str, torch.Tensor]:
    """JAX cnn14rnn_trm variables (nested numpy dicts) -> the reference
    trainer's state dict of tensors (the JAX exporters
    ``cnn14_rnn_state_dict`` and ``transformer_decoder_state_dict`` under
    ``encoder.`` and ``decoder.``)."""
    out: Dict[str, np.ndarray] = {}
    enc_p = variables["params"]["encoder"]
    enc_s = variables["batch_stats"]["encoder"]
    _cnn(enc_p["cnn"], enc_s["cnn"], "encoder.cnn", 6, out)
    if "fc1" in enc_p["cnn"]:
        _linear(enc_p["cnn"]["fc1"], "encoder.cnn.fc1", out)
    _gru(enc_p["rnn"]["network"], "encoder.rnn.network", rnn_num_layers,
         rnn_bidirectional, out)
    _transformer_decoder(variables["params"]["decoder"], "decoder", nlayers,
                         tie_weights, out)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def cdur5_trm_state_dict_from_jax(variables: Mapping, nlayers: int = 1,
                                  tie_weights: bool = False
                                  ) -> Dict[str, torch.Tensor]:
    """JAX KD student variables (``zoo.kd_student_cdur5``, or a config's
    ``Cdur5Encoder`` + ``TransformerDecoder``; nested numpy dicts) -> the
    port's state dict of tensors under ``encoder.`` and ``decoder.``.
    The encoder keys are the port's module names, which follow the JAX
    tree (``b1`` .. ``b5``, ``gru``): the reference's own Cdur5 names are
    in neither package."""
    out: Dict[str, np.ndarray] = {}
    enc_p = variables["params"]["encoder"]
    enc_s = variables["batch_stats"]["encoder"]
    for i in range(1, 6):
        b = f"b{i}"
        _batchnorm(enc_p[b]["bn"], enc_s[b]["bn"], f"encoder.{b}.bn", out)
        _conv2d(enc_p[b]["conv"], f"encoder.{b}.conv", out)
    _gru(enc_p["gru"], "encoder.gru", 1, True, out)
    _transformer_decoder(variables["params"]["decoder"], "decoder", nlayers,
                         tie_weights, out)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def kd_head_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """An encoder-KD head's JAX params (``stdnt_proj`` and, where the
    head has them, ``tchr_proj`` and ``logit_scale``; ``layer_weights``
    of the weighted multi-layer head) -> the port head's state dict."""
    out: Dict[str, np.ndarray] = {}
    for name in ("stdnt_proj", "tchr_proj"):
        if name in params:
            _linear(params[name], name, out)
    for name in ("logit_scale", "layer_weights"):
        if name in params:
            out[name] = _n(params[name])
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


# the style captioner's parts beside its encoder and decoder, under the
# JAX module names (``models/style.py``)
STYLE_PARTS = ("ref_encoder", "style_bank")


def captioner_parts(model: torch.nn.Module
                    ) -> List[Tuple[str, torch.nn.Module]]:
    """(prefix, module) of every part of a ``Captioner`` that its state
    dict in the reference key space holds: the encoder and decoder under
    :func:`reference_prefixes`, and a ``StyleCaptioner``'s ``ref_encoder.``
    and ``style_bank.``."""
    enc_prefix, dec_prefix = reference_prefixes(model)
    parts = [(enc_prefix, model.encoder), (dec_prefix, model.decoder)]
    return parts + [(f"{name}.", getattr(model, name))
                    for name in STYLE_PARTS if hasattr(model, name)]


def style_state_dict_from_jax(params: Mapping) -> Dict[str, np.ndarray]:
    """A JAX ``StyleCaptioner``'s ``ref_encoder`` and ``style_bank`` params
    (none for any other captioner) -> numpy arrays under their names."""
    out: Dict[str, np.ndarray] = {}
    for name in STYLE_PARTS:
        if name in params:
            out.update(jax_tree_state_dict(params[name], None, name))
    return out


def reference_prefixes(model: torch.nn.Module) -> Tuple[str, str]:
    """The prefixes of a ``Captioner``'s encoder and decoder keys in its
    reference key space: the HF EffB2-Transformer checkpoint's for an
    EfficientNet-B2 encoder, the reference trainer's ``encoder.`` /
    ``decoder.`` for every other."""
    from audiocaption_tpu_torch.models.effb2 import EfficientNetB2
    if isinstance(model.encoder, EfficientNetB2):
        return ENCODER_PREFIX, DECODER_PREFIX
    return "encoder.", "decoder."


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
    """Load a reference-key-space state dict (:func:`reference_prefixes`)
    into a ``Captioner``: every tensor of its parts
    (:func:`captioner_parts`) must be present; keys outside them are
    dropped (:func:`load_known`)."""
    parts = captioner_parts(model)
    subs: List[Dict] = [{} for _ in parts]
    for k, v in sd.items():
        for (prefix, _), sub in zip(parts, subs):
            if k.startswith(prefix):
                sub[k[len(prefix):]] = v
                break
    dec = subs[1]
    if "pos_encoder.pe" not in dec and hasattr(model.decoder,
                                               "pos_encoder"):
        # older trees without a PE table
        dec["pos_encoder.pe"] = model.decoder.pos_encoder.pe
    for (_, module), sub in zip(parts, subs):
        load_known(module, sub)


def _cnn(params, stats, prefix, n_blocks, out):
    _batchnorm(params["bn0"], stats["bn0"], f"{prefix}.bn0", out)
    for i in range(1, n_blocks + 1):
        _conv_block(params[f"conv_block{i}"], stats[f"conv_block{i}"],
                    f"{prefix}.conv_block{i}", out)


def bahattn_captioner_state_dict_from_jax(variables: Mapping,
                                          prefix: str = "",
                                          rnn_num_layers: int = 3,
                                          rnn_bidirectional: bool = True
                                          ) -> Dict[str, np.ndarray]:
    """JAX Cnn14-GRU + GRU-decoder captioner variables (the temporal
    captioner's, or any GRU decoder's, at any depth) -> numpy arrays
    under ``{prefix}encoder.`` and ``{prefix}decoder.``."""
    out: Dict[str, np.ndarray] = {}
    enc_p = variables["params"]["encoder"]
    enc_s = variables["batch_stats"]["encoder"]
    _cnn(enc_p["cnn"], enc_s["cnn"], f"{prefix}encoder.cnn", 6, out)
    if "fc1" in enc_p["cnn"]:
        _linear(enc_p["cnn"]["fc1"], f"{prefix}encoder.cnn.fc1", out)
    _gru(enc_p["rnn"]["network"], f"{prefix}encoder.rnn.network",
         rnn_num_layers, rnn_bidirectional, out)
    # in the reference module's order, which its state dict keeps
    dec = variables["params"]["decoder"]
    order = ("word_embedding", "model", "attn", "fc_proj", "ctx_proj",
             "classifier")
    dec = {k: dec[k] for k in sorted(
        dec, key=lambda k: order.index(k) if k in order else len(order))}
    out.update(jax_tree_state_dict(dec, None, f"{prefix}decoder"))
    return out


def sed_state_dict_from_jax(sed_variables: Mapping, prefix: str = ""
                            ) -> Dict[str, np.ndarray]:
    """JAX Cnn8-RNN SED variables -> numpy arrays under ``prefix`` (the
    port's ``Cnn8RnnSedModel`` names)."""
    out: Dict[str, np.ndarray] = {}
    sed_p, sed_s = sed_variables["params"], sed_variables["batch_stats"]
    _cnn(sed_p, sed_s, "sed", 4, out)
    _linear(sed_p["fc1"], "sed.fc1", out)
    _gru(sed_p["rnn"], "sed.rnn", 1, True, out)
    _linear(sed_p["fc_audioset"], "sed.fc_audioset", out)
    return {prefix + k[len("sed."):]: v for k, v in out.items()}


def tempgru_state_dict_from_jax(variables: Mapping, sed_variables: Mapping,
                                rnn_num_layers: int = 3
                                ) -> Dict[str, torch.Tensor]:
    """JAX Cnn14RnnTempAttnGru variables and Cnn8-RNN SED variables (nested
    numpy dicts) -> the reference checkpoint's state dict of tensors."""
    out = bahattn_captioner_state_dict_from_jax(variables, "cap_model.",
                                                rnn_num_layers)
    out.update(sed_state_dict_from_jax(sed_variables, "sed_model."))
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def _is_gru(p: Mapping) -> bool:
    return "w_ih_l0" in p


def jax_tree_state_dict(params: Mapping, stats: Mapping = None,
                        prefix: str = "") -> Dict[str, np.ndarray]:
    """A JAX module's params (and batch stats) -> numpy arrays under the
    same dotted names, in torch layouts: a Dense ``kernel`` [in, out] ->
    ``weight`` [out, in]; a Conv kernel -> [O, I, kh, kw]; a BatchNorm
    (stats beside it) -> ``weight`` / ``bias`` / ``running_*``; a
    LayerNorm -> ``weight`` / ``bias``; an Embed -> ``weight``; a GRU
    (``w_ih_l{k}[_reverse]``, ``cell_*``) -> ``nn.GRU``'s names, gate
    order r, z, n; a ``MultiheadAttention`` (q / k / v / out) -> the packed
    ``in_proj_*`` and ``out_proj``; any other leaf as it is."""
    stats = stats or {}
    out: Dict[str, np.ndarray] = {}
    pre = prefix + "." if prefix else ""
    p = params
    if "kernel" in p and not isinstance(p["kernel"], Mapping):
        (_conv2d if np.ndim(p["kernel"]) == 4 else _linear)(
            p, prefix, out)
    elif "scale" in p and "mean" in stats:
        _batchnorm(p, stats, prefix, out)
    elif "scale" in p:
        _layernorm(p, prefix, out)
    elif set(p) == {"embedding"}:
        _embedding(p, prefix, out)
    elif _is_gru(p):
        layers = sum(k.startswith("w_ih_l") and not k.endswith("_reverse")
                     for k in p)
        _gru(p, prefix, layers, any(k.endswith("_reverse") for k in p),
             out)
    elif "q_proj" in p:
        _mha(p, prefix, out)
    else:
        for k, v in p.items():
            if isinstance(v, Mapping):
                out.update(jax_tree_state_dict(v, stats.get(k, {}),
                                               pre + k))
            else:
                out[pre + k] = _n(v)
    return out


def captioner_state_dict_from_jax(variables: Mapping
                                  ) -> Dict[str, torch.Tensor]:
    """A JAX captioner's variables whose encoder keeps the JAX names in
    the port (see :func:`jax_tree_state_dict`) or is an item-8 encoder
    (:func:`encoder_state_dict_from_jax`) -> the port's state dict of
    tensors under ``encoder.`` and ``decoder.``: a GRU decoder leaf by
    leaf, a ``TransformerDecoder`` by the reference's names (its depth
    and tying read off the tree)."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    out = {"encoder." + k: v for k, v in encoder_state_dict_from_jax(
        params["encoder"], stats.get("encoder", {})).items()}
    dec = params["decoder"]
    if "attn_proj_dense" in dec:
        _transformer_decoder(dec, "decoder",
                             sum(k.startswith("layer") for k in dec),
                             "classifier" not in dec, out)
    else:
        out.update(jax_tree_state_dict(dec, None, "decoder"))
    out.update(style_state_dict_from_jax(params))
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


# -- the item-8 encoders: a JAX tree -> the reference checkpoint keys ------
#
# Each is the inverse of the JAX package's converter of its family
# (``convert_mobilenet_v3``, ``convert_htsat``, ``convert_uit``,
# ``convert_esresnext``, ``convert_cnn10_classifier``,
# ``convert_wavegram_cnn14``), read off the tree itself, so any depth and
# width converts; the port's modules carry these names.  Parts the JAX
# converters do not map keep the JAX names (MobileNetV3's ``bn0`` and
# ``fc1``).

def _conv_bn_pair(params, stats, conv, bn, prefix, out):
    _conv2d(params[conv], f"{prefix}.0", out)
    _batchnorm(params[bn], stats[bn], f"{prefix}.1", out)


def _se_linear(p, prefix, out):
    out[f"{prefix}.weight"] = _n(p["kernel"])[0, 0].T
    out[f"{prefix}.bias"] = _n(p["bias"])


def mobilenet_v3_state_dict_from_jax(params: Mapping, stats: Mapping
                                     ) -> Dict[str, np.ndarray]:
    """A JAX ``MobileNetV3Encoder``'s params and batch stats -> numpy
    arrays under the EfficientAT keys (``features.*``), ``bn0`` and
    ``fc1``."""
    out: Dict[str, np.ndarray] = {}
    _batchnorm(params["bn0"], stats["bn0"], "bn0", out)
    _conv_bn_pair(params, stats, "stem", "bn_stem", "features.0", out)
    n_blocks = sum(k.startswith("block") for k in params)
    for i in range(n_blocks):
        bp, bs = params[f"block{i}"], stats[f"block{i}"]
        t, j = f"features.{i + 1}.block", 0
        if "expand" in bp:
            _conv_bn_pair(bp, bs, "expand", "bn_expand", f"{t}.{j}", out)
            j += 1
        _conv_bn_pair(bp, bs, "depthwise", "bn_dw", f"{t}.{j}", out)
        j += 1
        if "se_reduce" in bp:
            se = f"{t}.{j}.conc_se_layers.0"
            _se_linear(bp["se_reduce"], f"{se}.fc1", out)
            _se_linear(bp["se_expand"], f"{se}.fc2", out)
            j += 1
        _conv_bn_pair(bp, bs, "project", "bn_proj", f"{t}.{j}", out)
    _conv_bn_pair(params, stats, "lastconv", "bn_last",
                  f"features.{n_blocks + 1}", out)
    if "fc1" in params:
        _linear(params["fc1"], "fc1", out)
    return out


def htsat_state_dict_from_jax(params: Mapping, stats: Mapping
                              ) -> Dict[str, np.ndarray]:
    """A JAX ``HtsatEncoder``'s params and batch stats -> numpy arrays
    under the HTSAT_Swin_Transformer keys."""
    out: Dict[str, np.ndarray] = {}
    _batchnorm(params["bn0"], stats["bn0"], "bn0", out)
    _conv2d(params["patch_embed"], "patch_embed.proj", out)
    _layernorm(params["patch_norm"], "patch_embed.norm", out)
    for name, p in params.items():
        if name.startswith("stage"):
            s, b = (int(x) for x in name[len("stage"):].split("_block"))
            tp = f"layers.{s}.blocks.{b}"
            _layernorm(p["norm1"], f"{tp}.norm1", out)
            _layernorm(p["norm2"], f"{tp}.norm2", out)
            _linear(p["attn"]["qkv"], f"{tp}.attn.qkv", out)
            _linear(p["attn"]["proj"], f"{tp}.attn.proj", out)
            out[f"{tp}.attn.relative_position_bias_table"] = _n(
                p["attn"]["relative_position_bias_table"])
            _linear(p["fc1"], f"{tp}.mlp.fc1", out)
            _linear(p["fc2"], f"{tp}.mlp.fc2", out)
        elif name.startswith("merge"):
            tp = f"layers.{int(name[len('merge'):])}.downsample"
            _layernorm(p["norm"], f"{tp}.norm", out)
            _linear(p["reduction"], f"{tp}.reduction", out)
    _layernorm(params["norm"], "norm", out)
    return out


def uit_state_dict_from_jax(params: Mapping, stats: Mapping
                            ) -> Dict[str, np.ndarray]:
    """A JAX ``UITBase``'s params and batch stats (a ``UitEncoder``'s
    ``trunk``) -> numpy arrays under the reference UiT keys; the head
    (``outputlayer``) where the tree has one."""
    out: Dict[str, np.ndarray] = {}
    _batchnorm(params["init_bn"], stats["init_bn"], "init_bn.1", out)
    _conv2d(params["patch_proj"], "patch_embed.proj", out)
    for k in ("cls_token", "token_pos_embed", "time_pos_embed",
              "freq_pos_embed"):
        out[k] = _n(params[k])
    for name, p in params.items():
        if name.startswith("blocks_"):
            b = f"blocks.{int(name[len('blocks_'):])}"
            _layernorm(p["norm1"], f"{b}.norm1", out)
            _layernorm(p["norm2"], f"{b}.norm2", out)
            _linear(p["attn"]["qkv"], f"{b}.attn.qkv", out)
            _linear(p["attn"]["proj"], f"{b}.attn.proj", out)
            _linear(p["mlp_fc1"], f"{b}.mlp.fc1", out)
            _linear(p["mlp_fc2"], f"{b}.mlp.fc2", out)
            for g in ("ls1", "ls2"):
                if f"{g}_gamma" in p:
                    out[f"{b}.{g}.gamma"] = _n(p[f"{g}_gamma"])
    _layernorm(params["norm"], "norm", out)
    if "out_proj" in params:
        _layernorm(params["out_norm"], "outputlayer.0", out)
        _linear(params["out_proj"], "outputlayer.1", out)
    return out


def esresnext_state_dict_from_jax(params: Mapping, stats: Mapping
                                  ) -> Dict[str, np.ndarray]:
    """A JAX ``ESResNeXtFBSP``'s params and batch stats (``{"fbsp",
    "trunk"}``; an encoder's ``fbsp_model``) -> numpy arrays under the
    reference ESResNeXt keys (``att5`` and ``fc`` where the tree has
    them)."""
    out: Dict[str, np.ndarray] = {}
    tp, ts = params["trunk"], stats["trunk"]
    _conv2d(tp["conv1"], "conv1", out)
    _batchnorm(tp["bn1"], ts["bn1"], "bn1", out)
    for name, p in tp.items():
        s = ts.get(name, {})
        if name.startswith("layer"):
            stage, i = name[len("layer"):].split("_")
            b = f"layer{stage}.{i}"
            for c in (1, 2, 3):
                _conv2d(p[f"conv{c}"], f"{b}.conv{c}", out)
                _batchnorm(p[f"bn{c}"], s[f"bn{c}"], f"{b}.bn{c}", out)
            if "downsample_conv" in p:
                _conv2d(p["downsample_conv"], f"{b}.downsample.0", out)
                _batchnorm(p["downsample_bn"], s["downsample_bn"],
                           f"{b}.downsample.1", out)
        elif name.startswith("att"):
            _conv2d(p["conv_depth"], f"{name}.conv_depth", out)
            _conv2d(p["conv_point"], f"{name}.conv_point", out)
            _batchnorm(p["bn"], s["bn"], f"{name}.bn", out)
    if "fc" in tp:
        _linear(tp["fc"], "fc", out)
    for k in ("m", "fb", "fc"):
        out[f"fbsp.{k}"] = _n(params["fbsp"][k])
    return out


def panns_classifier_state_dict_from_jax(params: Mapping, stats: Mapping
                                         ) -> Dict[str, np.ndarray]:
    """A JAX ``Cnn10`` or ``Wavegram_Logmel_Cnn14`` classifier's params
    and batch stats -> numpy arrays under the PANNs keys: the head's
    ``fc1`` and ``fc_audioset`` at the top, a 1-D conv kernel [k, I, O]
    as [O, I, k]."""
    body = {k: v for k, v in params.items() if k != "head"}
    out = jax_tree_state_dict(body, stats)
    out.update(jax_tree_state_dict(params["head"]))
    return out


def encoder_state_dict_from_jax(params: Mapping, stats: Mapping
                                ) -> Dict[str, np.ndarray]:
    """A JAX captioning encoder's params and batch stats -> the port
    encoder's state dict as numpy arrays: the item-8 encoders by their
    converters above (read off the tree: an HTS-AT has ``patch_norm``, a
    MobileNetV3 ``lastconv``, a UiT encoder a ``trunk``, an ESResNeXt
    encoder an ``fbsp_model``), every other leaf by leaf
    (:func:`jax_tree_state_dict`)."""
    if "patch_norm" in params:
        return htsat_state_dict_from_jax(params, stats)
    if "lastconv" in params:
        return mobilenet_v3_state_dict_from_jax(params, stats)
    if "trunk" in params and "patch_proj" in params["trunk"]:
        return {"trunk." + k: v for k, v in uit_state_dict_from_jax(
            params["trunk"], stats["trunk"]).items()}
    if "fbsp_model" in params:
        return {"fbsp_model." + k: v for k, v in
                esresnext_state_dict_from_jax(
                    params["fbsp_model"], stats["fbsp_model"]).items()}
    return jax_tree_state_dict(params, stats)
