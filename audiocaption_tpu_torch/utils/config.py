"""YAML configs with the reference's ergonomics (counterpart of
``audiocaption_tpu/utils/config.py``): ``inherit_from`` merged
recursively, ``key.sub=value`` overrides with YAML-typed values, and
the model built from the reference's {type, args} nodes (its dotted
type names are accepted: only the last component is read).

``yaml`` is imported where a config is read.  Every runner method takes
a config file or a config dict (:func:`resolve_config`).
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch


def merge_dicts(base: Dict, override: Dict) -> Dict:
    """Recursive dict merge; ``override`` wins."""
    out = copy.deepcopy(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge_dicts(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def load_config(path: str, overrides: Optional[Dict] = None) -> Dict:
    """Load YAML with recursive ``inherit_from`` (relative to the file),
    then ``overrides`` merged on top."""
    import yaml
    path = Path(path)
    with open(path) as f:
        config = yaml.safe_load(f)
    if config and "inherit_from" in config:
        parent_rel = config.pop("inherit_from")
        parent = load_config(str((path.parent / parent_rel).resolve()))
        config = merge_dicts(parent, config)
    if overrides:
        config = merge_dicts(config, overrides)
    return config


def parse_overrides(pairs) -> Dict:
    """["a.b=1", "--c=[2,3]"] -> nested dict with YAML-typed values."""
    import yaml
    out: Dict = {}
    for pair in pairs:
        key, _, value = pair.partition("=")
        node = out
        parts = key.strip().lstrip("-").split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = yaml.safe_load(value)
    return out


def resolve_config(config: Union[str, Dict], overrides=()) -> Dict:
    """A config file (``inherit_from`` followed) or a config dict (a deep copy), with ``key.sub=value`` overrides merged
    on top."""
    if isinstance(config, dict):
        return merge_dicts(config, parse_overrides(overrides))
    return load_config(config, parse_overrides(overrides))


def short_type(type_name: str) -> str:
    """A dotted type name read by its last part."""
    return type_name.split(".")[-1]


# the encoders over precomputed features (``input_mode`` "features")
FEATURE_ENCODERS = ("RnnEncoder", "TransformerEncoder",
                    "AudioTransformerEncoder", "M2TransformerEncoder")

# the GRU decoders the builder takes (every one of the JAX builder's)
RNN_DECODERS = ("BahAttnCatFcDecoder", "TemporalBahAttnDecoder",
                "BahAttnAddFcDecoder", "BahAttnDecoder",
                "ConditionalBahAttnDecoder", "StyleBahAttnDecoder",
                "SpecificityBahAttnDecoder", "StructBahAttnDecoder",
                "RnnFcDecoder")


def build_model_from_config(model_cfg: Dict,
                            vocab_size: Optional[int] = None,
                            compute_dtype: torch.dtype = torch.float32,
                            input_dim: Optional[int] = None
                            ) -> Tuple[torch.nn.Module, List[Tuple]]:
    """A ``Captioner`` from a reference-style model node, with the
    defaults of the JAX package's ``build_model_from_config``.  Encoders
    (the mel preset of ``sample_rate``, 32 kHz by default):
    ``EfficientNetB2`` (16 kHz), ``CrnnEncoder`` / ``Cnn14RnnEncoder`` (a
    Cnn14 and a GRU, from its ``cnn`` and ``rnn`` nodes), ``Cnn14Encoder``,
    ``Cnn6Encoder``, ``Cnn10Encoder``, ``MobileNetV2`` /
    ``MobileNetV2Encoder``, ``Cdur5Encoder``, ``Cdur8Encoder``,
    ``Cnn14TransformerEncoder`` (its ``transformer`` node's ``d_model`` 512
    and ``nlayers`` 2; an ``encoder.cnn.pretrained`` loads into its Cnn14),
    ``MobileNetV3`` / ``MobileNetV3Encoder`` (``model_name`` "mn10",
    ``pooling`` "mean_max_fc"), ``Htsat`` (HTS-AT base), ``UiT`` /
    ``UitEncoder`` / ``uit_*`` (the variant ``model_name`` or the type's
    own name, "uit_xs" by default; ``outputdim`` 537, ``target_length``
    1008; ``UIT_MEL_16K``) and ``ESResNeXtFBSP`` / ``ESResNeXtFBSPEncoder``
    (the public AudioSet settings: n_fft 2048, hop 561, window 1654
    blackmanharris, normalised, attention; ``input_mode`` "raw_wav", its
    own frontend, the mel preset left at 32 kHz whatever ``sample_rate``
    says, as in the JAX builder); over precomputed features
    (``input_mode`` "features"), ``RnnEncoder``,
    ``AudioTransformerEncoder`` (``TransformerEncoder`` is its other name)
    and ``M2TransformerEncoder``.  A feature encoder's input width is
    ``encoder.args.input_dim`` when the config gives it, else
    ``input_dim`` (the runner reads it off the first row of the data:
    flax infers it, torch needs it up front: :func:`feature_input_dim`).
    An ``EfficientNetB2`` with ``args.prune_ratio`` is built full here;
    :func:`apply_pruning` prunes it once the pretrained weights are in, as
    the JAX runner does.  Decoders: the ``TransformerDecoder``, the
    ``M2TransformerDecoder`` (on an M2 encoder only; its width the
    decoder's ``attn_emb_dim``, its gates one per encoder layer) and
    every GRU decoder (:data:`RNN_DECODERS`), at any ``num_layers``.  The
    memory and fc widths of a GRU or transformer decoder are the
    encoder's own (flax infers them in the JAX package, whatever the
    config's ``attn_emb_dim`` / ``fc_emb_dim`` say).  As in the JAX
    builder, ``compute_dtype`` reaches the EffB2, the Cnn14s, the
    MobileNetV3 and the transformer decoder only.  The model's own type
    is read as the JAX package reads it: every type but the style models
    is a plain ``Captioner``; an ``ScstWrapper`` node is read as the model
    node it wraps.  Returns (captioner, pretrained specs), a spec being
    (the dotted path of the submodule, e.g. ``"encoder.cnn"``, checkpoint
    path, kind: the JAX package's ``cnn14``, ``effb2``, ``htsat``,
    ``uit``, ``esresnext``, ``raw`` or ``decoder``, which
    ``cli/run.py::load_pretrained`` reads).  The conditioned transformer
    decoders take the transformer's arguments and ``event_classes``
    (``EventTransformerDecoder``) or ``keyword_classes_num``
    (``KeywordProbTransformerDecoder``), 527 by default.  A
    ``StyleCaptionModel`` or ``StyleSeq2SeqAttnModel`` node builds a
    ``models/style.py::StyleCaptioner`` from its ``style.args``:
    ``n_styles`` 4, a reference encoder of ``ref_d_model`` (the decoder's
    ``emb_dim``), ``ref_nlayers`` 2 and ``ref_dropout`` 0.2, and a style
    bank as wide as the decoder's ``emb_dim`` (its decoder a
    ``StyleBahAttnDecoder``).  An unknown type raises as in the JAX
    builder.  Weights are torch's defaults; the runner draws them
    (``zoo.random_init``)."""
    from audiocaption_tpu_torch.decoding.engine import SpecialTokens
    from audiocaption_tpu_torch.models import encoders_extra as EX
    from audiocaption_tpu_torch.models import rnn_decoder
    from audiocaption_tpu_torch.models.captioner import Captioner
    from audiocaption_tpu_torch.models.cnn14 import Cnn14Encoder
    from audiocaption_tpu_torch.models.effb2 import EfficientNetB2
    from audiocaption_tpu_torch.models.m2 import (
        M2TransformerDecoder, M2TransformerEncoder)
    from audiocaption_tpu_torch.models.rnn_encoder import (
        Cnn14RnnEncoder, RnnEncoder)
    from audiocaption_tpu_torch.models import transformer_decoder as TD
    from audiocaption_tpu_torch.ops.frontend import (
        CNN14_MEL_16K, CNN14_MEL_32K, EFFB2_MEL_16K)

    if short_type(model_cfg.get("type", "")) == "ScstWrapper":
        model_cfg = model_cfg["model"]
    pretrained = []
    enc_cfg = model_cfg["encoder"]
    enc_type = short_type(enc_cfg["type"])
    enc_args = enc_cfg.get("args") or {}

    def mel_of(args):
        return (CNN14_MEL_32K if args.get("sample_rate", 32000) == 32000
                else CNN14_MEL_16K)

    mel = mel_of(enc_args)
    input_mode = "mel"
    if enc_type in FEATURE_ENCODERS:
        input_mode = "features"
        in_dim = enc_args.get("input_dim", input_dim)
        if in_dim is None:
            raise ValueError(f"encoder {enc_type!r} reads precomputed "
                             "features: give encoder.args.input_dim or the "
                             "width of the data's rows (input_dim)")
    if enc_type in ("CrnnEncoder", "Cnn14RnnEncoder"):
        cnn_cfg, rnn_cfg = enc_cfg.get("cnn", {}), enc_cfg.get("rnn", {})
        cnn_args = cnn_cfg.get("args") or {}
        rnn_args = rnn_cfg.get("args") or {}
        mel = mel_of(cnn_args)
        encoder = Cnn14RnnEncoder(
            rnn_hidden_size=rnn_args.get("hidden_size", 512),
            rnn_num_layers=rnn_args.get("num_layers", 1),
            rnn_bidirectional=rnn_args.get("bidirectional", False),
            rnn_dropout=rnn_args.get("dropout", 0.2),
            rnn_pooling=rnn_args.get("pooling", "mean"),
            freeze_cnn=enc_args.get("freeze_cnn", False),
            freeze_cnn_bn=enc_args.get("freeze_cnn_bn", False),
            compute_dtype=compute_dtype)
        for part, node, kind in (("encoder.cnn", cnn_cfg, "cnn14"),
                                 ("encoder.rnn", rnn_cfg, "raw")):
            if node.get("pretrained"):
                pretrained.append((part, node["pretrained"], kind))
    elif enc_type == "Cnn14Encoder":
        encoder = Cnn14Encoder(compute_dtype=compute_dtype)
        if enc_cfg.get("pretrained"):
            pretrained.append(("encoder", enc_cfg["pretrained"], "cnn14"))
    elif enc_type in ("Cnn6Encoder", "Cnn10Encoder", "Cdur5Encoder",
                      "Cdur8Encoder"):
        encoder = getattr(EX, enc_type)()
    elif enc_type in ("MobileNetV2", "MobileNetV2Encoder"):
        encoder = EX.MobileNetV2Encoder()
    elif enc_type == "Cnn14TransformerEncoder":
        trm_args = enc_cfg.get("transformer", {}).get("args", {}) or {}
        encoder = EX.Cnn14TransformerEncoder(
            d_model=trm_args.get("d_model", 512),
            nlayers=trm_args.get("nlayers", 2),
            freeze_cnn=enc_args.get("freeze_cnn", False),
            freeze_cnn_bn=enc_args.get("freeze_cnn_bn", False),
            compute_dtype=compute_dtype)
        if enc_cfg.get("cnn", {}).get("pretrained"):
            pretrained.append(("encoder.cnn", enc_cfg["cnn"]["pretrained"],
                               "cnn14"))
    elif enc_type == "EfficientNetB2":
        encoder = EfficientNetB2(compute_dtype=compute_dtype)
        mel = EFFB2_MEL_16K
        if enc_cfg.get("pretrained"):
            pretrained.append(("encoder", enc_cfg["pretrained"], "effb2"))
    elif enc_type in ("MobileNetV3", "MobileNetV3Encoder"):
        from audiocaption_tpu_torch.models.mobilenet_v3 import (
            MobileNetV3Encoder)
        encoder = MobileNetV3Encoder(
            model_name=enc_args.get("model_name", "mn10"),
            pooling=enc_args.get("pooling", "mean_max_fc"),
            compute_dtype=compute_dtype)
    elif enc_type == "Htsat":
        from audiocaption_tpu_torch.models.htsat import HtsatEncoder
        encoder = HtsatEncoder()
        if enc_cfg.get("pretrained"):
            pretrained.append(("encoder", enc_cfg["pretrained"], "htsat"))
    elif enc_type in ("UiT", "UitEncoder") or enc_type.startswith("uit_"):
        from audiocaption_tpu_torch.models.uit import (
            UIT_MEL_16K, UIT_VARIANTS, UitEncoder)
        variant = enc_args.get("model_name", enc_type if
                               enc_type.startswith("uit_") else "uit_xs")
        encoder = UitEncoder(UIT_VARIANTS[variant](
            outputdim=enc_args.get("outputdim", 537),
            target_length=enc_args.get("target_length", 1008),
            classifier=False))
        mel = UIT_MEL_16K
        if enc_cfg.get("pretrained"):
            pretrained.append(("encoder", enc_cfg["pretrained"], "uit"))
    elif enc_type in ("ESResNeXtFBSP", "ESResNeXtFBSPEncoder"):
        from audiocaption_tpu_torch.models.resnext import (
            ESResNeXtFBSP, ESResNeXtFBSPEncoder)
        encoder = ESResNeXtFBSPEncoder(ESResNeXtFBSP(
            n_fft=enc_args.get("n_fft", 2048),
            hop_length=enc_args.get("hop_length", 561),
            win_length=enc_args.get("win_length", 1654),
            window=enc_args.get("window", "blackmanharris"),
            normalized=enc_args.get("normalized", True),
            num_classes=enc_args.get("num_classes", 527),
            apply_attention=enc_args.get("apply_attention", True),
            classifier=False))
        # its own frontend; the mel preset (unused) stays the 32 kHz one
        # whatever sample_rate says, as in the JAX builder
        input_mode, mel = "raw_wav", CNN14_MEL_32K
        if enc_cfg.get("pretrained"):
            pretrained.append(("encoder.fbsp_model", enc_cfg["pretrained"],
                               "esresnext"))
    elif enc_type == "RnnEncoder":
        encoder = RnnEncoder(
            in_dim, hidden_size=enc_args.get("hidden_size", 512),
            num_layers=enc_args.get("num_layers", 1),
            bidirectional=enc_args.get("bidirectional", False),
            dropout=enc_args.get("dropout", 0.2),
            pooling=enc_args.get("pooling", "mean"))
    elif enc_type in ("TransformerEncoder", "AudioTransformerEncoder"):
        encoder = EX.AudioTransformerEncoder(
            in_dim, d_model=enc_args.get("d_model", 512),
            nlayers=enc_args.get("nlayers", 2), nhead=enc_args.get("nhead"),
            dim_feedforward=enc_args.get("dim_feedforward"),
            dropout=enc_args.get("dropout", 0.2))
    elif enc_type == "M2TransformerEncoder":
        encoder = M2TransformerEncoder(
            in_dim, d_model=enc_args.get("d_model", 512),
            nlayers=enc_args.get("nlayers", 2), nhead=enc_args.get("nhead"),
            dim_feedforward=enc_args.get("dim_feedforward"),
            dropout=enc_args.get("dropout", 0.1),
            n_memory=enc_args.get("m", 40), compute_dtype=compute_dtype)
    else:
        raise ValueError(f"unsupported encoder type: {enc_type}")
    attn_width = getattr(encoder, "attn_emb_size", encoder.fc_emb_size)

    dec_cfg = model_cfg["decoder"]
    dec_type = short_type(dec_cfg["type"])
    dec_args = dict(dec_cfg.get("args", {}) or {})
    vocab = vocab_size or dec_args.get("vocab_size")
    if vocab is None:
        raise ValueError("the decoder needs a vocab_size (from the "
                         "tokenizer or the decoder's args)")
    if dec_type in ("TransformerDecoder", "EventTransformerDecoder",
                    "KeywordProbTransformerDecoder"):
        extra = {}
        if dec_type == "EventTransformerDecoder":
            extra["event_classes"] = dec_args.get("event_classes", 527)
        if dec_type == "KeywordProbTransformerDecoder":
            extra["keyword_classes_num"] = dec_args.get(
                "keyword_classes_num", 527)
        decoder = getattr(TD, dec_type)(
            emb_dim=dec_args.get("emb_dim", 256), vocab_size=vocab,
            attn_emb_dim=attn_width,
            nlayers=dec_args.get("nlayers", 2), nhead=dec_args.get("nhead"),
            dim_feedforward=dec_args.get("dim_feedforward"),
            tie_weights=dec_args.get("tie_weights", False),
            dropout=dec_args.get("dropout", 0.2),
            compute_dtype=compute_dtype, **extra)
    elif dec_type == "M2TransformerDecoder":
        if not isinstance(encoder, M2TransformerEncoder):
            raise ValueError("M2TransformerDecoder requires an "
                             "M2TransformerEncoder")
        decoder = M2TransformerDecoder(
            emb_dim=dec_args.get("attn_emb_dim", attn_width),
            vocab_size=vocab, nlayers=dec_args.get("nlayers", 2),
            nhead=dec_args.get("nhead"),
            dim_feedforward=dec_args.get("dim_feedforward"),
            dropout=dec_args.get("dropout", 0.1),
            n_enc_levels=encoder.nlayers, compute_dtype=compute_dtype)
    elif dec_type in RNN_DECODERS:
        decoder = getattr(rnn_decoder, dec_type)(
            emb_dim=dec_args.get("emb_dim", 512), vocab_size=vocab,
            fc_emb_dim=encoder.fc_emb_size, attn_emb_dim=attn_width,
            d_model=dec_args.get("d_model", 512),
            dropout=dec_args.get("dropout", 0.5),
            num_layers=dec_args.get("num_layers", 1))
    else:
        raise ValueError(f"unsupported decoder type: {dec_type}")
    if dec_cfg.get("pretrained"):
        pretrained.append(("decoder", dec_cfg["pretrained"], "decoder"))

    model_type = short_type(model_cfg.get("type", "TransformerModel"))
    if model_type in ("StyleCaptionModel", "StyleSeq2SeqAttnModel"):
        from audiocaption_tpu_torch.models.style import (
            StyleBank, StyleCaptioner, TextRefEncoder)
        style_args = dict((model_cfg.get("style") or {}).get("args") or {})
        emb_dim = decoder.emb_dim
        ref_d = style_args.get("ref_d_model", emb_dim)
        model = StyleCaptioner(
            encoder=encoder, decoder=decoder, mel=mel,
            special=SpecialTokens(), input_mode=input_mode,
            ref_encoder=TextRefEncoder(
                vocab, d_model=ref_d,
                nlayers=style_args.get("ref_nlayers", 2),
                dropout=style_args.get("ref_dropout", 0.2)),
            style_bank=StyleBank(style_args.get("n_styles", 4), emb_dim,
                                 query_dim=ref_d))
        return model, pretrained
    model = Captioner(encoder=encoder, decoder=decoder, mel=mel,
                      special=SpecialTokens(), input_mode=input_mode)
    return model, pretrained


def feature_input_dim(model_cfg: Dict, dataset) -> Optional[int]:
    """The input width a feature encoder of ``model_cfg`` takes when the
    config gives no ``encoder.args.input_dim``: the last dimension of the
    dataset's first row; None for any other encoder, or when the config
    gives it."""
    if short_type(model_cfg.get("type", "")) == "ScstWrapper":
        model_cfg = model_cfg["model"]
    enc = model_cfg["encoder"]
    if short_type(enc["type"]) not in FEATURE_ENCODERS or \
            (enc.get("args") or {}).get("input_dim") is not None:
        return None
    return int(np.shape(dataset.get_audio(dataset.audio_ids[0]))[-1])


def apply_pruning(model, model_cfg: Dict) -> bool:
    """Prune ``model``'s EffB2 encoder in place when ``model_cfg``'s
    ``encoder.args.prune_ratio`` asks for it (``models/effb2.py::
    build_pruned_effb2`` with ``prune_start_layer``, ``prune_se``,
    ``prune_method`` and ``prune_head``, the JAX runner's defaults 0,
    True, "operator_norm", False); returns whether it did.  The pruned
    encoder is left in ``train()`` mode if the model was."""
    from audiocaption_tpu_torch.models.effb2 import (
        EfficientNetB2, build_pruned_effb2)
    if short_type(model_cfg.get("type", "")) == "ScstWrapper":
        model_cfg = model_cfg["model"]
    args = model_cfg["encoder"].get("args") or {}
    if not args.get("prune_ratio"):
        return False
    if not isinstance(model.encoder, EfficientNetB2):
        raise ValueError("prune_ratio is only supported for EfficientNetB2")
    mode = model.encoder.training
    model.encoder = build_pruned_effb2(
        model.encoder, args["prune_ratio"],
        prune_start_layer=args.get("prune_start_layer", 0),
        prune_se=args.get("prune_se", True),
        method=args.get("prune_method", "operator_norm"),
        prune_head=args.get("prune_head", False)).train(mode)
    return True
