"""The item-8 encoders wired through the port's entry points, on the CPU:
the builder (``utils/config.py::build_model_from_config``), the
pretrained loader (``cli/run.py::load_pretrained``), the checkpoint
reader, ``cli/prepare_features.py`` and the ``encoders`` recipe
(``cli/recipes.py``).

  * the builder: each encoder type the JAX builder takes at
    ``utils/config.py:138-220`` (``MobileNetV3`` / ``MobileNetV3Encoder``,
    ``Htsat``, ``UiT`` / ``UitEncoder`` / ``uit_*``, ``ESResNeXtFBSP`` /
    ``ESResNeXtFBSPEncoder``) built by both builders from the same dicts:
    the same mel preset, ``input_mode``, output widths, parameter count
    (flax shapes by ``jax.eval_shape``) and pretrained specs (path and
    kind; the JAX builder writes paths with "/", the port with ".");
  * the loader: a reference-key file of each new kind (``htsat``,
    ``uit``, ``esresnext``) loads into the port's captioner what the JAX
    ``load_pretrained_into`` loads into its variables for the same file:
    every tensor equal after the load (UiT's time position table of
    another length skipped by shape in both);
  * ``prepare_features``: the helpers that run both tools on the same
    clips and checkpoint (``prepare_features_pair``, ``check_prepared``),
    which ``test_torch_prepare_features.py`` (htsat) and
    ``test_torch_panns_classifiers.py`` (the classifiers) call;
  * the checkpoint reader: a JAX experiment's variables of a UiT
    captioner convert (``jax_variables_to_reference``) into the port
    model's tensors, which then encode as JAX does;
  * the ``encoders`` recipe: ``configs/synthetic/cnn14rnn_trm.yaml`` with
    ``model.encoder`` replaced by each new encoder's node, the rest kept.

The helpers serve the other item-8 test files: ``random_variables``
(flax shapes filled from a numpy seed, no flax init, which runs eagerly
and takes ~40 s a model on the CPU), ``item8_captioner_pair`` (a JAX
captioner and the port's on the same weights: a given encoder and a
1-layer transformer decoder at emb 32), ``xe_step_of`` /
``check_xe_step`` (one XE step in both packages and the floors of
``test_torch_train_step``)."""

import copy
import dataclasses

import flax.linen as fnn
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from audiocaption_tpu.decoding.engine import SpecialTokens as JSpecial
from audiocaption_tpu.losses.loss import masked_token_loss as j_loss
from audiocaption_tpu.models.captioner import Captioner as JCaptioner
from audiocaption_tpu.models.transformer_decoder import (
    TransformerDecoder as JDecoder)
from audiocaption_tpu.optim.schedules import (
    exponential_decay_with_warmup as j_schedule)
from audiocaption_tpu.training.trainer import (
    create_train_state as j_create_state, make_optimizer as j_optimizer,
    make_train_step)
from audiocaption_tpu.utils.config import (
    build_model_from_config as j_build)

from audiocaption_tpu_torch.decoding.engine import SpecialTokens
from audiocaption_tpu_torch.losses.loss import masked_token_loss
from audiocaption_tpu_torch.models.captioner import Captioner
from audiocaption_tpu_torch.models.convert import (
    captioner_state_dict_from_jax, load_reference_state_dict)
from audiocaption_tpu_torch.models.transformer_decoder import (
    TransformerDecoder)
from audiocaption_tpu_torch.optim.schedules import (
    exponential_decay_with_warmup)
from audiocaption_tpu_torch.training.trainer import (
    create_train_state, train_step)
from audiocaption_tpu_torch.utils.config import build_model_from_config

from test_torch_family import (
    LR, FINAL, TOTAL, WD, CLIP, _counts as family_counts, clips, jax_batch)
from test_torch_train_step import (
    MISS_SHARE, PARAM_ATOL, _adam_state, _moment_tol, _report_close)

torch.set_num_threads(2)
V = 40


def random_variables(jmod, *args, seed: int = 0, init_kw=None) -> dict:
    """{"params", "batch_stats"} of ``jmod`` applied to ``args``, shapes by
    ``jax.eval_shape`` and values from ``numpy.random.RandomState(seed)``:
    a kernel N(0, 1 / fan_in), a bias N(0, 0.1^2), a norm's scale 1 +
    N(0, 0.1^2), a BN mean N(0, 0.1^2) and variance 1 + |N(0, 0.25)|,
    any other parameter N(0, 0.1^2)."""
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *args,
                                              **(init_kw or {})))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = getattr(path[-1], "key", "")
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            x = rng.randn(*shape) / np.sqrt(fan_in)
        elif name == "scale":
            x = 1.0 + 0.1 * rng.randn(*shape)
        elif name == "var":
            x = 1.0 + np.abs(0.5 * rng.randn(*shape))
        else:
            x = 0.1 * rng.randn(*shape)
        return x.astype(np.float32)
    out = jax.tree_util.tree_map_with_path(fill, shapes)
    return {"params": out["params"],
            "batch_stats": out.get("batch_stats", {})}


def no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, fnn.Dropout) and \
            context.method_name == "__call__":
        return args[0]
    return next_fun(*args, **kwargs)


def batch_statistics(jmodel, v, jb) -> dict:
    """Every BN's statistics set to those of one train-mode pass of
    ``jmodel`` over the batch ``jb`` (dropout off), whatever each BN's
    momentum m: two passes, from running statistics 0 and 1, give new = m
    * old + (1 - m) * batch, so m = new_1 - new_0 and batch = new_0 /
    (1 - m)."""
    @jax.jit
    def calib(v_):
        with fnn.intercept_methods(no_dropout):
            _, upd = jmodel.apply(v_, jb["wav"], jb["wav_len"], jb["cap"],
                                  jb["cap_len"], train=True,
                                  mutable=["batch_stats"],
                                  rngs={"sample": jax.random.PRNGKey(2),
                                        "dropout": jax.random.PRNGKey(3)})
        return upd["batch_stats"]

    def run(fill):
        return jax.device_get(calib({
            "params": v["params"], "batch_stats": jax.tree_util.tree_map(
                lambda a: np.full_like(a, fill), v["batch_stats"])}))
    new0, new1 = run(0.0), run(1.0)
    return jax.tree_util.tree_map(
        lambda a0, a1: (np.asarray(a0) / (1.0 - (np.asarray(a1) -
                                                 np.asarray(a0)))
                        ).astype(np.float32), new0, new1)


def item8_captioner_pair(jenc, tenc, jmel, mel, input_mode="mel", seed=0,
                         b=None, prepare=None):
    """A JAX captioner (encoder ``jenc``, a 1-layer decoder at emb 32, 2
    heads, mel preset ``jmel``) and the port's (``tenc``, ``mel``) on the
    same weights (``prepare`` applied to the drawn variables, then every
    BN's statistics those of the batch: :func:`batch_statistics`), both
    taking ``input_mode``; -> (JAX model,
    its variables, the port model in ``eval()``, the batch ``b``: 3 clips
    of at most 1 s by default)."""
    b = b or clips(seed=seed, B=3, Lc=8)
    jmodel = JCaptioner(encoder=jenc,
                        decoder=JDecoder(emb_dim=32, vocab_size=V,
                                         attn_emb_dim=0, nlayers=1, nhead=2,
                                         dropout=0.2),
                        mel=jmel, special=JSpecial(), input_mode=input_mode)
    jb = jax_batch(b)
    v = random_variables(jmodel, jb["wav"], jb["wav_len"], jb["cap"],
                         jb["cap_len"], seed=seed,
                         init_kw={"train": False})
    if prepare is not None:
        v = prepare(v)
    v["batch_stats"] = batch_statistics(jmodel, v, jb)
    port = Captioner(tenc, TransformerDecoder(
        emb_dim=32, vocab_size=V, attn_emb_dim=getattr(
            tenc, "attn_emb_size", tenc.fc_emb_size), nlayers=1, nhead=2,
        dropout=0.2), mel, SpecialTokens(), input_mode=input_mode)
    load_reference_state_dict(port, captioner_state_dict_from_jax(v))
    return jmodel, v, port.eval(), b


def port_step_of(port, b, dtype=torch.float32) -> dict:
    """One XE step of the port's captioner on ``b`` (wave in ``dtype``;
    dropout the identity) -> its metrics, parameters, Adam moments and BN
    statistics (numpy, by the port's names)."""
    warm = TOTAL // 5
    state = create_train_state(
        port, LR, exponential_decay_with_warmup(LR, FINAL, TOTAL, warm),
        WD, CLIP)
    port.train()
    batch = {k: torch.from_numpy(a) for k, a in b.items()}
    batch["wav"] = batch["wav"].to(dtype)
    dropout = F.dropout
    F.dropout = lambda t, p=0.5, training=True, inplace=False: t
    try:
        m = train_step(state, masked_token_loss("label_smoothing", 0.1),
                       batch, ss_ratio=torch.tensor(1.0),
                       generator=torch.Generator())
    finally:
        F.dropout = dropout
    named = dict(port.named_parameters())
    ost = state.optimizer.state

    def np_(t):
        return t.detach().numpy().astype(np.float64)
    return dict(
        m=m, params={n: np_(p) for n, p in named.items()},
        mu={n: np_(ost[p]["exp_avg"]) for n, p in named.items()},
        nu={n: np_(ost[p]["exp_avg_sq"]) for n, p in named.items()},
        stats={"encoder." + k: np_(a)
               for k, a in port.encoder.state_dict().items()
               if k.endswith(("running_mean", "running_var"))})


def xe_step_of(jmodel, jvars, port, b):
    """One XE step in both packages -> what the checks read (the
    ``test_torch_family`` XE step, teacher coins: ss_ratio 1.0 through
    the scheduled-sampling path): the port's (:func:`port_step_of`) and
    JAX's as ``j``, ``j_params``, ``j_mu``, ``j_nu``, ``j_stats``."""
    warm = TOTAL // 5
    tx = j_optimizer(LR, j_schedule(LR, FINAL, TOTAL, warm), WD, CLIP)
    jstate = j_create_state(jvars, tx, jax.random.PRNGKey(0))
    jstep = make_train_step(jmodel, j_loss("label_smoothing", 0.1), tx,
                            donate=False, use_ss=True)
    with fnn.intercept_methods(no_dropout):
        jstate, jm = jstep(jstate, jax_batch(b), jnp.float32(1.0))
    jm = jax.device_get(jm)
    s = port_step_of(port, b)
    j_params = jax.device_get(jstate.params)
    j_stats = jax.device_get(jstate.batch_stats)
    adam = _adam_state(jax.device_get(jstate.opt_state))

    def space(tree):
        tree = jax.tree_util.tree_map(
            lambda t, p: np.zeros(np.shape(p), np.float32)
            if isinstance(t, optax.MaskedNode) else np.asarray(t),
            tree, j_params, is_leaf=lambda x: isinstance(x, optax.MaskedNode))
        return {k: t.numpy() for k, t in captioner_state_dict_from_jax(
            {"params": tree, "batch_stats": j_stats}).items()}
    want, mu, nu = space(j_params), space(adam.mu), space(adam.nu)
    named = s["params"]
    s.update(j=jm, j_params={n: want[n] for n in named},
             j_mu={n: mu[n] for n in named}, j_nu={n: nu[n] for n in named},
             j_stats={k: a for k, a in want.items()
                      if k.endswith(("running_mean", "running_var"))})
    return s


def check_xe_step(s):
    """The port's step against JAX's by ``test_torch_train_step``'s
    floors."""
    assert not s["m"]["skipped"] and not bool(s["j"]["skipped"])
    np.testing.assert_allclose(float(s["m"]["loss"]), float(s["j"]["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(s["m"]["grad_norm"]),
                               float(s["j"]["grad_norm"]), rtol=1e-4)
    _report_close(s["params"], s["j_params"], PARAM_ATOL, "parameters",
                  MISS_SHARE)
    _report_close(s["mu"], s["j_mu"], _moment_tol(s["j_mu"]), "Adam mu")
    _report_close(s["nu"], s["j_nu"], _moment_tol(s["j_nu"]), "Adam nu")
    assert s["stats"] and set(s["stats"]) <= set(s["j_stats"])
    _report_close(s["stats"], {k: s["j_stats"][k] for k in s["stats"]},
                  lambda w: PARAM_ATOL * max(1.0, np.abs(w).max()),
                  "BN stats")




# ---------------------------------------------------------- builder --

DECODER = {"type": "TransformerDecoder", "args": {"emb_dim": 64,
                                                  "nlayers": 1}}
NODES = {
    "MobileNetV3": {"type": "MobileNetV3",
                    "args": {"model_name": "mn04", "pooling": "mean"}},
    "MobileNetV3Encoder": {
        "type": "captioning.models.eff_at_encoder.MobileNetV3Encoder",
        "args": {}},
    "Htsat": {"type": "captioning.models.htsat.Htsat",
              "args": {"sample_rate": 32000}},
    "Htsat_16k": {"type": "Htsat", "args": {"sample_rate": 16000}},
    "UiT": {"type": "UiT", "args": {}},
    "uit_xxs": {"type": "uit_xxs", "args": {"target_length": 512}},
    "UitEncoder": {"type": "UitEncoder",
                   "args": {"model_name": "audio_transformer_h128_d4_m3",
                            "outputdim": 527}},
    "ESResNeXtFBSP": {"type": "ESResNeXtFBSP",
                      "args": {"sample_rate": 44100}},
    "ESResNeXtFBSPEncoder": {
        "type": "ESResNeXtFBSPEncoder",
        "args": {"n_fft": 1024, "hop_length": 256, "win_length": 1024,
                 "window": "hann", "apply_attention": False}},
}


def model_node(name, pretrained=None):
    enc = copy.deepcopy(NODES[name])
    if pretrained:
        enc["pretrained"] = pretrained
    return {"type": "TransformerModel", "encoder": enc,
            "decoder": copy.deepcopy(DECODER)}


@pytest.mark.parametrize("name", list(NODES))
def test_builder_matches_jax(name):
    node = model_node(name, pretrained="weights.pth")
    n_jax, n_port, jmodel, port = family_counts(node)
    assert n_port == n_jax
    assert dataclasses.asdict(port.mel) == dataclasses.asdict(jmodel.mel)
    assert port.input_mode == jmodel.input_mode
    b = jax_batch(clips(B=2))
    out = jax.eval_shape(lambda: jmodel.apply(
        jmodel.init({"params": jax.random.PRNGKey(0),
                     "sample": jax.random.PRNGKey(1)}, b["wav"],
                    b["wav_len"], b["cap"], b["cap_len"], train=False),
        b["wav"], b["wav_len"], method=JCaptioner.encode))
    enc = port.encoder
    assert out["attn_emb"].shape[-1] == getattr(enc, "attn_emb_size",
                                                enc.fc_emb_size)
    assert out["fc_emb"].shape[-1] == enc.fc_emb_size
    assert port.decoder.attn_proj[0].in_features == out["attn_emb"].shape[-1]
    _, j_specs = j_build(node, vocab_size=V)
    _, specs = build_model_from_config(node, vocab_size=V)
    assert specs == [(path.replace("/", "."), ckpt, kind)
                     for path, ckpt, kind in j_specs]


def test_builder_names_what_still_raises():
    """The conditioned transformer decoders build (item 8b is ported); an
    unknown encoder type still raises."""
    node = model_node("MobileNetV3")
    node["decoder"]["type"] = "EventTransformerDecoder"
    model, _ = build_model_from_config(node, vocab_size=V)
    assert type(model.decoder).__name__ == "EventTransformerDecoder"
    node = model_node("MobileNetV3")
    node["encoder"]["type"] = "NoSuchEncoder"
    with pytest.raises(ValueError, match="unsupported encoder"):
        build_model_from_config(node, vocab_size=V)


# ----------------------------------------------------------- loader --

def reference_file(tmp_path, module, seed, rename=None) -> tuple:
    """A reference-key checkpoint of ``module``'s shapes (torch.save of a
    plain state dict drawn from ``seed``; ``rename`` maps a key to the
    file's or None to leave it out) -> (path, the dict as numpy)."""
    rng = np.random.RandomState(seed)
    sd = {}
    for k, t in module.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        a = (rng.rand(*t.shape) + 0.5 if k.endswith("running_var")
             else rng.randn(*t.shape)).astype(np.float32)
        k = rename(k) if rename else k
        if k is not None:
            sd[k] = a
    path = tmp_path / f"ref_{seed}.pth"
    torch.save({k: torch.from_numpy(a) for k, a in sd.items()}, path)
    return str(path), sd


LOADER_CASES = {
    # kind: (encoder node, the file's module, its keys' prefix in the port)
    "htsat": ("Htsat", lambda: __import__(
        "audiocaption_tpu_torch.models.htsat", fromlist=["x"]).HtsatEncoder(),
        "encoder."),
    "uit": ("UiT", lambda: __import__(
        "audiocaption_tpu_torch.models.uit", fromlist=["x"]).UIT_VARIANTS[
        "uit_xs"](outputdim=537, target_length=102), "encoder.trunk."),
    "esresnext": ("ESResNeXtFBSP", lambda: __import__(
        "audiocaption_tpu_torch.models.resnext", fromlist=["x"]
    ).ESResNeXtFBSP(n_fft=2048, hop_length=561, win_length=1654,
                    window="blackmanharris", normalized=True,
                    apply_attention=True, num_classes=527),
        "encoder.fbsp_model."),
}


@pytest.mark.parametrize("kind", list(LOADER_CASES))
def test_loader_kind_loads_what_jax_loads(kind, tmp_path):
    """The file (reference keys; UiT's zenodo sizes, its time position
    table 6 patches long against the builder's 63) into both packages'
    models: every tensor JAX's ``load_pretrained_into`` filled is the
    file's in the port too, and every tensor it kept (a table of another
    shape) the port kept as well."""
    from audiocaption_tpu.utils.config import load_pretrained_into
    from audiocaption_tpu_torch.cli.run import load_pretrained
    from audiocaption_tpu_torch.models.zoo import random_init
    name, module, prefix = LOADER_CASES[kind]
    path, sd = reference_file(tmp_path, module(), 3)
    node = model_node(name, pretrained=path)
    jmodel, j_specs = j_build(node, vocab_size=V)
    b = jax_batch(clips(B=2))
    v = random_variables(jmodel, b["wav"], b["wav_len"], b["cap"],
                         b["cap_len"], init_kw={"train": False})
    (j_spec,) = j_specs
    assert j_spec[2] == kind
    loaded = load_pretrained_into(v, j_spec)
    j_before = captioner_state_dict_from_jax(v)
    j_after = captioner_state_dict_from_jax(loaded)
    port, (spec,) = build_model_from_config(node, vocab_size=V)
    random_init(port, torch.Generator().manual_seed(0))
    before = {k: t.clone() for k, t in port.state_dict().items()}
    n = load_pretrained(port, spec)
    after = port.state_dict()
    filled = kept = 0
    for k, t in j_after.items():
        if not k.startswith("encoder.") or k.endswith("num_batches_tracked"):
            continue
        if not np.array_equal(t.numpy(), j_before[k].numpy()):
            np.testing.assert_array_equal(
                after[k].numpy(), sd[k[len(prefix):]], err_msg=k)
            filled += 1
        else:
            np.testing.assert_array_equal(after[k].numpy(),
                                          before[k].numpy(), err_msg=k)
            kept += 1
    assert filled == n > 0
    if kind == "uit":
        assert kept == 1       # the time position table
        assert np.array_equal(after["encoder.trunk.time_pos_embed"].numpy(),
                              before["encoder.trunk.time_pos_embed"].numpy())


# ------------------------------------------------- prepare_features --

def prepare_features_pair(root, encoder, module, seed=0):
    """``prepare_features --encoder {encoder} --checkpoint`` in both
    packages on 3 clips of 0.5 to 1 s (an h5 corpus at 32 kHz, batches of
    2): the checkpoint is ``module``'s state dict (its weights drawn from
    ``seed``, ``bn0``'s statistics those of a dB log-mel) -> {name: (JAX's
    rows, the port's rows)} for ``fc``, ``attn`` and, where written,
    ``probs``, each a dict audio_id -> array."""
    import csv
    import h5py
    from audiocaption_tpu.cli import prepare_features as JPF
    from audiocaption_tpu_torch.cli import prepare_features as TPF
    from audiocaption_tpu_torch.models.zoo import random_init
    sr = 32000
    rng = np.random.RandomState(seed)
    ids = [f"clip{i}" for i in range(3)]
    with h5py.File(root / "wav.h5", "w") as f:
        for i, aid in enumerate(ids):
            n = int(sr * (0.5 + 0.25 * i))
            t = np.arange(n) / sr
            f[aid] = (0.3 * np.sin(2 * np.pi * 330 * (i + 1) * t)
                      + 0.05 * rng.randn(n)).astype(np.float32)
    with open(root / "wav.csv", "w", newline="") as f:
        w = csv.writer(f, delimiter="\t")
        w.writerow(["audio_id", "hdf5_path"])
        w.writerows((aid, str(root / "wav.h5")) for aid in ids)
    random_init(module, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        module.bn0.running_mean.fill_(-40.0)
        module.bn0.running_var.fill_(400.0)
    torch.save(module.state_dict(), root / "ckpt.pth")
    common = ["--wav_csv", str(root / "wav.csv"), "--batch_size", "2",
              "--encoder", encoder, "--checkpoint", str(root / "ckpt.pth")]
    JPF.main(common + ["--output_dir", str(root / "jax")])
    TPF.main(common + ["--output_dir", str(root / "port"), "--device",
                       "cpu"])
    out = {}
    for name in ("fc", "attn", "probs"):
        rows = []
        for who in ("jax", "port"):
            path = root / who / f"{name}.h5"
            if path.exists():
                with h5py.File(path, "r") as f:
                    rows.append({k: np.asarray(f[k]) for k in f})
        if rows:
            assert len(rows) == 2, name
            out[name] = tuple(rows)
    return out


def check_prepared(out, tol=1e-4):
    """Both tools wrote the same ids, rows of the same shapes (attn cut to
    each clip's length) and values within ``tol`` relative."""
    for name, (want, got) in out.items():
        assert set(got) == set(want) and len(want) == 3, name
        for aid, w in want.items():
            assert got[aid].shape == w.shape, (name, aid)
            err = np.abs(got[aid].astype(np.float64) - w).max()
            assert err <= tol * max(1.0, np.abs(w).max()), (name, aid, err)
    lens = [out["attn"][1][f"clip{i}"].shape[0] for i in range(3)]
    assert lens == sorted(lens) and lens[0] < lens[-1]


# ----------------------------------------------------------- recipe --

@pytest.mark.parametrize("name", ["htsat", "mobilenet_v3", "uit_xs",
                                  "esresnext"])
def test_encoders_recipe(name):
    """``cnn14rnn_trm.yaml`` with the encoder node replaced, the rest as
    the recipe's; the port builds it (vocab 30) with the decoder's memory
    width the encoder's."""
    from audiocaption_tpu_torch.cli import recipes
    base = recipes.recipe("synthetic/cnn14rnn_trm.yaml", "/d")
    cfg = recipes.encoders_train("/d", name)
    assert cfg["model"]["encoder"] == recipes.ENCODER_NODES[name]
    assert cfg["model"]["decoder"] == base["model"]["decoder"]
    assert {k: v for k, v in cfg.items() if k not in ("model", "data",
                                                     "experiment_path")} \
        == {k: v for k, v in base.items() if k not in ("model", "data",
                                                      "experiment_path")}
    assert cfg["experiment_path"] == f"experiments/synthetic/{name}_trm/"
    sr = 16000 if name == "uit_xs" else 32000
    for split in ("train", "val"):
        assert cfg["data"][split]["dataset"]["args"]["target_sr"] == sr
        assert cfg["data"][split]["dataset"]["args"]["features"][
            "wav"].startswith("/d/")
    test = recipes.encoders_test("/d", name)
    assert test["data"]["test"]["dataset"]["args"]["target_sr"] == sr
    model, _ = build_model_from_config(cfg["model"], vocab_size=30)
    assert model.mel.sample_rate == sr or name == "esresnext"
    assert model.decoder.attn_proj[0].in_features == getattr(
        model.encoder, "attn_emb_size", model.encoder.fc_emb_size)


def test_jax_checkpoint_of_an_item8_captioner_loads():
    """A JAX experiment's variables of an item-8 captioner (a small UiT
    encoder, a transformer decoder) convert through the checkpoint
    reader's dispatch (``training/checkpoint.py::
    jax_variables_to_reference``) into exactly the port model's tensors,
    and the port then encodes as JAX does (within 1e-4 relative)."""
    from audiocaption_tpu.models import uit as JU
    from audiocaption_tpu_torch.models import uit as TU
    from audiocaption_tpu_torch.training.checkpoint import (
        jax_variables_to_reference)
    kw = dict(embed_dim=32, depth=1, num_heads=2, target_length=48)
    jmodel, v, port, b = item8_captioner_pair(
        JU.UitEncoder(trunk=JU.UITBase(**kw)),
        TU.UitEncoder(TU.UITBase(**kw, classifier=False)),
        JU.UIT_MEL_16K, TU.UIT_MEL_16K, seed=9)
    sd = jax_variables_to_reference(v)
    own = port.state_dict()
    assert set(own) - set(sd) <= {"decoder.pos_encoder.pe"}
    for k, t in own.items():
        if k in sd:
            np.testing.assert_array_equal(np.asarray(sd[k]), t.numpy(), k)
    want = jax.device_get(jax.jit(lambda v_, w, n: jmodel.apply(
        v_, w, n, method=JCaptioner.encode))(
            v, jnp.asarray(b["wav"]), jnp.asarray(b["wav_len"])))
    with torch.no_grad():
        got = port.encode(torch.from_numpy(b["wav"]),
                          torch.from_numpy(b["wav_len"]))
    for k in ("attn_emb", "fc_emb"):
        err = np.abs(got[k].numpy() - want[k]).max()
        assert err <= 1e-4 * max(1.0, np.abs(want[k]).max()), k
