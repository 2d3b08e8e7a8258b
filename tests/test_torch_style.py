"""The style captioner (``models/style.py``: ``TextRefEncoder``,
``StyleBank``, ``StyleCaptioner``) and ``captioner.sequence_embedding``
of the port against the JAX package, on the CPU.

  * ``TextRefEncoder`` (d_model 32, 2 layers) and ``StyleBank`` (4
    styles) alone, weights from a numpy seed: the CLS embedding,
    ``from_reference`` and ``from_weight`` within 1e-5;
  * a ``StyleCaptionModel`` (``Cnn6Encoder``, ``StyleBahAttnDecoder`` at
    emb and d_model 32) built from one config dict in both packages
    (``test_torch_family.jax_pair``): the converted tree is exactly the
    port's key space (``ref_encoder.*`` and ``style_bank.*`` beside
    ``encoder.*`` / ``decoder.*``), a JAX checkpoint's variables load
    through ``jax_variables_to_reference`` and a port checkpoint's round
    trip; the training forward (the style inferred from each caption,
    teacher forcing, ``eval()``) within 1e-5 of JAX's logits, and
    ``sequence_embedding`` of it within 1e-5; ``style_of_weight`` then a
    greedy decode with each one-hot style gives JAX's tokens;
  * the builder: ``StyleCaptionModel`` and ``StyleSeq2SeqAttnModel`` with
    the ``style.args`` defaults and with given ones, the same parameter
    shapes as the JAX builder's (``jax.eval_shape``).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocaption_tpu.models.captioner import (
    generate as j_generate, sequence_embedding as j_seq_emb)
from audiocaption_tpu.models.style import (
    StyleBank as JBank, StyleCaptioner as JStyleCaptioner,
    TextRefEncoder as JRef)
from audiocaption_tpu.utils.config import (
    build_model_from_config as j_build)

from audiocaption_tpu_torch.models.captioner import (
    generate, sequence_embedding)
from audiocaption_tpu_torch.models.convert import (
    captioner_state_dict_from_jax, jax_tree_state_dict,
    load_reference_state_dict)
from audiocaption_tpu_torch.models.style import (
    StyleBank, StyleCaptioner, TextRefEncoder)
from audiocaption_tpu_torch.training.checkpoint import (
    jax_variables_to_reference, model_variables)
from audiocaption_tpu_torch.utils.config import build_model_from_config

from test_torch_family import V, clips, jax_batch, jax_pair
from test_torch_item8_wiring import random_variables

torch.set_num_threads(2)
D, N_STYLES = 32, 4


def _tensors(sd):
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def caps(seed: int = 2, B: int = 4, L: int = 7):
    rng = np.random.RandomState(seed)
    cap = rng.randint(3, V, (B, L)).astype(np.int32)
    cap_len = np.asarray([L, 3, 5, 1][:B], np.int32)
    for i, n in enumerate(cap_len):
        cap[i, n:] = 0
    return cap, cap_len


def test_text_ref_encoder_matches_jax():
    cap, cap_len = caps()
    jref = JRef(vocab_size=V, d_model=D, nlayers=2, dropout=0.2)
    v = random_variables(jref, jnp.asarray(cap), jnp.asarray(cap_len),
                         seed=3)
    want = np.asarray(jref.apply(v, jnp.asarray(cap), jnp.asarray(cap_len)))
    ref = TextRefEncoder(V, d_model=D, nlayers=2, dropout=0.2).eval()
    ref.load_state_dict(_tensors(jax_tree_state_dict(v["params"])))
    with torch.no_grad():
        got = ref(torch.from_numpy(cap).long(),
                  torch.from_numpy(cap_len).long())
    assert got.shape == (4, D)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # the words past cap_len are masked out
    cap2 = cap.copy()
    cap2[1, 3:] = 7
    with torch.no_grad():
        again = ref(torch.from_numpy(cap2).long(),
                    torch.from_numpy(cap_len).long())
    np.testing.assert_allclose(again.numpy(), got.numpy(), atol=1e-6)


def test_style_bank_matches_jax():
    rng = np.random.RandomState(4)
    ref_emb = rng.randn(5, 24).astype(np.float32)
    weight = rng.rand(5, N_STYLES).astype(np.float32)
    jbank = JBank(n_styles=N_STYLES, style_dim=D)
    v = random_variables(jbank, jnp.asarray(ref_emb), seed=5)
    v["params"]["styles"] = v["params"]["styles"] * 10.0   # peaked scores
    bank = StyleBank(N_STYLES, D, query_dim=24)
    bank.load_state_dict(_tensors(jax_tree_state_dict(v["params"])))
    want_ref = np.asarray(jbank.apply(v, jnp.asarray(ref_emb),
                                      method=JBank.from_reference))
    want_w = np.asarray(jbank.apply(v, jnp.asarray(weight),
                                    method=JBank.from_weight))
    with torch.no_grad():
        got_ref = bank.from_reference(torch.from_numpy(ref_emb))
        got_w = bank.from_weight(torch.from_numpy(weight))
        assert torch.equal(bank(torch.from_numpy(ref_emb)), got_ref)
    np.testing.assert_allclose(got_ref.numpy(), want_ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_w.numpy(), want_w, atol=1e-5, rtol=0)


def style_node(model_type: str = "StyleCaptionModel", style_args=None):
    node = {"type": f"captioning.models.style_model.{model_type}",
            "encoder": {"type": "captioning.models.cnn_encoder.Cnn6Encoder",
                        "args": {"sample_rate": 32000}},
            "decoder": {"type": "captioning.models.rnn_decoder."
                                "StyleBahAttnDecoder",
                        "args": {"emb_dim": D, "d_model": D,
                                 "num_layers": 1, "dropout": 0.0}}}
    if style_args is not None:
        node["style"] = {"args": style_args}
    return node


@pytest.fixture(scope="module")
def style_pair():
    b = clips(seed=3, B=4, Lc=7)
    jmodel, jvars, port = jax_pair(style_node(), b, seed=1)
    # a peaked bank: the styles move the decode
    jvars["params"]["style_bank"] = dict(jvars["params"]["style_bank"])
    jvars["params"]["style_bank"]["styles"] = np.asarray(
        jvars["params"]["style_bank"]["styles"]) * 100.0
    load_reference_state_dict(port, captioner_state_dict_from_jax(jvars))
    return jmodel, jvars, port.eval(), b


def test_converted_keys_and_checkpoints(style_pair, tmp_path):
    jmodel, jvars, port, _ = style_pair
    assert isinstance(port, StyleCaptioner)
    assert isinstance(jmodel, JStyleCaptioner)
    got = set(captioner_state_dict_from_jax(jvars))
    want = set(model_variables(port))
    assert got == want, (sorted(got - want), sorted(want - got))
    assert any(k.startswith("ref_encoder.") for k in want)
    assert {"style_bank.styles", "style_bank.query_proj.weight"} <= want
    # a JAX checkpoint's tree, as the runner reads it
    ref = jax_variables_to_reference(jax.tree_util.tree_map(np.asarray,
                                                            jvars))
    assert set(ref) == want
    other, _ = build_model_from_config(style_node(), vocab_size=V)
    load_reference_state_dict(other, ref)
    for k, a in model_variables(other).items():
        np.testing.assert_array_equal(a, model_variables(port)[k])


def test_training_forward_and_sequence_embedding_match_jax(style_pair):
    jmodel, jvars, port, b = style_pair
    jb = jax_batch(b)
    jout = jmodel.apply(jvars, jb["wav"], jb["wav_len"], jb["cap"],
                        jb["cap_len"], ss_ratio=1.0, train=False,
                        rngs={"sample": jax.random.PRNGKey(0)})
    with torch.no_grad():
        out = port(torch.from_numpy(b["wav"]), torch.from_numpy(b["wav_len"]),
                   torch.from_numpy(b["cap"]), torch.from_numpy(b["cap_len"]))
        seq = sequence_embedding(out, torch.from_numpy(b["cap_len"]))
    np.testing.assert_allclose(out["logit"].numpy(), np.asarray(jout["logit"]),
                               atol=1e-5, rtol=0)
    want = np.asarray(j_seq_emb(jout, jb["cap_len"]))
    assert seq.shape == (4, D)
    np.testing.assert_allclose(seq.numpy(), want, atol=1e-5, rtol=0)
    # the inferred style reaches the logits: a given style moves them
    with torch.no_grad():
        fixed = port(torch.from_numpy(b["wav"]),
                     torch.from_numpy(b["wav_len"]),
                     torch.from_numpy(b["cap"]),
                     torch.from_numpy(b["cap_len"]),
                     cond_kwargs={"style": port.style_of_weight(
                         torch.eye(N_STYLES)[[0, 0, 0, 0]])})
    assert float((fixed["logit"] - out["logit"]).abs().max()) > 1e-4


def test_style_of_weight_decodes_as_jax(style_pair):
    jmodel, jvars, port, b = style_pair
    jb = jax_batch(b)
    seqs = []
    for s in range(N_STYLES):
        w = np.zeros((4, N_STYLES), np.float32)
        w[:, s] = 1.0
        jstyle = jmodel.apply(jvars, jnp.asarray(w),
                              method=JStyleCaptioner.style_of_weight)
        want = j_generate(jmodel, jvars, jb["wav"], jb["wav_len"],
                          sample_method="greedy", max_length=10,
                          cond_kwargs={"style": jstyle})["seq"]
        style = port.style_of_weight(torch.from_numpy(w))
        np.testing.assert_allclose(style.detach().numpy(),
                                   np.asarray(jstyle), atol=1e-5, rtol=0)
        got = generate(port, torch.from_numpy(b["wav"]),
                       torch.from_numpy(b["wav_len"]), max_length=10,
                       cond_kwargs={"style": style.detach()})["seq"]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        seqs.append(got)
    assert any(not torch.equal(seqs[0], s) for s in seqs[1:]), \
        "no style moves the decode"


@pytest.mark.parametrize("model_type", ["StyleCaptionModel",
                                        "StyleSeq2SeqAttnModel"])
@pytest.mark.parametrize("style_args", [None, {"n_styles": 6,
                                               "ref_d_model": 64,
                                               "ref_nlayers": 1,
                                               "ref_dropout": 0.1}])
def test_builder_matches_jax(model_type, style_args):
    node = style_node(model_type, copy.deepcopy(style_args))
    jmodel, _ = j_build(node, vocab_size=V)
    b = jax_batch(clips(B=2))
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        b["wav"], b["wav_len"], b["cap"], b["cap_len"], train=False))
    port, _ = build_model_from_config(node, vocab_size=V)
    assert isinstance(port, StyleCaptioner)
    for part in ("ref_encoder", "style_bank"):
        want = {k: tuple(np.shape(a)) for k, a in jax_tree_state_dict(
            jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes["params"][part]), None,
            part).items()}
        got = {f"{part}.{k}": tuple(t.shape)
               for k, t in getattr(port, part).state_dict().items()}
        assert got == want, part
    args = style_args or {}
    assert port.style_bank.n_styles == args.get("n_styles", 4)
    assert port.ref_encoder.d_model == args.get("ref_d_model", D)
    assert port.ref_encoder.nlayers == args.get("ref_nlayers", 2)
    assert port.ref_encoder.layer0.dropout == args.get("ref_dropout", 0.2)
