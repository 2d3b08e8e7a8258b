"""Fused decode kernels of the PyTorch port: the plain versions of both
kernels against the JAX package's fused decoders run in Pallas interpret
mode, on the same carried-over decoder weights and the same memory K/V.
The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda.py.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: tokens exact; n-best beam scores atol 1e-4 (float32 sums in
another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from audiocaption_tpu_torch.decoding import fused_beam as TB
from audiocaption_tpu_torch.decoding import fused_greedy as TG
from audiocaption_tpu_torch.models.convert import decoder_state_dict_from_jax
from audiocaption_tpu_torch.models.transformer_decoder import (
    TransformerDecoder as TorchDecoder)

torch.set_num_threads(1)

E, NHEAD, FFN, V, NL, S, L = 128, 2, 256, 48, 2, 9, 7


def _interpret(monkeypatch, module, call):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        kwargs.pop("compiler_params", None)
        return orig(*args, **kwargs)

    monkeypatch.setattr(module.pl, "pallas_call", patched)
    call._clear_cache()


def jitter_tree(tree, rng, scale):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.randn(*np.shape(x)).astype(np.float32)
        * scale, tree)


@pytest.fixture(scope="module")
def decoders():
    """(jax decoder, jax params, torch decoder) with jittered weights."""
    from audiocaption_tpu.models.transformer_decoder import TransformerDecoder
    jdec = TransformerDecoder(emb_dim=E, vocab_size=V, attn_emb_dim=32,
                              nlayers=NL, nhead=NHEAD, dim_feedforward=FFN,
                              tie_weights=True)
    params = jdec.init(jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32),
                       jnp.zeros((1, 5, 32)), jnp.asarray([5]))["params"]
    params = jitter_tree(jax.device_get(params), np.random.RandomState(7),
                         0.3)
    tdec = TorchDecoder(E, V, 32, nlayers=NL, nhead=NHEAD,
                        dim_feedforward=FFN, tie_weights=True).eval()
    tdec.load_state_dict(decoder_state_dict_from_jax(params, NL, True))
    return jdec, params, tdec


def memory(B, seed, lens):
    """Well-spread memory K/V [NL, 2, B, S, E] and validity [B, S]."""
    rng = np.random.RandomState(seed)
    memkv = rng.randn(NL, 2, B, S, E).astype(np.float32)
    valid = (np.arange(S)[None, :] < np.asarray(lens)[:, None])
    return memkv, valid.astype(np.uint8)


def jax_memory(memkv, valid):
    """The TPU kernels' layout: head-padded [S, B, H*128] per layer."""
    from audiocaption_tpu.decoding.fused_greedy import HPAD
    dh = E // NHEAD

    def pad_heads(m):                                     # [B, S, E]
        m = np.transpose(m, (1, 0, 2))
        out = np.zeros(m.shape[:2] + (NHEAD * HPAD,), np.float32)
        for h in range(NHEAD):
            out[:, :, h * HPAD:h * HPAD + dh] = m[:, :, h * dh:(h + 1) * dh]
        return jnp.asarray(out)

    memk = tuple(pad_heads(memkv[i, 0]) for i in range(NL))
    memv = tuple(pad_heads(memkv[i, 1]) for i in range(NL))
    return memk, memv, jnp.asarray(valid.T.astype(np.float32))


def torch_inputs(tdec, memkv, valid, device="cpu"):
    packed = TG.pack_decoder_weights(tdec).to(device)
    return (packed, torch.from_numpy(memkv).to(device),
            torch.from_numpy(valid).to(device))


def test_pack_layout_matches_offsets(decoders):
    _, _, tdec = decoders
    packed = TG.pack_decoder_weights(tdec)
    offs = TG.layer_offsets(E, FFN)
    assert packed.layers.shape == (NL, offs["size"][0])
    w = TG._layer_views(packed.layers[1], E, FFN)
    layer = tdec.layers[1]
    scale = 1.0 / np.sqrt(E // NHEAD)
    np.testing.assert_allclose(w["wqkv"][:E].numpy(),
                               layer.self_attn.in_proj_weight[:E].detach()
                               .numpy() * scale, rtol=1e-6)
    np.testing.assert_array_equal(w["w2"].numpy(),
                                  layer.linear2.weight.detach().numpy())
    np.testing.assert_array_equal(w["ln"][5].numpy(),
                                  layer.norm3.bias.detach().numpy())


@pytest.mark.parametrize("lens", [(9, 4, 6), (9, 0, 3)],
                         ids=["ragged", "empty_memory"])
def test_greedy_plain_matches_jax_kernel(decoders, monkeypatch, lens):
    import audiocaption_tpu.decoding.fused_greedy as FG
    jdec, params, tdec = decoders
    memkv, valid = memory(3, 11, lens)
    _interpret(monkeypatch, FG, FG._fused_decode_call)
    packed_j = {k: jnp.asarray(v)
                for k, v in FG.pack_decoder_weights(jdec, params).items()}
    want = np.asarray(FG._fused_decode_call(jdec, L, packed_j,
                                            *jax_memory(memkv, valid)))
    got = TG.fused_greedy_decode(*torch_inputs(tdec, memkv, valid), L)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 2      # trajectories are weight-dependent


@pytest.mark.parametrize("lens", [(9, 4, 6), (9, 0, 3)],
                         ids=["ragged", "empty_memory"])
def test_beam_plain_matches_jax_kernel(decoders, monkeypatch, lens):
    import audiocaption_tpu.decoding.fused_beam as FB
    from audiocaption_tpu.decoding.fused_greedy import pack_decoder_weights
    jdec, params, tdec = decoders
    memkv, valid = memory(3, 5, lens)
    _interpret(monkeypatch, FB, FB._fused_beam_call)
    packed_j = {k: jnp.asarray(v)
                for k, v in pack_decoder_weights(jdec, params).items()}
    want_seq, want_score = FB._fused_beam_call(jdec, L, 3, packed_j,
                                               *jax_memory(memkv, valid))
    seq, score = TB.fused_beam_decode(*torch_inputs(tdec, memkv, valid), L, 3)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(want_seq))
    np.testing.assert_allclose(score.numpy(), np.asarray(want_score),
                               atol=1e-4)


def _jax_beam(decoders, monkeypatch, memkv, valid, K):
    import audiocaption_tpu.decoding.fused_beam as FB
    from audiocaption_tpu.decoding.fused_greedy import pack_decoder_weights
    jdec, params, _ = decoders
    _interpret(monkeypatch, FB, FB._fused_beam_call)
    packed_j = {k: jnp.asarray(v)
                for k, v in pack_decoder_weights(jdec, params).items()}
    seq, score = FB._fused_beam_call(jdec, L, K, packed_j,
                                     *jax_memory(memkv, valid))
    return np.asarray(seq), np.asarray(score)


@pytest.mark.parametrize("K", [5, 8])
def test_wide_beam_plain_matches_jax_kernel(decoders, monkeypatch, K):
    """Beams 5-8: the TPU kernel pads K to 8 sublanes and serves them."""
    memkv, valid = memory(2, 17, (9, 4))
    want_seq, want_score = _jax_beam(decoders, monkeypatch, memkv, valid, K)
    packed, mk, mv = torch_inputs(decoders[2], memkv, valid)
    seq, score = TB.fused_beam_plain(packed, mk, mv, L, K)
    assert seq.shape == (2, K, L)
    np.testing.assert_array_equal(seq.numpy(), want_seq)
    np.testing.assert_allclose(score.numpy(), want_score, atol=1e-4)


def test_beam_decode_takes_beam_5_on_cpu_tensors(decoders, monkeypatch):
    memkv, valid = memory(2, 19, (9, 6))
    want_seq, want_score = _jax_beam(decoders, monkeypatch, memkv, valid, 5)
    seq, score = TB.fused_beam_decode(*torch_inputs(decoders[2], memkv,
                                                    valid), L, 5)
    np.testing.assert_array_equal(seq.numpy(), want_seq)
    np.testing.assert_allclose(score.numpy(), want_score, atol=1e-4)


def test_plain_versions_match_torch_engine(decoders):
    """The kernels' plain versions agree with the torch engine on the same
    memory (greedy exactly; beam n-best sequences exactly)."""
    from audiocaption_tpu_torch.decoding.engine import (
        SpecialTokens, beam_search, expand_to_beams, stepwise_decode)
    _, _, tdec = decoders
    memkv, valid = memory(2, 3, (9, 5))
    packed, mk, mv = torch_inputs(tdec, memkv, valid)
    sp = SpecialTokens()
    # the engine's cache from the same memory K/V
    static = {"mem_kpm": ~mv.bool()}
    for i in range(NL):
        static[f"mem_k{i}"], static[f"mem_v{i}"] = mk[i, 0], mk[i, 1]

    def fresh_dyn(rows):
        d = {f"self_{n}{i}": torch.zeros(rows, L, E)
             for i in range(NL) for n in ("k", "v")}
        d["self_pad"] = torch.zeros(rows, L, dtype=torch.bool)
        return d

    def step(st):
        return lambda w, t, d: tdec.step(w, t, st, d, is_pad_t=w == sp.pad)

    with torch.no_grad():
        want = stepwise_decode(step(static), fresh_dyn(2), 2, sp, L)["seq"]
        got = TG.fused_greedy_decode(packed, mk, mv, L)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        st_k = expand_to_beams(static, 3)
        want_b = beam_search(step(st_k), fresh_dyn(6), 2, 3, V, sp, L,
                             n_best=True)
        seq, score = TB.fused_beam_decode(packed, mk, mv, L, 3)
        np.testing.assert_array_equal(seq.numpy(), want_b["seq"].numpy())
        np.testing.assert_allclose(score.numpy(), want_b["score"].numpy(),
                                   atol=1e-4)


def test_wrappers_reject_bad_inputs(decoders):
    _, _, tdec = decoders
    memkv, valid = memory(2, 1, (9, 5))
    packed, mk, mv = torch_inputs(tdec, memkv, valid)
    with pytest.raises(ValueError):
        TG.fused_greedy_decode(packed, mk, mv.bool(), L)
    with pytest.raises(ValueError):
        TG.fused_greedy_decode(packed, mk[:1], mv, L)
    with pytest.raises(ValueError):
        TB.fused_beam_decode(packed, mk, mv, L, beam_size=9)
    with pytest.raises(ValueError):
        TG.fused_greedy_decode(packed, mk, mv, 1000)
