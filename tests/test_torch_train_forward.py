"""The port's training forward against the JAX package's, on the flagship
architecture (the full EfficientNet-B2 plan, a 2-layer tied transformer
decoder) at a narrow decoder (emb 64, vocab 50), dropout and
drop-connect 0.  The port model is drawn from a seed, its BN statistics
and affine parameters and its decoder matrices jittered with a numpy
seed, and carried to JAX by the JAX package's own converters
(``convert_effb2``, ``convert_transformer_decoder``).  Inputs: 3 clips
of at most 1 s at 16 kHz and padded captions, from a numpy seed.

  * BN running statistics after one train-mode forward against JAX
    ``batch_stats``: relative 1e-5 (the momentum repair: torch 0.01 =
    flax 0.99);
  * logits of the teacher path and of the cached scheduled-sampling path
    at ``ss_ratio=0.0`` against JAX: 1e-4 absolute, equal ``seq``;
  * the cached path against the recompute oracle in the port, same
    coins: 1e-5;
  * dropout and drop-connect: in ``train()`` the kept share within 3
    sigma of 1 - rate and the kept values scaled by 1 / keep; in
    ``eval()`` nothing moves.

The helpers here (``port_model``, ``calibrate_bn``, ``jax_model``,
``jax_variables``, ``make_batch``) are shared with the other ``test_torch_train_*`` files.
"""

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from audiocaption_tpu.models.captioner import Captioner as JCaptioner
from audiocaption_tpu.models.effb2 import (
    EfficientNetB2 as JEfficientNetB2, convert_effb2)
from audiocaption_tpu.models.transformer_decoder import (
    TransformerDecoder as JTransformerDecoder, convert_transformer_decoder)
from audiocaption_tpu.ops.frontend import EFFB2_MEL_16K as J_MEL

from audiocaption_tpu_torch.models.captioner import ss_forward_recompute
from audiocaption_tpu_torch.models.convert import effb2_state_dict_from_jax
from audiocaption_tpu_torch.models.effb2 import MBConvBlock, drop_connect
from audiocaption_tpu_torch.models.zoo import effb2_trm, random_init

torch.set_num_threads(2)

V, EMB, SR = 50, 64, 16000


def port_model(seed: int = 0, dropout: float = 0.0,
               drop_connect_rate: float = 0.0, decoder_jitter: float = 0.1):
    """The narrow flagship in the port: random weights from ``seed``,
    BN statistics and affine parameters and the decoder's matrices
    (by ``decoder_jitter``) jittered from a numpy seed (random-init
    EffB2 collapses, and a random decoder ties)."""
    m = effb2_trm(vocab_size=V, decoder_emb_dim=EMB, decoder_dropout=dropout)
    for block in m.encoder._blocks:
        block.drop_rate *= drop_connect_rate / m.encoder.drop_connect_rate
    random_init(m, torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed + 1)

    def rand(shape, scale, offset=0.0):
        return torch.from_numpy(
            (offset + rng.randn(*shape) * scale).astype(np.float32))
    with torch.no_grad():
        for mod in m.encoder.modules():
            if isinstance(mod, nn.BatchNorm2d):
                n = (mod.num_features,)
                mod.running_mean.copy_(rand(n, 0.1))
                mod.running_var.copy_(torch.from_numpy(
                    (0.5 + rng.rand(*n)).astype(np.float32)))
                mod.weight.copy_(rand(n, 0.2, 1.0))
                mod.bias.copy_(rand(n, 0.2))
        for p in m.decoder.parameters():
            if p.dim() == 2:
                p.add_(rand(p.shape, decoder_jitter))
    return m


def calibrate_bn(port, wav: np.ndarray, wav_len: np.ndarray) -> None:
    """Set every encoder BN's running statistics to those of one batch
    (a random-init EffB2 in ``eval()`` otherwise maps every clip to the
    same output)."""
    bns = [m for m in port.encoder.modules() if isinstance(m, nn.BatchNorm2d)]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None            # a cumulative average: one batch
    port.train()
    with torch.no_grad():
        port.encode(torch.from_numpy(wav), torch.from_numpy(wav_len))
    for m in bns:
        m.momentum = 0.01
    port.eval()


def jax_model():
    return JCaptioner(
        encoder=JEfficientNetB2(drop_connect_rate=0.0),
        decoder=JTransformerDecoder(emb_dim=EMB, vocab_size=V,
                                    attn_emb_dim=1408, dropout=0.0,
                                    nlayers=2, tie_weights=True),
        mel=J_MEL)


def jax_variables(port) -> dict:
    """The port model's weights as the JAX Captioner's variables."""
    enc = {k: v.numpy().copy() for k, v in port.encoder.state_dict().items()}
    dec = {k: v.numpy().copy() for k, v in port.decoder.state_dict().items()}
    p_enc, s_enc = convert_effb2(enc)
    p_dec = convert_transformer_decoder(dec, nlayers=2, tie_weights=True)
    return {"params": {"encoder": p_enc, "decoder": p_dec},
            "batch_stats": {"encoder": s_enc}}


def make_batch(seed: int = 0, B: int = 3, Lc: int = 8) -> dict:
    """Numpy clips (<= 1 s) and <bos> words <eos> captions, padded."""
    rng = np.random.RandomState(seed)
    wav_len = np.asarray([SR, 12000, 9000, 14000][:B], np.int64)
    wav = (rng.randn(B, SR) * 0.1).astype(np.float32)
    cap_len = np.asarray([Lc, Lc - 2, Lc - 4, Lc - 1][:B], np.int64)
    cap = np.zeros((B, Lc), np.int64)
    for i, n in enumerate(cap_len):
        cap[i, 0], cap[i, n - 1] = 1, 2
        cap[i, 1:n - 1] = rng.randint(3, V, n - 2)
    return {"wav": wav, "wav_len": wav_len, "cap": cap, "cap_len": cap_len}


def torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def jax_batch(b: dict) -> dict:
    return {k: jnp.asarray(v if v.dtype != np.int64 else v.astype(np.int32))
            for k, v in b.items()}


def bn_stats(port) -> dict:
    return {k: v.numpy().copy() for k, v in port.encoder.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


@pytest.fixture(scope="module")
def forwards():
    """One train-mode forward of each path in both packages, from the
    same weights and batch."""
    port = port_model()
    jmodel, jvars = jax_model(), jax_variables(port)
    b = make_batch()

    @jax.jit
    def jfwd(v, wav, wav_len, cap, cap_len):
        t_out, upd = jmodel.apply(v, wav, wav_len, cap, cap_len,
                                  ss_ratio=1.0, train=True,
                                  mutable=["batch_stats"])
        s_out, _ = jmodel.apply(v, wav, wav_len, cap, cap_len,
                                ss_ratio=0.0, train=True,
                                mutable=["batch_stats"],
                                rngs={"sample": jax.random.PRNGKey(0)})
        return (t_out["logit"], s_out["logit"], s_out["seq"],
                upd["batch_stats"])

    jb = jax_batch(b)
    j_teacher, j_ss, j_seq, j_stats = jax.device_get(
        jfwd(jvars, jb["wav"], jb["wav_len"], jb["cap"], jb["cap_len"]))
    tb = torch_batch(b)
    init_stats = bn_stats(port)
    port.train()
    with torch.no_grad():
        t_out = port(tb["wav"], tb["wav_len"], tb["cap"], tb["cap_len"], 1.0)
        stats = bn_stats(port)
        s_out = port(tb["wav"], tb["wav_len"], tb["cap"], tb["cap_len"], 0.0,
                     generator=torch.Generator().manual_seed(0))
    want_stats = {
        k: v.numpy() for k, v in effb2_state_dict_from_jax(
            jvars["params"]["encoder"], j_stats["encoder"]).items()
        if k.endswith(("running_mean", "running_var"))}
    return dict(port=port, batch=tb, j_teacher=j_teacher, j_ss=j_ss,
                j_seq=j_seq, stats=stats, want_stats=want_stats,
                init_stats=init_stats,
                t_out=t_out, s_out=s_out)


def test_effb2_bn_momentum_is_flax_0_99():
    enc = effb2_trm(vocab_size=V).encoder
    bns = [m for m in enc.modules() if isinstance(m, nn.BatchNorm2d)]
    assert len(bns) == 2 + sum(3 if b.has_expand else 2 for b in enc._blocks)
    assert {m.momentum for m in bns} == {0.01}


def test_bn_running_stats_after_train_forward_match_jax(forwards):
    got, want = forwards["stats"], forwards["want_stats"]
    assert set(got) == set(want) and len(got) > 100
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                   atol=1e-5 * np.abs(want[k]).max(),
                                   err_msg=k)
    # the statistics moved by a momentum-0.01 step: torch's default 0.1
    # would have moved them ten times as far
    init = forwards["init_stats"]
    for k in want:
        assert np.abs(want[k] - init[k]).max() > 0, k
    k = "_blocks.5._bn1.running_var"
    step = np.abs(got[k] - init[k]).max()
    assert step > 1e-4
    np.testing.assert_allclose(np.abs(got[k] - init[k]).max(),
                               np.abs(want[k] - init[k]).max(), rtol=1e-3)


def test_teacher_logits_match_jax(forwards):
    got = forwards["t_out"]["logit"].numpy()
    want = forwards["j_teacher"]
    assert got.shape == want.shape == (3, 7, V)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_cached_ss_logits_match_jax(forwards):
    out = forwards["s_out"]
    np.testing.assert_allclose(out["logit"].numpy(), forwards["j_ss"],
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(out["seq"].numpy(), forwards["j_seq"])
    # the model path diverges from the teacher path (else ss is vacuous)
    assert np.abs(forwards["j_ss"] - forwards["j_teacher"]).max() > 1e-2


@pytest.mark.parametrize("ss_ratio", [0.0, 0.5])
def test_cached_ss_matches_recompute_oracle(forwards, ss_ratio):
    port, tb = forwards["port"], forwards["batch"]
    port.eval()
    with torch.no_grad():
        enc = port.encode(tb["wav"], tb["wav_len"])
        a = port._ss_forward(enc, tb["cap"], ss_ratio,
                             torch.Generator().manual_seed(7))
        b = ss_forward_recompute(port, enc, tb["cap"], ss_ratio,
                                 torch.Generator().manual_seed(7))
    for k in ("logit", "embed", "sampled_logprob"):
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(a["seq"].numpy(), b["seq"].numpy())


def test_ss_float_one_is_teacher_forcing_and_tensor_one_is_cached(forwards):
    port, tb = forwards["port"], forwards["batch"]
    port.eval()
    with torch.no_grad():
        t = port(tb["wav"], tb["wav_len"], tb["cap"], tb["cap_len"], 1.0)
        c = port(tb["wav"], tb["wav_len"], tb["cap"], tb["cap_len"],
                 torch.tensor(1.0), generator=torch.Generator())
    assert "seq" not in t and "seq" in c
    np.testing.assert_allclose(c["logit"].numpy(), t["logit"].numpy(),
                               rtol=0, atol=1e-6)


def _kept_share_ok(kept: np.ndarray, rate: float) -> bool:
    n, keep = kept.size, 1.0 - rate
    sigma = np.sqrt(keep * rate / n)
    return abs(kept.mean() - keep) <= 3 * sigma


def test_drop_connect_share_and_scale():
    torch.manual_seed(0)
    x = torch.ones(20000, 3, 2, 2)
    rate = 0.3
    y = drop_connect(x, rate)
    per_sample = y.reshape(len(y), -1)
    assert bool((per_sample == per_sample[:, :1]).all())   # whole samples
    kept = (per_sample[:, 0] != 0).numpy()
    assert _kept_share_ok(kept, rate)
    np.testing.assert_allclose(per_sample[kept, 0].numpy(), 1 / (1 - rate),
                               rtol=1e-6)


def test_block_drop_connect_train_only():
    torch.manual_seed(1)
    blk = MBConvBlock(16, 16, 3, 1, 6, 33, drop_rate=0.25)
    ref = MBConvBlock(16, 16, 3, 1, 6, 33, drop_rate=0.0)
    ref.load_state_dict(blk.state_dict())
    x = torch.randn(1, 16, 5, 7).expand(4000, -1, -1, -1).contiguous()
    with torch.no_grad():
        blk.train(), ref.train()
        branch = (ref(x) - x)[0]
        d = (blk(x) - x).reshape(len(x), -1)
        kept = (d.abs().amax(1) > 0).numpy()
        assert _kept_share_ok(kept, 0.25)
        np.testing.assert_allclose(d[kept].numpy(),
                                   (branch.reshape(1, -1) / 0.75)
                                   .expand(int(kept.sum()), -1).numpy(),
                                   rtol=1e-5, atol=1e-6)
        blk.eval(), ref.eval()
        np.testing.assert_array_equal(blk(x[:2]).numpy(), ref(x[:2]).numpy())
    # the encoder's rates: 0.2 * idx / n_blocks
    enc = effb2_trm(vocab_size=V).encoder
    n = len(enc._blocks)
    assert [b.drop_rate for b in enc._blocks] == [0.2 * i / n
                                                  for i in range(n)]


def test_decoder_dropout_share_scale_and_eval():
    dec = effb2_trm(vocab_size=V, decoder_emb_dim=EMB).decoder
    layer = dec.layers[0]
    assert dec.dropout == layer.dropout == layer.self_attn.dropout == 0.2
    torch.manual_seed(2)
    layer.train()
    y = layer._drop(torch.ones(200000))
    kept = (y != 0).numpy()
    assert _kept_share_ok(kept, 0.2)
    np.testing.assert_allclose(y[kept].numpy(), 1 / 0.8, rtol=1e-6)
    # eval: a decoder at dropout 0.2 equals the same weights at 0
    quiet = effb2_trm(vocab_size=V, decoder_emb_dim=EMB,
                      decoder_dropout=0.0).decoder
    quiet.load_state_dict(dec.state_dict())
    rng = np.random.RandomState(3)
    word = torch.from_numpy(rng.randint(0, V, (2, 6)))
    mem = torch.from_numpy(rng.randn(2, 5, 1408).astype(np.float32))
    mem_len = torch.tensor([5, 3])
    with torch.no_grad():
        dec.eval()
        a = dec(word, mem, mem_len)["logit"]
        b = quiet.train()(word, mem, mem_len)["logit"]
        dec.train()
        c = dec(word, mem, mem_len)["logit"]
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert (a - c).abs().max() > 1e-3
