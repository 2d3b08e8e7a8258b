"""The folded MBConv block of the PyTorch port (``ops/fused_mbconv.py``)
against the JAX package's ``ops/pallas_mbconv.py`` and its flax
``MBConvBlock``, on weights carried across by the converter.

BN statistics and affine parameters are jittered, so the folded expand
bias is not zero.  Tolerance 2e-5 absolute on unit-scale inputs: the JAX
package holds its own pair to 2e-6, and torch sums in another order.  The
JAX Pallas kernel runs in interpret mode, patched as
``tests/test_pallas_mbconv.py`` patches it."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from audiocaption_tpu.models import effb2 as JE
from audiocaption_tpu_torch.models import convert
from audiocaption_tpu_torch.models import effb2 as TE
from audiocaption_tpu_torch.ops import fused_mbconv as FM

torch.set_num_threads(1)
ATOL = 2e-5


@pytest.fixture()
def PM(monkeypatch):
    import audiocaption_tpu.ops.pallas_mbconv as mod
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        kwargs.pop("compiler_params", None)
        return orig(*args, **kwargs)

    monkeypatch.setattr(mod.pl, "pallas_call", patched)
    return mod


def jitter(params, stats, rng):
    """Non-identity BN statistics and affine parameters, in place."""
    for name in stats:
        n = stats[name]["mean"].shape
        stats[name] = {"mean": (rng.randn(*n) * 0.1).astype(np.float32),
                       "var": (0.5 + rng.rand(*n)).astype(np.float32)}
        params[name] = {"scale": (1 + 0.2 * rng.randn(*n)).astype(np.float32),
                        "bias": (0.3 * rng.randn(*n)).astype(np.float32)}


def block_state_dict(params, stats):
    """A flax MBConvBlock's variables -> the port block's state dict."""
    out = {}
    for flax_name, port_name in (("expand_conv", "_expand_conv"),
                                 ("depthwise_conv", "_depthwise_conv"),
                                 ("se_reduce", "_se_reduce"),
                                 ("se_expand", "_se_expand"),
                                 ("project_conv", "_project_conv")):
        if flax_name in params:
            convert._conv2d(params[flax_name], port_name, out)
    for bn in ("bn0", "bn1", "bn2"):
        if bn in params:
            convert._batchnorm(params[bn], stats[bn], f"_{bn}", out)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def make_case(PM, kwargs, H, W, seed, jittered=True):
    """-> (JAX spec, JAX folded weights, port block, x NHWC, flax output)."""
    blk = JE.MBConvBlock(drop_rate=0.0, **kwargs)
    rng = np.random.RandomState(seed)
    x = rng.randn(2, H, W, kwargs["in_filters"]).astype(np.float32)
    v = jax.device_get(blk.init(jax.random.PRNGKey(seed), jnp.asarray(x)))
    params, stats = dict(v["params"]), dict(v["batch_stats"])
    if jittered:
        jitter(params, stats, rng)
    ref = np.asarray(blk.apply({"params": params, "batch_stats": stats},
                               jnp.asarray(x)))
    port = TE.MBConvBlock(**kwargs).eval()
    port.load_state_dict(block_state_dict(params, stats))
    spec = FM.spec_of(port)
    jspec = PM.MBConvSpec(*spec)
    jw = PM.pack_mbconv(params, stats, jspec)
    return jspec, jw, port, x, ref


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


B2 = dict(nominal_size=130, expand_ratio=6)
CASES = {
    "s1_k3_expand_residual": (dict(in_filters=16, out_filters=16, kernel=3,
                                   stride=1, **B2), 16, 21),
    "s1_k5_no_expand": (dict(in_filters=32, out_filters=16, kernel=5, stride=1,
                             expand_ratio=1, nominal_size=65), 8, 17),
    "s1_k3_no_expand_residual": (dict(in_filters=16, out_filters=16, kernel=3,
                                      stride=1, expand_ratio=1,
                                      nominal_size=130), 9, 13),
    "s2_k3_expand": (dict(in_filters=16, out_filters=24, kernel=3, stride=2,
                          **B2), 16, 22),
    "s2_k5_expand": (dict(in_filters=24, out_filters=40, kernel=5, stride=2,
                          expand_ratio=6, nominal_size=65), 9, 17),
    "s1_k5_pruned_widths": (dict(in_filters=24, out_filters=24, kernel=5,
                                 stride=1, expand_ratio=6, nominal_size=65,
                                 oup_override=101, squeeze_override=5), 7, 11),
}


def test_fold_bn_matches_jax(PM):
    rng = np.random.RandomState(0)
    kernel = rng.randn(3, 3, 7).astype(np.float32)
    bias = rng.randn(7).astype(np.float32)
    bn_p = {"scale": 1 + 0.2 * rng.randn(7), "bias": 0.3 * rng.randn(7)}
    bn_s = {"mean": 0.1 * rng.randn(7), "var": 0.5 + rng.rand(7)}
    bn = torch.nn.BatchNorm2d(7, eps=1e-3).eval()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(bn_p["scale"]))
        bn.bias.copy_(torch.from_numpy(bn_p["bias"]))
        bn.running_mean.copy_(torch.from_numpy(bn_s["mean"]))
        bn.running_var.copy_(torch.from_numpy(bn_s["var"]))
    for b in (None, bias):
        want_k, want_b = PM.fold_bn(kernel, b, bn_p, bn_s)
        got_k, got_b = FM.fold_bn(torch.from_numpy(kernel),
                                  None if b is None else torch.from_numpy(b),
                                  bn)
        np.testing.assert_allclose(got_k.numpy(), want_k, rtol=1e-6)
        np.testing.assert_allclose(got_b.numpy(), want_b, rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("name", ["s1_k3_expand_residual", "s1_k5_no_expand",
                                  "s1_k5_pruned_widths"])
def test_pack_mbconv_matches_jax(PM, name):
    kwargs, H, W = CASES[name]
    jspec, jw, port, _, _ = make_case(PM, kwargs, H, W, seed=1)
    got = FM.pack_mbconv(port)
    assert set(got) == set(jw)
    assert FM.spec_of(port) == tuple(jspec)
    for key, want in jw.items():
        want = np.asarray(want)
        if key.startswith("b_"):
            want = want[0]                        # JAX keeps [1, n] biases
        assert got[key].shape == want.shape, key
        np.testing.assert_allclose(got[key].numpy(), want, rtol=1e-6,
                                   atol=1e-7, err_msg=key)


@pytest.mark.parametrize("name", list(CASES))
def test_mbconv_plain_matches_jax(PM, name):
    """``mbconv_plain`` against ``xla_mbconv`` and the flax block, with
    jittered BN; on the CPU ``fused_mbconv_s1`` is ``mbconv_plain``."""
    kwargs, H, W = CASES[name]
    jspec, jw, port, x, ref = make_case(PM, kwargs, H, W, seed=2)
    weights = FM.pack_mbconv(port)
    got = nhwc(FM.mbconv_plain(nchw(x), weights, FM.spec_of(port)))
    xla = np.asarray(PM.xla_mbconv(jnp.asarray(x), jw, jspec))
    assert got.shape == ref.shape == xla.shape
    np.testing.assert_allclose(got, xla, atol=ATOL)
    np.testing.assert_allclose(got, ref, atol=ATOL)
    with torch.no_grad():
        np.testing.assert_allclose(nhwc(port(nchw(x))), ref, atol=ATOL)
    if jspec.stride == 1:
        np.testing.assert_array_equal(
            nhwc(FM.fused_mbconv_s1(nchw(x), weights, FM.spec_of(port))), got)


@pytest.mark.parametrize("name", ["s1_k3_expand_residual", "s1_k5_no_expand"])
def test_mbconv_plain_matches_jax_kernel_at_init(PM, name):
    """At flax's BN init the folded expand bias is 0, where the JAX kernel
    computes the block: the port agrees with it there."""
    kwargs, H, W = CASES[name]
    jspec, jw, port, x, ref = make_case(PM, kwargs, H, W, seed=3,
                                        jittered=False)
    kernel = np.asarray(PM.fused_mbconv_s1(jnp.asarray(x), jw, jspec))
    got = nhwc(FM.mbconv_plain(nchw(x), FM.pack_mbconv(port),
                               FM.spec_of(port)))
    np.testing.assert_allclose(got, kernel, atol=ATOL)
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_jax_kernel_border_fault_is_not_ported(PM):
    """The JAX kernel pads x and expands the padded map, so its border
    holds swish(b_exp) where the block pads the expanded map with zeros.
    With jittered BN the port matches the block and the JAX kernel does
    not (a fault of the JAX package, recorded here, not repaired)."""
    kwargs, H, W = CASES["s1_k3_expand_residual"]
    jspec, jw, port, x, ref = make_case(PM, kwargs, H, W, seed=4)
    assert float(np.abs(np.asarray(jw["b_exp"])).max()) > 0.1
    kernel = np.asarray(PM.fused_mbconv_s1(jnp.asarray(x), jw, jspec))
    got = nhwc(FM.mbconv_plain(nchw(x), FM.pack_mbconv(port),
                               FM.spec_of(port)))
    np.testing.assert_allclose(got, ref, atol=ATOL)
    assert float(np.abs(kernel - ref).max()) > 1e-3


def _stride1_shapes(encoder, H=32, W=500):
    """(spec, H, W, squeeze) of every stride-1 block of an encoder on a
    10 s log-mel (H mels x W frames at the stem's output)."""
    out = []
    for block in encoder._blocks:
        spec = FM.spec_of(block)
        if spec.stride == 2:
            pt, pb, pl_, pr = spec.pad
            H = (H + pt + pb - spec.kernel) // 2 + 1
            W = (W + pl_ + pr - spec.kernel) // 2 + 1
            continue
        out.append((spec, H, W, block._se_reduce.weight.shape[0]))
    return out


@pytest.fixture(scope="module")
def encoders():
    torch.manual_seed(0)
    full = TE.EfficientNetB2().eval()
    return {"flagship": full,
            "pruned_0.3": TE.build_pruned_effb2(full, 0.3, prune_head=False),
            "pruned_0.5": TE.build_pruned_effb2(full, 0.5, prune_head=False)}


def test_plan_tiles_fits_the_kernel(encoders):
    """Every tile plan of the flagship's stride-1 blocks and of the pruned
    0.3 / 0.5 encoders (and an odd pruned block) fits the kernel: Ec a
    multiple of 16 (the mma tile), Eg of Ec, the tile inside the map, 256
    threads (at most 1024), and the three launches' shared memory within
    227 KB as the kernel lays it out (the SE block's 1024 threads at
    least the squeeze width); every depthwise is 3x3 or 5x5."""
    shapes = [s for enc in encoders.values() for s in _stride1_shapes(enc)]
    assert len(shapes) == 3 * 19
    shapes.append((FM.spec_of(TE.MBConvBlock(
        48, 37, 5, 1, 6, 33, oup_override=203, squeeze_override=9)),
        7, 125, 9))
    assert FM.NT <= 1024 and FM.NT % 32 == 0
    for spec, H, W, squeeze in shapes:
        for B in (1, 8, 64):
            assert spec.kernel in (3, 5)
            plan = FM.plan_tiles(spec, B, H, W)
            Ho, Wo = FM._out_hw(spec, H, W)
            assert plan.Ec % 16 == 0 and plan.Eg % plan.Ec == 0
            assert plan.Ec <= -(-spec.exp_ch // 16) * 16
            assert 0 < plan.TH <= Ho and 0 < plan.TW <= Wo
            assert plan.WM in (1, 2, 4)
            assert plan.smem == FM.tile_smem(spec, H, W, plan.TH, plan.TW,
                                             plan.Ec) <= FM.SMEM_LIMIT
            assert plan.proj_smem == FM.project_smem(spec, plan.WM) \
                <= FM.SMEM_LIMIT
            assert squeeze <= FM.SE_NT
            assert FM.se_smem(spec, squeeze) <= FM.SMEM_LIMIT


def test_round_tf32_keeps_ten_mantissa_bits():
    """Round to nearest, ties away from zero, as ``cvt.rna.tf32.f32``."""
    one_ulp = 2.0 ** -10                          # TF32 spacing at 1.0
    v = torch.tensor([1.0, 1 + one_ulp / 2, 1 + one_ulp / 2 - 2 ** -20,
                      -(1 + one_ulp / 2), 3.0e-3, -7.5e5], dtype=torch.float32)
    got = FM.round_tf32(v)
    assert got.tolist()[:4] == [1.0, 1 + one_ulp, 1.0, -(1 + one_ulp)]
    assert not (got.view(torch.int32) & 0x1FFF).any()
    assert float(((got - v) / v).abs().max()) <= 2.0 ** -11
    big, small = FM.split_tf32(v)
    assert float(((big + small - v) / v).abs().max()) <= 2.0 ** -21


@pytest.mark.parametrize("index", [0, 1, 3, 6, 9, 12, 13, 17, 21, 22])
def test_split_tf32_keeps_float32_parity(encoders, index):
    """Both 1x1 products in the kernel's 3xTF32 split (big = tf32(v), small
    = tf32(v - big), a_small b_big + a_big b_small + a_big b_big) stay
    within 1e-5 relative of ``mbconv_plain`` on each distinct stride-1
    block shape of the flagship (its widths, a small map, BN jittered):
    the tensor-core route keeps float32 parity with TF32 off."""
    block = encoders["flagship"]._blocks[index]
    spec = FM.spec_of(block)
    assert spec.stride == 1
    weights = FM.pack_mbconv(block)
    gen = torch.Generator().manual_seed(index)
    for name in ("w_exp", "b_exp", "b_dw", "b_proj"):   # jittered BN, folded
        if name in weights:
            weights[name] = weights[name] * (
                1 + 0.2 * torch.randn(weights[name].shape, generator=gen))
            if name.startswith("b_"):
                weights[name] = weights[name] + 0.2 * torch.randn(
                    weights[name].shape, generator=gen)
    x = torch.randn(2, spec.in_ch, 5, 11, generator=gen)
    want = FM.mbconv_plain(x, weights, spec)
    got = FM.mbconv_split_tf32(x, weights, spec)
    scale = float(want.abs().max())
    assert got.shape == want.shape and scale > 0.1
    assert float((got - want).abs().max()) <= 1e-5 * scale
