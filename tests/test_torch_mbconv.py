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


def test_plan_tiles_fits_the_kernel():
    """Every tile plan of the flagship's stride-1 blocks (and a pruned
    one) keeps one projection tile per thread and fits shared memory."""
    H, W = 32, 500
    blocks = list(TE.EfficientNetB2()._blocks) + [TE.MBConvBlock(
        48, 37, 5, 1, 6, 33, oup_override=203, squeeze_override=9)]
    for block in blocks:
        spec = FM.spec_of(block)
        if spec.stride == 2:
            pt, pb, pl_, pr = spec.pad
            H = (H + pt + pb - spec.kernel) // 2 + 1
            W = (W + pl_ + pr - spec.kernel) // 2 + 1
            continue
        plan = FM.plan_tiles(spec, 64, H, W)
        assert plan.Ec % 8 == 0 and plan.TH <= H and plan.TW <= W
        assert -(-spec.out_ch // 8) * -(-plan.TH * plan.TW // 4) <= FM.NT
        assert plan.smem == FM.tile_smem(spec, H, W, plan.TH, plan.TW,
                                         plan.Ec) <= FM.SMEM_LIMIT
