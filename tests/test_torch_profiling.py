"""The port's profiling helpers (``utils/profiling.py``) on the CPU.

``flops_estimate`` counts a small conv + linear model's FLOPs exactly as
the analytic count of its products (two per multiply-add of the
convolution and the linear layer), and within 3% of the JAX package's
``flops_estimate`` of the same model in flax: XLA's cost analysis also
counts the elementwise work (the bias adds and the ReLU, here 1.2% of
the products) where ``FlopCounterMode`` counts the products alone.
``bytes_accessed`` counts each operation's operands and result once.
``mfu``, ``device_peak_flops`` (None on the CPU and for a
card not in its table, the H100 SXM's dense bf16 rate for that card),
``host_rss_gb`` and ``trace`` as specified."""

import json

import numpy as np
import pytest
import torch
from torch import nn

import flax.linen as fnn
import jax
import jax.numpy as jnp

from audiocaption_tpu.utils.profiling import (
    flops_estimate as j_flops_estimate)
from audiocaption_tpu_torch.utils import profiling as P

B, CIN, COUT, H, W, OUT = 2, 8, 16, 10, 12, 10


class TorchNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(CIN, COUT, 3)
        self.fc = nn.Linear(COUT * (H - 2) * (W - 2), OUT)

    def forward(self, x):
        return self.fc(torch.relu(self.conv(x)).flatten(1))


class FlaxNet(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        x = fnn.relu(fnn.Conv(COUT, (3, 3), padding="VALID")(x))
        return fnn.Dense(OUT)(x.reshape(x.shape[0], -1))


def analytic_flops():
    conv = 2 * B * COUT * (H - 2) * (W - 2) * CIN * 9
    fc = 2 * B * COUT * (H - 2) * (W - 2) * OUT
    return conv + fc


def test_flops_estimate_counts_the_products():
    x = torch.randn(B, CIN, H, W)
    with torch.no_grad():
        est = P.flops_estimate(TorchNet(), x)
    assert est["flops"] == analytic_flops()
    assert est["bytes_accessed"] >= 4 * (x.numel() + B * OUT)


def test_flops_estimate_agrees_with_jax():
    x = np.random.RandomState(0).randn(B, H, W, CIN).astype(np.float32)
    net = FlaxNet()
    params = net.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = j_flops_estimate(lambda p, v: net.apply(p, v), params,
                            jnp.asarray(x))["flops"]
    with torch.no_grad():
        got = P.flops_estimate(TorchNet(), torch.from_numpy(
            x.transpose(0, 3, 1, 2).copy()))["flops"]
    print(f"flops: port {got:.0f}, JAX {want:.0f} ({want / got - 1:.4f})")
    assert got <= want <= 1.03 * got


def test_flops_estimate_is_minus_one_where_nothing_counts():
    est = P.flops_estimate(lambda: None)
    assert est == {"flops": -1.0, "bytes_accessed": -1.0}


def test_peak_and_mfu(monkeypatch):
    assert P.device_peak_flops("cpu") is None
    assert P.mfu(1e12, 1.0, "cpu") is None
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "NVIDIA H100 80GB HBM3")
    assert P.device_peak_flops("cuda") == 989e12
    assert P.mfu(989e9, 2.0, "cuda") == pytest.approx(5e-4)
    assert P.mfu(0.0, 1.0, "cuda") is None
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "NVIDIA A10")
    assert P.device_peak_flops("cuda") is None


def test_host_rss_and_trace(tmp_path):
    assert P.host_rss_gb() > 0
    with P.trace(str(tmp_path)):
        torch.randn(64, 64) @ torch.randn(64, 64)
    events = json.loads((tmp_path / "trace.json").read_text())
    assert events["traceEvents"]
