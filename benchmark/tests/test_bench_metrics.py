"""Each per-layer metric reader on a small recorded trace."""

import pytest

from harness import env
from harness.trace import Trace

MS = 1_000_000


def small_trace():
    """10 ms window; an entry span holding a frontend and an encoder span;
    four kernels launched in them, one launched outside every span."""
    spans = {"entry": [(0, 6 * MS, 1)], "frontend": [(0, 1 * MS, 1)],
             "encoder": [(1 * MS, 3 * MS, 1)]}
    launches = {1: (int(0.5 * MS), 1), 2: (int(1.5 * MS), 1),
                3: (int(4 * MS), 1), 4: (int(5 * MS), 1), 5: (7 * MS, 1)}
    device = [(1 * MS, 2 * MS, "logmel", 1), (2 * MS, 4 * MS, "conv", 2),
              (4 * MS, 5 * MS, "beam", 3), (6 * MS, 7 * MS, "beam", 4),
              (8 * MS, 9 * MS, "copy", 5)]
    ops = {1: [(0, 1 * MS, "aten::stft"), (4 * MS, 6 * MS, "decode"),
               (7 * MS, 8 * MS, "aten::copy_")]}
    return Trace(device, launches, spans, ops, 0, 10 * MS)


def test_trace_reduction():
    tr = small_trace()
    assert tr.window_s == pytest.approx(0.010)
    assert tr.busy_s == pytest.approx(0.006)
    assert tr.device_s("frontend") == pytest.approx(0.001)
    assert tr.device_s("encoder") == pytest.approx(0.002)
    assert tr.device_s("entry", outside=("frontend", "encoder")) == \
        pytest.approx(0.002)
    assert tr.span_count("encoder") == 1
    ops = dict(tr.device_ops())
    assert ops["beam"] == pytest.approx(0.002)
    gaps = dict(tr.idle_gaps())
    assert gaps["aten::stft"] == pytest.approx(0.001)       # before logmel
    assert gaps["decode"] == pytest.approx(0.001)           # before beam 2
    assert gaps["aten::copy_"] == pytest.approx(0.001)      # before copy
    assert gaps["window end"] == pytest.approx(0.001)


def read(name, info, trace):
    return env.metric_reader(name).read(info, trace)


def test_caption_readers():
    tr = small_trace()
    info = {"host_entry_s": [0.002, 0.004], "dtype": "float32",
            "peak_flops": 67e12, "frontend_work": [(67e12 * 0.5e-3, 0)],
            "decode_work": [(0, 3.35e12 * 1e-3)],
            "model_flops_per_s": 33.5e12}
    assert read("dispatch_ms.caption", info, tr) == pytest.approx(3.0)
    assert read("logmel_roofline.caption", info, tr) == pytest.approx(50.0)
    assert read("encoder_ms.caption", info, tr) == pytest.approx(2.0)
    assert read("decode_roofline.caption", info, tr) == pytest.approx(50.0)
    assert read("mfu.caption", info, tr) == pytest.approx(50.0)
    for cell in ("caption", "train", "serve"):
        assert read(f"idle_share.{cell}", info, tr) == pytest.approx(40.0)


def test_train_and_serve_readers():
    tr = small_trace()
    info = {"forward_ms": 120.0, "backward_ms": 80.0, "dtype": "float32",
            "peak_flops": 67e12, "frontend_work": [(67e12 * 0.25e-3, 0)],
            "model_flops_per_s": 6.7e12, "served": 300, "batches": 4}
    assert read("train_forward_ms", info, tr) == 120.0
    assert read("train_backward_ms", info, tr) == 80.0
    assert read("logmel_roofline.train", info, tr) == pytest.approx(25.0)
    assert read("mfu.train", info, tr) == pytest.approx(10.0)
    assert read("serve_batch_mean", info, tr) == pytest.approx(75.0)


def test_readers_return_nothing_without_data():
    empty = {"dtype": "float32", "peak_flops": 67e12}
    names = [m["name"] for m in env.benchmark_spec()["per_layer"]]
    for name in names:
        assert read(name, empty, None) is None, name


def test_every_metric_has_a_reader_and_every_cell_a_file():
    spec = env.benchmark_spec()
    for m in spec["per_layer"]:
        assert (env.BENCH / "metrics" / f"{m['name']}.py").exists()
    for w in spec["workloads"]:
        files = env.cell_files(w["name"])
        assert files["cell"] == w
        assert (env.BENCH / "traffic" /
                f"{files['workload']['kind']}.py").exists()
