"""The no-JAX check compares whole top-level module names."""

import subprocess
import sys
import types

from harness import env


def test_port_name_passes_and_jax_names_fail(monkeypatch):
    for name in ("audiocaption_tpu_torch", "audiocaption_tpu_torch.models",
                 "jaxtyping_like", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert not [m for m in env.forbidden_modules()
                if m.startswith(("audiocaption_tpu_torch", "jaxtyping",
                                 "flaxen"))]
    for name in ("jax", "jaxlib.xla_client", "flax.linen", "optax",
                 "audiocaption_tpu", "audiocaption_tpu.models.zoo"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
        assert name in env.forbidden_modules()


def test_harness_and_reference_load_no_jax():
    code = ("import sys; sys.path[:0] = ['benchmark', '.']\n"
            "from harness import env, judge, models, seeded, trace\n"
            "import reference.effb2_trm, reference.cnn14rnn_trm\n"
            "import roofline.flops\n"
            "for k in ('batch_caption', 'train_step', 'serve_poisson'):\n"
            "    env.traffic_kind(k)\n"
            "bad = env.forbidden_modules()\n"
            "assert not bad, bad\n"
            "assert not [m for m in sys.modules\n"
            "            if m.split('.')[0] == 'audiocaption_tpu_torch'\n"
            "            and 'reference' in sys.modules]\n")
    subprocess.run([sys.executable, "-c", code], cwd=env.ROOT, check=True)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = ['benchmark']\n"
            "import reference.common, reference.effb2_trm\n"
            "import reference.cnn14rnn_trm\n"
            "names = {m.split('.')[0] for m in sys.modules}\n"
            "assert 'audiocaption_tpu_torch' not in names\n"
            "assert not names & {'jax', 'jaxlib', 'flax', 'audiocaption_tpu'}\n")
    subprocess.run([sys.executable, "-c", code], cwd=env.ROOT, check=True)
