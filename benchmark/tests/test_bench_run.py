"""``run.py`` fails, printing no result, without a card and in a checkout
that holds only the benchmark."""

import shutil
import subprocess
import sys

import pytest

from harness import env

ARGS = ["--workload", "effb2_trm.caption_b64", "--seed", "3000000001",
        "--seconds", "1", "--trace", "0"]


def no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible")


def test_fails_without_a_card():
    no_card()
    out = subprocess.run([sys.executable, "benchmark/run.py", *ARGS],
                         cwd=env.ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


def test_fails_with_only_the_benchmark(tmp_path):
    shutil.copy(env.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(env.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", *ARGS],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
