"""The port's native CIDEr-D scorer (``audiocaption_tpu_torch/native``,
its own copy of ``cider.cc`` built with g++ into ``build/native/``)
against its plain version (``metrics.cider.CiderD``) and against the JAX
package's ``FastCiderD``, rtol 1e-6 (as ``tests/test_native.py`` holds
the JAX scorer to its Python one).  A failed build raises, naming the
compiler's error: no fallback."""

import numpy as np
import pytest

from audiocaption_tpu.native import FastCiderD as JFastCiderD

from audiocaption_tpu_torch import native
from audiocaption_tpu_torch.metrics.cider import CiderD
from audiocaption_tpu_torch.native import FastCiderD


def corpus(seed: int, n_keys: int = 30, n_words: int = 40):
    rng = np.random.RandomState(seed)
    vocab = [f"w{i}" for i in range(n_words)]
    refs, preds = {}, {}
    for i in range(n_keys):
        k = f"k{i}"
        refs[k] = [" ".join(rng.choice(vocab, rng.randint(4, 12)))
                   for _ in range(rng.randint(2, 5))]
        preds[k] = [" ".join(rng.choice(vocab, rng.randint(1, 12)))]
    preds["k0"] = [refs["k0"][0]]         # one exact hit
    preds["k1"] = [""]                    # an empty caption
    return refs, preds


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fast_cider_matches_plain_and_jax(seed):
    refs, preds = corpus(seed)
    want_mean, want = CiderD().compute_score(refs, preds)
    got_mean, got = FastCiderD().compute_score(refs, preds)
    j_mean, j = JFastCiderD().compute_score(refs, preds)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(got, j, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(got_mean, want_mean, rtol=1e-6)
    assert got[0] > 0 and got[1] == 0


def test_library_lives_in_build_not_beside_the_source():
    path = native.library_path()
    FastCiderD().compute_score({"a": ["x y"]}, {"a": ["x y"]})
    assert path.is_file() and path.parent == native.BUILD_DIR
    assert path.parent != native.SOURCE.parent
    assert not list(native.SOURCE.parent.glob("*.so"))


def test_failed_build_raises():
    scorer = FastCiderD(compiler="/nonexistent/g++")
    with pytest.raises(RuntimeError, match="cider.cc failed"):
        scorer.compute_score({"a": ["x"]}, {"a": ["x"]})


def test_n_other_than_4_raises():
    with pytest.raises(ValueError, match="n = 4"):
        FastCiderD(n=3)
