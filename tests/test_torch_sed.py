"""The port's Cnn8-RNN SED model and host-side temporal-tag logic against
the JAX package.  Framewise probabilities: atol 1e-5 (float32 sums in
another order through four conv blocks and a BiGRU, then a sigmoid).
The numpy tag functions are copies and must give exactly equal
results."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocaption_tpu.models import export
from audiocaption_tpu.models import sed as JS
from audiocaption_tpu_torch.models import sed as TS

from test_torch_effb2 import jitter_bn

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sed_pair():
    """One JAX init (the weights do not depend on the frame count), batch
    norm statistics jittered, and the port model loaded from it."""
    model = JS.Cnn8RnnSedModel()
    v = jax.device_get(model.init(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 101, 64))))
    params, stats = dict(v["params"]), dict(v["batch_stats"])
    jitter_bn(params, stats, np.random.RandomState(0))
    sed = TS.Cnn8RnnSedModel().eval()
    sed.load_state_dict({k: torch.from_numpy(np.array(x)) for k, x in
                         export.cnn8rnn_state_dict(params, stats).items()})
    return model, {"params": params, "batch_stats": stats}, sed


@pytest.mark.parametrize("frames", [101, 64], ids=["pad_last", "exact"])
def test_sed_framewise_matches_jax(sed_pair, frames):
    model, v, sed = sed_pair
    rng = np.random.RandomState(frames)
    lms = (rng.randn(2, frames, 64) * 10 - 40).astype(np.float32)
    want = model.apply(v, jnp.asarray(lms))
    with torch.no_grad():
        got = sed(torch.from_numpy(lms))
    for key in ("segmentwise_output", "framewise_output"):
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-5, rtol=0, err_msg=key)
    assert got["framewise_output"].shape == (2, frames, 447)


def _probs(seed, shape):
    """Seeded framewise probabilities [B, T, C]: each class is active (0.9)
    over a random interval, or not at all, over a 0.1 floor, plus noise,
    so single, simultaneous and sequential events all occur."""
    rng = np.random.RandomState(seed)
    B, T, C = shape
    x = np.full(shape, 0.1)
    for b in range(B):
        for c in range(C):
            if rng.rand() < 0.5:
                start = rng.randint(0, T - 5)
                x[b, start:start + rng.randint(5, T // 2), c] = 0.9
    return x + 0.08 * rng.randn(*shape)


@pytest.mark.parametrize("seed", range(4))
def test_tag_functions_equal_jax(seed):
    x = _probs(seed, (4, 60, 4))
    for fn in ("find_contiguous_regions",):
        col = x[0, :, 0] > 0.5
        np.testing.assert_array_equal(getattr(TS, fn)(col),
                                      getattr(JS, fn)(col))
    np.testing.assert_array_equal(TS.double_threshold_1d(x[1, :, 2], 0.75, 0.25),
                                  JS.double_threshold_1d(x[1, :, 2], 0.75, 0.25))
    for arr in (x, x[0], x[0, :, 0]):
        np.testing.assert_array_equal(TS.double_threshold(arr, 0.75, 0.25),
                                      JS.double_threshold(arr, 0.75, 0.25))
    pairs = [(0, 3), (4, 6), (9, 12), (13, 20)]
    assert TS._connect(pairs, 1) == JS._connect(pairs, 1)
    segments = [(c, *sorted(np.random.RandomState(seed + c).rand(2)))
                for c in range(4)]
    assert TS.segments_to_temporal_tag(segments) == \
        JS.segments_to_temporal_tag(segments)
    got = TS.framewise_to_temporal_tags(x)
    np.testing.assert_array_equal(got, JS.framewise_to_temporal_tags(x))
    assert got.dtype == np.int32


def test_tags_cover_every_value():
    """The seeded inputs above reach all four tags."""
    tags = np.concatenate([TS.framewise_to_temporal_tags(_probs(s, (4, 60, 4)))
                           for s in range(4)])
    assert set(tags.tolist()) == {0, 1, 2, 3}
