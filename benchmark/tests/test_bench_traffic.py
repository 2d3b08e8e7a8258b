"""The traffic generators repeat exactly from a seed, and every seed gets
the same sizes in another order."""

import numpy as np
import pytest
import torch

from harness import seeded

SEEDS = [7, 3000000021, 2 ** 40 + 5]


@pytest.mark.parametrize("spec", [
    {"full_s": 10, "full_share": 0.9, "short_s": [3, 10]},
    {"uniform_s": [15, 30]}])
def test_clip_lengths_repeat_and_share_sizes(spec):
    runs = [seeded.clip_lengths(128, spec, 16000, s) for s in SEEDS]
    assert np.array_equal(runs[0], seeded.clip_lengths(128, spec, 16000,
                                                       SEEDS[0]))
    assert not np.array_equal(runs[0], runs[1])
    for r in runs[1:]:
        assert np.array_equal(np.sort(r), np.sort(runs[0]))


def test_full_share_and_range():
    n = seeded.clip_lengths(640, {"full_s": 10, "full_share": 0.9,
                                  "short_s": [3, 10]}, 16000, 1)
    assert (n == 160000).sum() == 576
    assert n.min() >= 3 * 16000 and n.max() <= 160000


def test_captions_repeat_and_are_framed():
    a, la = seeded.captions(64, (8, 20), 4368, 11)
    b, lb = seeded.captions(64, (8, 20), 4368, 11)
    c, lc = seeded.captions(64, (8, 20), 4368, 12)
    assert np.array_equal(a, b) and np.array_equal(la, lb)
    assert np.array_equal(np.sort(la), np.sort(lc))
    assert la.min() == 10 and la.max() == 22
    for row, n in zip(a, la):
        assert row[0] == 1 and row[n - 1] == 2 and (row[n:] == 0).all()
        assert ((row[1:n - 1] >= 3) & (row[1:n - 1] < 4368)).all()


def test_audio_repeats_and_is_silent_past_its_length():
    lens = [1000, 3000, 4000]
    x = seeded.audio(lens, 4000, 16000, seeded.device_gen(5, "audio", "cpu"))
    y = seeded.audio(lens, 4000, 16000, seeded.device_gen(5, "audio", "cpu"))
    z = seeded.audio(lens, 4000, 16000, seeded.device_gen(6, "audio", "cpu"))
    assert torch.equal(x, y) and not torch.equal(x, z)
    assert (x[0, 1000:] == 0).all() and (x[1, 3000:] == 0).all()
    assert x.abs().max() < 1.0 and x[2].abs().max() > 0.01
    assert seeded.to_int16(x).dtype == torch.int16


def test_arrivals_repeat_with_the_same_gaps():
    from traffic_import import serve
    d1, c1 = serve.offered(1000.0, 2.0, 3, 512)
    d2, c2 = serve.offered(1000.0, 2.0, 3, 512)
    d3, _ = serve.offered(1000.0, 2.0, 4, 512)
    assert np.array_equal(d1, d2) and np.array_equal(c1, c2)
    assert len(d1) == 2000 and d1[0] == 0.0
    g1, g3 = np.diff(d1), np.diff(d3)
    assert not np.array_equal(g1, g3)
    # the same gaps in another order: the window's span barely differs
    assert abs(d1[-1] - d3[-1]) < 0.01
    assert abs(d1[-1] - 2.0) < 0.05


def test_sub_seeds_take_large_seeds():
    assert seeded.sub_seed(2 ** 33 + 1, "audio") != seeded.sub_seed(1, "audio")
    assert seeded.sub_seed(2 ** 33 + 1, "audio") < 2 ** 63


def test_coins_repeat():
    from traffic_import import train
    pool = [{"cap": torch.zeros(2, 12, dtype=torch.long)}] * 3
    a = train.coins(9, pool, 3, 0.85)
    assert a == train.coins(9, pool, 3, 0.85)
    assert len(a) == 3 and all(len(c) == 11 for c in a)
    flat = [x for c in a for x in c]
    assert 0 < sum(flat) < len(flat) or len(flat) < 20
