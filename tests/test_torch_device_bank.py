"""The port's device-resident bank and prefetcher (``data/device_bank.py``,
``data/prefetch.py``) and the datasets' bank-row mode, on the CPU:

  * ``build_wav_bank`` / ``bank_rows`` equal to the JAX package's, bit for
    bit: float16 waves, int16 rows (/ 32768), ``[T, D]`` feature rows;
  * ``wav_index_mode`` items (``{wav_idx, wav_len}``) and the collate of
    ``[T, D]`` rows (padded on axis 0, by ``feature_bucket``, on the
    float16 wire);
  * ``.npy`` rows read with ``numpy.load``;
  * ``prefetch_to_device``: source order, ``(real, aug)`` pairs element by
    element, a worker's exception re-raised where its batch would come,
    and a consumer that stops early without a hang (each with its own
    timeout)."""

import csv
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audiocaption_tpu.data import device_bank as JB
from audiocaption_tpu.data import prefetch as JP
from audiocaption_tpu.data.collate import VarLenPadCollate as JCollate

from audiocaption_tpu_torch.data import device_bank as TB
from audiocaption_tpu_torch.data.collate import VarLenPadCollate
from audiocaption_tpu_torch.data.dataset import (
    CaptionDataset, InferenceDataset)
from audiocaption_tpu_torch.data.prefetch import prefetch_to_device

CPU = torch.device("cpu")


class Rows:
    """A dataset stand-in: ``audio_ids`` and ``get_audio``."""

    def __init__(self, rows):
        self.rows = rows
        self.audio_ids = [f"a{i}" for i in range(len(rows))]

    def get_audio(self, aid):
        return self.rows[int(aid[1:])]


def wave_rows(seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(n) * 0.3).astype(np.float16).astype(np.float32)
            for n in (1600, 1200, 1700, 400)]


def feature_rows(seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randn(n, 12).astype(np.float32) for n in (9, 4, 7)]


@pytest.mark.parametrize("kind", ["waves", "features"])
def test_build_wav_bank_matches_jax(kind):
    rows = wave_rows() if kind == "waves" else feature_rows()
    jbank, jlens = JB.build_wav_bank(Rows(rows))
    bank, lens = TB.build_wav_bank(Rows(rows), CPU)
    assert bank.dtype == torch.float16 and bank.device == CPU
    np.testing.assert_array_equal(lens, np.asarray(jlens))
    np.testing.assert_array_equal(bank.numpy(), np.asarray(jbank))
    idx = np.asarray([2, 0, 2], np.int32)
    got = TB.bank_rows(bank, torch.from_numpy(idx))
    want = np.asarray(JB.bank_rows(jbank, jnp.asarray(idx)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_bank_rows_widen_int16_and_bf16_as_jax():
    rng = np.random.RandomState(2)
    ints = rng.randint(-32768, 32767, (3, 50)).astype(np.int16)
    got = TB.bank_rows(torch.from_numpy(ints), torch.tensor([1, 2]))
    want = np.asarray(JB.bank_rows(jnp.asarray(ints), jnp.asarray([1, 2])))
    np.testing.assert_array_equal(got.numpy(), want)
    bf = torch.randn(4, 6).to(torch.bfloat16)
    got = TB.bank_rows(bf, torch.tensor([3]))
    want = np.asarray(JB.bank_rows(
        jnp.asarray(bf.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray([3])))
    np.testing.assert_array_equal(got.numpy(), want)


def write_npy_corpus(tmp_path, rows):
    (tmp_path / "f").mkdir()
    with open(tmp_path / "attn.csv", "w", newline="") as f:
        w = csv.writer(f, delimiter="\t")
        w.writerow(["audio_id", "file_name"])
        for i, r in enumerate(rows):
            path = tmp_path / "f" / f"a{i}.npy"
            np.save(path, r)
            w.writerow([f"a{i}", str(path)])
    caps = {"audios": [{"audio_id": f"a{i}", "captions": [
        {"caption": f"cap {i} {j}", "cap_id": j} for j in range(2)]}
        for i in range(len(rows))]}
    import json
    (tmp_path / "text.json").write_text(json.dumps(caps))
    return str(tmp_path / "attn.csv"), str(tmp_path / "text.json")


def test_npy_rows_and_wav_index_mode(tmp_path):
    rows = feature_rows()
    wav_csv, text = write_npy_corpus(tmp_path, rows)
    ds = CaptionDataset({"wav": wav_csv}, text)
    np.testing.assert_array_equal(ds[0]["wav"], rows[0])
    bank, lens = TB.build_wav_bank(ds, CPU)
    assert tuple(bank.shape) == (3, 9, 12)
    ds.enable_wav_index(lens)
    item = ds[3]
    assert set(item) == {"audio_id", "cap_id", "cap", "wav_idx", "wav_len"}
    assert item["audio_id"] == "a1" and int(item["wav_idx"]) == 1 and \
        int(item["wav_len"]) == 4
    inf = InferenceDataset({"wav": wav_csv})
    inf.enable_wav_index(lens)
    assert {k: int(v) if k != "audio_id" else v
            for k, v in inf[2].items()} == {"audio_id": "a2", "wav_idx": 2,
                                            "wav_len": 7}
    batch = VarLenPadCollate(pad_keys=["wav"])([inf[0], inf[2]])
    np.testing.assert_array_equal(batch["wav_idx"], [0, 2])
    np.testing.assert_array_equal(batch["wav_len"], [9, 7])
    assert "wav" not in batch


def test_feature_rows_collate_as_jax():
    """``[T, D]`` rows pad along axis 0 to a multiple of ``feature_bucket``
    frames (not the wave's sample bucket), on the float16 wire."""
    items = [{"audio_id": f"a{i}", "wav": r}
             for i, r in enumerate(feature_rows())]
    kw = dict(pad_keys=["wav"], buckets={"wav": 16000},
              wire_dtype={"wav": "float16"})
    got = VarLenPadCollate(**kw)(items)
    want = JCollate(**kw)(items)
    assert got["wav"].shape == (3, 16, 12) and got["wav"].dtype == np.float16
    for k in ("wav", "wav_len"):
        np.testing.assert_array_equal(got[k], want[k])


def _drain(it, timeout_s: float):
    """List ``it`` on a thread; fail if it takes over ``timeout_s``."""
    out, err = [], []

    def run():
        try:
            out.extend(it)
        except BaseException as exc:   # noqa: BLE001
            err.append(exc)
    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout_s)
    assert not t.is_alive(), "prefetch_to_device hung"
    return out, err


def batches(n=7):
    return [{"wav": np.full((2, 3), i, np.float32), "audio_id": [f"a{i}"],
             "cap": np.arange(4) + i} for i in range(n)]


def test_prefetch_keeps_source_order():
    src = batches()

    def slow():
        for i, b in enumerate(src):
            time.sleep(0.01 * (i % 3))
            yield b
    got, err = _drain(prefetch_to_device(slow(), CPU, depth=3), 10)
    assert not err
    assert [int(b["wav"][0, 0]) for b in got] == list(range(7))
    assert all(torch.is_tensor(b["wav"]) and b["audio_id"] == [f"a{i}"]
               for i, b in enumerate(got))
    # the JAX prefetcher over the same source gives the same batches
    jgot = list(JP.prefetch_to_device(iter(src)))
    for b, j in zip(got, jgot):
        np.testing.assert_array_equal(b["cap"].numpy(), np.asarray(j["cap"]))


def test_prefetch_transfers_pairs_element_by_element():
    src = [(a, b) for a, b in zip(batches(3), batches(3)[::-1])]
    seen = []
    got, err = _drain(prefetch_to_device(
        iter(src), CPU, transform=lambda p: (seen.append(1) or p)), 10)
    assert not err and len(seen) == 3
    for (real, aug), i in zip(got, range(3)):
        assert torch.is_tensor(real["wav"]) and torch.is_tensor(aug["wav"])
        assert int(real["wav"][0, 0]) == i and int(aug["wav"][0, 0]) == 2 - i


def test_prefetch_reraises_a_worker_exception():
    def failing():
        yield from batches(2)
        raise KeyError("bad batch")
    got, err = _drain(prefetch_to_device(failing(), CPU), 10)
    assert len(got) == 2 and len(err) == 1 and isinstance(err[0], KeyError)


def test_prefetch_early_break_stops_the_worker():
    """A consumer that breaks off leaves no worker blocked on the full
    queue: the generator closes, the worker thread ends."""
    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield {"wav": np.zeros(2, np.float32) + i}
            i += 1

    def consume():
        it = prefetch_to_device(endless(), CPU, depth=2)
        for b in it:
            if int(b["wav"][0]) == 3:
                break
        it.close()
    before = {t.ident for t in threading.enumerate()}
    consumer = threading.Thread(target=consume, daemon=True)
    consumer.start()
    consumer.join(10)
    assert not consumer.is_alive(), "the consumer hung"
    deadline = time.time() + 10
    while time.time() < deadline:
        workers = [t for t in threading.enumerate()
                   if t.name == "prefetch_to_device"
                   and t.ident not in before]
        if not workers:
            break
        time.sleep(0.05)
    assert not workers, "the prefetch worker still runs"
    assert len(produced) < 20
