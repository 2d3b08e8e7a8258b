"""The port's own spans (``utils/profiling.py::span`` / ``sync``) and the
server's counters, on the CPU.

  * with no profiler session, ``span`` and ``sync`` never call
    ``record_function``, on their own and on the program's paths that
    open them (a train step, a fused beam decode, the server), and no
    other module of the port names it;
  * under a ``torch.profiler`` session one scheduled-sampling train step
    of a small cnn14rnn_trm-shaped captioner (a linear stand-in for the
    Cnn14, the recipe's 3-layer BiGRU with dropout, an untied
    transformer decoder) records ``ac.train.forward`` holding
    ``ac.ss_loop`` and ``ac.sync.gru_lengths``, then
    ``ac.train.backward``, then ``ac.train.optimizer`` holding
    ``ac.sync.finite_check``, each once, and its loss and updated
    parameters equal the unprofiled step's exactly;
  * a beam decode records the frontend, encoder, memory K/V and search
    spans once each, in that order;
  * a GRU handed only its lengths as a tensor (``HmClassifier``'s) reads
    them itself, in ``ac.sync.gru_lengths_read``;
  * ``MicroBatchServer`` counts served requests, padding rows and queue
    wait, and ``profiling.trace`` records its threads' spans."""

import copy
import json
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from audiocaption_tpu_torch.decoding.fused_beam import FusedBeamDecoder
from audiocaption_tpu_torch.losses.loss import build_loss
from audiocaption_tpu_torch.models.captioner import Captioner
from audiocaption_tpu_torch.models.hm_classifier import HmClassifier
from audiocaption_tpu_torch.models.layers import HostLengths
from audiocaption_tpu_torch.models.rnn_encoder import RnnEncoder
from audiocaption_tpu_torch.models.transformer_decoder import (
    TransformerDecoder)
from audiocaption_tpu_torch.ops.frontend import CNN14_MEL_32K
from audiocaption_tpu_torch.optim.schedules import (
    exponential_decay_with_warmup)
from audiocaption_tpu_torch.serving import MicroBatchServer
from audiocaption_tpu_torch.training.trainer import (create_train_state,
                                                     train_step)
from audiocaption_tpu_torch.utils import profiling as P

torch.set_num_threads(2)

V, SR = 40, 32000


class TinyCrnn(nn.Module):
    """A linear map of the mel bins pooled 4x in time (the Cnn14's place),
    then the recipe's 3-layer BiGRU with dropout 0.5, its lengths handed
    down as ``Cnn14RnnEncoder`` hands them (copied before the "CNN")."""

    def __init__(self, n_mels: int = 64, width: int = 24, hidden: int = 16):
        super().__init__()
        self.cnn = nn.Linear(n_mels, width)
        self.rnn = RnnEncoder(width, hidden, 3, True, 0.5)
        self.fc_emb_size = self.rnn.out_size

    @staticmethod
    def out_len(feat_len):
        return torch.div(feat_len, 4, rounding_mode="floor")

    def forward(self, lms, feat_len):
        host_len = HostLengths(feat_len, self.out_len)
        x = F.avg_pool1d(self.cnn(lms).transpose(1, 2), 4).transpose(1, 2)
        return self.rnn(x, self.out_len(feat_len), host_len)


def tiny_captioner(seed: int = 0) -> Captioner:
    torch.manual_seed(seed)
    enc = TinyCrnn()
    dec = TransformerDecoder(emb_dim=32, vocab_size=V,
                             attn_emb_dim=enc.fc_emb_size, nlayers=2,
                             nhead=4, dim_feedforward=64, tie_weights=False,
                             dropout=0.2)
    return Captioner(enc, dec, CNN14_MEL_32K)


def batch():
    g = torch.Generator().manual_seed(3)
    wav = torch.randn(2, SR // 2, generator=g) * 0.1
    cap = torch.randint(3, V, (2, 7), generator=g)
    cap[:, 0], cap[1, 5:] = 1, 0
    cap[0, 6], cap[1, 4] = 2, 2
    return {"wav": wav, "wav_len": torch.tensor([SR // 2, SR // 3]),
            "cap": cap, "cap_len": torch.tensor([7, 5])}


def state_of(model):
    return create_train_state(
        model, 5e-4, exponential_decay_with_warmup(5e-4, 5e-7, 100, 20),
        1e-6, 1.0)


def run_step(state, seed: int = 11):
    """One scheduled-sampling step (ratio 0.5) with seeded dropout."""
    torch.manual_seed(seed)
    loss_fn = build_loss({"type": "LabelSmoothingLoss",
                          "args": {"smoothing": 0.1}})
    return train_step(state, loss_fn, batch(),
                      ss_ratio=torch.tensor(0.5),
                      generator=torch.Generator().manual_seed(seed))


def annotations(prof):
    """The profiler's user annotations named ``ac.*``: [(name, start ns,
    end ns, thread)] in start order."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
            e.start_thread_id())
           for e in prof.profiler.kineto_results.events()
           if e.is_user_annotation() and e.name().startswith("ac.")]
    return sorted(out, key=lambda a: a[1])


def inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_recording_follows_the_profiler():
    assert not P.recording()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert P.recording()
    assert not P.recording()


def _raise(*args, **kwargs):
    raise AssertionError("record_function called with no profiler on")


def _helpers():
    with P.span("ac.x"), P.sync("y"):
        pass
    # the program reaches the profiler through ``span`` alone
    package = Path(P.__file__).resolve().parent.parent
    users = sorted(str(f.relative_to(package)) for f in package.rglob("*.py")
                   if "record_function" in f.read_text())
    assert users == ["utils/profiling.py"], users


def _train():
    run_step(state_of(tiny_captioner()))


def _decode():
    model = tiny_captioner().eval()
    b = batch()
    FusedBeamDecoder(model, max_length=5, beam_size=2, device="cpu")(
        b["wav"], b["wav_len"])


def _serve():
    with MicroBatchServer(lambda w, n: torch.zeros(len(n), 3),
                          max_batch=4, max_samples=8) as srv:
        srv.submit(np.zeros(8, np.float32)).result(timeout=30)


@pytest.mark.parametrize("path", [_helpers, _train, _decode, _serve],
                         ids=["helpers", "train_step", "beam_decode",
                              "server"])
def test_no_record_function_without_a_profiler(monkeypatch, path):
    # the name ``span`` calls; torch's own optimizer calls
    # ``torch.autograd.profiler.record_function`` whatever the program does
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    assert P.span("ac.x") is P.sync("y")       # the one shared no-op
    path()


def test_train_step_spans_and_results_under_the_profiler():
    model = tiny_captioner()
    plain_state = state_of(copy.deepcopy(model))
    traced_state = state_of(model)
    want = run_step(plain_state)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = run_step(traced_state)
    spans = annotations(prof)
    names = [s[0] for s in spans]
    for name in ("ac.train.forward", "ac.ss_loop", "ac.sync.gru_lengths",
                 "ac.train.backward", "ac.train.optimizer",
                 "ac.sync.finite_check", "ac.frontend", "ac.encoder"):
        assert names.count(name) == 1, (name, names)
    assert "ac.sync.gru_lengths_read" not in names
    by = {s[0]: s for s in spans}
    for inner in ("ac.frontend", "ac.encoder", "ac.sync.gru_lengths",
                  "ac.ss_loop"):
        assert inside(by[inner], by["ac.train.forward"]), inner
    assert inside(by["ac.sync.gru_lengths"], by["ac.encoder"])
    assert inside(by["ac.sync.finite_check"], by["ac.train.optimizer"])
    assert by["ac.train.forward"][2] <= by["ac.train.backward"][1]
    assert by["ac.train.backward"][2] <= by["ac.train.optimizer"][1]
    assert torch.equal(got["loss"], want["loss"])
    assert torch.equal(got["grad_norm"], want["grad_norm"])
    assert not got["skipped"]
    for (n, a), b in zip(traced_state.model.named_parameters(),
                         plain_state.model.parameters()):
        assert torch.equal(a, b), n


def test_beam_decode_spans_under_the_profiler():
    model = tiny_captioner().eval()
    b = batch()
    dec = FusedBeamDecoder(model, max_length=5, beam_size=2, device="cpu")
    want = dec(b["wav"], b["wav_len"])
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = dec(b["wav"], b["wav_len"])
    assert torch.equal(got, want)
    names = [s[0] for s in annotations(prof)]
    assert names == ["ac.frontend", "ac.encoder", "ac.sync.gru_lengths",
                     "ac.decode.memory_kv", "ac.decode.search"], names


def test_hm_classifier_gru_reads_its_lengths_itself():
    """``HmClassifier``'s GRU gets its caption lengths as a tensor only,
    so it reads them itself: one ``ac.sync.gru_lengths_read``, no
    ``ac.sync.gru_lengths``; the logits are the unprofiled ones."""
    torch.manual_seed(0)
    clf = HmClassifier(V, emb_dim=16, hidden_size=8).eval()
    cap = torch.randint(3, V, (3, 6), generator=torch.Generator()
                        .manual_seed(1))
    cap_len = torch.tensor([6, 2, 4])
    with torch.no_grad():
        want = clf(cap, cap_len)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            got = clf(cap, cap_len)
    assert torch.equal(got, want)
    names = [s[0] for s in annotations(prof)]
    assert names == ["ac.sync.gru_lengths_read"], names


def test_server_counts_requests_padding_and_queue_wait():
    gate = threading.Event()
    calls = []

    def decode(wav, lens):
        gate.wait(30)          # hold the first batch until all are queued
        calls.append(len(lens))
        return torch.as_tensor(lens)[:, None].repeat(1, 2)

    t0 = time.perf_counter()
    with MicroBatchServer(decode, max_batch=4, max_wait_ms=1.0,
                          max_samples=16, batch_buckets=(1, 4),
                          max_inflight=1) as srv:
        futs = [srv.submit(np.ones(3 + i, np.float32)) for i in range(6)]
        time.sleep(0.2)
        gate.set()
        rows = [f.result(timeout=30) for f in futs]
        elapsed = time.perf_counter() - t0
        assert srv.served_requests == 6
        assert srv.dispatched_batches == len(calls)
        # every dispatch is padded to its bucket, 1 or 4
        assert srv.padded_rows == sum(calls) - 6
        assert 0 < srv.queue_wait_s <= 6 * elapsed
        # the first request waited for the gate before its dispatch
        # returned, the later ones for the first batch's slot
        assert srv.queue_wait_s / srv.served_requests > 0.05
    assert [int(r[0]) for r in rows] == [3 + i for i in range(6)]


def test_trace_records_the_server_threads_spans(tmp_path):
    # the server's threads start before the session does
    with MicroBatchServer(lambda w, n: torch.zeros(len(n), 3),
                          max_batch=4, max_samples=8) as srv:
        with P.trace(str(tmp_path)):
            srv.submit(np.zeros(8, np.float32)).result(timeout=30)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"ac.serve.pad", "ac.serve.dispatch",
            "ac.serve.resolve"} <= names, sorted(
        n for n in names if n and n.startswith("ac."))
