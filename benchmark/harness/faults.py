"""Faults planted in the program underneath a run, to see that the
comparison catches them: a token altered where it is produced, a beam
search run with one beam where the cell asks for more, half of a
training batch left out (the mean over the rest), a training step that
leaves its state unchanged.  Each is a context manager that
patches the program's entry for the duration."""

from __future__ import annotations

import contextlib

import torch


def _alter(ids: torch.Tensor, vocab: int) -> torch.Tensor:
    ids = ids.clone()
    ids[:, 1] = (ids[:, 1] + 1) % vocab
    return ids


@contextlib.contextmanager
def token(vocab: int):
    """Every served caption's second token moved to the next word."""
    from audiocaption_tpu_torch import hf_api
    from audiocaption_tpu_torch.decoding import select
    api_decode = hf_api.Effb2TrmCaptioningModel.decode
    loader_call = select.LoaderDecoder.__call__

    def decode(self, *a, **k):
        return _alter(api_decode(self, *a, **k), vocab)

    def call(self, *a, **k):
        return _alter(loader_call(self, *a, **k), vocab)
    hf_api.Effb2TrmCaptioningModel.decode = decode
    select.LoaderDecoder.__call__ = call
    try:
        yield
    finally:
        hf_api.Effb2TrmCaptioningModel.decode = api_decode
        select.LoaderDecoder.__call__ = loader_call


@contextlib.contextmanager
def beam1():
    """Every caption decoded with beam size 1, whatever the call asks."""
    from audiocaption_tpu_torch import hf_api
    from audiocaption_tpu_torch.decoding import select
    api_decode = hf_api.Effb2TrmCaptioningModel.decode
    loader_call = select.LoaderDecoder.__call__

    def decode(self, audio, audio_length, sample_method="beam", beam_size=3,
               *a, **k):
        return api_decode(self, audio, audio_length, sample_method, 1, *a,
                          **k)

    def call(self, *a, **k):
        return loader_call(self, *a, **dict(k, beam_size=1))
    hf_api.Effb2TrmCaptioningModel.decode = decode
    select.LoaderDecoder.__call__ = call
    try:
        yield
    finally:
        hf_api.Effb2TrmCaptioningModel.decode = api_decode
        select.LoaderDecoder.__call__ = loader_call


@contextlib.contextmanager
def half_batch():
    """Each training step sees the first half of its batch only."""
    from audiocaption_tpu_torch.training import trainer
    step = trainer.train_step

    def half(state, loss_fn, batch, *a, **k):
        n = batch["cap"].shape[0] // 2
        return step(state, loss_fn, {key: v[:n] for key, v in batch.items()},
                    *a, **k)
    trainer.train_step = half
    try:
        yield
    finally:
        trainer.train_step = step


@contextlib.contextmanager
def frozen():
    """Each training step leaves the parameters and Adam's state as they
    were."""
    from audiocaption_tpu_torch.training import trainer
    step = trainer.train_step

    def unchanged(state, *a, **k):
        params = [p.detach().clone() for p in state.params]
        opt = {id(p): {k_: (v.clone() if torch.is_tensor(v) else v)
                       for k_, v in s.items()}
               for p, s in state.optimizer.state.items()}
        out = step(state, *a, **k)
        with torch.no_grad():
            for p, old in zip(state.params, params):
                p.copy_(old)
        for p in list(state.optimizer.state):
            if id(p) in opt:
                state.optimizer.state[p] = opt[id(p)]
            else:
                del state.optimizer.state[p]
        return out
    trainer.train_step = unchanged
    try:
        yield
    finally:
        trainer.train_step = step


FAULTS = {"token": token, "beam1": beam1, "half_batch": half_batch,
          "frozen": frozen}


def plant(name: str, config) -> contextlib.AbstractContextManager:
    return FAULTS[name](config["vocab_size"]) if name == "token" \
        else FAULTS[name]()
