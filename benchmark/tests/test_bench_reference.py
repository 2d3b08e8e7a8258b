"""The plain reference against the port's plain CPU path at small sizes,
with the same seeded weights: the log-mel, each encoder, the decoder,
and the beam search (through a whole small run of each cell, which
compares every served caption)."""

import numpy as np
import pytest
import torch

from harness import models, seeded
from reference import cnn14rnn_trm as ref_cnn, effb2_trm as ref_eff
from reference.common import log_mel

torch.set_num_threads(4)


def wave(n=2, samples=24000, sr=16000, seed=1):
    lens = [samples, samples * 2 // 3][:n]
    return (seeded.audio(lens, samples, sr, seeded.device_gen(seed, "audio",
                                                              "cpu")),
            torch.as_tensor(lens))


@pytest.mark.parametrize("name", ["EFFB2_MEL_16K", "CNN14_MEL_32K"])
def test_log_mel(name):
    from audiocaption_tpu_torch.ops import frontend
    mel = ref_eff.MEL if name.startswith("EFFB2") else ref_cnn.MEL
    wav, _ = wave(sr=mel.sample_rate, samples=mel.sample_rate)
    port = frontend.LogMelFrontend(getattr(frontend, name))(wav)
    ref = log_mel(wav, mel)
    assert port.shape == ref.shape
    assert torch.allclose(port, ref, atol=2e-3), (port - ref).abs().max()


def config(name):
    from harness import env
    return env.read_json(env.BENCH / "configs" / f"{name}.json")


@pytest.mark.parametrize("name", ["effb2_trm", "cnn14rnn_trm"])
def test_encoder_and_decoder(name):
    cfg = config(name)
    weights = models.seeded_weights(cfg, 5, "cpu")
    port = models.program_model(cfg, weights, "cpu")
    ref = models.reference_model(cfg, weights, "cpu")
    wav, lens = wave(sr=cfg["sample_rate"], samples=cfg["sample_rate"] * 2)
    with torch.no_grad():
        enc = port.encode(wav, lens)
        mem, mask = ref.encode(wav, lens)
        static, _ = port.decoder.init_cache(enc["attn_emb"],
                                            enc["attn_emb_len"], 1)
        assert torch.equal(static["mem_kpm"], mask)
        words = torch.randint(3, cfg["vocab_size"], (2, 6))
        words[:, 0] = 1
        words[1, 4] = 0                     # a pad inside the prefix
        out = port.decoder(words, enc["attn_emb"], enc["attn_emb_len"],
                           cap_padding_mask=words == 0)
        logits, _ = ref.decoder(words, mem, mask)
    scale = logits.abs().max()
    assert (out["logit"] - logits).abs().max() <= 1e-4 * scale


@pytest.mark.parametrize("cell,config_,params", [
    ("effb2_trm.caption_b64", {}, {"batch": 2, "pool_batches": 1,
                                   "check_batches": 1,
                                   "lengths": {"full_s": 2, "full_share": 0.5,
                                               "short_s": [1, 2]}}),
    ("cnn14rnn_trm.caption_clotho", {}, {"batch": 2, "pool_batches": 1,
                                         "check_batches": 1,
                                         "lengths": {"uniform_s": [1, 2]}}),
    ("cnn14rnn_trm.train_clotho", {"batch_size": 3},
     {"pool_batches": 3, "lengths": {"uniform_s": [1, 2]}, "words": [3, 6]})])
def test_small_run_agrees(cell, config_, params):
    import run
    line, checks = run.run_cell(cell, 3000000017, 0.5, False, "cpu",
                                config_, params)
    for name, value, _ in checks:
        assert value <= 1e-4, checks
