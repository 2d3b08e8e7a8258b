"""The roofline and FLOP arithmetic against hand counts at small shapes."""


import numpy as np
import pytest
import torch

from roofline import flops, work


def test_logmel_work_by_hand():
    fb = np.zeros((5, 2), np.float32)
    fb[1, 0] = fb[2, 0] = fb[2, 1] = 1.0        # 3 weights on 2 bins
    f, b = work.logmel_work(n_fft=8, hop=4, n_mels=2, fb=fb, batch=2,
                            samples=16)
    frames = 16 // 4 + 1
    per = 8 + 2.5 * 8 * 3 + 3 * 2 + 2 * 3 + 2 * 2
    assert f == int(2 * frames * per)
    assert b == 4 * (2 * 16 + 8 + 3 + 2 * frames * 2)


def test_decode_flops_by_hand():
    mm, attn = work.decode_flops(E=2, F=3, V=5, S_valid=[4, 0], steps=[2, 1],
                                 rows_per_sample=3, layers=1, S=6)
    per = 1 * 2 * (6 * 4 + 2 * 2 * 3) + 2 * 5 * 2
    assert mm == 3 * per * 3
    attn_hand = 3 * 1 * 2 * 2 * 2 * ((1 + 4) + (2 + 4) + (1 + 6))
    assert attn == attn_hand


def test_memory_kv_and_bound():
    f, b = work.memory_kv_work(batch=2, S=3, D=4, E=5, layers=2)
    assert f == 2 * 2 * 3 * 4 * 5 + 2 * 2 * 2 * 2 * 3 * 5 * 5
    assert b == 4 * (2 * 3 * 4 + 4 * 5 + 3 * 5 + 2 * 2 * (25 + 5)
                     + 2 * 2 * 2 * 3 * 5)
    assert work.bound_s(67e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 3.35e12) == pytest.approx(1.0)


def test_gru_flops_by_hand():
    assert flops.gru_flops(10, 4, 3, 2) == \
        2 * 10 * 2 * 3 * 3 * (4 + 3) + 2 * 10 * 2 * 3 * 3 * (6 + 3)


def test_cnn14_count_matches_the_convolutions():
    cfg = {"reference": "cnn14rnn_trm", "rnn_hidden_size": 8,
           "rnn_num_layers": 1, "decoder_emb_dim": 64, "vocab_size": 10,
           "decoder_n_layers": 1, "decoder_tie_weights": False,
           "rnn_dropout": 0.5, "decoder_dropout": 0.2}
    samples = 32000 * 2
    got = flops.encoder_flops(cfg, samples)
    T, M = samples // 320 + 1, 64
    hand, cin = 0, 1
    for i, c in enumerate((64, 128, 256, 512, 1024, 2048)):
        hand += 2 * 9 * (cin * c + c * c) * T * M
        cin = c
        if i < 5:
            T, M = T // 2, M // 2
    assert got["cnn"] == hand
    assert got["rnn"] == flops.gru_flops((samples // 320 + 1) // 32, 2048, 8, 1)


def test_decoder_count_by_hand():
    cfg = {"reference": "cnn14rnn_trm", "rnn_hidden_size": 8,
           "rnn_num_layers": 1, "decoder_emb_dim": 64, "vocab_size": 10,
           "decoder_n_layers": 1, "decoder_tie_weights": False,
           "rnn_dropout": 0.5, "decoder_dropout": 0.2,
           "memory_dim": 16, "beam_size": 3, "max_length": 20}
    m = flops.model(cfg)
    mem = torch.empty(1, 5, 16, device="meta")
    w = torch.zeros(1, 4, dtype=torch.long, device="meta")

    def dec():
        memory, mask = m.decoder.memory(mem, torch.tensor([5], device="meta"))
        m.decoder(w, memory, mask)
    E, T, S = 64, 4, 5
    hand = (2 * S * 16 * E                       # memory projection
            + 2 * T * E * 3 * E + 2 * T * T * E * 2 + 2 * T * E * E  # self
            + 2 * T * E * E + 2 * S * E * 2 * E + 2 * T * S * E * 2
            + 2 * T * E * E                      # cross
            + 2 * T * E * 4 * E * 2              # FFN
            + 2 * T * E * 10)                    # classifier
    assert flops.count(dec) == hand
