"""A run with the timed path broken underneath reads ``correct`` false:
for each fault a cell can have (one chip, so no exchange between chips
to leave out).  Small cells on the CPU, the card check skipped."""

import pytest

import control
import run

CAPTION = {"batch": 2, "pool_batches": 2, "check_batches": 1,
           "lengths": {"full_s": 2, "full_share": 0.5, "short_s": [1, 2]}}
CLOTHO = {"batch": 2, "pool_batches": 2, "check_batches": 1,
          "lengths": {"uniform_s": [1, 2]}}
SERVE = {"rate": 3, "pool_clips": 4, "check_requests": 3, "grace_s": 30,
         "lengths": {"full_s": 1, "full_share": 0.5, "short_s": [0.5, 1]},
         "server": {"max_batch": 4, "max_wait_ms": 5.0, "max_inflight": 2,
                    "wire": "i16", "max_samples": 16000}}
TRAIN = {"pool_batches": 4, "lengths": {"uniform_s": [1, 2]},
         "words": [3, 5]}
CELLS = {"effb2_trm.caption_b64": ({}, CAPTION),
         "cnn14rnn_trm.caption_clotho": ({}, CLOTHO),
         "effb2_trm.serve_poisson": ({}, SERVE),
         "cnn14rnn_trm.train_clotho": ({"batch_size": 4}, TRAIN)}
CASES = [("effb2_trm.caption_b64", "token"),
         ("cnn14rnn_trm.caption_clotho", "token"),
         ("effb2_trm.serve_poisson", "token"),
         ("effb2_trm.caption_b64", "beam1"),
         ("cnn14rnn_trm.caption_clotho", "beam1"),
         ("effb2_trm.serve_poisson", "beam1"),
         ("cnn14rnn_trm.train_clotho", "half_batch"),
         ("cnn14rnn_trm.train_clotho", "frozen")]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(cell):
    config, params = CELLS[cell]
    line, checks = run.run_cell(cell, 3000000007, 1.0, False, "cpu",
                                config, params)
    assert line["correct"], checks


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_caught(cell, fault):
    config, params = CELLS[cell]
    checks = control.fault_checks(cell, 3000000007, fault, 1.0, "cpu",
                                  config, params)
    assert any(v > limit for _, v, limit in checks), checks


@pytest.mark.cuda
def test_control_fails_on_the_card(card):
    """The control at a size a test run holds: the TF32 reference fails."""
    for cell, (config, params) in CELLS.items():
        if "serve" in cell:
            continue
        checks = control.control_checks(cell, 3000000007, "cuda", config,
                                        params)
        assert any(v > limit for _, v, limit in checks), (cell, checks)
