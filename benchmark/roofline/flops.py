"""Model FLOPs of the reference at a cell's shapes, behind ``mfu``.

The encoders' convolutions and products are counted by
``FlopCounterMode`` on the meta device (no memory, no time on the card);
the GRU, which it does not count, in closed form; the log-mel by
``work.logmel_work``.  Two FLOPs a multiply-add; elementwise work and
normalisation are not counted, so ``mfu`` understates the card's work."""

from __future__ import annotations

import functools
from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from reference.common import mel_filterbank
from roofline.work import decode_flops, logmel_work, memory_kv_work


def count(fn, *args) -> int:
    mode = FlopCounterMode(display=False)
    with mode:
        fn(*args)
    return int(mode.get_total_flops())


def gru_flops(frames: int, d_in: int, hidden: int, layers: int,
              directions: int = 2) -> int:
    """A GRU's forward: per step, layer and direction three gates of
    (input + hidden) x hidden products."""
    total, width = 0, d_in
    for _ in range(layers):
        total += directions * frames * 2 * 3 * hidden * (width + hidden)
        width = directions * hidden
    return total


@functools.lru_cache(maxsize=None)
def _meta_model(module_name: str, config_json: str):
    import importlib
    import json
    ref = importlib.import_module(module_name)
    with torch.device("meta"):
        return ref.Captioner(json.loads(config_json)).to("meta").eval()


def model(config: Dict):
    import json
    return _meta_model(f"reference.{config['reference']}",
                       json.dumps(config, sort_keys=True))


def frontend_flops(config: Dict, samples: int) -> int:
    mel = model(config).mel
    return logmel_work(mel.n_fft, mel.hop, mel.n_mels, mel_filterbank(mel),
                       1, samples)[0]


@functools.lru_cache(maxsize=None)
def _encoder_flops(module_name: str, config_json: str, samples: int) -> int:
    import json
    config = json.loads(config_json)
    m = _meta_model(module_name, config_json)
    frames = m.mel.frames(samples)
    lms = torch.empty(1, frames, m.mel.n_mels, device="meta")
    lens = torch.tensor([frames], device="meta")
    enc = m.encoder
    if hasattr(enc, "cnn"):                 # Cnn14 -> BiGRU
        total = count(enc.cnn, lms, lens)
        return total + gru_flops(frames // 32, 2048,
                                 config["rnn_hidden_size"],
                                 config["rnn_num_layers"])
    return count(enc, lms, lens)


def encoder_flops(config: Dict, samples: int) -> Dict[str, int]:
    """{"cnn", "rnn"} FLOPs of one clip's encoder forward (rnn 0 for an
    encoder without one)."""
    import json
    key = json.dumps(config, sort_keys=True)
    name = f"reference.{config['reference']}"
    total = _encoder_flops(name, key, samples)
    rnn = 0
    if "rnn_hidden_size" in config:
        frames = model(config).mel.frames(samples)
        rnn = gru_flops(frames // 32, 2048, config["rnn_hidden_size"],
                        config["rnn_num_layers"])
    return {"cnn": total - rnn, "rnn": rnn}


def dims(config: Dict) -> Dict:
    E = config["decoder_emb_dim"]
    return {"E": E, "F": 4 * E, "V": config["vocab_size"],
            "layers": config["decoder_n_layers"],
            "tied": config["decoder_tie_weights"],
            "D": config["memory_dim"], "K": config["beam_size"],
            "L": config["max_length"]}


def caption_flops(config: Dict, samples: int, steps: float) -> float:
    """One clip captioned: log-mel, encoder, memory K/V, a beam search of
    ``steps`` executed steps over the clip's valid memory."""
    dm = dims(config)
    S = model(config).mel.frames(samples) // 32
    enc = encoder_flops(config, samples)
    kv = memory_kv_work(1, S, dm["D"], dm["E"], dm["layers"])[0]
    mm, attn = decode_flops(dm["E"], dm["F"], dm["V"], [S], [int(steps)],
                            dm["K"], dm["layers"], S)
    frac = steps - int(steps)
    if frac:
        mm1, attn1 = decode_flops(dm["E"], dm["F"], dm["V"], [S],
                                  [int(steps) + 1], dm["K"], dm["layers"], S)
        mm, attn = mm + frac * (mm1 - mm), attn + frac * (attn1 - attn)
    return (frontend_flops(config, samples) + enc["cnn"] + enc["rnn"] + kv
            + mm + attn)


def train_flops(config: Dict, samples: int, words: int) -> float:
    """One clip of a training step: the frozen log-mel and Cnn14 forward
    only; the BiGRU and the decoder (teacher-forced over ``words``
    positions, the memory projection included) forward and backward,
    three times their forward.  Scheduled sampling's extra decoder steps
    are not model FLOPs and are not counted."""
    m = model(config)
    S = m.mel.frames(samples) // 32
    enc = encoder_flops(config, samples)
    dm = dims(config)
    mem = torch.empty(1, S, dm["D"], device="meta")
    lens = torch.tensor([S], device="meta")
    w = torch.zeros(1, words, dtype=torch.long, device="meta")

    def dec():
        memory, mask = m.decoder.memory(mem, lens)
        m.decoder(w, memory, mask)
    return (frontend_flops(config, samples) + enc["cnn"]
            + 3 * (enc["rnn"] + count(dec)))
