"""Deterministic learnable synthetic captioning corpora (counterpart of
``audiocaption_tpu/cli/synthetic_corpus.py``, whose generators this is a
copy of).

    python -m audiocaption_tpu_torch.cli.synthetic_corpus generate_v2 \\
        data/synthetic_v2 --sr 32000
    python -m audiocaption_tpu_torch.cli.synthetic_corpus \\
        generate_temporal data/synthetic_temporal
    python -m audiocaption_tpu_torch.cli.synthetic_corpus ceiling \\
        data/synthetic_v2/test_text.json

The clips are event-structured audio (tones, chirps, noise bursts with
distinct spectral signatures, in sequence or overlapping) and the
captions come from a paraphrase grammar over the events, so a model that
hears the events and their order can reach the corpus's round-robin
CIDEr ceiling.  Three corpora: ``generate`` (v1: 8 events, 1-2 in
sequence), ``generate_v2`` (16 events with confusable pairs, up to 3,
per-reference synonyms and coverage noise) and ``generate_temporal``
(overlapping events with a temporal tag 0-3 and ground-truth segments
for SED training).

Written per split: ``{split}_wav/{audio_id}.wav`` (the wave rounded to
float16, as the JAX generator stores it in its h5, written as float32
through ``scipy.io.wavfile``, so exactly), ``{split}_wav.csv``
(``audio_id\\tfile_name``), ``{split}_text.json`` ({"audios": [{audio_id,
captions: [{tokens, caption, cap_id}]}]}); the temporal corpus adds
``{split}_tag.csv`` (``audio_id\\ttag``) and ``{split}_sed.json``; the
train split's vocabulary goes to ``vocab.pkl``.  Every file but the wave
container and ``wav.csv`` is byte for byte the JAX generator's for the
same seed and sizes, and every sample equals the JAX h5's.  Everything is
seeded: the same (seed, sizes) gives the same corpus.  :func:`subset`
cuts a corpus's train split to its first clips without generating
anything: the corpus of the smaller train size.
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import numpy as np

# ----------------------------------------------------------------- events --
# Each event type: (noun phrase, synthesis function(rng, t, sr) -> wave).
# Signatures are spectrally disjoint so the mapping audio -> phrase is
# unambiguous; onset/offset ramps avoid clicks.


def _ramp(n: int, sr: int, ms: float = 30.0) -> np.ndarray:
    r = int(sr * ms / 1000)
    env = np.ones(n, np.float32)
    if r > 0 and n > 2 * r:
        env[:r] = np.linspace(0, 1, r, dtype=np.float32)
        env[-r:] = np.linspace(1, 0, r, dtype=np.float32)
    return env


def _sine(f):
    def synth(rng, t, sr):
        return np.sin(2 * np.pi * f * t).astype(np.float32)
    return synth


def _chirp(f0, f1):
    def synth(rng, t, sr):
        T = t[-1] if len(t) else 1.0
        inst = f0 + (f1 - f0) * t / max(T, 1e-6)
        phase = 2 * np.pi * np.cumsum(inst) / sr
        return np.sin(phase).astype(np.float32)
    return synth


def _noise(rng, t, sr):
    return rng.randn(len(t)).astype(np.float32) * 0.7


def _beeps(rng, t, sr):
    gate = (np.sin(2 * np.pi * 6.0 * t) > 0.3).astype(np.float32)
    return (np.sin(2 * np.pi * 1000.0 * t) * gate).astype(np.float32)


def _rumble(rng, t, sr):
    # narrowband low-frequency noise: smoothed white noise
    x = rng.randn(len(t) + 256).astype(np.float32)
    k = np.hanning(257).astype(np.float32)
    k /= k.sum()
    y = np.convolve(x, k, mode="valid")[: len(t)]
    return (y / (np.std(y) + 1e-8)).astype(np.float32)


def _chime(rng, t, sr):
    # repeated decaying harmonic strikes at 1.2 kHz
    period = 0.8
    phase = (t % period)
    env = np.exp(-6.0 * phase).astype(np.float32)
    tone = sum(np.sin(2 * np.pi * 1320.0 * (h + 1) * t) / (h + 1)
               for h in range(3))
    return (tone * env).astype(np.float32) * 0.8


EVENTS: List[Tuple[str, object]] = [
    ("low tone", _sine(220.0)),
    ("high whistle", _sine(2600.0)),
    ("rising siren", _chirp(400.0, 1600.0)),
    ("falling siren", _chirp(1600.0, 400.0)),
    ("static noise", _noise),
    ("quick beeps", _beeps),
    ("deep rumble", _rumble),
    ("bright chime", _chime),
]

# ---------------------------------------------------------------- grammar --
# 5 paraphrase templates per arity; every audio gets all 5 (cap_id 0..4)
# in a clip-deterministic order, as Clotho has 5 captions an audio.

TEMPLATES_1 = [
    "a {a} is heard",
    "the sound of a {a}",
    "a {a} sounds steadily",
    "someone hears a {a}",
    "a {a} plays alone",
]

TEMPLATES_2 = [
    "a {a} is followed by a {b}",
    "a {a} and then a {b}",
    "first a {a} then a {b}",
    "a {b} comes after a {a}",
    "a {a} sounds before a {b}",
]


def synth_clip(rng: np.random.RandomState, events: List[int], sr: int,
               duration: float, events_table=None) -> np.ndarray:
    """Events fill sequential segments with short silence gaps; levels
    are randomized mildly so amplitude is not a caption cue."""
    table = EVENTS if events_table is None else events_table
    n = int(sr * duration)
    wav = rng.randn(n).astype(np.float32) * 0.003  # noise floor
    n_ev = len(events)
    seg = duration / n_ev
    for i, ev in enumerate(events):
        start = i * seg + rng.uniform(0.1, 0.4)
        end = (i + 1) * seg - rng.uniform(0.1, 0.4)
        s, e = int(start * sr), int(end * sr)
        e = max(e, s + int(0.05 * sr))          # tiny-duration floor
        t = np.arange(e - s, dtype=np.float32) / sr
        x = table[ev][1](rng, t, sr)
        gain = rng.uniform(0.25, 0.6)
        wav[s:e] += x * _ramp(e - s, sr) * gain
    peak = np.abs(wav).max()
    if peak > 0.99:
        wav *= 0.99 / peak
    return wav


def captions_for(rng: np.random.RandomState, events: List[int]
                 ) -> List[str]:
    phrases = [EVENTS[e][0] for e in events]
    if len(events) == 1:
        temps = TEMPLATES_1
        fills = {"a": phrases[0]}
    else:
        temps = TEMPLATES_2
        fills = {"a": phrases[0], "b": phrases[1]}
    order = rng.permutation(len(temps))
    return [temps[i].format(**fills) for i in order]


def sample_events(rng: np.random.RandomState) -> List[int]:
    if rng.rand() < 0.35:
        return [int(rng.randint(len(EVENTS)))]
    a = int(rng.randint(len(EVENTS)))
    b = int(rng.randint(len(EVENTS) - 1))
    if b >= a:
        b += 1  # distinct pair; order is the thing to learn
    return [a, b]


# ------------------------------------------------------- temporal corpus --
# Clips whose events overlap in time, for the temporal-tag pipeline:
# 0 = single event, 1 = simultaneous, 2 = sequential, 3 = complex.  The
# generator also writes the ground-truth event segments (SED targets) and
# the tag of each clip.  Segment geometry is chosen so that the tag logic
# (segments_to_temporal_tag with thre=0.5) gives the intended tag exactly;
# generation asserts it.

TEMPLATES_WHILE = [
    "a {a} while a {b} sounds",
    "a {a} and a {b} at the same time",
    "a {b} joins a {a}",
    "a {a} together with a {b}",
    "a {a} as a {b} plays along",
]

TEMPLATES_COMPLEX = [
    "a {a} with a {b} and then a {c}",
    "a {a} and a {b} together followed by a {c}",
    "a {b} joins a {a} before a {c}",
    "a {a} while a {b} then a {c}",
    "after a {a} and a {b} together a {c} sounds",
]


def sample_temporal_segments(rng: np.random.RandomState, duration: float
                             ) -> Tuple[List[Tuple[int, float, float]], int]:
    """Sample (segments [(class, onset, offset)], temporal tag)."""
    r = rng.rand()
    if r < 0.25:                                  # tag 0: single event
        a, = rng.choice(len(EVENTS), 1, replace=False)
        on = rng.uniform(0.5, 2.0)
        off = on + rng.uniform(4.0, min(7.0, duration - 0.3 - on))
        return [(int(a), on, off)], 0
    if r < 0.55:                                  # tag 1: simultaneous
        a, b = rng.choice(len(EVENTS), 2, replace=False)
        on_a = rng.uniform(0.5, 1.5)
        off_a = on_a + rng.uniform(5.5, min(7.5, duration - 0.4 - on_a))
        on_b = on_a + rng.uniform(0.8, 1.8)
        off_b = min(off_a + rng.uniform(-0.5, 1.0), duration - 0.3)
        return [(int(a), on_a, off_a), (int(b), on_b, off_b)], 1
    if r < 0.85:                                  # tag 2: sequential
        a, b = rng.choice(len(EVENTS), 2, replace=False)
        on_a = rng.uniform(0.4, 1.2)
        off_a = on_a + rng.uniform(2.5, 3.6)
        on_b = off_a + rng.uniform(0.7, 1.5)
        off_b = on_b + rng.uniform(2.5, min(3.6, duration - 0.3 - on_b))
        return [(int(a), on_a, off_a), (int(b), on_b, off_b)], 2
    # tag 3: complex, a and b overlap, then c after both
    a, b, c = rng.choice(len(EVENTS), 3, replace=False)
    on_a = rng.uniform(0.3, 0.8)
    off_a = on_a + rng.uniform(3.2, 4.0)
    on_b = on_a + rng.uniform(0.6, 1.2)
    off_b = off_a + rng.uniform(-0.2, 0.4)
    on_c = max(off_a, off_b) + rng.uniform(0.6, 1.2)
    off_c = on_c + rng.uniform(2.0, min(3.0, duration - 0.3 - on_c))
    return [(int(a), on_a, off_a), (int(b), on_b, off_b),
            (int(c), on_c, off_c)], 3


def synth_from_segments(rng: np.random.RandomState,
                        segments: List[Tuple[int, float, float]],
                        sr: int, duration: float) -> np.ndarray:
    """Overlapping events sum; levels mildly randomized (no level cue)."""
    n = int(sr * duration)
    wav = rng.randn(n).astype(np.float32) * 0.003  # noise floor
    for cls, on, off in segments:
        s, e = int(on * sr), int(off * sr)
        t = np.arange(e - s, dtype=np.float32) / sr
        x = EVENTS[cls][1](rng, t, sr)
        wav[s:e] += x * _ramp(e - s, sr) * rng.uniform(0.25, 0.5)
    peak = np.abs(wav).max()
    if peak > 0.99:
        wav *= 0.99 / peak
    return wav


def temporal_captions_for(rng: np.random.RandomState,
                          segments: List[Tuple[int, float, float]],
                          tag: int) -> List[str]:
    """5 paraphrases; event phrases ordered by onset."""
    order = sorted(range(len(segments)), key=lambda i: segments[i][1])
    phrases = [EVENTS[segments[i][0]][0] for i in order]
    if tag == 0:
        temps, fills = TEMPLATES_1, {"a": phrases[0]}
    elif tag == 1:
        temps, fills = TEMPLATES_WHILE, {"a": phrases[0], "b": phrases[1]}
    elif tag == 2:
        temps, fills = TEMPLATES_2, {"a": phrases[0], "b": phrases[1]}
    else:
        temps, fills = TEMPLATES_COMPLEX, {"a": phrases[0],
                                           "b": phrases[1], "c": phrases[2]}
    perm = rng.permutation(len(temps))
    return [temps[i].format(**fills) for i in perm]


# ----------------------------------------------------------------- writer --

def write_wave(path: Path, wav: np.ndarray, sr: int) -> None:
    """The wave rounded to float16 (the JAX corpus's stored values),
    written as float32 samples (exact)."""
    from scipy.io import wavfile
    wavfile.write(str(path), sr,
                  wav.astype(np.float16).astype(np.float32))


def _text_entry(aid: str, caps: List[str]) -> Dict:
    return {"audio_id": aid, "captions": [
        {"tokens": c, "caption": c.capitalize() + ".", "cap_id": str(j)}
        for j, c in enumerate(caps)]}


def _write_corpus(output_dir: str, sizes: Dict[str, int], rng_base: int,
                  prefix: str, sr: int,
                  clip: Callable[[np.random.RandomState, str], Tuple],
                  temporal: bool = False) -> Dict[str, Dict[str, str]]:
    """The three splits, split ``si`` drawn from ``RandomState(rng_base +
    si)``; ``clip(rng, audio_id)`` -> (wave, captions) or, for the
    temporal corpus, (wave, captions, segments, tag)."""
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    paths: Dict[str, Dict[str, str]] = {}
    train_caps: List[str] = []
    for si, (split, n) in enumerate(sizes.items()):
        rng = np.random.RandomState(rng_base + si)
        wav_dir = out / f"{split}_wav"
        wav_dir.mkdir(exist_ok=True)
        audios, sed_audios, tags = [], [], []
        with open(out / f"{split}_wav.csv", "w") as csv:
            csv.write("audio_id\tfile_name\n")
            for i in range(n):
                aid = f"{prefix}_{split}_{i:05d}"
                wav, caps, *extra = clip(rng, aid)
                wav_path = wav_dir / f"{aid}.wav"
                write_wave(wav_path, wav, sr)
                csv.write(f"{aid}\t{wav_path}\n")
                audios.append(_text_entry(aid, caps))
                if temporal:
                    segments, tag = extra
                    tags.append(f"{aid}\t{tag}\n")
                    sed_audios.append({
                        "audio_id": aid, "tag": tag,
                        "segments": [[int(c), round(float(on), 3),
                                      round(float(off), 3)]
                                     for c, on, off in segments]})
                if split == "train":
                    train_caps.extend(caps)
        with open(out / f"{split}_text.json", "w") as f:
            json.dump({"audios": audios}, f)
        paths[split] = {"wav_csv": str(out / f"{split}_wav.csv"),
                        "text": str(out / f"{split}_text.json"),
                        "wav_dir": str(wav_dir)}
        if temporal:
            with open(out / f"{split}_tag.csv", "w") as f:
                f.write("audio_id\ttag\n" + "".join(tags))
            with open(out / f"{split}_sed.json", "w") as f:
                json.dump({"audios": sed_audios}, f)
            paths[split].update(tag=str(out / f"{split}_tag.csv"),
                                sed=str(out / f"{split}_sed.json"))

    paths["vocab"] = {"vocab": _write_vocab(out, train_caps)}
    return paths


def _write_vocab(out: Path, train_caps: List[str]) -> str:
    """The train captions' words, in order of first use, after the
    special tokens -> ``vocab.pkl``."""
    from audiocaption_tpu_torch.data.tokenizer import DictTokenizer
    tok = DictTokenizer()
    for c in train_caps:
        for w in c.split():
            tok.add_word(w)
    with open(out / "vocab.pkl", "wb") as f:
        pickle.dump(tok.state_dict(), f)
    return str(out / "vocab.pkl")


def subset(src: str, dst: str, n_train: int) -> Dict[str, Dict[str, str]]:
    """The corpus in ``src`` with its train split cut to its first
    ``n_train`` clips, written to ``dst``: the files its generator writes
    for ``n_train`` train clips and the same seed, val and test (each
    split is drawn from its own stream, clip by clip, so the first clips
    of a larger train split are those of a smaller one; the vocabulary is
    rebuilt from the kept captions).  The wav files stay in ``src``, and
    the tables point there.  -> the paths, as the generators return
    them."""
    src_p, out = Path(src), Path(dst)
    out.mkdir(parents=True, exist_ok=True)
    paths: Dict[str, Dict[str, str]] = {}
    for split in ("train", "val", "test"):
        n = n_train if split == "train" else None
        names = {"wav_csv": f"{split}_wav.csv", "text": f"{split}_text.json",
                 "tag": f"{split}_tag.csv", "sed": f"{split}_sed.json"}
        paths[split] = {"wav_dir": str(src_p / f"{split}_wav")}
        for key, name in names.items():
            if not (src_p / name).exists():
                continue
            text = (src_p / name).read_text()
            if name.endswith(".json"):
                data = json.loads(text)
                data["audios"] = data["audios"][:n]
                text = json.dumps(data)
            else:
                lines = text.splitlines(keepends=True)
                text = "".join(lines[:1 + n] if n is not None else lines)
            (out / name).write_text(text)
            paths[split][key] = str(out / name)
    train = json.loads((out / "train_text.json").read_text())["audios"]
    paths["vocab"] = {"vocab": _write_vocab(
        out, [c["tokens"] for a in train for c in a["captions"]])}
    return paths


def generate_temporal(output_dir: str, n_train: int = 2000,
                      n_val: int = 200, n_test: int = 200,
                      sr: int = 32000, duration: float = 10.0,
                      seed: int = 0) -> Dict[str, Dict[str, str]]:
    """Temporal-structure corpus: waves, captions, the temporal tag of
    each clip and its ground-truth event segments (SED targets).  32 kHz
    by default, the temporal model's front end (Cnn14 at 32 kHz)."""
    from audiocaption_tpu_torch.models.sed import segments_to_temporal_tag

    def clip(rng, aid):
        segments, tag = sample_temporal_segments(rng, duration)
        # the sampler's geometry must give the intended tag through the
        # overlap logic
        assert segments_to_temporal_tag(segments) == tag, \
            (aid, segments, tag)
        wav = synth_from_segments(rng, segments, sr, duration)
        return (wav, temporal_captions_for(rng, segments, tag), segments,
                tag)
    return _write_corpus(output_dir,
                         {"train": n_train, "val": n_val, "test": n_test},
                         7000 + seed * 1000, "syntmp", sr, clip,
                         temporal=True)


def generate(output_dir: str, n_train: int = 2000, n_val: int = 200,
             n_test: int = 200, sr: int = 16000, duration: float = 10.0,
             seed: int = 0) -> Dict[str, Dict[str, str]]:
    """Write the v1 corpus; returns {split: {wav_csv, text, wav_dir}}
    paths and {vocab: {vocab}}."""
    def clip(rng, aid):
        events = sample_events(rng)
        wav = synth_clip(rng, events, sr, duration)
        return wav, captions_for(rng, events)
    return _write_corpus(output_dir,
                         {"train": n_train, "val": n_val, "test": n_test},
                         seed * 1000, "syn", sr, clip)


# ------------------------------------------------------------- corpus v2 --
# The quality-headroom corpus: 16 event types with acoustically
# confusable pairs (nearby sine frequencies, overlapping chirp ranges, two
# noise colours, two pulse rates); each of the 5 references names an
# event with an independently drawn synonym, so exact n-gram metrics
# cannot saturate; up to 3 sequential events; an arity-3 reference drops
# one non-leading event with p=0.25 (annotators disagree on coverage).


def _am_tone(f, rate):
    def synth(rng, t, sr):
        carrier = np.sin(2 * np.pi * f * t)
        env = 0.55 + 0.45 * np.sin(2 * np.pi * rate * t)
        return (carrier * env).astype(np.float32)
    return synth


def _clicks(rng, t, sr):
    y = np.zeros(len(t), np.float32)
    step = int(0.25 * sr)
    for s in range(0, len(t) - 64, step):
        y[s:s + 64] = rng.uniform(0.8, 1.0) * np.hanning(64)
    return y


def _buzz(rng, t, sr):
    # harmonic-rich quasi-sawtooth at 110 Hz
    y = sum(np.sin(2 * np.pi * 110.0 * (h + 1) * t) / (h + 1)
            for h in range(8))
    return (y / 2.0).astype(np.float32)


def _hiss(rng, t, sr):
    x = rng.randn(len(t) + 64).astype(np.float32)
    # crude high-pass: first difference, repeated
    for _ in range(2):
        x = np.diff(x)
    y = x[: len(t)]
    return (y / (np.std(y) + 1e-8) * 0.5).astype(np.float32)


def _pips(rng, t, sr):
    gate = (np.sin(2 * np.pi * 1.6 * t) > 0.6).astype(np.float32)
    return (np.sin(2 * np.pi * 800.0 * t) * gate).astype(np.float32)


# (synonym phrases, synth); the FIRST synonym is the canonical one (drawn
# with higher probability, so consensus phrasing exists for CIDEr to
# reward).
EVENTS_V2: List[Tuple[Tuple[str, ...], object]] = [
    (("low tone", "deep tone", "bass tone"), _sine(220.0)),
    (("low hum", "soft hum"), _sine(150.0)),                 # ~ low tone
    (("high whistle", "shrill whistle"), _sine(2600.0)),
    (("piercing tone", "sharp tone"), _sine(3100.0)),        # ~ whistle
    (("rising siren", "upward siren"), _chirp(400.0, 1600.0)),
    (("falling siren", "downward siren"), _chirp(1600.0, 400.0)),
    (("slow sweep", "gentle sweep"), _chirp(700.0, 1100.0)),  # ~ sirens
    (("static noise", "white noise", "harsh static"), _noise),
    (("deep rumble", "low rumble"), _rumble),                # ~ noise/hum
    (("quick beeps", "rapid beeps"), _beeps),
    (("slow pips", "steady pips"), _pips),                   # ~ beeps
    (("bright chime", "ringing chime"), _chime),
    (("warbling tone", "wavering tone"), _am_tone(900.0, 5.0)),
    (("ticking clicks", "sharp clicks"), _clicks),
    (("buzzing drone", "rough buzz"), _buzz),
    (("soft hiss", "faint hiss"), _hiss),                    # ~ static
]

TEMPLATES_V2_1 = [
    "a {a} is heard",
    "the sound of a {a}",
    "a {a} sounds steadily",
    "someone hears a {a}",
    "a {a} plays alone",
    "only a {a} can be heard",
]

TEMPLATES_V2_2 = [
    "a {a} is followed by a {b}",
    "a {a} and then a {b}",
    "first a {a} then a {b}",
    "a {b} comes after a {a}",
    "a {a} sounds before a {b}",
    "after a {a} a {b} is heard",
    "a {a} gives way to a {b}",
]

TEMPLATES_V2_3 = [
    "a {a} then a {b} and finally a {c}",
    "a {a} is followed by a {b} and then a {c}",
    "first a {a} then a {b} and last a {c}",
    "a {a} a {b} and a {c} sound one after another",
    "after a {a} and a {b} a {c} is heard",
    "a {c} comes after a {a} and a {b}",
]


def sample_events_v2(rng: np.random.RandomState) -> List[int]:
    r = rng.rand()
    arity = 1 if r < 0.25 else (2 if r < 0.65 else 3)
    return [int(x) for x in
            rng.choice(len(EVENTS_V2), arity, replace=False)]


def _synonym(rng: np.random.RandomState, ev: int) -> str:
    """Canonical synonym with p=0.6, the rest uniform."""
    syns = EVENTS_V2[ev][0]
    if len(syns) == 1 or rng.rand() < 0.6:
        return syns[0]
    return syns[1 + int(rng.randint(len(syns) - 1))]


def captions_for_v2(rng: np.random.RandomState,
                    events: List[int]) -> List[str]:
    """5 references; each independently samples synonyms and a template,
    and an arity-3 reference may drop one non-leading event (annotator
    coverage noise)."""
    caps = []
    for _ in range(5):
        evs = list(events)
        if len(evs) == 3 and rng.rand() < 0.25:
            del evs[1 + int(rng.randint(2))]     # drop b or c, keep order
        phrases = [_synonym(rng, e) for e in evs]
        temps = (TEMPLATES_V2_1, TEMPLATES_V2_2,
                 TEMPLATES_V2_3)[len(evs) - 1]
        temp = temps[int(rng.randint(len(temps)))]
        fills = dict(zip("abc", phrases))
        caps.append(temp.format(**fills))
    return caps


def generate_v2(output_dir: str, n_train: int = 3000, n_val: int = 300,
                n_test: int = 300, sr: int = 16000,
                duration: float = 10.0, seed: int = 0
                ) -> Dict[str, Dict[str, str]]:
    """Write the v2 corpus (the layout of :func:`generate`)."""
    def clip(rng, aid):
        events = sample_events_v2(rng)
        wav = synth_clip(rng, events, sr, duration, events_table=EVENTS_V2)
        return wav, captions_for_v2(rng, events)
    return _write_corpus(output_dir,
                         {"train": n_train, "val": n_val, "test": n_test},
                         31000 + seed * 1000, "syn2", sr, clip)


def ceiling(text_json: str, n_audios: int = 0) -> Dict[str, float]:
    """Round-robin inter-annotator score ceiling on a split
    (``metrics/tools.py::round_robin_scores``)."""
    from audiocaption_tpu_torch.metrics.tools import round_robin_scores
    with open(text_json) as f:
        data = json.load(f)
    key2refs = {a["audio_id"]: [c["tokens"] for c in a["captions"]]
                for a in data["audios"]}
    if n_audios:
        keys = sorted(key2refs)[:n_audios]
        key2refs = {k: key2refs[k] for k in keys}
    return round_robin_scores(key2refs)


GENERATORS = {"generate": (generate, 2000, 200, 16000),
              "generate_v2": (generate_v2, 3000, 300, 16000),
              "generate_temporal": (generate_temporal, 2000, 200, 32000)}


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(
        prog="audiocaption_tpu_torch.cli.synthetic_corpus")
    sub = parser.add_subparsers(dest="command", required=True)
    for name, (_, n_train, n_eval, sr) in GENERATORS.items():
        g = sub.add_parser(name)
        g.add_argument("output_dir")
        g.add_argument("--n_train", type=int, default=n_train)
        g.add_argument("--n_val", type=int, default=n_eval)
        g.add_argument("--n_test", type=int, default=n_eval)
        g.add_argument("--sr", type=int, default=sr)
        g.add_argument("--duration", type=float, default=10.0)
        g.add_argument("--seed", type=int, default=0)
    c = sub.add_parser("ceiling")
    c.add_argument("text_json")
    c.add_argument("--n_audios", type=int, default=0)
    args = parser.parse_args(argv)
    if args.command == "ceiling":
        print(json.dumps(ceiling(args.text_json, args.n_audios), indent=1))
        return
    fn = GENERATORS[args.command][0]
    paths = fn(args.output_dir, args.n_train, args.n_val, args.n_test,
               args.sr, args.duration, args.seed)
    print(json.dumps(paths, indent=1))


if __name__ == "__main__":
    main()
