"""Offline data tools (counterpart of ``audiocaption_tpu/cli/data_tools.py``;
reference data/augment/*, data/create_dataset/prepare_car.py,
prepare_text_metadata/* and python_scripts/utils/{word2vec/
create_word_embedding, model_eval_diff, predict_nrst_ngbr, ...}.py).

    python -m audiocaption_tpu_torch.cli.data_tools <cmd> ...

with JAX's sub-commands and flags:

  speed_perturb         perturbed wav.csv + duplicated captions (below)
  subset_concat         a% of corpus A + corpus B (a_subset_concat_b.py)
  text_similarity       near-duplicate captions of other clips as extra
                        references, from caption embeddings in an h5
  retrieve_similarity   audio -> text retrieval pseudo corpus from an
                        [audio x caption] similarity h5
  audio_similarity      captions of the nearest reference clip (h5
                        embeddings) for every new clip above a threshold
  filter_new_audio_aug  the best of three pseudo captions by similarity
  prepare_car           AudioCaption-Car label jsons -> {dev,eval}/text.json
  extract_specificity   -log unigram frequency per word and caption
  extract_keyword       per-caption keywords: the stopword heuristic
  create_word_embedding word2vec (``utils/word_embedding.py``, on a
                        device) or pretrained npz vectors + PCA -> .npy
  predict_nrst_ngbr     nearest-neighbour caption transfer (h5 features)
  model_eval_diff       all references minus leave-one-out, by metric
  pred_to_anno, concat_anno_json, concat_pred_json, prepare_wav_csv,
  wavcsv_from_textjson  json and csv utilities

Each writes what the JAX tool writes, byte for byte, from the same
inputs.  Tools that read h5 files need ``h5py`` (imported when they run).
Not ported, since they need a download: ``back_translate`` (MarianMT
weights) and ``extract_syntax`` (a CoreNLP server); their sub-commands
raise and say so.  ``extract_keyword`` runs JAX's path for a host without
stanza; stanza's lemma and POS path needs its downloaded models.
``create_word_embedding`` trains on the card unless ``--device cpu``.

speed_perturb:

    python -m audiocaption_tpu_torch.cli.data_tools speed_perturb \\
        INPUT_DIR OUTPUT_DIR [--speeds 0.9 1.1] [--sr 16000] [--compute] \\
        [--wav_csv CSV] [--text_json JSON]

reads ``INPUT_DIR/wav.csv`` and ``INPUT_DIR/text.json`` (or the files
``--wav_csv`` and ``--text_json`` name, e.g. a corpus's
``train_wav.csv`` and ``train_text.json``) and writes into OUTPUT_DIR:

  * ``wav.csv``: one row per clip and speed, audio id ``sp{speed}-{id}``.
    With ``--compute``, the clip resampled by ``resample_poly`` at
    ``Fraction(1 / speed).limit_denominator(1000)`` (a slower clip is
    longer), its values rounded to float16 as the JAX tool stores them,
    written as a float32 wav file (exact) under ``OUTPUT_DIR/wav/``
    at the clip's own rate (``--sr`` for an h5 row), and a ``file_name``
    row for it; the card machine has no h5py, where the JAX tool writes
    ``waveform_sp.h5``.  Without ``--compute``, the JAX tool's
    ffmpeg / sox pipe rows;
  * ``text.json``: the input's items, then a copy of each clip's item
    under every perturbed id, as the JAX tool writes it.

A wav.csv row is read as the datasets read it: a ``file_name`` row from
its wav file, an ``hdf5_path`` row from the h5.
"""

from __future__ import annotations

import argparse
import csv
import json
import math
import random
from collections import Counter
from fractions import Fraction
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np


def _read_rows(path: Path) -> List[Dict[str, str]]:
    with open(path) as f:
        return list(csv.DictReader(f, delimiter="\t"))


def speed_perturb(input_dir: str, output_dir: str,
                  speeds: Sequence[float] = (0.9, 1.1), sr: int = 16000,
                  compute: bool = False, wav_csv: Optional[str] = None,
                  text_json: Optional[str] = None) -> Dict[str, str]:
    """See the module docstring -> {wav_csv, text_json} written."""
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    rows = _read_rows(Path(wav_csv or Path(input_dir) / "wav.csv"))
    with open(text_json or Path(input_dir) / "text.json") as f:
        audios = json.load(f)["audios"]
    aid_to_item = {a["audio_id"]: a for a in audios}
    if compute:
        from scipy.signal import resample_poly
        from audiocaption_tpu_torch.cli.synthetic_corpus import write_wave
        from audiocaption_tpu_torch.data.dataset import _H5Cache, read_wav
        wav_dir = out / "wav"
        wav_dir.mkdir(exist_ok=True)
        h5 = _H5Cache()
        sp_rows = []
        for row in rows:
            if row.get("file_name"):
                rate, wav = read_wav(row["file_name"])
            else:
                rate, wav = sr, h5.read(row["hdf5_path"], row["audio_id"])
            for speed in speeds:
                sp_aid = f"sp{speed}-{row['audio_id']}"
                frac = Fraction(1.0 / speed).limit_denominator(1000)
                path = wav_dir / f"{sp_aid}.wav"
                write_wave(path, resample_poly(wav, frac.numerator,
                                               frac.denominator), rate)
                sp_rows.append([sp_aid, str(path)])
    else:
        sp_rows = [[f"sp{speed}-{row['audio_id']}",
                    f"ffmpeg -i {row.get('file_name') or row['hdf5_path']} "
                    f"-f wav -ar {sr} -ab 16 - | sox -t wav - -t wav - "
                    f"speed {speed} |"] for row in rows for speed in speeds]
    sp_items = []
    for row in rows:
        for speed in speeds:
            if row["audio_id"] in aid_to_item:
                item = json.loads(json.dumps(aid_to_item[row["audio_id"]]))
                item["audio_id"] = f"sp{speed}-{row['audio_id']}"
                sp_items.append(item)
    with open(out / "text.json", "w") as f:
        json.dump({"audios": audios + sp_items}, f, indent=4,
                  ensure_ascii=False)
    with open(out / "wav.csv", "w", newline="") as f:
        writer = csv.writer(f, delimiter="\t", lineterminator="\n")
        writer.writerow(["audio_id", "file_name"])
        writer.writerows(sp_rows)
    print(f"wrote {len(sp_rows)} perturbed rows to {out}")
    return {"wav_csv": str(out / "wav.csv"),
            "text_json": str(out / "text.json")}


def _load_audios(path: str) -> List[Dict]:
    with open(path) as f:
        return json.load(f)["audios"]


def _dump_audios(audios: List[Dict], path: str) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump({"audios": audios}, f, indent=4, ensure_ascii=False)


def _h5_rows(path: str):
    """An h5 file's datasets in its order -> (keys, [arrays])."""
    import h5py
    keys, rows = [], []
    with h5py.File(path, "r") as store:
        for key, value in store.items():
            keys.append(key)
            rows.append(np.asarray(value))
    return keys, rows


def back_translate(input: str, output: str, batch_size: int = 32):
    """Not ported: needs the MarianMT weights (a download)."""
    raise SystemExit("back_translate needs the MarianMT models "
                     "(Helsinki-NLP/opus-mt-en-ROMANCE and -ROMANCE-en), a "
                     "download the port does not make; run the JAX package's "
                     "tool where they are installed")


def subset_concat(set_a: str, set_b: str, subset_a_output: str,
                  all_output: str, a_percent: float, seed: int = 1,
                  total_number: Optional[int] = None) -> None:
    """``a_percent`` of corpus A's clips (drawn by ``random.seed(seed)``;
    an existing ``subset_a_output`` is reused) plus B's clips up to
    ``total_number`` (default: A's size), written to ``all_output``."""
    random.seed(seed)
    a_data, b_data = _load_audios(set_a), _load_audios(set_b)
    a_number = int(len(a_data) * a_percent)
    total = total_number if total_number is not None else len(a_data)
    b_number = total - a_number
    if Path(subset_a_output).exists():
        a_subset = _load_audios(subset_a_output)
        if len(a_subset) != a_number:
            raise ValueError(f"{subset_a_output} holds {len(a_subset)} clips, "
                             f"not {a_number}")
    else:
        a_subset = random.sample(a_data, a_number)
        _dump_audios(a_subset, subset_a_output)
    b_subset = b_data if b_number > len(b_data) \
        else random.sample(b_data, b_number)
    _dump_audios(a_subset + b_subset, all_output)
    print(f"a: {a_number}, b: {len(b_subset)}")


def _cosine(a: np.ndarray, b: Optional[np.ndarray] = None) -> np.ndarray:
    """Cosine similarity of the rows of ``a`` with those of ``b`` (or of
    ``a``), each row scaled by max(its norm, 1e-12)."""
    a = a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-12)
    if b is None:
        b = a
    else:
        b = b / np.maximum(np.linalg.norm(b, axis=-1, keepdims=True), 1e-12)
    return a @ b.T


def _order(matched: Dict, nearest: bool) -> List:
    """The matched keys shuffled (``random``), or by falling similarity."""
    order = list(matched.keys())
    random.shuffle(order)
    if nearest and order:
        order = [k for k, _ in sorted(matched.items(), key=lambda x: -x[1])]
    return order


def text_similarity(input_label: str, text_embedding: str,
                    output_label: str, thresholds=(0.9, 1.0),
                    max_caption_aug: Optional[int] = None,
                    nearest: bool = False, exclude_real: bool = False,
                    seed: int = 1) -> None:
    """Caption-similarity augmentation: the captions of other clips whose
    embedding (``text_embedding``: an h5 of ``{audio_id}_{cap_id}`` rows)
    lies within ``thresholds`` join a clip's as extra references."""
    random.seed(seed)
    keys, embeds = _h5_rows(text_embedding)
    sim = _cosine(np.stack(embeds))
    data = _load_audios(input_label)
    aid_to_idx = {a["audio_id"]: i for i, a in enumerate(data)}
    aid_len = len(next(iter(aid_to_idx)))
    for idx in range(sim.shape[0]):
        aid, cap_id = keys[idx][:aid_len], keys[idx][aid_len + 1:]
        matched = {keys[j]: sim[idx][j] for j in np.where(
            (sim[idx] > thresholds[0]) & (sim[idx] < thresholds[1]))[0]}
        n = 0
        for mk in _order(matched, nearest):
            m_aid, m_cap = mk[:aid_len], mk[aid_len + 1:]
            if m_aid == aid:
                continue
            n += 1
            aug = dict(data[aid_to_idx[m_aid]]["captions"][int(m_cap) - 1])
            aug["cap_id"] = f"{cap_id}_textaug_{n}"
            data[aid_to_idx[aid]]["captions"].append(aug)
            if max_caption_aug and n >= max_caption_aug:
                break
    if exclude_real:
        out = []
        for item in data:
            caps = [c for c in item["captions"] if "aug" in str(c["cap_id"])]
            if caps:
                out.append({"audio_id": item["audio_id"], "captions": caps})
        _dump_audios(out, output_label)
    else:
        _dump_audios(data, output_label)


def retrieve_similarity(annotation: str, sim_store: str, output: str,
                        thresholds=(0.0, 1.0),
                        max_caption_aug: Optional[int] = None,
                        nearest: bool = False, exclude_real: bool = False,
                        seed: int = 1) -> None:
    """An audio -> text retrieval pseudo corpus from a precomputed [audio x
    caption] similarity h5 (``sim``, ``audio_id``, optional ``text_id``)."""
    import h5py
    random.seed(seed)
    data = _load_audios(annotation)
    cap_map = {f"{a['audio_id']}_{c['cap_id']}": c
               for a in data for c in a["captions"]}
    with h5py.File(sim_store, "r") as store:
        sim = np.asarray(store["sim"])
        audio_ids = [x.decode() for x in store["audio_id"][()]]
        cap_ids = ([x.decode() for x in store["text_id"][()]]
                   if "text_id" in store else list(audio_ids))
        if len(data[0]["captions"]) == 1 and "text_id" not in store:
            cap_ids = [c + "_1" for c in cap_ids]
    if len(cap_map) != len(cap_ids):
        keep = [i for i, c in enumerate(cap_ids) if c in cap_map]
        sim = sim[:, keep]
        cap_ids = [cap_ids[i] for i in keep]
    aug_data = []
    for ai, aid in enumerate(audio_ids):
        matched = {cap_ids[j]: sim[ai][j] for j in np.where(
            (sim[ai] >= thresholds[0]) & (sim[ai] <= thresholds[1]))[0]}
        caps = []
        for n, ck in enumerate(_order(matched, nearest), 1):
            aug = dict(cap_map[ck])
            aug["cap_id"] = f"retriveaug_{n}"
            aug["similarity"] = f"{matched[ck]:.3f}"
            caps.append(aug)
            if max_caption_aug and n >= max_caption_aug:
                break
        if caps:
            aug_data.append({"audio_id": aid, "captions": caps})
    if exclude_real:
        print(f"{len(aug_data)} augment audio after filtering")
        _dump_audios(aug_data, output)
    else:
        _dump_audios(data, output)


def audio_similarity(ref_embedding: str, ref_caption: str,
                     new_embedding: str, output: str,
                     threshold: float = 0.95) -> None:
    """Cross-corpus caption transfer: every clip of ``new_embedding`` whose
    nearest reference clip (cosine of the h5 embeddings) lies above
    ``threshold`` takes that clip's captions."""
    r_ids, r_embs = _h5_rows(ref_embedding)
    n_ids, n_embs = _h5_rows(new_embedding)
    aid_to_caps = {a["audio_id"]: a["captions"]
                   for a in _load_audios(ref_caption)}
    sim = _cosine(np.stack(n_embs), np.stack(r_embs))
    out = []
    for i, aid in enumerate(n_ids):
        j = int(sim[i].argmax())
        if sim[i][j] > threshold and r_ids[j] in aid_to_caps:
            caps = []
            for n, c in enumerate(aid_to_caps[r_ids[j]], 1):
                cc = dict(c)
                cc["cap_id"] = f"audioaug_{n}"
                cc["similarity"] = f"{sim[i][j]:.3f}"
                caps.append(cc)
            out.append({"audio_id": aid, "captions": caps})
    print(f"{len(out)} of {len(n_ids)} clips matched above {threshold}")
    _dump_audios(out, output)


def filter_new_audio_aug(wav_csv: str, generator_pred: str,
                         event_generator_pred: str, retrieval_pred: str,
                         output: str, blacklist: Optional[str] = None,
                         min_sim: float = 0.5) -> None:
    """Pseudo captions for new audio: per clip of ``wav_csv`` (less the
    blacklist), the best of the generator's, the event generator's and the
    retrieval's caption by audio-text similarity, kept at ``min_sim`` or
    above."""
    bl = set()
    if blacklist:
        with open(blacklist) as f:
            bl = {line.strip() for line in f if line.strip()}
    with open(wav_csv) as f:
        aids = [aid for aid in (line.strip().split()[0]
                                for line in f.readlines()[1:])
                if aid not in bl]

    def load_preds(path):
        return {a["audio_id"]: a["captions"] for a in _load_audios(path)}

    g = load_preds(generator_pred)
    eg = load_preds(event_generator_pred)
    r = load_preds(retrieval_pred)
    out = []
    for aid in aids:
        sim, tokens = float(g[aid][0]["at_sim"]), g[aid][0]["tokens"]
        if float(eg[aid][0]["at_sim"]) > sim:
            sim, tokens = float(eg[aid][0]["at_sim"]), eg[aid][0]["tokens"]
        if aid in r and float(r[aid][0]["similarity"]) > sim:
            sim, tokens = float(r[aid][0]["similarity"]), r[aid][0]["tokens"]
        if sim >= min_sim:
            item = dict(g[aid][0])
            item["tokens"] = tokens
            item["at_sim"] = sim
            out.append({"audio_id": aid, "captions": [item]})
    print(f"{len(out)} data left after filtering")
    _dump_audios(out, output)


def _json_records(path: str) -> List[Dict]:
    """A label json as rows: a list of records, or pandas' default
    ``columns`` layout ({column: {row: value}}), rows in the order of the
    first column's."""
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, list):
        return data
    columns = list(data)
    return [{c: data[c][r] for c in columns} for r in data[columns[0]]]


def prepare_car(target: str, dev_label: str, eval_label: str) -> None:
    """AudioCaption-Car (zh) label jsons -> ``{dev,eval}/text.json``
    (prepare_car.py, the label paths as arguments): audio id
    ``car_{file name}``, dev cap ids ``{audio_id}_{caption_index}``, eval
    cap ids ``{caption_index}``."""
    def build(label_path: str, cap_id_fmt):
        data: Dict[str, Dict] = {}
        for row in _json_records(label_path):
            fname = Path(row["filename"]).name
            aid = f"car_{fname}"
            entry = data.setdefault(aid, {"raw_name": fname, "captions": []})
            entry["captions"].append({
                "caption": row["caption"],
                "cap_id": cap_id_fmt(aid, row["caption_index"])})
        return [{"audio_id": aid, "raw_name": v["raw_name"],
                 "captions": v["captions"]} for aid, v in data.items()]

    root = Path(target)
    _dump_audios(build(dev_label, lambda a, i: f"{a}_{i}"),
                 str(root / "dev" / "text.json"))
    _dump_audios(build(eval_label, lambda a, i: str(i)),
                 str(root / "eval" / "text.json"))


def extract_specificity(input_json: str, output_word_condition: str,
                        output_caption_condition: str,
                        sentence_reduce: str = "sum") -> None:
    """-log unigram frequency per word (a tsv), and per caption its sum or
    mean (``sentence_reduce``) over its words (extract_specificity.py)."""
    data = _load_audios(input_json)
    counter: Counter = Counter()
    total = 0
    for item in data:
        for cap in item["captions"]:
            toks = cap["tokens"].split()
            counter.update(toks)
            total += len(toks)
    word_cond = {w: -math.log(c / total) for w, c in counter.items()}
    with open(output_word_condition, "w") as f:
        f.write("word\tspecificity\n")
        for w, v in word_cond.items():
            f.write(f"{w}\t{v:.3f}\n")
    with open(output_caption_condition, "w") as f:
        f.write("cap_id\tspecificity\n")
        for item in data:
            for cap in item["captions"]:
                toks = cap["tokens"].split()
                s = sum(word_cond[t] for t in toks)
                if sentence_reduce == "mean":
                    s /= max(len(toks), 1)
                f.write(f"{item['audio_id']}_{cap['cap_id']}\t{s:.3f}\n")


_STOPWORDS = {
    "a", "an", "the", "is", "are", "was", "were", "be", "being", "been",
    "and", "or", "of", "in", "on", "at", "to", "with", "by", "for",
    "as", "it", "its", "this", "that", "then", "while", "there", "some",
    "very", "from", "into", "over", "under", "up", "down", "out",
}


def extract_keyword(annotation: str, output: str,
                    audio_keyword_file: Optional[str] = None,
                    keyword_vocab: Optional[str] = None) -> None:
    """Per-caption keyword tsv (keyword/extract_caption_keyword.py), by
    JAX's path for a host without stanza: the caption's alphabetic words
    that are not stopwords, lowercased, with the clip's tags of
    ``audio_keyword_file`` (a tsv of ``audio_id``, ``keywords`` joined by
    "; "), sorted, kept to ``keyword_vocab`` (one keyword a line) if
    given."""
    data = _load_audios(annotation)
    aid_to_kw: Dict[str, List[str]] = {}
    if audio_keyword_file:
        with open(audio_keyword_file, newline="") as f:
            aid_to_kw = {r["audio_id"]: [k for k in (r["keywords"] or "")
                                         .split("; ") if k]
                         for r in csv.DictReader(f, delimiter="\t")}
    vocab = None
    if keyword_vocab:
        with open(keyword_vocab) as f:
            vocab = {line.strip() for line in f if line.strip()}

    def candidates(text: str) -> List[str]:
        return [t.lower() for t in text.split()
                if t.lower() not in _STOPWORDS and t.isalpha()]

    with open(output, "w") as f:
        f.write("cap_id\tkeywords\n")
        for item in data:
            tags = aid_to_kw.get(item["audio_id"], [])
            for cap in item["captions"]:
                kws = sorted(set(tags + candidates(
                    cap.get("tokens", cap.get("caption", "")))))
                if vocab is not None:
                    kws = [k for k in kws if k in vocab]
                f.write(f"{item['audio_id']}_{cap['cap_id']}\t"
                        f"{'; '.join(kws)}\n")


def extract_syntax(input_json: str, server: str, parse_result: str,
                   output: str):
    """Not ported: needs a running CoreNLP server."""
    raise SystemExit("extract_syntax needs a running CoreNLP server "
                     "(reference extract_syntax.py), which the port does "
                     "not start; run the JAX package's tool against one")


def create_word_embedding(vocab_file: str, embed_size: int, output: str,
                          caption_file: Optional[str] = None,
                          pretrained_weights_path: Optional[str] = None,
                          window: int = 5, epochs: int = 10,
                          negatives: int = 5, lr: float = 0.025,
                          seed: int = 0, device: str = "cuda",
                          negative_ids=None) -> np.ndarray:
    """A [vocab, embed_size] float32 ``.npy`` for a ``DictTokenizer``
    vocabulary: rows from ``np.random.RandomState(seed).randn``, replaced
    by pretrained vectors (an npz of ``words`` and ``vectors``, PCA-reduced
    when wider) or by word2vec vectors trained on ``caption_file``'s
    tokens (``utils/word_embedding.py::train_word2vec`` on ``device``;
    ``negative_ids`` passes its negative draws).  -> the matrix."""
    from audiocaption_tpu_torch.data.tokenizer import DictTokenizer
    from audiocaption_tpu_torch.utils.word_embedding import (
        pca_reduce, train_word2vec)
    tokenizer = DictTokenizer(tokenizer_path=vocab_file)
    rng = np.random.RandomState(seed)
    emb = rng.randn(len(tokenizer), embed_size).astype(np.float32)
    if pretrained_weights_path:
        vecs = np.load(pretrained_weights_path, allow_pickle=True)
        if not isinstance(vecs, np.lib.npyio.NpzFile):
            raise SystemExit(
                "pretrained path must be an npz with 'words' + 'vectors'"
                " (binary gensim formats need gensim, absent here)")
        words = [str(w) for w in vecs["words"]]
        mat = np.asarray(vecs["vectors"], np.float32)
        if mat.shape[1] > embed_size:
            mat = pca_reduce(mat, embed_size)
        vectors = dict(zip(words, mat))
        unseen = "vocab words not in pretrained vectors (random init)"
    else:
        sentences = [c["tokens"].split() for item in _load_audios(caption_file)
                     for c in item["captions"]]
        vectors = train_word2vec(sentences, embed_size, window=window,
                                 epochs=epochs, negatives=negatives, lr=lr,
                                 seed=seed, device=device,
                                 negative_ids=negative_ids)
        unseen = "vocab words unseen in the corpus (random init)"
    missing = 0
    for word, idx in tokenizer.word2idx.items():
        if word in vectors:
            emb[idx] = vectors[word]
        else:
            missing += 1
    print(f"{missing} {unseen}")
    np.save(output, emb)
    print(f"wrote [{emb.shape[0]}, {emb.shape[1]}] embeddings to {output}")
    return emb


def predict_nrst_ngbr(train_feature: str, train_corpus: str,
                      pred_feature: str, output_json: str,
                      seed: int = 1) -> None:
    """Nearest-neighbour caption transfer: each clip of ``pred_feature``
    takes a random caption (``random.seed(seed)``) of its nearest train
    clip by cosine of the h5 features (predict_nrst_ngbr.py)."""
    random.seed(seed)
    tr_ids, tr_embs = _h5_rows(train_feature)
    aid_to_tokens = {a["audio_id"]: [c["tokens"] for c in a["captions"]]
                     for a in _load_audios(train_corpus)}
    pr_ids, pr_embs = _h5_rows(pred_feature)
    sim = _cosine(np.stack(pr_embs), np.stack(tr_embs))
    preds = []
    for i, aid in enumerate(pr_ids):
        nn = tr_ids[int(sim[i].argmax())]
        preds.append({"filename": aid,
                      "tokens": random.choice(aid_to_tokens[nn])})
    Path(output_json).parent.mkdir(parents=True, exist_ok=True)
    with open(output_json, "w") as f:
        json.dump({"predictions": preds}, f, indent=4, ensure_ascii=False)


def model_eval_diff(prediction_json: str, caption_json: str, output: str,
                    zh: bool = False) -> None:
    """BLEU-4, CIDEr-D and ROUGE-L on all references minus their mean over
    the single-reference subsets (model_eval_diff.py; the port's
    ``metrics/``)."""
    from audiocaption_tpu_torch.data.dataset import load_caption_json
    from audiocaption_tpu_torch.metrics.eval import evaluate_captions
    with open(prediction_json) as f:
        preds = json.load(f)["predictions"]
    key2pred = {p["filename"]: [p.get("tokens", p.get("caption", ""))]
                for p in preds}
    key2refs = {k: v for k, v in load_caption_json(caption_json, zh=zh).items()
                if k in key2pred}
    n_refs = min(len(v) for v in key2refs.values())
    full = evaluate_captions(key2pred, key2refs, zh=zh)
    metrics = ("bleu_4", "cider", "rouge_l")
    loo = {m: 0.0 for m in metrics}
    for i in range(n_refs):
        r = evaluate_captions(key2pred, {k: [v[i]] for k, v in key2refs.items()},
                              zh=zh)
        for m in metrics:
            loo[m] += r[m] / n_refs
    with open(output, "w") as f:
        f.write("Diff (all refs - mean single ref):\n")
        for m in metrics:
            f.write(f"{m}: {full[m] - loo[m]:6.3f}\n")
    print(f"wrote {output}")


def pred_to_anno(prediction_input: str, annotation_output: str,
                 wav_csv: Optional[str] = None) -> None:
    """A prediction json -> an annotation json whose one reference (cap id
    "1") is each prediction, kept to ``wav_csv``'s ids if given; the flat
    {audio_id: tokens} form takes ``aid[1:12]`` as the id, as
    pred_to_anno.py does (AudioCaps ``Y{youtube_id}.wav``)."""
    target = None
    if wav_csv:
        with open(wav_csv) as f:
            rows = [ln.split("\t") for ln in f.read().splitlines()[1:]]
        target = {r[0] for r in rows if r}
    with open(prediction_input) as f:
        preds = json.load(f)
    if "predictions" in preds:
        pairs = ((item["filename"], item["tokens"])
                 for item in preds["predictions"])
    else:
        pairs = ((aid[1:12], tokens) for aid, tokens in preds.items())
    data = [{"audio_id": aid, "captions": [{"cap_id": "1", "tokens": tokens}]}
            for aid, tokens in pairs if target is None or aid in target]
    with open(annotation_output, "w") as f:
        json.dump({"audios": data}, f, indent=4, ensure_ascii=False)
    print(f"wrote {len(data)} audios to {annotation_output}")


def concat_anno_json(input_jsons, output_json: str,
                     indent: Optional[int] = None) -> None:
    """Merge annotation jsons; an audio id seen again extends its
    captions."""
    merged: Dict[str, Dict] = {}
    for path in input_jsons:
        with open(path, encoding="utf-8") as f:
            audios = json.load(f)["audios"]
        print(f"{path}: {len(audios)} audio clips")
        for item in audios:
            if item["audio_id"] in merged:
                merged[item["audio_id"]]["captions"].extend(item["captions"])
            else:
                merged[item["audio_id"]] = item
    print(f"new json has {len(merged)} audio clips")
    with open(output_json, "w") as f:
        json.dump({"audios": list(merged.values())}, f, indent=indent,
                  ensure_ascii=False)


def concat_pred_json(input_jsons, output_json: str) -> None:
    """Merge prediction jsons; a file name seen again extends its token
    list."""
    merged: Dict[str, List] = {}
    for path in input_jsons:
        with open(path, encoding="utf-8") as f:
            for item in json.load(f)["predictions"]:
                tokens = item["tokens"]
                if isinstance(tokens, str):
                    tokens = [tokens]
                merged.setdefault(item["filename"], []).extend(tokens)
    data = [{"filename": k, "tokens": v} for k, v in merged.items()]
    with open(output_json, "w") as f:
        json.dump({"predictions": data}, f, indent=4, ensure_ascii=False)


def prepare_wav_csv(audio_directory: str, output_csv: str,
                    recursive: bool = False, prefix: str = "") -> None:
    """A directory's .wav / .mp3 / .flac files -> a wav csv of
    ``audio_id`` (``prefix`` + file name) and ``file_name`` (absolute)."""
    root = Path(audio_directory)
    names = root.rglob("*") if recursive else root.iterdir()
    n = 0
    with open(output_csv, "w") as f:
        f.write("audio_id\tfile_name\n")
        for p in sorted(names):
            if p.suffix in (".wav", ".mp3", ".flac"):
                f.write(f"{prefix + p.name}\t{p.absolute()}\n")
                n += 1
    print(f"wrote {n} rows to {output_csv}")


def wavcsv_from_textjson(annotation: str, waveform_csv: str,
                         output: str) -> None:
    """``waveform_csv``'s rows of the audio ids of ``annotation``, in its
    order, as ``audio_id``, ``hdf5_path``."""
    aid_to_h5 = {}
    with open(waveform_csv) as f:
        rows = f.read().splitlines()
    for ln in rows[1:]:
        parts = ln.split("\t")
        if len(parts) >= 2:
            aid_to_h5[parts[0]] = parts[1]
    audios = _load_audios(annotation)
    with open(output, "w") as f:
        f.write("audio_id\thdf5_path\n")
        for item in audios:
            f.write(f"{item['audio_id']}\t{aid_to_h5[item['audio_id']]}\n")
    print(f"wrote {len(audios)} rows to {output}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="audiocaption_tpu_torch.cli.data_tools")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("speed_perturb")
    s.add_argument("input_dir")
    s.add_argument("output_dir")
    s.add_argument("--speeds", type=float, nargs="+", default=[0.9, 1.1])
    s.add_argument("--sr", type=int, default=16000)
    s.add_argument("--compute", action="store_true")
    s.add_argument("--wav_csv", default=None)
    s.add_argument("--text_json", default=None)

    s = sub.add_parser("back_translate")
    s.add_argument("input")
    s.add_argument("output")
    s.add_argument("--batch_size", type=int, default=32)

    s = sub.add_parser("subset_concat")
    s.add_argument("set_a")
    s.add_argument("set_b")
    s.add_argument("subset_a_output")
    s.add_argument("all_output")
    s.add_argument("--a_percent", type=float, required=True)
    s.add_argument("--seed", type=int, default=1)
    s.add_argument("--total_number", type=int, default=None)

    for name, first, low in (("text_similarity", ("input_label",
                                                  "text_embedding",
                                                  "output_label"), 0.9),
                             ("retrieve_similarity", ("annotation",
                                                      "sim_store", "output"),
                              0.0)):
        s = sub.add_parser(name)
        for arg in first:
            s.add_argument(arg)
        s.add_argument("--thresholds", type=float, nargs=2,
                       default=[low, 1.0])
        s.add_argument("--max_caption_aug", type=int, default=None)
        s.add_argument("--nearest", action="store_true")
        s.add_argument("--exclude_real", action="store_true")

    s = sub.add_parser("audio_similarity")
    for arg in ("ref_embedding", "ref_caption", "new_embedding", "output"):
        s.add_argument(arg)
    s.add_argument("--threshold", type=float, default=0.95)

    s = sub.add_parser("filter_new_audio_aug")
    for arg in ("wav_csv", "generator_pred", "event_generator_pred",
                "retrieval_pred", "output"):
        s.add_argument(arg)
    s.add_argument("--blacklist", default=None)
    s.add_argument("--min_sim", type=float, default=0.5)

    s = sub.add_parser("prepare_car")
    s.add_argument("target")
    s.add_argument("--dev_label", required=True)
    s.add_argument("--eval_label", required=True)

    s = sub.add_parser("extract_specificity")
    for arg in ("input_json", "output_word_condition",
                "output_caption_condition"):
        s.add_argument(arg)
    s.add_argument("--sentence_reduce", default="sum",
                   choices=["mean", "sum"])

    s = sub.add_parser("extract_keyword")
    s.add_argument("annotation")
    s.add_argument("output")
    s.add_argument("--audio_keyword_file", default=None)
    s.add_argument("--keyword_vocab", default=None)

    s = sub.add_parser("extract_syntax")
    s.add_argument("input_json")
    s.add_argument("server")
    s.add_argument("parse_result", choices=["constituent", "pos"])
    s.add_argument("output")

    s = sub.add_parser("create_word_embedding")
    s.add_argument("vocab_file")
    s.add_argument("embed_size", type=int)
    s.add_argument("output")
    s.add_argument("--caption_file", default=None)
    s.add_argument("--pretrained_weights_path", default=None)
    s.add_argument("--window", type=int, default=5)
    s.add_argument("--epochs", type=int, default=10)
    s.add_argument("--negatives", type=int, default=5)
    s.add_argument("--lr", type=float, default=0.025)
    s.add_argument("--device", default="cuda")

    s = sub.add_parser("predict_nrst_ngbr")
    for arg in ("train_feature", "train_corpus", "pred_feature",
                "output_json"):
        s.add_argument(arg)

    s = sub.add_parser("model_eval_diff")
    for arg in ("prediction_json", "caption_json", "output"):
        s.add_argument(arg)
    s.add_argument("--zh", action="store_true")

    s = sub.add_parser("pred_to_anno")
    s.add_argument("prediction_input")
    s.add_argument("annotation_output")
    s.add_argument("--wav_csv", default=None)

    s = sub.add_parser("concat_anno_json")
    s.add_argument("input_jsons", nargs="+")
    s.add_argument("output_json")
    s.add_argument("--indent", type=int, default=None)

    s = sub.add_parser("concat_pred_json")
    s.add_argument("input_jsons", nargs="+")
    s.add_argument("output_json")

    s = sub.add_parser("prepare_wav_csv")
    s.add_argument("audio_directory")
    s.add_argument("output_csv")
    s.add_argument("--recursive", action="store_true")
    s.add_argument("--prefix", default="")

    s = sub.add_parser("wavcsv_from_textjson")
    for arg in ("annotation", "waveform_csv", "output"):
        s.add_argument(arg)

    args = vars(p.parse_args(argv))
    return globals()[args.pop("cmd")](**args)


if __name__ == "__main__":
    main()
