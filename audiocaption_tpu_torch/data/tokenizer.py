"""Word-level caption tokenizer (counterpart of the ``DictTokenizer`` of
``audiocaption_tpu/data/tokenizer.py``; reference
``captioning/datasets/text_tokenizer.py``).

Special ids are fixed by construction order: <pad>=0, <start>=1,
<end>=2, <unk>=3.  ``state_dict`` is the raw word -> id dict, so the
reference's vocab.pkl files and the tokenizer state stored in
checkpoints load directly.
"""

from __future__ import annotations

import json
import pickle
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np


def pad_sequence_list(seqs: List[np.ndarray], pad_value: int):
    """[arrays of varying length] -> (padded [N, Lmax] int64, lens [N])."""
    lens = np.asarray([len(s) for s in seqs], np.int32)
    out = np.full((len(seqs), int(lens.max())), pad_value, np.int64)
    for i, s in enumerate(seqs):
        out[i, :len(s)] = s
    return out, lens


class DictTokenizer:

    def __init__(self, tokenizer_path: Optional[str] = None,
                 max_length: int = 20) -> None:
        self.word2idx: Dict[str, int] = {}
        self.idx2word: Dict[int, str] = {}
        self.idx = 0
        for tok in ("<pad>", "<start>", "<end>", "<unk>"):
            self.add_word(tok)
        self.loaded = False
        if tokenizer_path is not None and Path(tokenizer_path).exists():
            with open(tokenizer_path, "rb") as f:
                self.load_state_dict(pickle.load(f))
            self.loaded = True
        self.bos = self.word2idx["<start>"]
        self.eos = self.word2idx["<end>"]
        self.pad = self.word2idx["<pad>"]
        self.max_length = max_length

    def add_word(self, word: str) -> None:
        if word not in self.word2idx:
            self.word2idx[word] = self.idx
            self.idx2word[self.idx] = word
            self.idx += 1

    def encode_word(self, word: str) -> int:
        return self.word2idx.get(word, self.word2idx["<unk>"])

    def __call__(self, texts: List[str]) -> Dict[str, np.ndarray]:
        """Captions -> {cap [N, L] <start> ids <end> padded, cap_len [N]};
        each caption keeps its first ``max_length`` words."""
        if not isinstance(texts, list):
            raise TypeError("the input must be List[str]")
        batch = []
        for text in texts:
            tokens = [self.encode_word(t)
                      for t in text.split()][:self.max_length]
            batch.append(np.asarray([self.bos] + tokens + [self.eos]))
        caps, cap_lens = pad_sequence_list(batch, self.pad)
        return {"cap": caps, "cap_len": cap_lens}

    def decode(self, batch_token_ids) -> List[str]:
        """Ids -> words up to the first <end>, <start> skipped."""
        out = []
        for token_ids in batch_token_ids:
            tokens = []
            for tid in token_ids:
                tid = int(tid)
                if tid == self.eos:
                    break
                if tid == self.bos:
                    continue
                tokens.append(self.idx2word[tid])
            out.append(" ".join(tokens))
        return out

    def __len__(self) -> int:
        return len(self.word2idx)

    def state_dict(self) -> Dict[str, int]:
        return self.word2idx

    def load_state_dict(self, state_dict: Dict[str, int]) -> None:
        self.word2idx = dict(state_dict)
        self.idx2word = {i: w for w, i in self.word2idx.items()}
        self.idx = len(self.word2idx)

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(self.state_dict(), f)


def build_vocab(caption_json: str, threshold: int = 1,
                output_path: Optional[str] = None,
                max_length: int = 20) -> DictTokenizer:
    """A ``DictTokenizer`` vocabulary from a caption json ({"audios":
    [{audio_id, captions: [{caption | tokens, cap_id}]}]}): the four
    special words, then every word of the captions' ``tokens`` (else
    ``caption``) counted at least ``threshold`` times, in sorted order
    (``audiocaption_tpu/data/tokenizer.py::build_vocab``; the reference's
    ``python_scripts/utils/build_custom_tokenizer.py``).  Written as the
    pickled word -> id dict to ``output_path`` if given."""
    with open(caption_json) as f:
        data = json.load(f)
    counter: Counter = Counter()
    for audio in data["audios"]:
        for cap in audio["captions"]:
            counter.update(cap.get("tokens", cap.get("caption", "")).split())
    tok = DictTokenizer(max_length=max_length)
    for word, count in sorted(counter.items()):
        if count >= threshold:
            tok.add_word(word)
    tok.loaded = True
    if output_path:
        tok.save(output_path)
    return tok
