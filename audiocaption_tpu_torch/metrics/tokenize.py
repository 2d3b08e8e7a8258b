"""Caption normalisation before scoring (a copy of
``audiocaption_tpu/metrics/tokenize.py``).

The reference shells out to the Java Stanford PTBTokenizer through
pycocoevalcap.  This module applies the same normalisation to caption
text without a JVM: clitics split off, brackets and the COCO punctuation
set removed, lowercased, split on whitespace.
"""

from __future__ import annotations

import re
from typing import Dict, List

# Punctuation removed by PTBTokenizer (pycocoevalcap tokenizer.py)
_PUNCT = ["''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
          ".", "?", "!", ",", ":", "-", "--", "...", ";"]
_PUNCT_SET = set(_PUNCT)

_CLITIC_RE = re.compile(r"(\w)('s|'re|'ve|'ll|'d|'m|n't)\b",
                        re.IGNORECASE)
_CLITICS = {"'s", "'re", "'ve", "'ll", "'d", "'m", "n't"}


def ptb_tokenize_sentence(text: str) -> str:
    text = text.replace("\n", " ")
    # separate clitics like PTB ("dog's" -> "dog 's")
    text = _CLITIC_RE.sub(r"\1 \2", text)
    # brackets become -LRB-/-RRB-/... in PTB, all of which the COCO
    # punctuation list removes — drop them directly
    text = re.sub(r"[(){}\[\]]", " ", text)
    # split dashes/ellipses, then single sentence punctuation, off words
    text = re.sub(r"(\.\.\.+|--+)(?=\s|$)", r" \1 ", text)
    text = re.sub(r"([.,!?:;])(?=\s|$)", r" \1 ", text)
    tokens = []
    for t in text.split():
        tl = t.lower()
        # drop pure-punctuation tokens (the COCO list plus runs like
        # '..' left by ellipsis splitting — all removed by PTB+COCO)
        if tl in _PUNCT_SET or re.fullmatch(r"[.,!?:;'\"`-]+", tl):
            continue
        if tl not in _CLITICS:
            # straight/back quotes are emitted as standalone ``/'' PTB
            # tokens (removed); strip them off glued words
            tl = tl.strip("'\"`")
        if tl and tl not in _PUNCT_SET:
            tokens.append(tl)
    return " ".join(tokens)


def ptb_tokenize(key2captions: Dict[str, List[str]]
                 ) -> Dict[str, List[str]]:
    return {k: [ptb_tokenize_sentence(c) for c in caps]
            for k, caps in key2captions.items()}
