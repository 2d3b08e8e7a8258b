"""``spice_py``: SPICE's scoring idea without a parser, a copy of
``audiocaption_tpu/metrics/spice.py``.

The reference scores SPICE through pycocoevalcap's Java jar, which needs
a JVM and the Stanford dependency parser.  This module keeps SPICE's
score, the F1 over semantic propositions (objects, attributes,
relations) between the candidate and the merged reference scene graph
(Anderson et al. 2016), with a lexicon-based proposition extractor in
place of the parse:

  * tokens split into CONTENT chunks at a closed-class boundary lexicon
    (determiners, prepositions, conjunctions, light verbs, temporal
    connectives);
  * a chunk's last word is its object head, the others its attributes
    -> tuples (head,) and (attr, head);
  * the boundary words BETWEEN consecutive chunks map onto a small
    relation vocabulary (after / before / while / and / with)
    -> tuples (head_i, rel, head_j);
  * words match exactly or by Porter stem.

The score is an APPROXIMATION, reported only as ``spice_py`` (and
``spider_py`` = (CIDEr-D + spice_py) / 2), never as ``spice`` or
``spider``.  On the synthetic corpora's grammar (determiner + modifier +
head noun phrases joined by temporal connectives) the extractor finds the
intended propositions; on free English it is a heuristic.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, List, Sequence, Tuple

from audiocaption_tpu_torch.metrics.meteor import stem as _stem

# closed-class boundary lexicon: words that never head an object chunk
_DETERMINERS = {"a", "an", "the", "some", "this", "that", "these",
                "those", "its", "their", "his", "her", "one", "another",
                "only", "no"}
_PREPOSITIONS = {"of", "in", "on", "at", "by", "with", "to", "from",
                 "over", "under", "into", "through", "near", "behind",
                 "above", "below", "without", "against"}
_CONNECTIVES = {"and", "then", "while", "as", "before", "after",
                "during", "until", "when", "meanwhile", "finally",
                "first", "last", "next"}
_LIGHT_VERBS = {"is", "are", "was", "were", "be", "been", "being",
                "comes", "come", "sounds", "sound", "heard", "hear",
                "hears", "plays", "play", "playing", "joins", "join",
                "gives", "give", "way", "follows", "followed",
                "can", "makes", "make", "made", "sounding", "goes",
                "go", "there", "it", "someone", "something"}
_ADVERBS = {"steadily", "loudly", "softly", "quietly", "alone",
            "together", "again", "repeatedly", "briefly", "slowly",
            "quickly", "down", "up", "away", "along", "same", "time",
            "other", "each"}
_BOUNDARY = (_DETERMINERS | _PREPOSITIONS | _CONNECTIVES | _LIGHT_VERBS
             | _ADVERBS)

# relation normalization: boundary words -> canonical relation
_REL_MAP = {
    "after": "after", "followed": "after", "follows": "after",
    "then": "after", "next": "after", "comes": "after",
    "finally": "after", "last": "after",
    "before": "before", "until": "before",
    "while": "while", "during": "while", "together": "while",
    "joins": "while", "meanwhile": "while", "when": "while",
    "as": "while", "same": "while",
    "with": "with",
    "and": "and",
    "way": "after",     # "gives way to"
}

Tuple_ = Tuple[str, ...]


def _segments(tokens: Sequence[str]) -> List[Tuple[str, List[str]]]:
    """Alternating ('B', boundary words) / ('C', content words) runs."""
    segs: List[Tuple[str, List[str]]] = []
    for w in tokens:
        w = w.lower().strip(".,!?;:")
        if not w:
            continue
        kind = "B" if w in _BOUNDARY else "C"
        if segs and segs[-1][0] == kind:
            segs[-1][1].append(w)
        else:
            segs.append((kind, [w]))
    return segs


def propositions(tokens: Sequence[str]) -> FrozenSet[Tuple_]:
    """Caption tokens -> frozenset of stemmed proposition tuples."""
    segs = _segments(tokens)
    chunks: List[List[str]] = [ws for kind, ws in segs if kind == "C"]
    # boundary runs BETWEEN consecutive chunks, in order, plus the
    # sentence-leading run ("after a X a Y ..." carries its relation
    # before the first chunk)
    leading: List[str] = []
    if segs and segs[0][0] == "B":
        leading = segs[0][1]
    between: List[List[str]] = []
    seen_chunk = False
    pending: List[str] = []
    for kind, ws in segs:
        if kind == "C":
            if seen_chunk:
                between.append(pending)
            pending = []
            seen_chunk = True
        else:
            pending = ws
    trailing: List[str] = pending   # boundary run after the last chunk

    out = set()
    heads = []
    for ch in chunks:
        head = _stem(ch[-1])
        heads.append(head)
        out.add((head,))
        for attr in ch[:-1]:
            out.add((_stem(attr), head))
    for i in range(1, len(heads)):
        bw = between[i - 1] if i - 1 < len(between) else []
        rel = None
        for w in bw:
            if w in _REL_MAP:
                cand = _REL_MAP[w]
                # prefer a temporal relation over bare "and"/"with"
                if rel is None or cand not in ("and", "with"):
                    rel = cand
                if rel not in ("and", "with"):
                    break
        if (rel in (None, "and") and i == 1
                and any(w in ("after", "first") for w in leading)):
            # "after a X(,) a Y ..." / "first a X and a Y": the leading
            # connective carries the sequence for the first pair
            rel = "after"
        if rel in (None, "and") and i == len(heads) - 1:
            # "a X and a Y at the same time / together": the trailing
            # run carries the simultaneity for the final pair
            if any(_REL_MAP.get(w) == "while" for w in trailing):
                rel = "while"
        if rel is not None:
            # temporal normalization: (X, "after", Y) means X sounds
            # first and Y comes after it.  "X before Y" keeps mention
            # order (X earlier); "Y comes/sounds after X" inverts it
            # (Y is the later one).
            if rel == "before":
                out.add((heads[i - 1], "after", heads[i]))
            elif rel == "after" and _saying_comes_after(bw):
                out.add((heads[i], "after", heads[i - 1]))
            else:
                out.add((heads[i - 1], rel, heads[i]))
    return frozenset(out)


def _saying_comes_after(between: Sequence[str]) -> bool:
    """'comes after' / 'sounds after' patterns invert mention order."""
    ws = list(between)
    for i, w in enumerate(ws):
        if w == "after" and i > 0 and ws[i - 1] in ("comes", "sounds",
                                                    "come", "sound"):
            return True
    return False


def spice_pair_f1(cand: FrozenSet[Tuple_],
                  refs: FrozenSet[Tuple_]) -> float:
    """F1 of candidate propositions vs the merged reference graph."""
    if not cand and not refs:
        return 1.0
    if not cand or not refs:
        return 0.0
    tp = len(cand & refs)
    p = tp / len(cand)
    r = tp / len(refs)
    return 0.0 if p + r == 0 else 2 * p * r / (p + r)


def spice_py(key2pred: Dict[str, List[str]],
             key2refs: Dict[str, List[str]]
             ) -> Tuple[float, Dict[str, float]]:
    """Corpus SPICE approximation -> (mean F1, per-key F1).

    Reference graphs are the UNION of the per-reference propositions
    (SPICE merges reference scene graphs before matching)."""
    per_key: Dict[str, float] = {}
    for k, preds in key2pred.items():
        cand = propositions(preds[0].split())
        merged = set()
        for r in key2refs[k]:
            merged |= propositions(r.split())
        per_key[k] = spice_pair_f1(cand, frozenset(merged))
    avg = sum(per_key.values()) / max(len(per_key), 1)
    return avg, per_key
