"""The Porter stemmer (Porter, "An algorithm for suffix stripping",
Program 14.3 (1980): 130-137) in the NLTK_EXTENSIONS mode of nltk's
``nltk.stem.porter.PorterStemmer``, the default mode, which the JAX
package's ``meteor_py`` and ``spice_py`` stem through.

Carried here as source so that the port's scorers need no nltk: a
transcription of nltk 3.10's ``porter.py`` (Copyright (C) 2001-2024 NLTK
Project, Apache License 2.0), restricted to that one mode, with the same
rules in the same order.  ``tests/test_torch_metrics.py`` holds it word
for word against nltk's stemmer.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

_VOWELS = frozenset("aeiou")

# NLTK's table of irregular forms: form -> stem
_IRREGULAR = {form: stem for stem, forms in {
    "sky": ["sky", "skies"], "die": ["dying"], "lie": ["lying"],
    "tie": ["tying"], "news": ["news"], "inning": ["innings", "inning"],
    "outing": ["outings", "outing"], "canning": ["cannings", "canning"],
    "howe": ["howe"], "proceed": ["proceed"], "exceed": ["exceed"],
    "succeed": ["succeed"]}.items() for form in forms}

Rule = Tuple[str, str, Optional[Callable[[str], bool]]]


def _is_consonant(word: str, i: int) -> bool:
    """A letter other than a vowel, and other than a 'y' after a
    consonant (a run of 'y's alternates)."""
    if word[i] in _VOWELS:
        return False
    if word[i] == "y":
        negate = False
        while i > 0 and word[i] == "y":
            negate = not negate
            i -= 1
        return (word[i] not in _VOWELS) != negate
    return True


def _measure(stem: str) -> int:
    """m in [C](VC){m}[V]."""
    cv = "".join("c" if _is_consonant(stem, i) else "v"
                 for i in range(len(stem)))
    return cv.count("vc")


def _positive(stem: str) -> bool:
    return _measure(stem) > 0


def _above_one(stem: str) -> bool:
    return _measure(stem) > 1


def _contains_vowel(stem: str) -> bool:
    return any(not _is_consonant(stem, i) for i in range(len(stem)))


def _ends_double_consonant(word: str) -> bool:
    return (len(word) >= 2 and word[-1] == word[-2]
            and _is_consonant(word, len(word) - 1))


def _ends_cvc(word: str) -> bool:
    """*o: the stem ends cvc, the second c not w, x or y; or (NLTK) is a
    vowel and a consonant."""
    return (len(word) >= 3 and _is_consonant(word, len(word) - 3)
            and not _is_consonant(word, len(word) - 2)
            and _is_consonant(word, len(word) - 1)
            and word[-1] not in ("w", "x", "y")) or (
        len(word) == 2 and not _is_consonant(word, 0)
        and _is_consonant(word, 1))


def _cut(word: str, suffix: str) -> str:
    return word[:-len(suffix)] if suffix else word


def _apply_rules(word: str, rules: List[Rule]) -> str:
    """The first rule whose suffix matches decides: its replacement if
    its condition holds, else the word unchanged.  The suffix "*d" is a
    double consonant (two letters cut)."""
    for suffix, replacement, condition in rules:
        if suffix == "*d" and _ends_double_consonant(word):
            stem = word[:-2]
        elif word.endswith(suffix):
            stem = _cut(word, suffix)
        else:
            continue
        if condition is None or condition(stem):
            return stem + replacement
        return word
    return word


def _step1a(word: str) -> str:
    if word.endswith("ies") and len(word) == 4:
        return _cut(word, "ies") + "ie"
    return _apply_rules(word, [("sses", "ss", None), ("ies", "i", None),
                               ("ss", "ss", None), ("s", "", None)])


def _step1b(word: str) -> str:
    if word.endswith("ied"):
        return _cut(word, "ied") + ("ie" if len(word) == 4 else "i")
    if word.endswith("eed"):
        stem = _cut(word, "eed")
        return stem + "ee" if _measure(stem) > 0 else word
    for suffix in ("ed", "ing"):
        if word.endswith(suffix):
            inter = _cut(word, suffix)
            if _contains_vowel(inter):
                break
    else:
        return word
    return _apply_rules(inter, [
        ("at", "ate", None), ("bl", "ble", None), ("iz", "ize", None),
        ("*d", inter[-1], lambda stem: inter[-1] not in ("l", "s", "z")),
        ("", "e", lambda stem: _measure(stem) == 1 and _ends_cvc(stem))])


def _step1c(word: str) -> str:
    return _apply_rules(word, [(
        "y", "i",
        lambda stem: len(stem) > 1 and _is_consonant(stem, len(stem) - 1))])


def _step2(word: str) -> str:
    if word.endswith("alli") and _positive(_cut(word, "alli")):
        return _step2(_cut(word, "alli") + "al")
    return _apply_rules(word, [
        ("ational", "ate", _positive), ("tional", "tion", _positive),
        ("enci", "ence", _positive), ("anci", "ance", _positive),
        ("izer", "ize", _positive), ("bli", "ble", _positive),
        ("alli", "al", _positive), ("entli", "ent", _positive),
        ("eli", "e", _positive), ("ousli", "ous", _positive),
        ("ization", "ize", _positive), ("ation", "ate", _positive),
        ("ator", "ate", _positive), ("alism", "al", _positive),
        ("iveness", "ive", _positive), ("fulness", "ful", _positive),
        ("ousness", "ous", _positive), ("aliti", "al", _positive),
        ("iviti", "ive", _positive), ("biliti", "ble", _positive),
        ("fulli", "ful", _positive),
        # the 'l' of 'logi' stays with the stem
        ("logi", "log", lambda stem: _positive(word[:-3]))])


def _step3(word: str) -> str:
    return _apply_rules(word, [
        ("icate", "ic", _positive), ("ative", "", _positive),
        ("alize", "al", _positive), ("iciti", "ic", _positive),
        ("ical", "ic", _positive), ("ful", "", _positive),
        ("ness", "", _positive)])


def _step4(word: str) -> str:
    return _apply_rules(word, [
        ("al", "", _above_one), ("ance", "", _above_one),
        ("ence", "", _above_one), ("er", "", _above_one),
        ("ic", "", _above_one), ("able", "", _above_one),
        ("ible", "", _above_one), ("ant", "", _above_one),
        ("ement", "", _above_one), ("ment", "", _above_one),
        ("ent", "", _above_one),
        ("ion", "", lambda stem: _measure(stem) > 1 and stem[-1] in "st"),
        ("ou", "", _above_one), ("ism", "", _above_one),
        ("ate", "", _above_one), ("iti", "", _above_one),
        ("ous", "", _above_one), ("ive", "", _above_one),
        ("ize", "", _above_one)])


def _step5a(word: str) -> str:
    if word.endswith("e"):
        stem = _cut(word, "e")
        if _measure(stem) > 1:
            return stem
        if _measure(stem) == 1 and not _ends_cvc(stem):
            return stem
    return word


def _step5b(word: str) -> str:
    return _apply_rules(word, [("ll", "l",
                                lambda stem: _measure(word[:-1]) > 1)])


def porter_stem(word: str) -> str:
    """The stem of ``word``, lowercased, as nltk's ``PorterStemmer().stem``
    gives it."""
    stem = word.lower()
    if stem in _IRREGULAR:
        return _IRREGULAR[stem]
    if len(word) <= 2:
        return stem
    for step in (_step1a, _step1b, _step1c, _step2, _step3, _step4,
                 _step5a, _step5b):
        stem = step(stem)
    return stem
