"""Porter stemmer (Porter 1980), full algorithm, deterministic, no data.

The port's copy of `unpaired_image_captioning_tpu/eval/metrics/porter.py`,
host code copied as it is.

Used by the METEOR stem stage (the reference METEOR-1.5 jar embeds a Porter
stemmer; `coco-caption/pycocoevalcap/meteor/meteor.py:18-24` — jar stripped
upstream). This follows the canonical published algorithm including the two
standard departures of the author's reference implementation
(Step 2: ``bli -> ble`` instead of ``abli -> able``, plus ``logi -> log``).
Verified against the published example vectors in
tests/test_metrics.py::test_porter_vectors.
"""

from __future__ import annotations


def _is_cons(w: str, i: int) -> bool:
    c = w[i]
    if c in "aeiou":
        return False
    if c == "y":
        return i == 0 or not _is_cons(w, i - 1)
    return True


def _measure(stem: str) -> int:
    """Number of VC sequences in [C](VC){m}[V]."""
    m = 0
    i, n = 0, len(stem)
    while i < n and _is_cons(stem, i):
        i += 1
    while i < n:
        while i < n and not _is_cons(stem, i):
            i += 1
        if i >= n:
            break
        m += 1
        while i < n and _is_cons(stem, i):
            i += 1
    return m


def _has_vowel(stem: str) -> bool:
    return any(not _is_cons(stem, i) for i in range(len(stem)))


def _ends_double_cons(w: str) -> bool:
    return (len(w) >= 2 and w[-1] == w[-2] and _is_cons(w, len(w) - 1))


def _cvc(w: str) -> bool:
    """*o: stem ends cvc where the final c is not w, x or y."""
    if len(w) < 3:
        return False
    if (_is_cons(w, len(w) - 3) and not _is_cons(w, len(w) - 2)
            and _is_cons(w, len(w) - 1)):
        return w[-1] not in "wxy"
    return False


def _replace(w: str, suf: str, rep: str, min_m: int) -> str | None:
    """If w ends with suf and measure(stem) > min_m-? — returns replacement
    or None. min_m is the m threshold the STEM must exceed (m > min_m - 1
    i.e. m >= min_m)."""
    if not w.endswith(suf):
        return None
    stem = w[: len(w) - len(suf)]
    if _measure(stem) >= min_m:
        return stem + rep
    return w  # suffix matched but condition failed: stop scanning this step


_STEP2 = [("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
          ("anci", "ance"), ("izer", "ize"), ("bli", "ble"), ("alli", "al"),
          ("entli", "ent"), ("eli", "e"), ("ousli", "ous"),
          ("ization", "ize"), ("ation", "ate"), ("ator", "ate"),
          ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"),
          ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"),
          ("biliti", "ble"), ("logi", "log")]

_STEP3 = [("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
          ("ical", "ic"), ("ful", ""), ("ness", "")]

_STEP4 = ["al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
          "ment", "ent", "ion", "ou", "ism", "ate", "iti", "ous", "ive",
          "ize"]


def porter_stem(word: str) -> str:
    w = word.lower()
    if len(w) <= 2:
        return w

    # Step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif not w.endswith("ss") and w.endswith("s"):
        w = w[:-1]

    # Step 1b
    flag_1b = False
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    elif w.endswith("ed") and _has_vowel(w[:-2]):
        w = w[:-2]
        flag_1b = True
    elif w.endswith("ing") and _has_vowel(w[:-3]):
        w = w[:-3]
        flag_1b = True
    if flag_1b:
        if w.endswith(("at", "bl", "iz")):
            w = w + "e"
        elif _ends_double_cons(w) and w[-1] not in "lsz":
            w = w[:-1]
        elif _measure(w) == 1 and _cvc(w):
            w = w + "e"

    # Step 1c
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"

    # Step 2 (m > 0), longest matching suffix only
    for suf, rep in sorted(_STEP2, key=lambda x: -len(x[0])):
        if w.endswith(suf):
            stem = w[: len(w) - len(suf)]
            if _measure(stem) > 0:
                w = stem + rep
            break

    # Step 3 (m > 0)
    for suf, rep in sorted(_STEP3, key=lambda x: -len(x[0])):
        if w.endswith(suf):
            stem = w[: len(w) - len(suf)]
            if _measure(stem) > 0:
                w = stem + rep
            break

    # Step 4 (m > 1); 'ion' additionally requires stem ending s or t
    for suf in sorted(_STEP4, key=len, reverse=True):
        if w.endswith(suf):
            stem = w[: len(w) - len(suf)]
            if _measure(stem) > 1:
                if suf == "ion" and (not stem or stem[-1] not in "st"):
                    break
                w = stem
            break

    # Step 5a
    if w.endswith("e"):
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _cvc(stem)):
            w = stem

    # Step 5b
    if _measure(w) > 1 and _ends_double_cons(w) and w.endswith("l"):
        w = w[:-1]

    return w
