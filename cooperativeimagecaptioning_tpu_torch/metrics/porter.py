"""Porter stemmer (classic 1980 algorithm) — support for METEOR stem matching.

Standard-algorithm implementation (the same algorithm Snowball/NLTK implement);
used by metrics/meteor.py as the 'stem' module (METEOR 1.5's English stemmer)."""

from __future__ import annotations


def _cons(w, i):
    c = w[i]
    if c in "aeiou":
        return False
    if c == "y":
        return i == 0 or not _cons(w, i - 1)
    return True


def _m(w):
    """Measure: number of VC sequences."""
    n = 0
    i = 0
    L = len(w)
    while i < L and _cons(w, i):
        i += 1
    while i < L:
        while i < L and not _cons(w, i):
            i += 1
        if i >= L:
            break
        n += 1
        while i < L and _cons(w, i):
            i += 1
    return n


def _has_vowel(w):
    return any(not _cons(w, i) for i in range(len(w)))


def _ends_double_cons(w):
    return len(w) >= 2 and w[-1] == w[-2] and _cons(w, len(w) - 1)


def _cvc(w):
    if len(w) < 3:
        return False
    if not (_cons(w, len(w) - 3) and not _cons(w, len(w) - 2)
            and _cons(w, len(w) - 1)):
        return False
    return w[-1] not in "wxy"


def stem(word: str) -> str:
    w = word.lower()
    if len(w) <= 2:
        return w
    # step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]
    # step 1b
    flag = False
    if w.endswith("eed"):
        if _m(w[:-3]) > 0:
            w = w[:-1]
    elif w.endswith("ed") and _has_vowel(w[:-2]):
        w = w[:-2]
        flag = True
    elif w.endswith("ing") and _has_vowel(w[:-3]):
        w = w[:-3]
        flag = True
    if flag:
        if w.endswith(("at", "bl", "iz")):
            w += "e"
        elif _ends_double_cons(w) and not w.endswith(("l", "s", "z")):
            w = w[:-1]
        elif _m(w) == 1 and _cvc(w):
            w += "e"
    # step 1c
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"
    # step 2
    step2 = [("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
             ("anci", "ance"), ("izer", "ize"), ("abli", "able"),
             ("alli", "al"), ("entli", "ent"), ("eli", "e"), ("ousli", "ous"),
             ("ization", "ize"), ("ation", "ate"), ("ator", "ate"),
             ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"),
             ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"),
             ("biliti", "ble")]
    for suf, rep in step2:
        if w.endswith(suf):
            if _m(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break
    # step 3
    step3 = [("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
             ("ical", "ic"), ("ful", ""), ("ness", "")]
    for suf, rep in step3:
        if w.endswith(suf):
            if _m(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break
    # step 4
    step4 = ["al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
             "ment", "ent", "ou", "ism", "ate", "iti", "ous", "ive", "ize"]
    for suf in sorted(step4, key=len, reverse=True):
        if w.endswith(suf):
            base = w[: -len(suf)]
            if _m(base) > 1:
                w = base
            break
    else:
        if w.endswith("ion") and _m(w[:-3]) > 1 and w[:-3].endswith(("s", "t")):
            w = w[:-3]
    # step 5a
    if w.endswith("e"):
        base = w[:-1]
        if _m(base) > 1 or (_m(base) == 1 and not _cvc(base)):
            w = base
    # step 5b
    if _m(w) > 1 and _ends_double_cons(w) and w.endswith("l"):
        w = w[:-1]
    return w
