"""BLEU 1..4 (ref: coco-caption/pycocoevalcap/bleu/bleu_scorer.py).

Corpus BLEU with the coco-caption conventions: per-n clipped precision with the
"closest" reference-length effective length (the BleuScorer default used by
Bleu(4).compute_score), smoothed per-segment scores for the per-image outputs
(tiny +1 smoothing on counts like bleu_scorer.py's `small`/`tiny` handling), and
brevity penalty on corpus totals.
"""

from __future__ import annotations

import math
from collections import defaultdict


def _ngrams(words, n):
    counts = defaultdict(int)
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i:i + k])] += 1
    return counts


def _cook_refs(refs, n=4):
    reflen = [len(r.split()) for r in refs]
    maxcounts = {}
    for ref in refs:
        for ngram, count in _ngrams(ref.split(), n).items():
            maxcounts[ngram] = max(maxcounts.get(ngram, 0), count)
    return reflen, maxcounts


def _cook_test(test, reflen, refmaxcounts, n=4):
    words = test.split()
    testlen = len(words)
    result = {"testlen": testlen,
              "reflen": _closest_len(reflen, testlen),
              "guess": [max(0, testlen - k + 1) for k in range(1, n + 1)],
              "correct": [0] * n}
    counts = _ngrams(words, n)
    for ngram, count in counts.items():
        result["correct"][len(ngram) - 1] += min(
            refmaxcounts.get(ngram, 0), count)
    return result


def _closest_len(reflens, testlen):
    """closest reference length, ties -> shorter (bleu_scorer.py 'closest')."""
    return min(reflens, key=lambda r: (abs(r - testlen), r))


def compute_bleu(gts: dict, res: dict, n: int = 4):
    """gts: {id: [refs]}, res: {id: [hyp]} -> (corpus [b1..b4], per-image lists).

    Matches coco-caption Bleu(4).compute_score output structure."""
    small = 1e-9
    tiny = 1e-15
    totals = {"testlen": 0, "reflen": 0,
              "guess": [0] * n, "correct": [0] * n}
    per_image = [[] for _ in range(n)]
    ids = sorted(res.keys(), key=lambda x: str(x))
    # always 'closest': coco-caption's Bleu wrapper forces option='closest'
    # (bleu.py:41), so the scorer's 1-image 'average' default never fires in
    # the pipeline the reference runs
    for iid in ids:
        reflen, maxcounts = _cook_refs(gts[iid], n)
        comps = _cook_test(res[iid][0], reflen, maxcounts, n)
        for key in ("testlen", "reflen"):
            totals[key] += comps[key]
        for k in range(n):
            totals["guess"][k] += comps["guess"][k]
            totals["correct"][k] += comps["correct"][k]
        # per-segment score with +tiny smoothing and its own brevity penalty
        bleus = []
        prod = 1.0
        for k in range(n):
            prod *= (comps["correct"][k] + tiny) / (comps["guess"][k] + small)
            score = prod ** (1.0 / (k + 1))
            ratio = (comps["testlen"] + tiny) / (comps["reflen"] + small)
            if ratio < 1:
                score *= math.exp(1 - 1 / ratio)
            bleus.append(score)
        for k in range(n):
            per_image[k].append(bleus[k])
    corpus = []
    prod = 1.0
    for k in range(n):
        prod *= (totals["correct"][k] + tiny) / (totals["guess"][k] + small)
        score = prod ** (1.0 / (k + 1))
        ratio = (totals["testlen"] + tiny) / (totals["reflen"] + small)
        if ratio < 1:
            score *= math.exp(1 - 1 / ratio)
        corpus.append(score)
    return corpus, per_image
