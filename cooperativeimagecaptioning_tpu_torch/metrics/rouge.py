"""ROUGE-L (ref: coco-caption/pycocoevalcap/rouge/rouge.py).

LCS-based F-measure with beta = 1.2 and max over references."""

from __future__ import annotations

import numpy as np


def _lcs_len(a, b):
    if len(a) < len(b):
        a, b = b, a
    prev = [0] * (len(b) + 1)
    for i in range(1, len(a) + 1):
        cur = [0] * (len(b) + 1)
        for j in range(1, len(b) + 1):
            if a[i - 1] == b[j - 1]:
                cur[j] = prev[j - 1] + 1
            else:
                cur[j] = max(prev[j], cur[j - 1])
        prev = cur
    return prev[len(b)]


BETA = 1.2


def rouge_l(candidate: str, refs: list) -> float:
    token_c = candidate.split(" ")
    prec, rec = [], []
    for reference in refs:
        token_r = reference.split(" ")
        lcs = _lcs_len(token_r, token_c)
        prec.append(lcs / float(len(token_c)))
        rec.append(lcs / float(len(token_r)))
    prec_max, rec_max = max(prec), max(rec)
    if prec_max != 0 and rec_max != 0:
        return ((1 + BETA ** 2) * prec_max * rec_max) / \
            float(rec_max + BETA ** 2 * prec_max)
    return 0.0


def compute_rouge(gts: dict, res: dict):
    ids = sorted(gts.keys(), key=lambda x: str(x))
    scores = np.array([rouge_l(res[i][0], gts[i]) for i in ids])
    return float(scores.mean()), scores
