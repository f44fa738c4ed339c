"""Kernel C, the beam logit head (csrc/beam_head*.cu): a first pass over
column tiles of the logit matrix (vocab_partials*: each tile's top kk and
its log-sum-exp partials), then a merge a row (beam_merge).

    logits = h @ W + b  [R, V]; the top kk of each row, and its lse

Bytes: h [R, H], W [H, V] and b read once, the kk values and ids and the
lse a row written once.  Operations: 2 R H V of the product."""

from __future__ import annotations

from portbench.core.peaks import ITEMSIZE, bound_s

PATTERNS = ("vocab_partials", "beam_merge")
CALL = "beam_merge"


def flops(s):
    return 2 * s["rows"] * s["hidden"] * s["vocab"]


def nbytes(s):
    R, H, V, kk = s["rows"], s["hidden"], s["vocab"], s["kk"]
    e = ITEMSIZE[s["dtype"]]
    return e * (R * H + H * V + V) + R * (kk * 4 + kk * 4 + 4)


def bound(s, peaks):
    return bound_s(flops(s), nbytes(s), s["dtype"], peaks)
