"""Kernel F, the maxout-LSTM cell of both speakers (csrc/cell_step.cu:
cell_tf32x3_kernel and cell_fma_kernel; csrc/cell_wgmma.cu:
cell_wgmma_kernel), one launch a call.

    sums = xt @ Wi + bi + h @ Wh + bh   (+ att @ Wc + bc, Att2in2)
    c' = f c + i max(...);  h' = o tanh(c')

Bytes: xt [B, D], h and c [B, H] (and att [B, H]) and the weights read
once, h' and c' written once, in the call's dtype.  Operations: 2 m n k
of the two (three) products."""

from __future__ import annotations

from portbench.core.peaks import ITEMSIZE, bound_s

PATTERNS = ("cell_tf32x3_kernel", "cell_wgmma_kernel", "cell_fma_kernel")
CALL = "cell_"


def flops(s):
    B, D, H = s["rows"], s["input"], s["hidden"]
    return 2 * B * (D * 5 * H + H * 5 * H + (H * 2 * H if s["att"] else 0))


def nbytes(s):
    B, D, H = s["rows"], s["input"], s["hidden"]
    e = ITEMSIZE[s["dtype"]]
    weights = D * 5 * H + H * 5 * H + 2 * 5 * H
    acts = B * D + 2 * B * H
    if s["att"]:
        weights += H * 2 * H + 2 * H
        acts += B * H
    return e * (weights + acts + 2 * B * H)


def bound(s, peaks):
    return bound_s(flops(s), nbytes(s), s["dtype"], peaks)
