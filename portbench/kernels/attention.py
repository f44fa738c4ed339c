"""Kernel A, the fused additive attention of one Att2in2 step (csrc/
att_step.cu): its att_h pre-pass (att_h_*) and its stream
(attention_kernel), two launches a call.

    att_h  = h @ W_h2att + b                              [B, A]
    scores = tanh(p_att + att_h[:, None]) @ w_alpha + b   [B, K]
    w      = softmax(scores), masked and renormalised
    out    = sum_k w_k emb_k                              [B, H]

Bytes: what the function needs, each read once: h [B, H], the context of
each image (emb [N, K, H], p_att [N, K, A], the mask [N, K] in float32),
the weights, and out [B, H] written once.  Rows of one image share its
context (the beams of a decode: B = N x beams, `images` N in the shape;
without it N = B), so a kernel that reads the context once an image meets
the bound and one that reads a copy a row does not.  Operations: 2 m n k
of att_h, of the scores and of the weighted sum, a row each."""

from __future__ import annotations

from portbench.core.peaks import ITEMSIZE, bound_s

PATTERNS = ("attention_kernel", "att_h_")  # the launches whose time counts
CALL = "attention_kernel"                  # one launch of this a call


def flops(s):
    B, K, H, A = s["rows"], s["slots"], s["hidden"], s["att_hid"]
    return 2 * B * H * A + 2 * B * K * A + 2 * B * K * H


def nbytes(s):
    B, K, H, A = s["rows"], s["slots"], s["hidden"], s["att_hid"]
    N = s.get("images", B)
    e = ITEMSIZE[s["dtype"]]
    inputs = B * H + N * K * H + N * K * A + H * A + A + A + 1
    return e * (inputs + B * H) + 4 * N * K


def bound(s, peaks):
    return bound_s(flops(s), nbytes(s), s["dtype"], peaks)
