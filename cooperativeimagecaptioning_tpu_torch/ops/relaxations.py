"""Straight-through / partial-sampling relaxations of discrete word sampling
(counterpart of the JAX package's ops/relaxations.py).

They make the discrete caption differentiable, so that the listener's
retrieval loss can train the speaker end to end (the paper's core
technique).  Each is a function of (rng, logprobs): `rng` is a draw source
(ops/draws.py) and logprobs a log-softmax [B, C]; each returns (relaxed
[B, C], ind [B]).  The straight-through trick is `(y_hard - y).detach() +
y`: the forward value of y_hard, the gradient of y.

References (the original code): gumbel_st models/gumbel.py:6-30,
gumbel_soft models/gumbel_softmax.py:17-42, multinomial_st
models/multinomial.py:4-27, multinomial_soft models/multinomial_soft.py:5-35.
The draws follow the JAX package's key order: the Gumbel (or uniform)
noise over [B, C] first, then the [B] row mask of the partial modes.
"""

from __future__ import annotations

import torch


def _div(x, t):
    """x / t with t as a tensor of x's dtype: a CUDA tensor divided by a
    Python number is a product with the rounded reciprocal.  A number
    becomes a tensor by a fill on x's device (no host-to-device copy, so a
    CUDA graph captures it); a staged tensor is used as it is."""
    if isinstance(t, torch.Tensor):
        return x / t.to(dtype=x.dtype, device=x.device)
    return x / torch.full((), t, dtype=x.dtype, device=x.device)


def sample_gumbel(rng, shape, device, eps: float = 1e-20):
    """-log(-log(U + eps) + eps) with U ~ U[0, 1) (ref gumbel.py:7-12)."""
    u = rng.uniform(shape, device)
    return -torch.log(-torch.log(u + eps) + eps)


def _one_hot_of_argmax(y):
    ind = torch.argmax(y, dim=-1)
    return torch.nn.functional.one_hot(ind, y.shape[-1]).to(y.dtype), ind


def _row_mask(rng, logprobs, ss_prob):
    """Bernoulli(ss_prob) per row, as [B, 1] in the logprobs' dtype."""
    u = rng.uniform((logprobs.shape[0],), logprobs.device)
    return (u < ss_prob)[:, None].to(logprobs.dtype)


def gumbel_st(rng, logprobs, temperature):
    """Straight-through Gumbel-softmax: forward the one-hot of argmax(y),
    backward d softmax((lp + g) / T)."""
    g = sample_gumbel(rng, logprobs.shape, logprobs.device)
    y = torch.softmax(_div(logprobs + g, temperature), dim=-1)
    y_hard, ind = _one_hot_of_argmax(y)
    return (y_hard - y).detach() + y, ind


def gumbel_soft(rng, logprobs, temperature, ss_prob: float = 0.25):
    """Partial-sampling Gumbel-softmax: rows picked by a Bernoulli(ss_prob)
    mask take the straight-through hard forward; the others pass the soft
    y through unchanged (ref `(part_y_hard - part_logits).detach() + y`)."""
    g = sample_gumbel(rng, logprobs.shape, logprobs.device)
    y = torch.softmax(_div(logprobs + g, temperature), dim=-1)
    y_hard, ind = _one_hot_of_argmax(y)
    mask = _row_mask(rng, logprobs, ss_prob)
    return (y_hard * mask - y * mask).detach() + y, ind


def multinomial_st(rng, logprobs, temperature):
    """Straight-through multinomial: y = softmax(lp / T), ind ~
    Categorical(y) (a Gumbel-max over lp / T), forward the one-hot of ind,
    backward d y."""
    x = _div(logprobs, temperature)
    y = torch.softmax(x, dim=-1)
    ind = torch.argmax(x + rng.gumbel(x.shape, x.device), dim=-1)
    y_hard = torch.nn.functional.one_hot(ind, y.shape[-1]).to(y.dtype)
    return (y_hard - y).detach() + y, ind


def multinomial_soft(rng, logprobs, temperature, ss_prob: float = 0.25):
    """Partial-sampling multinomial.  y = exp(lp / T) stays unnormalized for
    T != 1, as in the reference (multinomial_soft.py): the draw
    renormalizes, but the soft rows carry the unnormalized y."""
    x = _div(logprobs, temperature)
    y = torch.exp(x)
    ind = torch.argmax(x + rng.gumbel(x.shape, x.device), dim=-1)
    y_hard = torch.nn.functional.one_hot(ind, y.shape[-1]).to(y.dtype)
    mask = _row_mask(rng, logprobs, ss_prob)
    return (y_hard * mask - y * mask).detach() + y, ind
