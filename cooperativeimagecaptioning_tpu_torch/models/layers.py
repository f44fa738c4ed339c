"""Functional building blocks (counterpart of the JAX package's
models/layers.py).

Parameters are nested dicts of tensors in the JAX layout: a Linear is
{'w': [in, out], 'b': [out]} applied as `x @ w + b`, so a JAX tree converts
to the port by copying its leaves (utils/tree.to_torch), with no transpose.
A model holds its tree as a utils/tree.ParamTree, whose nodes read the
leaves as attributes (`linear` takes such a node).
Initializers draw from a numpy RandomState, with the bounds of the JAX
package's (torch.nn.Linear's default U(-1/sqrt(in), 1/sqrt(in))); they
cannot give JAX's numbers for the same seed, and need not.
Random draws at run time (dropout) come from an explicit torch.Generator
that the caller passes in.
"""

from __future__ import annotations

import numpy as np
import torch


def uniform_init(rng: np.random.RandomState, shape, scale: float):
    return rng.uniform(-scale, scale, shape).astype(np.float32)


def linear_init(rng: np.random.RandomState, in_dim: int, out_dim: int):
    bound = 1.0 / np.sqrt(in_dim)
    return {"w": uniform_init(rng, (in_dim, out_dim), bound),
            "b": uniform_init(rng, (out_dim,), bound)}


def attention_init(rng: np.random.RandomState, rnn_size: int,
                   att_hid_size: int):
    return {"h2att": linear_init(rng, rnn_size, att_hid_size),
            "alpha_net": linear_init(rng, att_hid_size, 1)}


def linear(params, x):
    return x @ params.w + params.b


def embedding_lookup(table, ids):
    """table [N, D], integer ids of any shape -> [*ids.shape, D]."""
    return table.index_select(0, ids.reshape(-1)).reshape(
        tuple(ids.shape) + (table.shape[1],))


def keep_mask(shape, rate: float, gen, device):
    """Bernoulli(1 - rate) keep mask from `gen` (a generator on `device`)."""
    return torch.rand(shape, generator=gen, device=device) < 1.0 - rate


def dropout(x, rate: float, gen=None, mask=None):
    """Inverted dropout (JAX layers.py:44-50, torch semantics): keep with
    probability 1 - rate, scale the kept values by 1 / (1 - rate), keep the
    dtype.  The keep mask is drawn from `gen`, or given as `mask` (a mask
    drawn beforehand, so that a recomputed step sees the same one)."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    if mask is None:
        mask = keep_mask(x.shape, rate, gen, x.device)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device)
                       ).to(x.dtype)
