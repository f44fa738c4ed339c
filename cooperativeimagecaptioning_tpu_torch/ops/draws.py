"""Explicit sources of random noise for the port's stochastic paths.

Every draw of sampling, of the relaxations and of dropout comes from a draw
source: an object with `uniform(shape, device)` (U[0, 1), float32) and
`gumbel(shape, device)` (standard Gumbel, float32).  The JAX package's
draws reduce to these two: `jax.random.bernoulli(key, p, shape)` is
`uniform < p`, and `jax.random.categorical(key, x)` is
`argmax(x + gumbel)`, so a Gumbel-max over the same noise picks the same
ids.

  Draws   -- backed by a torch.Generator (on the device the tensors live
             on): the source of the main path.
  Replay  -- hands out given arrays in order: the tests replay the noise
             the JAX package draws along its key splits, and a
             checkpointed step replays the noise drawn before it.
  Record  -- passes another source's draws through and keeps them, so
             that one run's noise can be replayed in another.
  RowShard -- a data-parallel rank's rows of another source's draws: each
             draw is made at the global batch's size and sliced, so a mesh
             run draws the single-device run's noise (under GSPMD the
             global masks are drawn once and sharded).
  ColShard -- a model-group rank's columns of another source's draws: the
             [rows, V+1] noise of a selection over the vocabulary is drawn
             whole and each rank keeps the columns of its logit slice.
"""

from __future__ import annotations

import numpy as np
import torch

_TINY = torch.finfo(torch.float32).tiny


class Draws:
    """Uniform and Gumbel noise from one torch.Generator (None: torch's
    default generator of the device)."""

    def __init__(self, gen=None):
        self.gen = gen

    def uniform(self, shape, device):
        return torch.rand(tuple(shape), generator=self.gen, device=device)

    def gumbel(self, shape, device):
        # jax.random.gumbel: -log(-log(U)) with U on [tiny, 1)
        u = self.uniform(shape, device).clamp_min_(_TINY)
        return -torch.log(-torch.log(u))


class Replay:
    """Hands out `arrays` (numpy arrays or tensors) in order, whichever of
    `uniform` / `gumbel` asks; the shape asked for must match."""

    def __init__(self, arrays):
        self.arrays = list(arrays)
        self.pos = 0

    def _next(self, shape, device):
        if self.pos >= len(self.arrays):
            raise IndexError(f"replay ran out after {self.pos} draws")
        x = self.arrays[self.pos]
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x, np.float32))  # a writable copy
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"replay draw {self.pos}: shape {tuple(x.shape)}"
                             f", asked for {tuple(shape)}")
        self.pos += 1
        return x.to(device=device, dtype=torch.float32)

    uniform = _next
    gumbel = _next

    def done(self) -> bool:
        return self.pos == len(self.arrays)


class Record:
    """Draws from `source` and keeps every draw in `taken`, in order."""

    def __init__(self, source):
        self.source = source
        self.taken = []

    def uniform(self, shape, device):
        x = self.source.uniform(shape, device)
        self.taken.append(x)
        return x

    def gumbel(self, shape, device):
        x = self.source.gumbel(shape, device)
        self.taken.append(x)
        return x


class RowShard:
    """Rows [index * b, (index + 1) * b) of `source`'s draws of n * b rows,
    where b is the leading dim asked for."""

    def __init__(self, source, n: int, index: int):
        self.source, self.n, self.index = source, n, index

    def _rows(self, kind, shape, device):
        b = shape[0]
        full = getattr(self.source, kind)((b * self.n,) + tuple(shape[1:]),
                                          device)
        return full[self.index * b:(self.index + 1) * b]

    def uniform(self, shape, device):
        return self._rows("uniform", shape, device)

    def gumbel(self, shape, device):
        return self._rows("gumbel", shape, device)


class ColShard:
    """Columns [index * c, (index + 1) * c) of `source`'s draws of n * c
    columns, where c is the last dim asked for."""

    def __init__(self, source, n: int, index: int):
        self.source, self.n, self.index = source, n, index

    def _cols(self, kind, shape, device):
        c = shape[-1]
        full = getattr(self.source, kind)(tuple(shape[:-1]) + (c * self.n,),
                                          device)
        return full[..., self.index * c:(self.index + 1) * c]

    def uniform(self, shape, device):
        return self._cols("uniform", shape, device)

    def gumbel(self, shape, device):
        return self._cols("gumbel", shape, device)


def source(rng):
    """A draw source from a torch.Generator (or None), or `rng` itself when
    it is one already."""
    if rng is None or isinstance(rng, torch.Generator):
        return Draws(rng)
    return rng
