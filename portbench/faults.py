"""Faults planted in the program, for showing that a run's comparison
fails when the timed path is broken underneath it: a step that returns its
state unchanged, half of the batch left out (a training step's mean taken
over the rest), and a token altered where it is produced; in the decode
also a greedy decode in place of the beam search, and the beam search
returning the worse of its final beams.  One chip runs no exchange between
chips, so that fault has no place here.  Each fault is a context manager
that patches one name of the program and puts it back."""

from __future__ import annotations

import contextlib

import torch

TRAIN = ("state_unchanged", "half_batch", "token_altered")
DECODE = ("state_unchanged", "half_batch", "token_altered", "greedy",
          "second_beam")


@contextlib.contextmanager
def _patched(module, name, make):
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def train(kind, vocab_size):
    """A fault of the training step."""
    from cooperativeimagecaptioning_tpu_torch.training import (
        joint, loop, optim)
    if kind == "state_unchanged":
        # the guarded update leaves params and moments as they were
        return _patched(optim, "guarded_update", lambda orig: (
            lambda opt, params, grads, states, agents, lr, group=None:
            torch.ones((), dtype=torch.bool,
                       device=next(iter(states.values()))["count"].device)))
    if kind == "half_batch":
        def make(orig):
            def loss_fn(modules, params, opt, batch, rng, hp, turn, *a, **k):
                b = batch["labels"].shape[0] // 2
                half = {key: v[:b] if torch.is_tensor(v) and v.dim() > 0
                        and v.shape[0] == 2 * b else v
                        for key, v in batch.items()}
                return orig(modules, params, opt, half, rng, hp, turn, *a,
                            **k)
            return loss_fn
        return _patched(joint, "loss_fn", make)
    if kind == "token_altered":
        def make(orig):
            def stage(self, max_steps):
                st = orig(self, max_steps)
                a = st["layout"].slices["labels"][0]
                # the first target word of the chunk's first row
                st["rows"][0, a + 1] = st["rows"][0, a + 1] % vocab_size + 1
                return st
            return stage
        return _patched(loop.Trainer, "_stage_chunk", make)
    raise KeyError(kind)


def decode(kind, vocab_size):
    """A fault of the served decode."""
    from cooperativeimagecaptioning_tpu_torch.ops import decoding
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import cell_step
    if kind == "state_unchanged":
        return _patched(cell_step, "fused_cell", lambda orig: (
            lambda xt, h, c, *rest: (h, c)))
    if kind == "half_batch":
        def make(orig):
            def beam_search(speaker, ctx, L, m, **k):
                B = ctx["att_feats"].shape[0] if ctx.get("att_feats") \
                    is not None else ctx["fc_feats"].shape[0]
                half = {key: None if v is None else v[:B // 2]
                        for key, v in ctx.items()}
                out = orig(speaker, half, L, m, **k)
                seq = torch.zeros((B, L), dtype=out.seq.dtype,
                                  device=out.seq.device)
                seq[:B // 2] = out.seq
                return out._replace(seq=seq)
            return beam_search
        return _patched(decoding, "beam_search", make)
    if kind == "token_altered":
        def make(orig):
            def beam_search(*a, **k):
                out = orig(*a, **k)
                seq = out.seq.clone()
                seq[0, 0] = seq[0, 0] % vocab_size + 1
                return out._replace(seq=seq)
            return beam_search
        return _patched(decoding, "beam_search", make)
    if kind == "greedy":
        def make(orig):
            def beam_search(speaker, ctx, L, m, **k):
                return decoding.sample(speaker, ctx, L, mode="greedy")
            return beam_search
        return _patched(decoding, "beam_search", make)
    if kind == "second_beam":
        # the done-beam record takes the worst recorded candidate: at the
        # last merge, where every beam is recorded, the worse final beam
        return _patched(decoding, "torch", lambda orig: _WorstRecord(orig))
    raise KeyError(kind)


class _WorstRecord:
    """torch, but argmax of the beam search's done records (NEG_INF where
    not done) taking the smallest recorded entry."""

    def __init__(self, torch_):
        self._torch = torch_

    def __getattr__(self, name):
        return getattr(self._torch, name)

    def argmax(self, x, dim):
        done = x > -1e37
        return self._torch.where(done, x, self._torch.full_like(
            x, float("inf"))).argmin(dim=dim)
