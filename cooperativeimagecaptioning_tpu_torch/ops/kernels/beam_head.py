"""Fused beam logit head: h @ W + b -> per row the top-kk logits, their ids
and the logsumexp, without writing [R, V] logits or sorting them.

Counterpart of the JAX package's ops/pallas/beam_head.py.  `beam_head`
launches the kernel in csrc/beam_head.cu for CUDA tensors and takes
`beam_head_reference` for CPU tensors.  Ids come in lax.top_k's order:
larger logit first, the lower id first on an exact tie.  log-softmax values
are vals - lse[:, None].  Forward only.

As in the greedy head, the kernel's first pass is the tensor-core pass for
bfloat16 inputs that fit it and the FMA pass for everything else
(`logit_head.head_pass`, by type, shape and alignment alone); a launch that
fails raises.  Any 1 <= kk <= V is taken on every device, as the JAX head
takes any m: on the card a kk above the longest compiled list (ROUND_KK)
runs the kernel's two passes in rounds of ROUND_KK candidates, each round
admitting only candidates after the last one the round before took.

On a registered vocab mesh (`_dispatch.set_vocab_mesh`) whose rank holds a
slice of the logit layer, `beam_head` takes `beam_head_sharded` (JAX
beam_head.py:97-160): kernel C on the slice, the model group's [R, n*m]
candidates and [n, R] logsumexps gathered in shard-major order, and the
`head_merge` kernel.
"""

from __future__ import annotations

import torch

from cooperativeimagecaptioning_tpu_torch.ops.kernels import _build, _dispatch
from cooperativeimagecaptioning_tpu_torch.ops.kernels.head_merge import (
    head_merge)
from cooperativeimagecaptioning_tpu_torch.ops.kernels.logit_head import (
    check_head_inputs, logits_f32, partials_scratch, plan_first_pass)
from cooperativeimagecaptioning_tpu_torch.parallel import collectives, vocab

ROW_TILE = 8          # rows per block of the beam kernel (kBeamRows)
SLOTS = (1, 2, 4, 8, 16)  # compiled top-list lengths; kk rounds up to one
ROUND_KK = SLOTS[-1]  # candidates a round yields where kk is longer


def top_k(x, k: int):
    """lax.top_k along the last axis: descending, lower index first on
    ties.  torch.topk promises nothing about ties, so this is a stable
    descending sort, sliced."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def beam_head_reference(h, w, b, kk: int):
    """Plain PyTorch version -> (vals f32 [R,kk], idx int32 [R,kk],
    lse f32 [R])."""
    logits = logits_f32(h, w, b)
    mx = logits.max(dim=-1).values
    lse = mx + torch.log(torch.exp(logits - mx[:, None]).sum(dim=-1))
    vals, idx = top_k(logits, kk)
    return vals, idx.to(torch.int32), lse


def beam_head(h, w, b, kk: int):
    """h [R, H], w [H, V], b [V], 1 <= kk <= V -> (vals, idx, lse); on a
    vocab mesh, where w is this rank's slice, the global result."""
    mesh = vocab.logit_mesh(w)
    if mesh is not None:
        return beam_head_sharded(h, w, b, kk, mesh)
    return local_beam_head(h, w, b, kk)


def beam_head_sharded(h, w, b, m: int, mesh):
    """The beam head over the model group's vocabulary slices: w [H, V/n]
    and b [V/n] are this rank's (shard = its model index), h [R, H] the
    group's common rows.  Kernel C gives the slice's top-m, one all_gather
    each of the candidates (shard-major) and of the logsumexps, and
    `head_merge` the global top-m (global ids) and logsumexp, the same on
    every rank of the group."""
    _dispatch.forward_only("beam_head", h, w, b)
    vals, idx, lse = local_beam_head(h, w, b, m)
    g = mesh.model
    return head_merge(collectives.all_gather(vals, g, dim=1),
                      collectives.all_gather(idx, g, dim=1),
                      collectives.all_gather(lse[None], g, dim=0),
                      w.shape[1], m)


def local_beam_head(h, w, b, kk: int):
    """The head on one device's w, whole or a slice (ids local to it)."""
    _dispatch.forward_only("beam_head", h, w, b)
    if not 1 <= kk <= w.shape[1]:
        raise ValueError(f"beam_head takes 1 <= kk <= V = {w.shape[1]}, "
                         f"got {kk}")
    if not _dispatch.use_kernel(h):
        return beam_head_reference(h, w, b, kk)
    check_head_inputs("beam_head", h, w, b)
    R, H = h.shape
    V = w.shape[1]
    slots = next((s for s in SLOTS if s >= kk), ROUND_KK)
    which, splits, split_cols = plan_first_pass(R, ROW_TILE, h, w, b)
    dev = h.device
    scratch, parts = partials_scratch(R, splits, slots, dev)
    vals = torch.empty((R, kk), dtype=torch.float32, device=dev)
    idx = torch.empty((R, kk), dtype=torch.int32, device=dev)
    lse = torch.empty((R,), dtype=torch.float32, device=dev)
    # the rounds' per-row thresholds: f32 [R] then int32 [R]
    thr = torch.empty(2 * R, dtype=torch.float32, device=dev) \
        if kk > slots else None
    lib = _build.library()
    code = lib.cic_beam_head(
        _build.ptr(h), _build.ptr(w), _build.ptr(b), *parts,
        _build.ptr(vals), _build.ptr(idx), _build.ptr(lse), _build.ptr(thr),
        R, H, V, kk,
        slots, splits, split_cols, int(h.dtype == torch.bfloat16),
        int(which == "mma"), _build.stream(dev))
    _build.check(lib, code, "beam_head")
    _dispatch.count("beam_head", which)
    return vals, idx, lse
