"""The collectives of a mesh run, written down where the JAX package lets
XLA's partitioner place them (its parallel/mesh.py: "No hand-written
collectives").

A `Group` is one process group of the mesh (a model group: the ranks of one
data row; a data group: the ranks of one model column; or the world) with
this rank's place in it.  The helpers take a Group and always call the
backend, whatever its size; callers skip a group of one where that saves a
copy.  Under gloo a CUDA buffer is staged through the host: gloo's support
for CUDA tensors differs between PyTorch builds, and the buffers that cross
are small (the heads' candidates, loss sums, flags) except the gradients of
a data group, which a run over NCCL keeps on the card.

Two autograd Functions make a layer split over the model group's vocabulary
slices trainable (Megatron's pair):
  `copy_to_group`     forward identity, backward all-reduce SUM of the
                      gradient (an input every shard reads);
  `reduce_from_group` forward all-reduce SUM, backward identity (a sum of
                      the shards' partial results).
`torch.distributed.nn.functional.all_reduce` would all-reduce the gradient
of the second once more, multiplying it by the group's size.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from cooperativeimagecaptioning_tpu_torch.utils.tree import (
    from_leaves, leaves)

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


class Group(NamedTuple):
    """A process group and this rank's place in it."""
    pg: Any         # the backend's group handle (None: the default group)
    ranks: tuple    # global ranks, in group-rank order
    rank: int       # this process's index in `ranks`
    staged: bool    # gloo with CUDA buffers: collectives go through the host

    @property
    def size(self) -> int:
        return len(self.ranks)


def _buffer(x, group):
    """A copy of x that the backend may overwrite: on the host when the
    group stages, else on x's device."""
    x = x.detach()
    return x.to("cpu", copy=True) if group.staged else x.clone(
        memory_format=torch.contiguous_format)


def all_reduce(x, group: Group, op: str = "sum"):
    """The reduction ("sum", "max" or "min") of x over the group, a new
    tensor on x's device."""
    buf = _buffer(x, group)
    dist.all_reduce(buf, op=_OPS[op], group=group.pg)
    return buf.to(x.device) if group.staged else buf


def all_gather(x, group: Group, dim: int = 0):
    """The group's x, concatenated along `dim` in group-rank order."""
    buf = _buffer(x, group)
    parts = [torch.empty_like(buf) for _ in range(group.size)]
    dist.all_gather(parts, buf, group=group.pg)
    out = torch.cat(parts, dim=dim)
    return out.to(x.device) if group.staged else out


def broadcast_(x, group: Group):
    """x of the group's first rank, copied into x on every rank."""
    buf = _buffer(x, group)
    dist.broadcast(buf, src=group.ranks[0], group=group.pg)
    with torch.no_grad():
        x.copy_(buf)
    return x


def broadcast_object(obj, group: Group):
    """The group's first rank's picklable `obj`, on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=group.ranks[0], group=group.pg)
    return box[0]


def barrier(group: Group):
    """Every rank of the group waits until all have arrived."""
    dist.barrier(group=group.pg)


def all_reduce_tree(tree, group: Group):
    """Every tensor leaf of a nested dict summed over the group, in one
    collective over one flat buffer; the tree of a group of one as it is."""
    if group.size == 1:
        return tree
    pairs = leaves(tree)
    flat = torch.cat([x.reshape(-1) for _, x in pairs])
    flat = all_reduce(flat, group)
    out, at = [], 0
    for path, x in pairs:
        out.append((path, flat[at:at + x.numel()].view_as(x)))
        at += x.numel()
    return from_leaves(out)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_group(x, group: Group):
    """Identity; the gradient is summed over the group."""
    return x if group.size == 1 else _CopyToGroup.apply(x, group)


def reduce_from_group(x, group: Group):
    """The sum of x over the group; the gradient passes unchanged."""
    return x if group.size == 1 else _ReduceFromGroup.apply(x, group)
