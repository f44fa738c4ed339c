"""The collectives of a mesh run, written down where the JAX package lets
XLA's partitioner place them (its parallel/mesh.py: "No hand-written
collectives").

A `Group` is one process group of the mesh (a model group: the ranks of one
data row; a data group: the ranks of one model column; or the world) with
this rank's place in it.  The helpers take a Group and always call the
backend, whatever its size; callers skip a group of one where that saves a
copy.  A group of None (a run on one device) leaves x as it is, so that one
code path serves both.  Under gloo a CUDA buffer is staged through the host: gloo's support
for CUDA tensors differs between PyTorch builds, and the buffers that cross
are small (the heads' candidates, loss sums, flags) except the gradients of
a data group, which a run over NCCL keeps on the card.

Three autograd Functions make a layer split over a group trainable:
  `copy_to_group`     forward identity, backward all-reduce SUM of the
                      gradient (an input every shard reads);
  `reduce_from_group` forward all-reduce SUM, backward identity (a sum of
                      the shards' partial results);
  `gather_from_group` forward all_gather (the group's parts concatenated),
                      backward the gradient summed over the group and this
                      rank's part of it kept (every rank's loss reads every
                      part: the data group's embeddings of the contrastive
                      matrix).
`torch.distributed.nn.functional.all_reduce` would all-reduce the gradient
of the second once more, multiplying it by the group's size.  Integer ids
(sampled captions, no gradient) go through `all_gather` as they are.

A plan (`planned(plan)`) sees every `all_reduce` and `all_gather`, and
through them `all_reduce_tree` and the three Functions, in whichever thread
calls them (autograd runs a backward's collectives in its device thread):
  `Recording`    notes each collective (op, group, shape, dtype) and runs it
                 as usual: the order every rank of a group must keep;
  `SegmentPlan`  captures an iteration on the card as CUDA graphs that end
                 at each collective (training/fused.py): at a collective it
                 ends the segment's capture, runs the collective once into a
                 static output buffer, and begins the next segment on the
                 same stream and memory pool; `replay()` then replays
                 segment i, runs collective i from its static input into its
                 static output (gloo: through the host, NCCL: on the card)
                 and goes on to segment i + 1.
A broadcast or a barrier under a plan raises: no captured iteration holds
one, and a rank that ran one alone would leave the others waiting.
"""

from __future__ import annotations

import warnings
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


def _reduce(x, group, op):
    buf = _buffer(x, group)
    dist.all_reduce(buf, op=_OPS[op], group=group.pg)
    return buf


def _gather(x, group, dim):
    buf = _buffer(x, group)
    parts = [torch.empty_like(buf) for _ in range(group.size)]
    dist.all_gather(parts, buf, group=group.pg)
    return torch.cat(parts, dim=dim)


# a collective's result from its input, on the host where the group stages
_RUN = {"all_reduce": _reduce, "all_gather": _gather}

# the plan that sees every collective (process-wide: autograd's device
# thread calls the backward's), or None
_plan = None


def _collective(kind, x, group, arg):
    if _plan is not None:
        return _plan.collective(kind, x, group, arg)
    return _RUN[kind](x, group, arg).to(x.device)


def all_reduce(x, group: Group, op: str = "sum"):
    """The reduction ("sum", "max" or "min") of x over the group, a new
    tensor on x's device (under a `SegmentPlan` its static output)."""
    if group is None:
        return x
    return _collective("all_reduce", x, group, op)


def all_gather(x, group: Group, dim: int = 0):
    """The group's x, concatenated along `dim` in group-rank order."""
    if group is None:
        return x
    return _collective("all_gather", x, group, dim)


def _unplanned(what):
    if _plan is not None:
        raise RuntimeError(f"{what} under a collective plan: a captured "
                           f"iteration holds only all_reduce and all_gather")


def broadcast_(x, group: Group):
    """x of the group's first rank, copied into x on every rank."""
    _unplanned("broadcast_")
    buf = _buffer(x, group)
    dist.broadcast(buf, src=group.ranks[0], group=group.pg)
    with torch.no_grad():
        x.copy_(buf)
    return x


def broadcast_object(obj, group: Group):
    """The group's first rank's picklable `obj`, on every rank."""
    _unplanned("broadcast_object")
    box = [obj]
    dist.broadcast_object_list(box, src=group.ranks[0], group=group.pg)
    return box[0]


def barrier(group: Group):
    """Every rank of the group waits until all have arrived."""
    _unplanned("barrier")
    dist.barrier(group=group.pg)


class planned:
    """Context manager: `plan` sees every collective inside (one plan at a
    time); it calls plan.begin() on entry and plan.end() on exit."""

    def __init__(self, plan):
        self.plan = plan

    def __enter__(self):
        global _plan
        if _plan is not None:
            raise RuntimeError("a collective plan is active already")
        self.plan.begin()
        _plan = self.plan
        return self.plan

    def __exit__(self, *exc):
        global _plan
        _plan = None
        self.plan.end(exc[0] is not None)
        return False


class Recording:
    """A plan that notes each collective -- (op, group ranks, input shape,
    dtype, reduce op or gather dim) -- and runs it as usual."""

    def __init__(self):
        self.ops = []

    def begin(self):
        pass

    def end(self, failed):
        pass

    def collective(self, kind, x, group, arg):
        self.ops.append((kind, group.ranks, tuple(x.shape), str(x.dtype),
                         arg))
        return _RUN[kind](x, group, arg).to(x.device)


class _Static(NamedTuple):
    """A collective between two segments: `out` <- its result on `x`."""
    kind: str
    group: Group
    arg: Any
    x: torch.Tensor
    out: torch.Tensor

    def run(self):
        with torch.no_grad():
            self.out.copy_(_RUN[self.kind](self.x, self.group, self.arg))


class SegmentPlan:
    """An iteration captured on the card as segments that end at its
    collectives: graphs [g_0, ..., g_n] and collectives [c_0, ...,
    c_n-1] on static buffers, replayed g_0, c_0, g_1, ..., g_n.

    All segments are captured on `stream` into one memory pool (a tensor
    made in one segment and read in a later one keeps its address, as in a
    graph of the whole iteration), in the relaxed capture mode (a segment
    that a backward's collective ends began in another thread).  Each
    registers `generators`, so a replay draws, segment after segment, the
    noise one eager iteration draws from them.  Under the plan a collective
    returns its static output; the static input is the tensor it was given,
    kept alive with the plan."""

    def __init__(self, device, stream, generators=()):
        self.device = device
        self.stream = stream
        self.generators = list(generators)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs = []
        self.ops = []
        self._open = False

    def _begin_segment(self):
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        graph.capture_begin(pool=self.pool, capture_error_mode="relaxed")
        self.graphs.append(graph)
        self._open = True

    def _end_segment(self):
        self._open = False
        with warnings.catch_warnings():
            # a segment between two collectives may launch nothing
            warnings.filterwarnings("ignore", message=".*CUDA Graph is empty")
            self.graphs[-1].capture_end()

    def begin(self):
        with torch.cuda.stream(self.stream):
            self._begin_segment()

    def end(self, failed):
        if not self._open:
            return
        with torch.cuda.stream(self.stream):
            if not failed:
                self._end_segment()
                return
            try:
                self._end_segment()
            except RuntimeError:
                pass  # the capture's own error is the one to raise

    def collective(self, kind, x, group, arg):
        with torch.cuda.stream(self.stream):
            self._end_segment()
            x = x.detach()
            res = _RUN[kind](x, group, arg)
            op = _Static(kind, group, arg, x,
                         torch.empty(res.shape, dtype=res.dtype,
                                     device=x.device))
            op.run()
            self.ops.append(op)
            self._begin_segment()
        return op.out

    @property
    def segments(self) -> int:
        return len(self.graphs)

    def replay(self):
        """One iteration: each segment's graph, then the collective that
        ends it, on the current stream."""
        for i, graph in enumerate(self.graphs):
            graph.replay()
            if i < len(self.ops):
                self.ops[i].run()


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


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        total = all_reduce(grad, ctx.group)
        return total.narrow(ctx.dim, ctx.group.rank * ctx.size,
                            ctx.size), None, None


def _alone(group) -> bool:
    return group is None or group.size == 1


def part_of(x, group: Group, size: int):
    """This rank's `size` rows of a tensor or array gathered over the group
    (x itself without a group)."""
    if group is None:
        return x
    return x[group.rank * size:(group.rank + 1) * size]


def gather_from_group(x, group: Group, dim: int = 0):
    """The group's x concatenated along `dim`; the gradient of this rank's
    part is the sum over the group of the gradients of it."""
    return x if _alone(group) else _GatherFromGroup.apply(x, group, dim)


def copy_to_group(x, group: Group):
    """Identity; the gradient is summed over the group."""
    return x if _alone(group) else _CopyToGroup.apply(x, group)


def reduce_from_group(x, group: Group):
    """The sum of x over the group; the gradient passes unchanged."""
    return x if _alone(group) else _ReduceFromGroup.apply(x, group)
