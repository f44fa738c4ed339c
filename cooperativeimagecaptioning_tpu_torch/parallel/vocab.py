"""The speaker's vocabulary split over the model group (the pieces the JAX
package leaves to GSPMD on its vocab-sharded logit and embedding).

With a vocabulary mesh registered (`_dispatch.set_vocab_mesh`), a rank
holds its contiguous slice of the logit layer (V_local = (V+1) / n columns)
and, where V+2 divides the axis, of the embedding (rows).  A tensor is taken
for a slice when its vocabulary dim times the model axis is the global
width; a replicated leaf keeps the plain path.  All are plain PyTorch with
collectives, as the JAX package computes them outside any Pallas kernel:

  `into_shard`     the hidden state entering the logit slice ("copy to the
                   model group": its gradient is summed over the group);
  `log_softmax`    local max, MAX over the group, local sum of exp, SUM
                   (the logsumexp enters each slice through "copy to");
  `pick`           lp[..., ids] from the slice that holds each id, SUM;
  `embedding_lookup` a masked local lookup, then "reduce from the group";
  `nclass`         the global V+1 (the BOS id) from a slice's width;
  `softmax`        as log_softmax, the sum entering through "copy to";
  `argmax`         each rank's largest entry and its local id as one
                   record a row, gathered, and the `head_merge` kernel in
                   its argmax mode (on the card the hand-written merge,
                   which keeps the heads' tie rule: the lower global id
                   wins an exact tie) -- the categorical draw as a
                   Gumbel-max across slices, the straight-through arg-max,
                   greedy selection;
  `one_hot`        the one-hot rows of global ids, a slice's columns of them;
  `soft_embed`     relaxed one-hot rows times an embedding table, either of
                   them split: the local product, "reduce from the group".
A relaxed one-hot row has the V+2 columns of the embedding (the V+1 logit
columns and a zero BOS column); on a logit split a rank holds its logit
slice's columns of it, and the model group's last rank the BOS column too
(`soft_slice`, `with_bos_column`, `one_hot_row`, `drop_bos_column`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
from cooperativeimagecaptioning_tpu_torch.ops.kernels.head_merge import (
    head_merge, records)
from cooperativeimagecaptioning_tpu_torch.parallel import collectives


def _shard_mesh(width: int, extra: int):
    vm = _dispatch.vocab_mesh()
    if vm is None:
        return None
    mesh, V = vm
    return mesh if width * mesh.n_model == V + extra else None


def logit_mesh(x):
    """The registered mesh when x's last dim is a rank's slice of the V+1
    logit columns, else None."""
    return _shard_mesh(x.shape[-1], 1)


def embed_mesh(table):
    """The registered mesh when `table` is a rank's slice of the V+2
    embedding rows, else None."""
    return _shard_mesh(table.shape[0], 2)


def nclass(w) -> int:
    """V+1, the global logit width (and the BOS id), of a logit weight or its
    slice."""
    mesh = logit_mesh(w)
    return w.shape[1] * (mesh.n_model if mesh else 1)


def into_shard(x, w):
    """x as the input of the logit slice `w`: on a model group its gradient
    sums the slices' contributions."""
    mesh = logit_mesh(w)
    return x if mesh is None else collectives.copy_to_group(x, mesh.model)


def log_softmax(logits):
    """log_softmax over the last dim; over the model group's slices when
    `logits` is a slice (the result is this rank's slice)."""
    mesh = logit_mesh(logits)
    if mesh is None:
        return torch.log_softmax(logits, dim=-1)
    mx = collectives.all_reduce(
        logits.detach().amax(dim=-1, keepdim=True), mesh.model, "max")
    s = collectives.reduce_from_group(
        torch.exp(logits - mx).sum(dim=-1, keepdim=True), mesh.model)
    # the logsumexp enters every slice: its gradient sums theirs
    return logits - collectives.copy_to_group(mx + torch.log(s), mesh.model)


def softmax(x):
    """softmax over the last dim; over the model group's slices when x is a
    slice (the result is this rank's slice)."""
    mesh = logit_mesh(x)
    if mesh is None:
        return torch.softmax(x, dim=-1)
    g = mesh.model
    mx = collectives.all_reduce(x.detach().amax(dim=-1, keepdim=True), g,
                                "max")
    e = torch.exp(x - mx)
    # the sum enters every slice: its gradient sums theirs
    s = collectives.copy_to_group(collectives.reduce_from_group(
        e.sum(dim=-1, keepdim=True), g), g)
    return e / s


def argmax(x):
    """The global id of the largest entry along the last dim (the lowest of
    equal ones), int64, without gradient.  On a slice: each rank's largest
    and its local id as a [val | id] record a row, the model group's
    records gathered in one collective, and `head_merge`'s argmax mode (R
    rows of n candidates)."""
    mesh = logit_mesh(x)
    if mesh is None:
        return torch.argmax(x, dim=-1)
    lead, width = x.shape[:-1], x.shape[-1]
    v, i = x.detach().reshape(-1, width).float().max(dim=-1)
    rec = records(v[:, None], i[:, None])
    got = collectives.all_gather(rec, mesh.model, dim=0)
    return head_merge(got.view(mesh.n_model, *rec.shape), width, 1,
                      "argmax").reshape(lead)


def one_hot(ids, like):
    """The one-hot rows of global `ids` over like's last dim, in like's
    dtype; on a slice this rank's columns of them."""
    width = like.shape[-1]
    mesh = logit_mesh(like)
    if mesh is None:
        return F.one_hot(ids.long(), width).to(like.dtype)
    local, inside = _local_ids(ids, width, mesh)
    return F.one_hot(local, width).to(like.dtype) * \
        inside[..., None].to(like.dtype)


def add_at(logits, ids, value):
    """logits [B, C] with `value` added at each row's global id (ids [B]);
    on a slice only where the slice holds the id."""
    mesh = logit_mesh(logits)
    if mesh is None:
        return logits + torch.zeros_like(logits).scatter_(
            1, ids.long()[:, None], value)
    local, inside = _local_ids(ids, logits.shape[-1], mesh)
    pen = torch.zeros_like(logits).scatter_(1, local[:, None], value)
    return logits + torch.where(inside[:, None], pen, torch.zeros_like(pen))


def soft_slice(x):
    """(mesh, the global index of its first column) when x's last dim is
    this rank's share of the V+2 columns of relaxed one-hot rows: its logit
    slice's columns, on the model group's last rank with the BOS column
    V+1 after them; None for whole rows."""
    vm = _dispatch.vocab_mesh()
    if vm is None:
        return None
    mesh, V = vm
    n = mesh.n_model
    if (V + 1) % n:
        return None
    width, last = (V + 1) // n, mesh.model_index == n - 1
    if x.shape[-1] == width or (last and x.shape[-1] == width + 1):
        return mesh, mesh.model_index * width
    return None


def with_bos_column(y):
    """Relaxed rows over the V+1 logit columns -> over the V+2 embedding
    columns: a zero BOS column appended (on a slice by the model group's
    last rank alone)."""
    mesh = logit_mesh(y)
    if mesh is not None and mesh.model_index != mesh.n_model - 1:
        return y
    return torch.cat([y, y.new_zeros(y.shape[:-1] + (1,))], dim=-1)


def drop_bos_column(soft):
    """The inverse of `with_bos_column`."""
    sl = soft_slice(soft)
    if sl is not None and sl[0].model_index != sl[0].n_model - 1:
        return soft
    return soft[..., :-1]


def one_hot_row(hot, like):
    """A row over like's last dim (its dtype and device) with a 1 at global
    column `hot` -- all zeros on a rank whose share lacks it --, written by
    kernels alone (item assignment of a Python number copies it from the
    host, which a CUDA graph capture refuses)."""
    n = like.shape[-1]
    sl = soft_slice(like)
    at = hot - (0 if sl is None else sl[1])
    row = like.new_zeros((n,))
    if 0 <= at < n:
        idx = torch.full((1,), at, dtype=torch.long, device=like.device)
        row = row.index_fill_(0, idx, 1.0)
    return row


def soft_embed(soft, table):
    """Relaxed one-hot rows soft [..., V+2] times an embedding table
    [V+2, D]: the whole product, or on a mesh this rank's part of it summed
    over the model group -- the rank's columns of the rows against the
    matching rows of a whole table (`soft_slice`), or the rank's rows of
    the table against the matching columns of whole rows.  The whole
    operand enters through "copy to", so its gradient is the group's sum."""
    sl = soft_slice(soft)
    if sl is not None:
        mesh, first = sl
        rows = collectives.copy_to_group(table, mesh.model).narrow(
            0, first, soft.shape[-1])
        return collectives.reduce_from_group(soft @ rows, mesh.model)
    mesh = embed_mesh(table)
    if mesh is None:
        return soft @ table
    n = table.shape[0]
    cols = collectives.copy_to_group(soft, mesh.model).narrow(
        -1, mesh.model_index * n, n)
    return collectives.reduce_from_group(cols @ table, mesh.model)


def gather_cols(x, ids, dim):
    """torch.gather(x, dim, ids) with global vocabulary ids along `dim`; x
    may be a logit slice along that dim (the ids' entries from the slices
    that hold them, summed over the model group)."""
    mesh = _shard_mesh(x.shape[dim], 1)
    if mesh is None:
        return torch.gather(x, dim, ids)
    local, inside = _local_ids(ids, x.shape[dim], mesh)
    got = torch.gather(x, dim, local)
    return collectives.reduce_from_group(
        torch.where(inside, got, torch.zeros((), dtype=x.dtype,
                                             device=x.device)), mesh.model)


def _local_ids(ids, width, mesh):
    """(ids inside this rank's slice, the mask of those ids)."""
    local = ids.long() - mesh.model_index * width
    inside = (local >= 0) & (local < width)
    return local.clamp(0, width - 1), inside


def pick(lp, ids):
    """lp[..., ids] along the last dim (ids of lp's shape without it)."""
    return gather_cols(lp, ids[..., None].long(), -1)[..., 0]


def embedding_lookup(table, ids):
    """table [N, D] (or this rank's slice of its rows), integer ids of any
    shape -> [*ids.shape, D]."""
    mesh = embed_mesh(table)
    if mesh is None:
        # F.embedding: its backward on the card sums each row's
        # contributions in a fixed order (index_select's backward adds them
        # with atomics, in whatever order they land), so two runs of one
        # step, per-step or replayed from a CUDA graph, give equal bits
        return torch.nn.functional.embedding(ids, table)
    local, inside = _local_ids(ids.reshape(-1), table.shape[0], mesh)
    rows = torch.where(inside[:, None], table.index_select(0, local),
                       torch.zeros((), dtype=table.dtype,
                                   device=table.device))
    return collectives.reduce_from_group(rows, mesh.model).reshape(
        tuple(ids.shape) + (table.shape[1],))
