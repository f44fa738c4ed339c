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
  `nclass`         the global V+1 (the BOS id) from a slice's width.
"""

from __future__ import annotations

import torch

from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
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


def _local_ids(ids, width, mesh):
    """(ids inside this rank's slice, the mask of those ids)."""
    local = ids.long() - mesh.model_index * width
    inside = (local >= 0) & (local < width)
    return local.clamp(0, width - 1), inside


def pick(lp, ids):
    """lp[..., ids] along the last dim (ids of lp's shape without it)."""
    mesh = logit_mesh(lp)
    if mesh is None:
        return torch.gather(lp, -1, ids[..., None].long())[..., 0]
    local, inside = _local_ids(ids, lp.shape[-1], mesh)
    got = torch.gather(lp, -1, local[..., None])[..., 0]
    return collectives.reduce_from_group(
        torch.where(inside, got, torch.zeros((), dtype=lp.dtype,
                                             device=lp.device)), mesh.model)


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
