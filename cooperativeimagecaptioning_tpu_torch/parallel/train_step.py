"""The distributed training step over the (data, model) mesh (counterpart of
the JAX package's parallel/train_step.py, one GSPMD-partitioned program
there).

`make_distributed_train_step(opt, turn, mesh)` returns step(params, optim,
batch, streams, hp) -> (loss, aux), which in one call:
  * keeps this rank's rows of the global batch (`mesh.shard_batch`) and of
    every random draw (`draws.RowShard`: the global noise, sliced);
  * runs the loss and its backward, the caption loss normalised over the
    global batch (the data group's mask sum), the vocabulary through the
    model group's slices (parallel/vocab.py);
  * sums the gradients over the data group (one all-reduce of one flat
    buffer): a replicated leaf then holds the global gradient on every rank,
    a vocab slice its slice of it (the model group summed the gradient of
    the hidden state already, in `copy_to_group`'s backward);
  * applies the guarded Adam update of `optim` (an OptimizerManager over the
    rank's params, its flag the MIN over the world).
The returned loss and aux are the global batch's (summed over the data
group), the same on every rank.
"""

from __future__ import annotations

import torch

from cooperativeimagecaptioning_tpu_torch.ops import draws
from cooperativeimagecaptioning_tpu_torch.parallel import collectives
from cooperativeimagecaptioning_tpu_torch.parallel.mesh import shard_batch
from cooperativeimagecaptioning_tpu_torch.training import joint


def row_streams(streams, mesh):
    """The named streams of an iteration as this rank's rows of the global
    draws."""
    if mesh.n_data == 1:
        return streams
    return {name: draws.RowShard(src, mesh.n_data, mesh.data_index)
            for name, src in streams.items()}


def global_sums(loss, aux, mesh):
    """(loss, aux) summed over the data group, one collective."""
    keys = sorted(aux)
    if mesh.n_data == 1:
        return loss, aux
    total = collectives.all_reduce(
        torch.stack([loss] + [aux[k] for k in keys]), mesh.data)
    return total[0], dict(zip(keys, total[1:]))


def make_distributed_train_step(opt, turn, mesh):
    grad_fn = joint.value_and_grad(
        opt, turn, rows=mesh.data if mesh.n_data > 1 else None)

    def step(params, optim, batch, streams, hp):
        (loss, aux), grads = grad_fn(params, shard_batch(batch, mesh),
                                     row_streams(streams, mesh), hp)
        grads = collectives.all_reduce_tree(grads, mesh.data)
        optim.step(params, grads, turn)
        return global_sums(loss, aux, mesh)

    return step
