"""The distributed training step over the (data, model) mesh (counterpart of
the JAX package's parallel/train_step.py, one GSPMD-partitioned program
there).

`make_distributed_train_step(opt, turn, mesh)` returns step(params, optim,
batch, streams, hp, reward=None, sampled=None, lr=None) -> (loss, aux) for
one turn ('optimizer', 'speaker' or 'listener'), which in one call (a
per-step iteration's, or the body a fused chunk captures,
training/fused.py):
  * takes this rank's rows of the global batch (`mesh.shard_batch`: the
    Trainer puts only those rows on the device) and of the global reward,
    and draws this rank's rows of every random draw (`draws.RowShard`: the
    global noise, sliced);
  * runs the turn's loss and its backward, every term this rank's share of
    the global batch's (training/joint.py: the normalisers summed over the
    data group, the listener's contrastive matrix over it, the vocabulary
    through the model group's slices, parallel/vocab.py);
  * sums the gradients over the data group (one all-reduce of one flat
    buffer): a replicated leaf then holds the global gradient on every rank,
    a vocab slice its slice of it (the model group summed the gradient of
    the hidden state already, in `copy_to_group`'s backward);
  * applies the guarded Adam update of the turn's agents
    (`optim.agents_to_update`) through `optim` (an OptimizerManager over
    the rank's params, its non-finite flag the MIN over the world, so
    every rank takes or skips the turn's step together).
The returned loss and aux are the global batch's (summed over the data
group), the same on every rank.
"""

from __future__ import annotations

import torch

from cooperativeimagecaptioning_tpu_torch.ops import draws
from cooperativeimagecaptioning_tpu_torch.parallel import collectives
from cooperativeimagecaptioning_tpu_torch.training import joint


def row_streams(streams, mesh):
    """The named streams of an iteration as this rank's rows of the global
    draws."""
    if mesh.n_data == 1:
        return streams
    return {name: draws.RowShard(src, mesh.n_data, mesh.data_index)
            for name, src in streams.items()}


def data_rows(mesh):
    """The data group whose ranks hold shares of the batch's rows, or None
    on a data axis of 1 (every rank holds them all)."""
    return mesh.data if mesh.n_data > 1 else None


def global_sums(loss, aux, mesh):
    """(loss, aux) summed over the data group, one collective."""
    keys = sorted(aux)
    if mesh.n_data == 1:
        return loss, aux
    total = collectives.all_reduce(
        torch.stack([loss] + [aux[k] for k in keys]), mesh.data)
    return total[0], dict(zip(keys, total[1:]))


def make_distributed_train_step(opt, turn, mesh):
    grad_fn = joint.value_and_grad(opt, turn, rows=data_rows(mesh))

    def step(params, optim, batch, streams, hp, reward=None, sampled=None,
             lr=None):
        """`batch`: this rank's rows (`mesh.shard_batch`); `reward`: this
        rank's rows of the host reward, or None; `lr`: a fused chunk's
        staged rate (a 0-d tensor), or None for the optimizer's."""
        (loss, aux), grads = grad_fn(params, batch, row_streams(streams, mesh),
                                     hp, reward, sampled)
        grads = collectives.all_reduce_tree(grads, mesh.data)
        optim.step(params, grads, turn, lr)
        return global_sums(loss, aux, mesh)

    return step
