"""The (data, model) process grid and its sharding rules (counterpart of the
JAX package's parallel/mesh.py).

The JAX package runs one controller over a device mesh and lets GSPMD
partition its programs.  The port runs one process per mesh position over
`torch.distributed`, with rank = data_index * n_model + model_index (the
JAX mesh's row-major device grid):
  data  -- batch parallelism: each rank keeps its contiguous share of the
           global batch's rows, and gradients are summed over the data group;
  model -- vocabulary parallelism: the logit layer [H, V+1] (by columns) and
           the embedding [V+2, D] (by rows), each only where its vocabulary
           dim divides the axis; the heads and the log-softmax merge over
           the model group (parallel/vocab.py).

Every rank reads the same global batch from the same loader and keeps its
rows (`shard_batch`), so the data order is the single-device run's; params
start replicated (a broadcast from global rank 0) and `shard_params` keeps
each rank's slices; `gather_params` rebuilds the whole tree (a checkpoint of
a mesh run is the file set of a single-device run).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist

from cooperativeimagecaptioning_tpu_torch.parallel import collectives
from cooperativeimagecaptioning_tpu_torch.parallel.collectives import Group
from cooperativeimagecaptioning_tpu_torch.utils.tree import (
    from_leaves, leaves)

# ROADMAP item of what a mesh run does not do yet
REST = "ROADMAP.md queue 1: multi-device, the rest"
# every process group's timeout: a rank that died leaves the others waiting
# no longer than this
GROUP_TIMEOUT = timedelta(seconds=60)


@dataclass
class Mesh:
    """One rank's view of the (data, model) grid."""
    n_data: int
    n_model: int
    rank: int
    device: torch.device
    backend: str
    model: Group   # the ranks of this rank's data row
    data: Group    # the ranks of this rank's model column
    world: Group

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "model": self.n_model}

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model


def backend_for(device: str, ranks_on_host: int) -> str:
    """NCCL where each rank has a card of its own, gloo where ranks share a
    card or run on the CPU."""
    if device == "cuda" and torch.cuda.device_count() >= ranks_on_host:
        return "nccl"
    return "gloo"


def rank_device(device: str, rank: int) -> torch.device:
    """The device of a rank: the CPU, or card LOCAL_RANK (the rank outside
    torchrun) modulo the cards there are, so that ranks beyond the cards
    share them."""
    if device == "cpu":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def mesh_shape(opt, device: str = "cuda"):
    """(n_data, n_model) of a run's options, or None for a single-device run
    (JAX training/loop.py:96-105): mesh_data_axis 0 means all remaining
    devices (the ranks of a started group, else the cards), and an explicit
    1 with a model axis a model-only mesh."""
    n_data = int(getattr(opt, "mesh_data_axis", 0) or 0)
    n_model = int(getattr(opt, "mesh_model_axis", 1) or 1)
    if n_data <= 1 and n_model <= 1:
        return None
    if n_data == 0:
        if dist.is_initialized():
            avail = dist.get_world_size()
        else:
            avail = torch.cuda.device_count() if device == "cuda" else 1
        n_data = max(1, avail // n_model)
    return n_data, n_model


def make_mesh(n_data: int = 0, n_model: int = 1, device: str = "cuda") -> Mesh:
    """This rank's Mesh over the started process group (every rank calls it,
    in the same order as every other collective); n_data=0 takes all
    remaining ranks.  Creates one group per data row and one per model
    column, each with GROUP_TIMEOUT."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh: no process group: start the ranks with the port's "
            "train / eval entry points (they spawn one process per mesh "
            "position), under torchrun, or with parallel.launch.spawn")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data == 0:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a ({n_data}, {n_model}) mesh needs "
                         f"{n_data * n_model} ranks, the group has {world}")
    dev = rank_device(device, rank)
    backend = dist.get_backend()
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("an NCCL group needs its ranks on cards")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    staged = backend == "gloo" and dev.type == "cuda"

    def groups(rows):
        mine = None
        for ranks in rows:
            pg = dist.new_group(list(ranks), timeout=GROUP_TIMEOUT)
            if rank in ranks:
                mine = Group(pg, tuple(ranks), ranks.index(rank), staged)
        return mine

    model = groups([list(range(d * n_model, (d + 1) * n_model))
                    for d in range(n_data)])
    data = groups([list(range(m, world, n_model)) for m in range(n_model)])
    return Mesh(n_data, n_model, rank, dev, backend, model, data,
                Group(None, tuple(range(world)), rank, staged))


def replicate(tree, mesh: Mesh):
    """Every tensor leaf set to global rank 0's, in place; returns the
    tree."""
    for _, x in leaves(tree):
        collectives.broadcast_(x, mesh.world)
    return tree


# batch keys that are per-run constants, not per-step data: always replicated
_REPLICATED_KEYS = frozenset({"df_table"})


def _rows(x, n: int, i: int, axis: int):
    size = x.shape[axis] // n
    return x.narrow(axis, i * size, size)


def shard_batch(batch, mesh: Mesh):
    """This rank's share of every tensor's leading (batch) axis over 'data'
    (JAX mesh.py:45-78).  Leaves whose leading dim does not divide the axis
    (per-image reward refs beside per-sequence rows) and `_REPLICATED_KEYS`
    stay whole."""
    n, i = mesh.n_data, mesh.data_index

    def put(x, const=False):
        if isinstance(x, dict):
            return {k: put(v, const or k in _REPLICATED_KEYS)
                    for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(put(v, const) for v in x)
        if not isinstance(x, torch.Tensor) or const or x.dim() == 0 or \
                x.shape[0] % n:
            return x
        return _rows(x, n, i, 0)
    return put(batch)


def shard_batch_stacked(xs, mesh: Mesh):
    """shard_batch for inputs stacked on a leading step axis: axis 1 holds
    each step's rows (JAX mesh.py:81-97)."""
    n, i = mesh.n_data, mesh.data_index

    def put(x):
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if not isinstance(x, torch.Tensor) or x.dim() < 2 or x.shape[1] % n:
            return x
        return _rows(x, n, i, 1)
    return put(xs)


def _vocab_dim(path: str):
    """The vocabulary dim of a speaker leaf (JAX mesh.py:100-111): logit w
    [H, V+1] by columns, its bias by entries, an embedding [V+2, D] by rows;
    None for every other leaf."""
    names = path.split(".")
    if "logit" in names:
        return 1 if names[-1] == "w" else 0
    if names[-1] == "embed":
        return 0
    return None


def param_specs(params, mesh) -> dict:
    """{leaf path: the dim split over 'model', or None} of a whole tree (JAX
    param_shardings): a vocabulary dim that does not divide the model axis
    stays replicated (V+1 and V+2 are consecutive, so on an even axis at most
    one of logit and embedding splits)."""
    n = mesh.n_model
    out = {}
    for path, x in leaves(params):
        dim = _vocab_dim(path) if n > 1 else None
        out[path] = dim if dim is not None and x.shape[dim] % n == 0 \
            else None
    return out


def _shard_leaf(x, dim, mesh):
    if dim is None:
        return x
    # a fresh contiguous copy: the heads' 16-byte loads need aligned rows
    return _rows(x, mesh.n_model, mesh.model_index, dim).clone(
        memory_format=torch.contiguous_format)


def shard_params(params, mesh: Mesh, specs: dict):
    """This rank's slices of a whole tree, by `param_specs`."""
    return from_leaves((path, _shard_leaf(x, specs[path], mesh))
                       for path, x in leaves(params))


def gather_params(params, mesh: Mesh, specs: dict):
    """The whole tree from every rank's slices (all_gather over the model
    group), detached."""
    return from_leaves(
        (path, x.detach() if specs[path] is None else
         collectives.all_gather(x, mesh.model, specs[path]))
        for path, x in leaves(params))


def _agent_specs(specs, agent, paths):
    return [specs[f"{agent}.{p}"] for p in paths]


def shard_states(states, paths, mesh: Mesh, specs: dict):
    """Adam states {agent: {'count', 'mu': [...], 'nu': [...]}} of whole
    leaves (moment lists in `paths[agent]` order) -> this rank's slices."""
    out = {}
    for agent, st in states.items():
        dims = _agent_specs(specs, agent, paths[agent])
        out[agent] = {"count": st["count"],
                      **{k: [_shard_leaf(x, d, mesh)
                             for x, d in zip(st[k], dims)]
                         for k in ("mu", "nu")}}
    return out


def gather_states(states, paths, mesh: Mesh, specs: dict):
    """The inverse of `shard_states` (all_gather over the model group)."""
    out = {}
    for agent, st in states.items():
        dims = _agent_specs(specs, agent, paths[agent])
        out[agent] = {"count": st["count"],
                      **{k: [x if d is None else
                             collectives.all_gather(x, mesh.model, d)
                             for x, d in zip(st[k], dims)]
                         for k in ("mu", "nu")}}
    return out
