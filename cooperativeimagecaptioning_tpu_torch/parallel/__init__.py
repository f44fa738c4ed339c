"""Parallelism of the port: the (data, model) process grid, its sharding
rules and collectives, the vocab-parallel pieces of the speaker, the
distributed train step and the launcher of the ranks (counterpart of the
JAX package's parallel/, where GSPMD places the collectives).  The train
step lives in parallel/train_step.py, imported where it is used."""

from cooperativeimagecaptioning_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, gather_params, make_mesh, param_specs, replicate, shard_batch,
    shard_batch_stacked, shard_params)
