"""Write tests/data/jax_orbax_run/: a small run dir that the JAX package
wrote under checkpoint_backend 'orbax', for readers that have no JAX (the
port's tests, and chip_smoke.py on a machine with a card).

    python tests/data/make_jax_orbax_fixture.py

Runs on the CPU with two host devices.  The params of a tiny speaker and
listener (joint.init_params: vocab 25, rnn 16, vse_embed 16) are placed on
a (1 data, 2 model) mesh with the JAX package's vocab-sharded layout
(parallel/mesh.param_shardings), so the vocab-sized leaves are saved as
two chunks each, and saved by the JAX package's CheckpointManager as
`model-best.orbax` (orbax's StandardCheckpointer: OCDBT, zstd).  The leaves
as saved go beside it into `expected.npz`, keyed by their paths joined
with '.'.  Rerunning writes a new database (new file names) with the same
leaves.
"""

import os
import shutil
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=2")

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from cooperativeimagecaptioning_tpu.config import Options  # noqa: E402
from cooperativeimagecaptioning_tpu.parallel import mesh as jmesh  # noqa: E402
from cooperativeimagecaptioning_tpu.training import checkpoint as jckpt  # noqa: E402
from cooperativeimagecaptioning_tpu.training import joint  # noqa: E402

OUT = os.path.join(HERE, "jax_orbax_run")
OPT = dict(caption_model="att2in2", vse_model="fc", vocab_size=25,
           rnn_size=16, input_encoding_size=12, att_hid_size=8,
           fc_feat_size=20, att_feat_size=20, seq_length=8,
           vse_embed_size=16, checkpoint_backend="orbax")


def main():
    shutil.rmtree(OUT, ignore_errors=True)
    opt = Options(checkpoint_path=OUT, **OPT)
    params = joint.init_params(jax.random.PRNGKey(7), opt)
    mesh = jmesh.make_mesh(1, 2)
    params = jax.device_put(params, jmesh.param_shardings(params, mesh))
    mgr = jckpt.CheckpointManager(opt)
    mgr.save_best(params)
    mgr.sync()
    flat = {".".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(params)}
    np.savez(os.path.join(OUT, "expected.npz"), **flat)
    sharded = sorted(k for k, leaf in zip(flat, jax.tree.leaves(params))
                     if len(leaf.sharding.device_set) > 1 and
                     not leaf.sharding.is_fully_replicated)
    print(f"{len(flat)} leaves, sharded over 2 devices: {sharded}")


if __name__ == "__main__":
    main()
