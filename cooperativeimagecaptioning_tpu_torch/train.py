"""Training entry point of the port (mirrors the repository's train.py).

    python -m cooperativeimagecaptioning_tpu_torch.train --device cuda \\
        --phase 2 --caption_model att2in2 --input_json data/cocotalk.json ...

Takes the JAX package's flags (config.parse_opt, the reference's CLI) plus
`--device` (default cuda), and runs `training.loop.train`: phase 1 (the
listener, run_fc_con.py's flag set), phase 2 (MLE), self-critical CIDEr-D
fine-tuning with the host reward, and phase-3 joint training with the
relaxed or the REINFORCE DISC loss (run_joint.py's flag sets for -o
gumbel, multinomial, gumbel_softmax, multinomial_soft, reinforce and their
ablations: `--retrieval_reward reinforce --reinforce_baseline_type
gt|greedy|no`, alternating speaker and listener turns), seeded with
`--speaker_stage_2_model_path` / `--initialize_retrieval` or resumed with
`--start_from DIR`; `--audit_grad_isolation 1` checks that each step moved
only its turn's agents, and `--profile_dir D --profile_start S
--profile_steps N` traces the iterations [S, S + N) with torch.profiler;
`--fused_steps K --device_feature_cache 1` trains in captured chunks of K
where nothing needs the host each step (training/loop.py `_fused_gate`).
`--checkpoint_backend orbax` keeps the model trees as `.orbax`
directories (asynchronous, atomic saves; read and written without orbax,
training/orbax_tier.py).  After a phase-3 run, results harvesting writes
the val / test dicts and the run's json report (evaluation/harvest.py; the
repository's train.py does the same), once, after the last rank of a mesh
run finished.

    python -m cooperativeimagecaptioning_tpu_torch.train --device cuda \
        --phase 1 --caption_model fc --vse_model fc --vse_loss_weight 1 \
        --caption_loss_weight 0 --rank_eval 1 --checkpoint_path runs/fc_con

    python -m cooperativeimagecaptioning_tpu_torch.train --device cuda \
        --phase 3 --vse_model fc --is_alternating 1 \
        --alternating_turn speaker --alternating_turn listener \
        --retrieval_reward gumbel --retrieval_reward_weight 0.01 \
        --cider_optimization 0.99 --caption_loss_weight 0 \
        --speaker_stage_2_model_path runs/att/model.pth \
        --initialize_retrieval runs/fc_con/model_vse-best.pth ...

Every phase also on a (data, model) process grid, per step or in fused
chunks (`--fused_steps K --device_feature_cache 1`): `--mesh_data_axis N
--mesh_model_axis M` starts the N*M ranks from this one command (one
process per mesh position: NCCL where each has a card, gloo where they
share one or run on the CPU), or, under torchrun, each process is the rank
the environment names, on one host or on several (NCCL only where no two
ranks of the world share a card; global rank 0 reads and writes the run
dir, and harvests it alone):

    python -m cooperativeimagecaptioning_tpu_torch.train --device cuda \
        --phase 2 --mesh_data_axis 2 --mesh_model_axis 2 ...
    torchrun --nproc_per_node 4 -m cooperativeimagecaptioning_tpu_torch.train \
        --device cuda --phase 2 --mesh_data_axis 2 --mesh_model_axis 2 ...
    torchrun --nnodes 2 --node_rank R --nproc_per_node 2 \
        --master_addr HOST0 --master_port 29500 \
        -m cooperativeimagecaptioning_tpu_torch.train --device cuda \
        --phase 2 --mesh_data_axis 4 --fused_steps 8 \
        --device_feature_cache 1 ...
"""

from __future__ import annotations

import argparse
import os

from cooperativeimagecaptioning_tpu_torch import config
from cooperativeimagecaptioning_tpu_torch.evaluation import harvest
from cooperativeimagecaptioning_tpu_torch.parallel import launch
from cooperativeimagecaptioning_tpu_torch.parallel.mesh import mesh_shape
from cooperativeimagecaptioning_tpu_torch.training.loop import train


def train_rank(opt, device):
    """One rank of a mesh run -> the iterations it trained."""
    return train(opt, device=device).iteration


def main(argv=None):
    """Train; after a phase-3 run, harvest its results.  Returns the
    Trainer (on a mesh: rank 0's iterations)."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda",
                     help="torch device to train on (cuda, or cpu for the "
                          "plain versions of the kernels)")
    known, rest = pre.parse_known_args(argv)
    opt = config.parse_opt(rest)
    shape = mesh_shape(opt, known.device)
    if shape is None:
        result = train(opt, device=known.device)
    else:
        result = launch.run(train_rank, (opt, known.device),
                            shape[0] * shape[1], known.device)
        if launch.under_torchrun():
            if int(os.environ["RANK"]) != 0:
                return result  # rank 0 harvests
            # the other ranks have left: rank 0 re-evaluates on its own
            # device
            opt = opt.replace(mesh_data_axis=0, mesh_model_axis=1)
    if opt.phase in (1, 2):
        return result
    harvest.create_dicts_and_json_after_training(opt, device=known.device)
    print("Finished all")
    return result


if __name__ == "__main__":
    main()
