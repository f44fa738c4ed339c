"""Training entry point of the port (mirrors the repository's train.py).

    python -m cooperativeimagecaptioning_tpu_torch.train --device cuda \\
        --phase 2 --caption_model att2in2 --input_json data/cocotalk.json ...

Takes the JAX package's flags (config.parse_opt, the reference's CLI) plus
`--device` (default cuda), and runs `training.loop.train`.  The port trains
the speaker without a listener: phase 2 (MLE) and self-critical CIDEr-D
fine-tuning with the host reward (`--cider_optimization 1
--caption_loss_weight 0 --phase 3`), resumed with `--start_from DIR` (or
seeded with `--speaker_stage_2_model_path`); other configurations raise
NotImplementedError naming what is missing.

    python -m cooperativeimagecaptioning_tpu_torch.train --device cuda \\
        --phase 3 --cider_optimization 1 --caption_loss_weight 0 \\
        --start_from runs/att_phase2 --checkpoint_path runs/att_scst ...
"""

from __future__ import annotations

import argparse

from cooperativeimagecaptioning_tpu_torch import config
from cooperativeimagecaptioning_tpu_torch.training.loop import train


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda",
                     help="torch device to train on (cuda, or cpu for the "
                          "plain versions of the kernels)")
    known, rest = pre.parse_known_args(argv)
    opt = config.parse_opt(rest)
    return train(opt, device=known.device)


if __name__ == "__main__":
    main()
