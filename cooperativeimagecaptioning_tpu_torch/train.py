"""Training entry point of the port (mirrors the repository's train.py).

    python -m cooperativeimagecaptioning_tpu_torch.train --device cuda \\
        --phase 2 --caption_model att2in2 --input_json data/cocotalk.json ...

Takes the JAX package's flags (config.parse_opt, the reference's CLI) plus
`--device` (default cuda), and runs `training.loop.train`.  The port trains
phase 2 (the speaker's MLE stage) so far; other configurations raise
NotImplementedError naming what is missing.
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
