"""Phase-1 listener pretraining driver of the port (counterpart of the JAX
package's scripts/run_fc_con.py; ref: bash_scripts/run_fc_con.sh).

Trains the VSE listener on ground-truth captions with the caption model frozen:
vse_loss_weight 1, caption_loss_weight 0, rank_eval 1, 30 epochs, on the card
unless --device cpu.

    python -m cooperativeimagecaptioning_tpu_torch.scripts.run_fc_con -b 128
"""

from __future__ import annotations

import argparse
import os


# Reference phase-1 flag-set (bash_scripts/run_fc_con.sh:65-86): the one
# source shared by this driver and chip_smoke.py's phase 1.
STAGE_FLAGS = dict(
    id="fc_con", caption_model="fc", vse_model="fc", phase=1,
    vse_loss_weight=1, caption_loss_weight=0, rank_eval=1, language_eval=0,
    seq_per_img=1, learning_rate=5e-4, learning_rate_decay_start=0,
    learning_rate_decay_every=15, scheduled_sampling_start=0)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-b", "--batch", type=int, default=128)
    p.add_argument("--max-epochs", type=int, default=30)
    p.add_argument("--root-dir", default="runs")
    p.add_argument("--input-json", default="data/cocotalk.json")
    p.add_argument("--input-label-h5", default="data/cocotalk_label.h5")
    p.add_argument("--input-fc-dir", default="data/cocotalk_fc")
    p.add_argument("--input-att-dir", default="data/cocotalk_att")
    p.add_argument("-I", "--dataset", default="coco")
    p.add_argument("--set", action="append", default=[],
                   metavar="K=V", help="Options override, e.g. --set rnn_size=64 (repeatable)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, or cpu)")
    args = p.parse_args(argv)

    from cooperativeimagecaptioning_tpu_torch.config import (
        Options, parse_set_overrides)
    from cooperativeimagecaptioning_tpu_torch.training.loop import train

    ckpt = os.path.join(args.root_dir, "log_fc_con")
    os.makedirs(ckpt, exist_ok=True)
    opt = Options(
        batch_size=args.batch, max_epochs=args.max_epochs,
        checkpoint_path=ckpt, start_from=ckpt if os.listdir(ckpt) else None,
        input_json=args.input_json, input_label_h5=args.input_label_h5,
        input_fc_dir=args.input_fc_dir, input_att_dir=args.input_att_dir,
        dataset=args.dataset,
        save_checkpoint_every=3000, val_images_use=5000, **STAGE_FLAGS)
    opt = opt.replace(**parse_set_overrides(args.set))
    train(opt, device=args.device)


if __name__ == "__main__":
    main()
