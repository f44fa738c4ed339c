"""Phase-3 / joint cooperative training driver of the port (counterpart of
the JAX package's scripts/run_joint.py; ref: bash_scripts/run_joint.sh).

Maps an optimization mode to the reference's flag sets and run-dir naming:
  gumbel | gumbel_softmax | multinomial | multinomial_soft | reinforce
  + ablations: reinforce_listener | reinforce_speaker | gumbel_speaker |
    multinomial_speaker
and derives cider weight = 1 - discriminative weight (run_joint.sh:92).
Trains on the card unless --device cpu, then harvests the run dir (the
per-criterion bests, pruning, the test re-evaluation and the json report).

    python -m cooperativeimagecaptioning_tpu_torch.scripts.run_joint -o gumbel \\
        --speaker-stage-2-model runs/log_att/model-best.pth \\
        --listener-stage-1-model runs/log_fc_con/model-best.pth
"""

from __future__ import annotations

import argparse
import os
import shutil

# The Options every joint run shares, beside build_run's per-mode overrides;
# chip_smoke.py's joint phases train with both.
JOINT_BASE = dict(
    caption_model="att2in2", vse_model="fc", language_eval=1, rank_eval=1,
    rank_on_gen_captions=True, seq_per_img=1, learning_rate_decay_start=0,
    scheduled_sampling_start=0)


def build_run(args):
    """Return (run_dir_name, opt_overrides) mirroring run_joint.sh:92-241."""
    d = args.discriminative
    cider = 1 - d
    fixed = f"_C{cider:g}_LR{args.lr}_D{args.decay}_E{args.every}"
    if args.softmax_cooling > 0:
        fixed += f"_O{args.softmax_cooling:g}"
    fixed += f"_BS{args.batch}"
    o = args.optimization
    ov = dict(retrieval_reward_weight=d, cider_optimization=cider,
              learning_rate=args.lr, learning_rate_decay_rate=args.decay,
              learning_rate_decay_every=args.every, batch_size=args.batch,
              caption_loss_weight=args.caption,
              vse_loss_weight=args.vse, share_embed=args.shared_embedding,
              max_epochs=args.max_epochs, is_alternating=1,
              alternating_turn=["speaker", "listener"], retrieval_reward=o)
    if o == "gumbel":
        name = f"G{d:g}_T{args.temperature:g}_TA{args.annealing:g}_AE" \
               f"{args.annealing_every}{fixed}"
        ov.update(gumbel_temp=args.temperature,
                  gumbel_temperature_annealing_factor=args.annealing,
                  num_iteration_for_annealing=args.annealing_every or 500)
    elif o == "gumbel_softmax":
        name = f"GS{d:g}_T{args.temperature:g}_P{args.prob:g}{fixed}"
        ov.update(gumbel_temp=args.temperature,
                  prob_gumbel_softmax=args.prob,
                  softmax_cooling_decay_factor=args.softmax_cooling)
    elif o == "multinomial":
        name = f"M{d:g}_T{args.temperature:g}{fixed}"
        ov.update(multinomial_temp=args.temperature)
    elif o == "multinomial_soft":
        name = f"MS{d:g}_T{args.temperature:g}_P{args.prob:g}{fixed}"
        ov.update(multinomial_temp=args.temperature,
                  prob_multinomial_soft=args.prob,
                  softmax_cooling_decay_factor=args.softmax_cooling)
    elif o == "reinforce":
        name = f"R{d:g}_CAP{args.caption:g}_V{args.vse:g}_BSL_" \
               f"{args.reinforce_baseline}{fixed}"
        ov.update(reinforce_baseline_type=args.reinforce_baseline or "gt")
    elif o == "reinforce_listener":  # ablation: listener only
        name = f"rl{d:g}{fixed}"
        ov.update(alternating_turn=["listener"], retrieval_reward="reinforce",
                  reinforce_baseline_type="gt", max_epochs=500,
                  vse_loss_weight=1, cider_optimization=0,
                  caption_loss_weight=0)
    elif o == "reinforce_speaker":  # ablation: non-alternating speaker
        name = f"r{d:g}{fixed}"
        ov.update(is_alternating=0, alternating_turn=None, phase=3,
                  retrieval_reward="reinforce")
    elif o == "gumbel_speaker":
        name = f"g{d:g}_T{args.temperature:g}{fixed}"
        ov.update(is_alternating=0, alternating_turn=None, phase=3,
                  gumbel_temp=args.temperature, retrieval_reward="gumbel")
    elif o == "multinomial_speaker":
        name = f"m{d:g}_T{args.temperature:g}{fixed}"
        ov.update(is_alternating=0, alternating_turn=None, phase=3,
                  multinomial_temp=args.temperature,
                  retrieval_reward="multinomial")
    else:
        raise SystemExit(f"Unknown optimization {o}")
    return name, ov


def joint_flags(**kw):
    """build_run() with this driver's own CLI defaults: the one source of the
    per-mode reference flag-sets (run_joint.sh:140-241), reused by
    chip_smoke.py's joint phases so the sets cannot drift.
    Returns (run_dir_name, opt_overrides)."""
    defaults = dict(optimization="gumbel", discriminative=0.01,
                    temperature=1.0, lr=5e-4, decay=0.8, every=15, batch=128,
                    vse=0, caption=0, reinforce_baseline="gt",
                    shared_embedding=0, prob=0.25, softmax_cooling=0,
                    annealing=0, annealing_every=0, max_epochs=350)
    defaults.update(kw)
    return build_run(argparse.Namespace(**defaults))


def seed_checkpoint_dir(ckpt_path, speaker_model_path, run_id):
    """ref: bash_scripts/copy_model.sh — seed the joint run from the stage-2
    speaker checkpoint and rename infos to the new run id."""
    from cooperativeimagecaptioning_tpu_torch.training import checkpoint as ck
    os.makedirs(ckpt_path, exist_ok=True)
    if speaker_model_path and ck.model_exists(speaker_model_path):
        # keep the stage-2 artifact NAME (copy_model.sh does `cp -r` of the
        # whole log_att dir): a fresh seeded run dir must NOT contain
        # alternatingModel.pth — that file appearing is what makes the
        # Trainer's bootstrap treat the dir as a mid-joint RESUME and lenient-
        # merge the checkpoint (including stage-2's untrained listener) over
        # the stage-1 listener loaded via initialize_retrieval
        # (ref cascade: AlternatingJointModel.py:131-177)
        dst = os.path.join(ckpt_path, os.path.basename(speaker_model_path))
        if not ck.model_exists(dst):
            opath = ck.orbax_sibling(speaker_model_path)
            if opath is None:
                shutil.copy(speaker_model_path, dst)
            else:  # an orbax-backend stage-2 run: its .orbax directory
                shutil.copytree(opath, ck.orbax_path(dst))
        src_dir = os.path.dirname(speaker_model_path)
        src_infos = os.path.join(src_dir, "infos_att.pkl")
        dst_infos = os.path.join(ckpt_path, f"infos_{run_id}.pkl")
        if os.path.isfile(src_infos) and not os.path.isfile(dst_infos):
            shutil.copy(src_infos, dst_infos)
        # copy_model.sh copies the WHOLE stage-2 dir — carry the speaker's
        # Adam state too, so joint training doesn't warm-start from zero
        src_opt = os.path.join(src_dir, "optimizer.pth")
        dst_opt = os.path.join(ckpt_path, "speaker_optimizer.pth")
        if os.path.isfile(src_opt) and not os.path.isfile(dst_opt):
            shutil.copy(src_opt, dst_opt)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-o", "--optimization", default="gumbel")
    p.add_argument("-D", "--discriminative", type=float, default=0.01)
    p.add_argument("-t", "--temperature", type=float, default=1)
    p.add_argument("-l", "--lr", type=float, default=5e-4)
    p.add_argument("-d", "--decay", type=float, default=0.8)
    p.add_argument("-e", "--every", type=int, default=15)
    p.add_argument("-b", "--batch", type=int, default=128)
    p.add_argument("-v", "--vse", type=float, default=0)
    p.add_argument("-c", "--caption", type=float, default=0)
    p.add_argument("-r", "--reinforce-baseline", default="gt")
    p.add_argument("-E", "--shared-embedding", type=int, default=0)
    p.add_argument("-p", "--prob", type=float, default=0.25)
    p.add_argument("-O", "--softmax-cooling", type=float, default=0)
    p.add_argument("-a", "--annealing", type=float, default=0)
    p.add_argument("-n", "--annealing-every", type=int, default=0)
    p.add_argument("-I", "--dataset", default="coco")
    p.add_argument("--max-epochs", type=int, default=350)
    p.add_argument("--root-dir", default="runs")
    p.add_argument("--input-json", default="data/cocotalk.json")
    p.add_argument("--input-label-h5", default="data/cocotalk_label.h5")
    p.add_argument("--input-fc-dir", default="data/cocotalk_fc")
    p.add_argument("--input-att-dir", default="data/cocobu_att")
    p.add_argument("--speaker-stage-2-model", default="")
    p.add_argument("--listener-stage-1-model", default="")
    p.add_argument("--set", action="append", default=[],
                   metavar="K=V", help="Options override, e.g. --set rnn_size=64 (repeatable)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, or cpu)")
    args = p.parse_args(argv)

    from cooperativeimagecaptioning_tpu_torch.config import (
        Options, parse_set_overrides)
    from cooperativeimagecaptioning_tpu_torch.training.loop import train

    name, ov = build_run(args)
    ckpt = os.path.join(args.root_dir, args.optimization, name)
    run_id = f"att_d{args.discriminative:g}"
    seed_checkpoint_dir(ckpt, args.speaker_stage_2_model, run_id)

    val_images = 5000 if args.dataset == "coco" else 1014
    opt = Options(
        id=run_id, checkpoint_path=ckpt, start_from=ckpt,
        input_json=args.input_json, input_label_h5=args.input_label_h5,
        input_fc_dir=args.input_fc_dir, input_att_dir=args.input_att_dir,
        dataset=args.dataset, save_checkpoint_every=3000,
        val_images_use=val_images, **JOINT_BASE,
        speaker_stage_2_model_path=args.speaker_stage_2_model,
        speaker_stage_2_optimizer_path=(os.path.join(
            os.path.dirname(args.speaker_stage_2_model), "optimizer.pth")
            if args.speaker_stage_2_model else ""),
        listener_stage_1_model_path=args.listener_stage_1_model,
        initialize_retrieval=args.listener_stage_1_model or None,
        **ov)
    opt = opt.replace(**parse_set_overrides(args.set))
    train(opt, device=args.device)
    from cooperativeimagecaptioning_tpu_torch.evaluation import harvest
    harvest.create_dicts_and_json_after_training(opt, device=args.device)


if __name__ == "__main__":
    main()
