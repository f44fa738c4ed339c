"""Full-dims optimization-mode comparison grid of the port — the reference's
central ablation (ref: bash_scripts/run_joint.sh:140-241; README.md:92-96
known-good hyperparams) at showcase scale on the card (the counterpart of
the JAX package's scripts/mode_grid.py).

Every joint mode is seeded from the SAME stage-1 listener + stage-2 speaker
(showcase_full_scale.run_pretrain_stages — reference protocol, copy_model.sh
seeding), trained for the same number of joint iterations, and then
evaluated across its saved checkpoints with the fixed_listener_rank
condition grid, so the artifact carries per-mode trajectories of:
  - sampled-caption CIDEr (fluency of the distribution the objective moves)
  - pair rsum on sampled captions (current listener x sampled speaker — the
    paper's joint-discriminability axis)
  - greedy in-training rank rsum (the reference's own protocol metric)
  - GT rsum with the current listener (listener-drift control)

Modes and their reference-published hyperparams:
  gumbel            D=0.3 (run_joint.sh gumbel flag-set, lr 5e-4 decay 0.8)
  gumbel_softmax    D=0.3, prob 0.25 (run_joint.sh gumbel_softmax flag-set)
  reinforce         D=0.8, gt baseline, vse 0.1, lr 5e-3, decay 0.8
                    (README.md:96 known-good)
  multinomial       D=0.3, temperature 1 (run_joint.sh multinomial flag-set)
  multinomial_soft  D=0.3, prob 0.25 (run_joint.sh multinomial_soft flag-set)

Writes <workdir>/mode_grid.json:
  {"dims": ..., "pretrain": {...}, "modes": {mode: {"train": stage-result,
   "flags": ..., "rank_points": [...]}}}

Resume-safe: every stage Trainer resumes from its checkpoint dir; re-running
the script skips completed work, and a run with another --modes adds its
modes to the grid, reusing the pretrain stages and the seeded baseline.
On the card unless --device cpu:

    python -m cooperativeimagecaptioning_tpu_torch.scripts.mode_grid \\
        --workdir mode_grid
"""

from __future__ import annotations

import argparse
import json
import os
import time

from cooperativeimagecaptioning_tpu_torch.scripts.showcase_full_scale import (
    VOCAB, SEQ_LEN, build_dataset, write_df_pickle, protocol_dims,
    protocol_common, run_pretrain_stages, run_stage, joint_baseline_eval,
    joint_opt)


# mode -> joint_flags kwargs (one source: scripts/run_joint.build_run maps
# these to the reference flag-sets)
MODES = {
    "gumbel": dict(optimization="gumbel", discriminative=0.3),
    "gumbel_softmax": dict(optimization="gumbel_softmax",
                           discriminative=0.3),
    "reinforce": dict(optimization="reinforce", discriminative=0.8,
                      lr=5e-3, decay=0.8, vse=0.1, reinforce_baseline="gt"),
    "multinomial": dict(optimization="multinomial", discriminative=0.3),
    "multinomial_soft": dict(optimization="multinomial_soft",
                             discriminative=0.3),
}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--images", type=int, default=20000)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--val-images-use", type=int, default=1000)
    p.add_argument("--listener-iters", type=int, default=2000)
    p.add_argument("--mle-iters", type=int, default=20000)
    p.add_argument("--joint-iters", type=int, default=6000)
    p.add_argument("--eval-every", type=int, default=500)
    p.add_argument("--modes", default=",".join(MODES),
                   help="comma list out of " + "|".join(MODES))
    p.add_argument("--conditions",
                   default="current-sample,current-greedy,current-gt,"
                           "frozen-sample")
    p.add_argument("--workdir", default="mode_grid")
    p.add_argument("--vocab", type=int, default=VOCAB)
    p.add_argument("--seq", type=int, default=SEQ_LEN)
    p.add_argument("--set", action="append", default=[], metavar="K=V")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, or cpu)")
    args = p.parse_args(argv)

    os.makedirs(args.workdir, exist_ok=True)
    args.workdir = os.path.abspath(args.workdir)
    os.chdir(args.workdir)

    from cooperativeimagecaptioning_tpu_torch.scripts import (
        fixed_listener_rank)
    from cooperativeimagecaptioning_tpu_torch.scripts.run_joint import (
        joint_flags, seed_checkpoint_dir)

    modes = [m.strip() for m in args.modes.split(",") if m.strip()]
    unknown = [m for m in modes if m not in MODES]
    if unknown:
        raise SystemExit(f"unknown modes {unknown}")

    dims, extra = protocol_dims(args.set)
    ds = build_dataset(args.images, args.vocab, args.seq, dims)
    df_name = write_df_pickle(ds)
    common = protocol_common(args, ds, dims, extra)
    results = {"dims": dict(vocab=args.vocab, seq=args.seq, batch=args.batch,
                            images=args.images, **dims),
               "pretrain": {}, "modes": {}}
    out_path = os.path.join(args.workdir, "mode_grid.json")
    if os.path.isfile(out_path):
        # re-runs extend the existing grid (e.g. adding a mode later) rather
        # than clobbering completed modes
        with open(out_path) as f:
            prior = json.load(f)
        for k in ("pretrain", "modes", "baseline"):
            if k in prior:
                results[k] = prior[k]

    def flush():
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1)

    t0 = time.time()
    s1_model, s2_model, s2 = run_pretrain_stages(
        args, common, ds, results["pretrain"], args.device)
    flush()

    joint_target = args.mle_iters + args.joint_iters
    baseline = results.get("baseline")  # reuse from a prior run
    for mode in modes:
        mk = MODES[mode]
        d = mk["discriminative"]
        jdir = os.path.join(args.workdir, f"joint_{mode}")
        os.makedirs(jdir, exist_ok=True)
        run_id = f"att_d{d:g}"
        seed_checkpoint_dir(jdir, s2_model, run_id)
        name, jf = joint_flags(batch=args.batch, max_epochs=-1, **mk)
        opt = joint_opt(jdir, run_id, s1_model, s2_model, s2, df_name, jf,
                        common)
        if baseline is None:
            # one shared seeded reference point (same for every mode: same
            # stage-1 listener + stage-2 speaker, zero joint iterations)
            baseline = joint_baseline_eval(opt, ds, args.workdir,
                                           args.device)
            results["baseline"] = baseline
            flush()
        print(f"[grid] mode={mode} run_dir_name={name} "
              f"({time.time() - t0:.0f}s elapsed)", flush=True)
        results["modes"].setdefault(mode, {})
        results["modes"][mode]["flags"] = {
            k: v for k, v in jf.items() if not isinstance(v, (list, dict))}
        results["modes"][mode]["train"] = run_stage(
            f"joint_{mode}", opt, ds, joint_target, device=args.device)
        flush()

        fr = fixed_listener_rank.main([
            "--workdir", args.workdir, "--joint-dir", f"joint_{mode}",
            "--optimization", mk["optimization"],
            "--discriminative", str(d),
            "--images", str(args.images), "--batch", str(args.batch),
            "--vocab", str(args.vocab), "--seq", str(args.seq),
            "--val-images-use", str(args.val_images_use),
            "--conditions", args.conditions, "--device", args.device,
        ] + [x for s in args.set for x in ("--set", s)], dataset=ds)
        results["modes"][mode]["rank_points"] = fr["points"]
        flush()

    print(f"mode grid -> {out_path} ({time.time() - t0:.0f}s)", flush=True)
    return results


if __name__ == "__main__":
    main()
