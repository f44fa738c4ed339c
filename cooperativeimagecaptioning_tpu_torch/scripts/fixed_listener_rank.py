"""Rank GENERATED captions across the saved joint checkpoints under a
condition grid {frozen|current listener} x {greedy|sampled|gt captions}
(the port's counterpart of the JAX package's scripts/fixed_listener_rank.py).

The in-training rank-on-generated-captions metric conflates two moving
agents (the speaker's captions change AND the listener ranking them is
itself co-trained — ref protocol: eval_utils.py:415-542 ranks with the
joint model's own vse) and it decodes with ARGMAX, which on the derived
synthetic geometry is decoupled from the sampling policy the joint RL
objective optimizes (argmax is not a mode of the optimal multimodal
policy).  This grid disentangles both:

  frozen-*   rank with the stage-1-best listener (the artifact the joint
             run was seeded from, run_joint.sh:310-311) for EVERY
             checkpoint — speaker-side changes only
  current-*  rank with the checkpoint's own listener — the pragmatic pair
  *-greedy   argmax captions (the reference protocol)
  *-sample   multinomial captions (sample_max=0, T=1) — the distribution
             the objective actually moves; the evaluator draws from its
             fixed-seed streams (ops/draws.py), so conditions are
             common-random-number comparable within the port (not with the
             JAX package's draws)
  *-gt       the GROUND-TRUTH captions ranked by that listener (the
             listener-drift control)

Evaluates every alternatingModel-<it>.pth (or, of an orbax-backend run,
alternatingModel-<it>.orbax) in --joint-dir plus the seeded
baseline (stage-2 speaker + stage-1 listener, zero joint iterations) and
writes fixed_listener_rank_<joint-dir>.json:
  {"points": [{"iteration", "condition", "rsum", ...}, ...]}

On the card unless --device cpu (after scripts/showcase_full_scale.py):

    python -m cooperativeimagecaptioning_tpu_torch.scripts.fixed_listener_rank \\
        --workdir showcase_full --joint-dir joint_g03
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import time

from cooperativeimagecaptioning_tpu_torch.scripts.showcase_full_scale import (
    VOCAB, SEQ_LEN, build_dataset, write_df_pickle, protocol_dims, _rsum,
    _val_loss)


def main(argv=None, dataset=None):
    """dataset: optional prebuilt SyntheticDataset (scripts/mode_grid passes
    its own so the derived corpus isn't regenerated per mode)."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workdir", default="showcase_full")
    p.add_argument("--joint-dir", default="joint_g03")
    p.add_argument("--discriminative", type=float, default=0.3,
                   help="D weight the joint dir was trained with (flag-set "
                        "reconstruction only; no training happens here)")
    p.add_argument("--optimization", default="gumbel",
                   help="optimization mode the joint dir was trained with "
                        "(gumbel|reinforce|multinomial|multinomial_soft; "
                        "flag-set reconstruction only)")
    p.add_argument("--listener", default=None,
                   help="frozen listener artifact (default: the stage-1 "
                        "model_vse-best.pth the joint run was seeded from)")
    p.add_argument("--images", type=int, default=20000)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--val-images-use", type=int, default=1000)
    p.add_argument("--vocab", type=int, default=VOCAB)
    p.add_argument("--seq", type=int, default=SEQ_LEN)
    p.add_argument("--set", action="append", default=[], metavar="K=V")
    p.add_argument("--conditions",
                   default="frozen-greedy,frozen-sample,"
                           "current-greedy,current-sample",
                   help="comma list of <listener>-<generation> conditions; "
                        "listener: frozen|current, generation: greedy|sample"
                        "|gt (gt ranks the GROUND-TRUTH captions — the "
                        "listener-drift control)")
    p.add_argument("--device", default="cuda",
                   help="torch device to evaluate on (cuda, or cpu)")
    args = p.parse_args(argv)

    args.workdir = os.path.abspath(args.workdir)
    os.chdir(args.workdir)

    from cooperativeimagecaptioning_tpu_torch.config import Options
    from cooperativeimagecaptioning_tpu_torch.scripts.run_joint import (
        joint_flags)
    from cooperativeimagecaptioning_tpu_torch.training import checkpoint as ck
    from cooperativeimagecaptioning_tpu_torch.training.loop import Trainer

    dims, extra = protocol_dims(args.set)
    ds = dataset if dataset is not None else \
        build_dataset(args.images, args.vocab, args.seq, dims)
    df_name = write_df_pickle(ds)

    jdir = os.path.join(args.workdir, args.joint_dir)
    s1 = args.listener or os.path.join(args.workdir, "log_fc_con",
                                       "model_vse-best.pth")
    s2_model = os.path.join(args.workdir, "log_att", "model-best.pth")
    run_id = None
    for f in os.listdir(jdir):
        m = re.match(r"infos_(.+?)\.pkl$", f)
        if m and "-" not in m.group(1):
            run_id = m.group(1)
    if not run_id:
        raise FileNotFoundError(f"no infos_<id>.pkl in {jdir}")

    _, jf = joint_flags(optimization=args.optimization,
                        discriminative=args.discriminative, batch=args.batch,
                        max_epochs=-1)
    mine = dict(
        id=run_id, phase=3, caption_model="att2in2", vse_model="fc",
        on_device_cider=1, cached_tokens=df_name, seq_per_img=1,
        rank_eval=1, rank_on_gen_captions=True, language_eval=1,
        checkpoint_path=jdir, start_from=jdir,
        batch_size=args.batch, val_images_use=args.val_images_use,
        device_feature_cache=1, feature_cache_dtype="bf16",
        max_epochs=-1, save_checkpoint_every=10**9, **dims)
    mine.update(extra)
    opt = Options(**{**jf, **mine})

    tr = Trainer(opt, dataset=ds, verbose=False, device=args.device)
    ev = tr.evaluator()
    template = tr.params
    frozen = ck.load_params(s1, device=tr.device)
    if "listener" not in frozen:
        raise KeyError(f"{s1} holds no listener tree")
    frozen_listener = frozen["listener"]

    eval_kwargs = {"split": "val", "dataset": opt.input_json}
    eval_kwargs.update(vars(opt))
    conditions = [c.strip() for c in args.conditions.split(",") if c.strip()]

    # each iteration's model: a .pth, or the .orbax directory of an
    # orbax-backend run, read through its .pth name (checkpoint.read_tree)
    found = {}
    for f in glob.glob(os.path.join(jdir, "alternatingModel-*")):
        m = re.search(r"alternatingModel-(\d+)\.(pth|orbax)$", f)
        if m:
            found[int(m.group(1))] = f[:-len(m.group(2))] + "pth"
    ckpts = sorted(found.items())
    if not ckpts:
        raise FileNotFoundError(f"no alternatingModel-<it>.pth or .orbax "
                                f"in {jdir}")
    # the seeded baseline: stage-2 speaker + the same frozen listener, i.e.
    # zero joint iterations — the reference point the claim is against
    todo = [("seed", s2_model)] + ckpts

    points = []
    gt_cache = {}  # (iteration, effective-listener) -> gt_ranks dict: every
    # gen-sent eval_split already computes a full GT rank pass (stored as
    # val_loss['gt_ranks']), so a 'gt' condition after a gen condition with
    # the same listener is free
    for it, path in todo:
        base = ck.load_params_into(template, path)
        for cond in conditions:
            lst, gen = cond.split("-")
            eff_lst = "frozen" if (lst == "frozen" or it == "seed") \
                else "current"
            t0 = time.time()
            params = dict(base)
            if eff_lst == "frozen":
                params["listener"] = frozen_listener
            ek = dict(eval_kwargs)
            if gen == "sample":
                # sample_max=0 moves the language-metric decode to sampling;
                # gen_sample_max=0 moves the rank eval's gen-sent decode too
                # (the reference pins that one to greedy — eval_utils.py:347)
                ek.update(sample_max=0, beam_size=1, temperature=1.0,
                          gen_sample_max=0)
            if gen == "gt":
                # control: rank GROUND-TRUTH captions with this listener —
                # separates "the listener got generically better" from "the
                # pair learned a caption-specific code"
                val_loss = gt_cache.get((it, eff_lst))
                if val_loss is None:
                    val_loss = ev.evalrank(params, tr.loader, ek,
                                           use_gen_sent=False)
                    gt_cache[(it, eff_lst)] = val_loss
                ls = {}
            else:
                val_loss, predictions, lang_stats = ev.eval_split(
                    params, tr.loader, ek, use_gen_sent=True)
                ls = lang_stats or {}
                if isinstance(val_loss, dict) and \
                        isinstance(val_loss.get("gt_ranks"), dict):
                    gt_cache[(it, eff_lst)] = val_loss["gt_ranks"]
            pt = {"iteration": it, "condition": cond,
                  "rsum": _rsum(val_loss), "val_loss": _val_loss(val_loss),
                  "CIDEr": ls.get("CIDEr"), "Bleu_4": ls.get("Bleu_4"),
                  "wall_s": round(time.time() - t0, 1)}
            if isinstance(val_loss, dict):
                flat = dict(val_loss)
                flat.update(val_loss.get("val", {})
                            if isinstance(val_loss.get("val"), dict) else {})
                for k, v in flat.items():
                    if any(t in k for t in ("_r1", "_r5", "_r10", "medr",
                                            "meanr", "_ar")):
                        try:
                            pt[k] = round(float(v), 3)
                        except (TypeError, ValueError):
                            pass
            points.append(pt)
            print("[fixedrank] " + " ".join(
                f"{k}={v}" for k, v in pt.items() if v is not None),
                flush=True)
    tr.close()

    out = {"joint_dir": args.joint_dir, "listener": s1,
           "baseline": "seed = stage-2 speaker + frozen stage-1 listener, "
                       "0 joint iterations",
           "conditions": conditions, "points": points}
    path = os.path.join(args.workdir,
                        f"fixed_listener_rank_{args.joint_dir}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"fixed-listener rank -> {path}", flush=True)
    return out


if __name__ == "__main__":
    main()
