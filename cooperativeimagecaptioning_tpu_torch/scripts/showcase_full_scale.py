"""Full-dimension convergence showcase of the port (counterpart of the JAX
package's scripts/showcase_full_scale.py): the reference's 3-stage
cooperative protocol at FULL model scale on the card.

Dimensions match the reference paper protocol exactly (att2in2: vocab 9487,
rnn/input-enc/att-hid 512, feats 2048, K<=36, seq 16, batch 128 —
bash_scripts/run_att.sh + run_joint.sh:43,54,249-251); the data is a derived
synthetic dataset (captions are a fixed random teacher function of each
image's attention features, data/sources.py SyntheticDataset(derived=True))
so there is a real mapping to LEARN, not just memorize, and intra-image
n-gram overlap keeps CIDEr meaningful at the 9487-word vocabulary.

The default 20k images keeps the train split (12k) well above the 2048-dim
feature space: below that, a linear VSE image encoder can interpolate an
arbitrary image->embedding hash and retrieval memorizes instead of
generalizing.  COCO itself avoids this with 110k train images.

Stages (flag-sets imported from the port's scripts/run_fc_con.py /
run_att.py / run_joint.py — one source, no drift):
  1. phase-1 listener (VSE) pretrain on GT captions
  2. phase-2 speaker MLE to convergence (val XE tracked per checkpoint eval)
  3. phase-3 joint gumbel-ST + on-device CIDEr (cached-df DfTable built from
     the train split), seeded from stages 1+2 incl. both Adam states,
     >= --joint-iters iterations with full checkpoint evals, then harvesting.

Writes showcase_full_scale.json {stage: {it_per_s, trajectory}} in --workdir.
Trains on the card unless --device cpu:

    python -m cooperativeimagecaptioning_tpu_torch.scripts.showcase_full_scale
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import shutil
import time
from collections import Counter

import numpy as np


# model DIMS only — the caption/vse model families come from each stage's
# shared driver flag-set (scripts/run_{fc_con,att,joint}.py)
FULL_DIMS = dict(
    rnn_size=512, input_encoding_size=512, att_hid_size=512,
    fc_feat_size=2048, att_feat_size=2048, vse_embed_size=1024,
    drop_prob_lm=0.5, max_att_len=36)
VOCAB, SEQ_LEN = 9487, 16


def protocol_dims(set_args):
    """One source for the --set override split used by all three protocol
    scripts (this one, time_eval_protocol, fixed_listener_rank): returns
    (dims, extra) where dims = FULL_DIMS updated by the overrides that ARE
    model dims, extra = the remaining overrides to merge into the Options
    kwargs LAST (so --set wins over script defaults)."""
    from cooperativeimagecaptioning_tpu_torch.config import parse_set_overrides
    overrides = parse_set_overrides(set_args)
    dims = dict(FULL_DIMS)
    dims.update({k: v for k, v in overrides.items() if k in dims})
    return dims, {k: v for k, v in overrides.items() if k not in dims}


def build_dataset(num_images, vocab=VOCAB, seq=SEQ_LEN, dims=None):
    from cooperativeimagecaptioning_tpu_torch.data.sources import (
        SyntheticDataset)
    dims = dims or FULL_DIMS
    t0 = time.time()
    ds = SyntheticDataset(
        num_images=num_images, vocab_size=vocab, seq_length=seq,
        fc_feat_size=dims["fc_feat_size"], att_feat_size=dims["att_feat_size"],
        max_K=dims["max_att_len"], caps_per_image=5, derived=True, seed=7)
    print(f"derived dataset: {num_images} images x 5 caps, vocab {vocab} "
          f"({time.time() - t0:.0f}s)", flush=True)
    return ds


def write_df_pickle(ds, name="synthtalk"):
    """Train-split document frequencies in the reference pickle format
    (ciderD_scorer.py:70-74: df over per-image reference sets, ref_len =
    #sets; tokens as decimal-id strings like misc/rewards.py array_to_str)."""
    df = Counter()
    n_docs = 0
    for img in ds.info["images"]:
        if img["split"] != "train":
            continue
        n_docs += 1
        grams = set()
        for row in ds.get_refs(img["id"]):
            toks = [str(int(t)) for t in row if t > 0]
            for n in range(1, 5):
                for i in range(len(toks) - n + 1):
                    grams.add(tuple(toks[i:i + n]))
        df.update(grams)
    os.makedirs("data", exist_ok=True)
    with open(f"data/{name}.p", "wb") as f:
        pickle.dump({"ref_len": n_docs, "document_frequency": dict(df)}, f)
    print(f"df pickle: {len(df)} ngrams over {n_docs} train images",
          flush=True)
    return name


def _traj_point(tr, turn, loss, it_s=None):
    """One trajectory point from the just-recorded val_result_history entry
    (checkpoint_operations stores {loss, lang_stats} keyed by iteration)."""
    lang = tr.val_result_history.get(tr.iteration, {})
    ls = lang.get("lang_stats") or {}
    return {
        "iteration": tr.iteration, "turn": turn,
        "it_per_s": round(it_s, 2) if it_s else None,
        # a resumed at-target stage records its final eval point without
        # having run a step: loss is then NaN-initialized, not divergence —
        # keep the artifact strict-JSON (null, never NaN)
        "loss": round(float(loss), 4) if np.isfinite(float(loss)) else None,
        "val_loss": _val_loss(lang.get("loss")),
        "CIDEr": ls.get("CIDEr"), "Bleu_4": ls.get("Bleu_4"),
        "rsum": _rsum(lang.get("loss")),
    }


def run_stage(tag, opt, ds, iters, deviations=None, device="cuda"):
    """`iters` is the ABSOLUTE target iteration (the joint stages inherit
    stage-2's counter via the copy_model seeding, reference semantics, so
    their target is mle_iters + joint_iters computed by the caller — a
    resumed mid-joint run must NOT re-add joint_iters on top of the resumed
    counter).

    deviations: dict of {flag: (value_used, reference_value)} protocol
    deltas, stamped verbatim into the stage's result object so artifacts
    claiming 'reference flag-set' carry their deltas machine-readably."""
    from cooperativeimagecaptioning_tpu_torch.training.loop import Trainer
    print(f"[{tag}] constructing Trainer (resume="
          f"{bool(opt.start_from)})", flush=True)
    tr = Trainer(opt, dataset=ds, verbose=False, device=device)
    print(f"[{tag}] starting at iter {tr.iteration}, target {iters}",
          flush=True)
    t_start = time.time()
    t_lap, lap_iter0 = t_start, tr.iteration
    warm_at = None
    last_ckpt = None
    turn = None
    loss_dict = {"loss": float("nan")}
    traj = []
    while tr.iteration < iters:
        loss_dict, turn, _ = tr.train_iteration()
        if warm_at is None or tr.iteration % 100 == 0:
            # host sync: bounds the queue of launches ahead of the device
            float(loss_dict["loss"])
        if warm_at is None:
            warm_at = time.time()  # first step done = warm-up paid
            t_lap, lap_iter0 = warm_at, tr.iteration
            print(f"[{tag}] first step done ({warm_at - t_start:.0f}s "
                  f"warm-up: kernel build, cuBLAS handles, allocator)",
                  flush=True)
        if tr.iteration % opt.save_checkpoint_every == 0:
            tr.checkpoint_operations()
            last_ckpt = tr.iteration
            now = time.time()
            it_s = (tr.iteration - lap_iter0) / max(1e-9, now - t_lap)
            t_lap, lap_iter0 = time.time(), tr.iteration
            point = _traj_point(tr, turn, loss_dict["loss"], it_s)
            traj.append(point)
            print(f"[{tag}] " + " ".join(
                f"{k}={v}" for k, v in point.items() if v is not None),
                flush=True)
    # ALWAYS close the stage with a recorded eval point, so that a stage
    # whose iteration count misses the save_checkpoint_every cadence still
    # carries its final point in the artifact
    if last_ckpt != tr.iteration:  # don't repeat a just-run full eval
        tr.checkpoint_operations()
        it_s = (tr.iteration - lap_iter0) / max(1e-9, time.time() - t_lap)
        point = _traj_point(tr, turn, loss_dict["loss"],
                            it_s if tr.iteration > lap_iter0 else None)
        traj.append(point)
        print(f"[{tag}] final " + " ".join(
            f"{k}={v}" for k, v in point.items() if v is not None),
            flush=True)
    tr.close()
    total = time.time() - t_start
    steady = max((p["it_per_s"] for p in traj if p.get("it_per_s")),
                 default=None)
    print(f"[{tag}] done: {iters} iters in {total:.0f}s "
          f"(steady {steady} it/s)", flush=True)
    out = {"iters": iters, "total_s": round(total, 1),
           "steady_it_per_s": steady, "trajectory": traj}
    if deviations is not None:  # {} = explicit "reference flag-set, no deltas"
        out["deviations"] = deviations
    return out


def _val_loss(v):
    if isinstance(v, dict):
        v = v.get("loss_cap", v.get("loss"))
    try:
        return round(float(v), 4)
    except (TypeError, ValueError):
        return None


def _rsum(v):
    if isinstance(v, dict):
        r = v.get("rsum")
        if r is None and isinstance(v.get("val"), dict):
            r = v["val"].get("rsum")
        try:
            return round(float(r), 1)
        except (TypeError, ValueError):
            return None
    return None


def joint_opt(s3, run_id, s1_model, s2_model, s2, df_name, jf, common):
    """Options of a joint stage: the joint flag-set `jf` seeded from stages
    1+2 (ref run_joint.sh + copy_model.sh), with on-device CIDEr over the
    cached df `df_name`."""
    from cooperativeimagecaptioning_tpu_torch.config import Options
    from cooperativeimagecaptioning_tpu_torch.scripts.run_joint import (
        JOINT_BASE)
    return Options(
        start_from=s3, id=run_id, phase=3, on_device_cider=1,
        cached_tokens=df_name, checkpoint_path=s3,
        speaker_stage_2_model_path=s2_model,
        speaker_stage_2_optimizer_path=os.path.join(s2, "optimizer.pth"),
        initialize_retrieval=s1_model,
        **{**JOINT_BASE, **jf, **common})


def joint_baseline_eval(opt3, ds, workdir, device="cuda"):
    """One full checkpoint eval of the SEEDED joint state — speaker =
    stage-2-best, listener = stage-1-best, zero joint iterations — so the
    cooperative claim (rank-on-generated-captions rsum rises during joint
    training) has its reference point recorded in the artifact, not only
    points from iteration >= first checkpoint.  Rebuilds the seed in a
    scratch dir, so it is exact even when the real joint stages resume
    mid-run (ref protocol: run_joint.sh:310-311 seeds, eval_utils.py:415-542
    ranks)."""
    from cooperativeimagecaptioning_tpu_torch.scripts.run_joint import (
        seed_checkpoint_dir)
    from cooperativeimagecaptioning_tpu_torch.training.loop import Trainer
    tmp = os.path.join(workdir, "joint_seed_baseline")
    shutil.rmtree(tmp, ignore_errors=True)
    seed_checkpoint_dir(tmp, opt3.speaker_stage_2_model_path, opt3.id)
    opt = opt3.replace(checkpoint_path=tmp, start_from=tmp)
    print("[baseline] evaluating the seeded joint state (0 joint iters)",
          flush=True)
    tr = Trainer(opt, dataset=ds, verbose=False, device=device)
    tr.checkpoint_operations()
    lang = tr.val_result_history.get(tr.iteration, {})
    ls = lang.get("lang_stats") or {}
    point = {"iteration": tr.iteration,
             "val_loss": _val_loss(lang.get("loss")),
             "CIDEr": ls.get("CIDEr"), "Bleu_4": ls.get("Bleu_4"),
             "rsum": _rsum(lang.get("loss"))}
    tr.close()
    print("[baseline] " + " ".join(
        f"{k}={v}" for k, v in point.items() if v is not None), flush=True)
    return point


def run_pretrain_stages(args, common, ds, results, device="cuda"):
    """Stages 1+2 of the reference protocol (shared with scripts/mode_grid.py:
    every joint mode is seeded from the SAME pretrained pair).  Returns
    (s1_model, s2_model, s2_dir).

    Stage 1 runs the REFERENCE flag-set — vse_max_violation=1
    (VSEFCModel.py:149-207 default) — with the flag-gated mean-hinge warm-up
    extension (vse_hinge_warmup_iters): on the derived synthetic geometry the
    hardest-negative hinge does not escape random init, the known VSE++
    warm-start caveat; warming up with the mean hinge then switching keeps
    the reference flag untouched.  deviations is stamped EMPTY — the warm-up
    is an additive extension flag, recorded under `notes`."""
    from cooperativeimagecaptioning_tpu_torch.config import Options
    from cooperativeimagecaptioning_tpu_torch.scripts.run_att import (
        STAGE_FLAGS as S2_FLAGS)
    from cooperativeimagecaptioning_tpu_torch.scripts.run_fc_con import (
        STAGE_FLAGS as S1_FLAGS)

    # stage 1 — listener pretrain: the run_fc_con.py flag-set verbatim
    # (FC caption model => use_att=False, so the feature cache stays fc-only;
    # seq_per_img keeps the reference default 1 — every batch holds 128
    # UNIQUE images; seq_per_img>1 additionally saturates the max-violation
    # hinge, the hardest negative being a duplicate of the positive image).
    warmup = min(500, max(1, args.listener_iters // 4))
    s1 = os.path.join(args.workdir, "log_fc_con")
    os.makedirs(s1, exist_ok=True)
    opt1 = Options(checkpoint_path=s1,
                   start_from=s1 if os.listdir(s1) else None,
                   **{**S1_FLAGS, **common, "language_eval": 0,
                      "vse_hinge_warmup_iters": warmup})
    results["stage1_listener"] = run_stage(
        "stage1", opt1, ds, args.listener_iters, deviations={},
        device=device)
    results["stage1_listener"]["notes"] = {
        "vse_hinge_warmup_iters": warmup,
        "why": "mean-hinge warm-up before the reference max-violation hinge "
               "engages (VSE++ warm-start recipe; extension flag, reference "
               "flag-set otherwise verbatim incl. vse_max_violation=1)"}

    # stage 2 — speaker MLE: the run_att.py flag-set verbatim
    s2 = os.path.join(args.workdir, "log_att")
    os.makedirs(s2, exist_ok=True)
    opt2 = Options(checkpoint_path=s2,
                   start_from=s2 if os.listdir(s2) else None,
                   **{**S2_FLAGS, **common})
    results["stage2_mle"] = run_stage("stage2", opt2, ds, args.mle_iters,
                                      device=device)

    s2_model = os.path.join(s2, "model-best.pth")
    # the reference's drivers hand the joint run the RETRIEVAL-best stage-1
    # artifact (run_joint.sh:310-311)
    s1_model = os.path.join(s1, "model_vse-best.pth")
    if not os.path.isfile(s1_model):
        s1_model = os.path.join(s1, "model-best.pth")
    return s1_model, s2_model, s2


def protocol_common(args, ds, dims, extra):
    """The Options every stage shares: batch, cadence, val size, the bf16
    device feature cache and the model dims, then the --set extras."""
    n_val = sum(1 for im in ds.info["images"] if im["split"] == "val")
    common = dict(batch_size=args.batch, language_eval=1,
                  save_checkpoint_every=args.eval_every,
                  val_images_use=min(n_val, args.val_images_use),
                  losses_log_every=100, max_epochs=-1,
                  device_feature_cache=1, feature_cache_dtype="bf16", **dims)
    common.update(extra)
    return common


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--images", type=int, default=20000)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--val-images-use", type=int, default=1000)
    p.add_argument("--listener-iters", type=int, default=1000)
    p.add_argument("--mle-iters", type=int, default=6000)
    p.add_argument("--joint-iters", type=int, default=3000)
    p.add_argument("--joint-iters-d03", type=int, default=None,
                   help="iterations for the D=0.3 variant stage (default: "
                        "--joint-iters); the discriminative-axis recovery "
                        "crosses its seeded baseline later than 3000 iters")
    p.add_argument("--eval-every", type=int, default=500)
    p.add_argument("--disc-variant", type=int, default=1,
                   help="also run the D=0.3 cooperative-dynamic joint stage")
    p.add_argument("--workdir", default="showcase_full")
    p.add_argument("--vocab", type=int, default=VOCAB)
    p.add_argument("--seq", type=int, default=SEQ_LEN)
    p.add_argument("--set", action="append", default=[], metavar="K=V",
                   help="Options override forwarded to every stage (e.g. "
                        "--set rnn_size=32 for a reduced-dim smoke run)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, or cpu)")
    args = p.parse_args(argv)

    os.makedirs(args.workdir, exist_ok=True)
    args.workdir = os.path.abspath(args.workdir)
    os.chdir(args.workdir)

    from cooperativeimagecaptioning_tpu_torch.evaluation import harvest
    from cooperativeimagecaptioning_tpu_torch.scripts.run_joint import (
        joint_flags, seed_checkpoint_dir)

    dims, extra = protocol_dims(args.set)
    ds = build_dataset(args.images, args.vocab, args.seq, dims)
    df_name = write_df_pickle(ds)
    common = protocol_common(args, ds, dims, extra)
    results = {"dims": dict(vocab=args.vocab, seq=args.seq, batch=args.batch,
                            images=args.images, **dims)}

    s1_model, s2_model, s2 = run_pretrain_stages(args, common, ds, results,
                                                 args.device)

    # stage 3 — joint cooperative: the run_joint.py gumbel flag-set
    # (discriminative 0.01 / cider 0.99 via joint_flags), seeded from stages
    # 1+2 with both Adam states (ref run_joint.sh + copy_model.sh): the
    # fresh run bootstraps speaker=stage-2, listener=initialize_retrieval
    s3 = os.path.join(args.workdir, "joint_g")
    os.makedirs(s3, exist_ok=True)
    seed_checkpoint_dir(s3, s2_model, "att_d0.01")
    _, jf = joint_flags(discriminative=0.01, batch=args.batch, max_epochs=-1)
    opt3 = joint_opt(s3, "att_d0.01", s1_model, s2_model, s2, df_name, jf,
                     common)
    # the joint stages inherit stage-2's iteration counter via the seeding,
    # so their ABSOLUTE target is mle+joint (resume-safe: a run that died
    # mid-joint must not re-add joint_iters on top of the resumed counter)
    joint_target = args.mle_iters + args.joint_iters
    results["joint_baseline"] = joint_baseline_eval(opt3, ds, args.workdir,
                                                    args.device)
    results["stage3_joint"] = run_stage("stage3", opt3, ds, joint_target,
                                        device=args.device)

    # stage 3b — cooperative-dynamic variant at a discriminative-heavy
    # weighting (gumbel D=0.3 / cider 0.7).  On the derived synthetic
    # geometry SCST's objective (expected SAMPLED CIDEr - greedy) rises
    # while greedy-decode CIDEr does not track it (per-position-independent
    # refs make the optimal sampling policy multimodal), so the paper's
    # headline cooperative signal here is the LISTENER axis: retrieval of
    # generated captions (rank_on_gen_captions).
    if args.disc_variant:
        s3b = os.path.join(args.workdir, "joint_g03")
        os.makedirs(s3b, exist_ok=True)
        seed_checkpoint_dir(s3b, s2_model, "att_d0.3")
        _, jf2 = joint_flags(discriminative=0.3, batch=args.batch,
                             max_epochs=-1)
        opt3b = opt3.replace(checkpoint_path=s3b, start_from=s3b,
                             id="att_d0.3", **jf2)
        d03_iters = args.joint_iters_d03 \
            if args.joint_iters_d03 is not None else args.joint_iters
        results["stage3_joint_d03"] = run_stage(
            "stage3b", opt3b, ds, args.mle_iters + d03_iters,
            device=args.device)

    harvest.create_dicts_and_json_after_training(opt3, dataset=ds,
                                                 device=args.device)
    results["harvest"] = sorted(os.listdir(s3))[:40]

    out = os.path.join(args.workdir, "showcase_full_scale.json")
    with open(out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"showcase results -> {out}", flush=True)
    return results


if __name__ == "__main__":
    main()
