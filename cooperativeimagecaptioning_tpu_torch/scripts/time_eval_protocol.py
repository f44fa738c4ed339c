"""Time the FULL reference checkpoint-eval protocol at protocol scale on the
card (the port's counterpart of the JAX package's
scripts/time_eval_protocol.py).

The reference evaluates every checkpoint on 5000 val images at beam=2 with
language metrics AND generated-caption rank metrics (run_joint.sh:249-251,
eval.py:33, eval_utils.py:415-542).  That cost bounds the checkpoint cadence
of a real-COCO training run.  This script builds a synthetic 5000-val-image
layout at the paper's full dimensions (att2in2 vocab 9487 / rnn 512 / K=36),
runs the Trainer's exact checkpoint-eval path twice (the first pass pays the
card's warm-up: the kernel build, cuBLAS handles and the allocator's first
blocks), and prints one JSON line with the phase timings beside the card's
name ("platform"; "cpu" on the CPU).

On the card:  python -m cooperativeimagecaptioning_tpu_torch.scripts.time_eval_protocol
CPU smoke:    python -m cooperativeimagecaptioning_tpu_torch.scripts.time_eval_protocol \\
                --device cpu --images 60 --val-images 16 --batch 8 \\
                --set rnn_size=32 ...
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from cooperativeimagecaptioning_tpu_torch.scripts.showcase_full_scale import (
    VOCAB, SEQ_LEN, build_dataset, write_df_pickle, protocol_dims)


def platform(device):
    """The card's name for a CUDA device, else the device type."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--images", type=int, default=6000,
                   help="total synthetic images (val split sized below)")
    p.add_argument("--val-images", type=int, default=5000)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--beam", type=int, default=2)
    p.add_argument("--workdir", default="eval_protocol")
    p.add_argument("--vocab", type=int, default=VOCAB)
    p.add_argument("--seq", type=int, default=SEQ_LEN)
    p.add_argument("--load-checkpoint", default="",
                   help="model/alternatingModel .pth to evaluate (quality-"
                        "canary mode: the artifact then reports a REAL "
                        "CIDEr/rsum alongside the timing).  Pass the SAME "
                        "--images as the training run — the derived teacher "
                        "function depends on the dataset size/seed, so a "
                        "checkpoint evaluated against a different corpus "
                        "reads degenerate.  Default: random init, and the "
                        "artifact says so (weights label)")
    p.add_argument("--set", action="append", default=[], metavar="K=V")
    p.add_argument("--device", default="cuda",
                   help="torch device to evaluate on (cuda, or cpu)")
    args = p.parse_args(argv)

    os.makedirs(args.workdir, exist_ok=True)
    args.workdir = os.path.abspath(args.workdir)
    os.chdir(args.workdir)

    from cooperativeimagecaptioning_tpu_torch.config import Options
    from cooperativeimagecaptioning_tpu_torch.scripts.run_joint import (
        joint_flags)
    from cooperativeimagecaptioning_tpu_torch.training.loop import Trainer

    dims, extra = protocol_dims(args.set)

    # split layout: exactly the protocol's val size, a small train split for
    # the df table / loader bookkeeping, remainder test
    n_val = args.val_images
    ds = build_dataset(args.images, args.vocab, args.seq, dims)
    # re-split: build_dataset uses the showcase default split; protocol
    # timing wants val = args.val_images EXACTLY — otherwise the timing
    # artifact's protocol.val_images field silently over-claims
    n_train = int(args.images * max(0.02, 1.0 - n_val / args.images - 0.01))
    n_train = min(n_train, args.images - n_val - 1)
    if n_train < 1:
        sys.exit(f"--images {args.images} cannot hold --val-images {n_val} "
                 f"plus train/test splits; need images >= val+2")
    for ix, img in enumerate(ds.info["images"]):
        img["split"] = ("train" if ix < n_train else
                        "val" if ix < n_train + n_val else "test")
    got_val = sum(1 for im in ds.info["images"] if im["split"] == "val")
    if got_val != n_val:
        raise RuntimeError(f"val split holds {got_val} images, not {n_val}")
    df_name = write_df_pickle(ds)

    _, jf = joint_flags(discriminative=0.01, batch=args.batch, max_epochs=-1)
    common = dict(batch_size=args.batch, language_eval=1,
                  val_images_use=n_val, save_checkpoint_every=10**9,
                  device_feature_cache=1, feature_cache_dtype="bf16", **dims)
    common.update(extra)
    ckdir = os.path.join(args.workdir, "ckpt")
    os.makedirs(ckdir, exist_ok=True)
    opt = Options(id="evalproto", phase=3, caption_model="att2in2",
                  vse_model="fc", on_device_cider=1, cached_tokens=df_name,
                  seq_per_img=1, rank_eval=1, rank_on_gen_captions=True,
                  beam_size=args.beam, checkpoint_path=ckdir,
                  **{**jf, **common})

    t0 = time.time()
    tr = Trainer(opt, dataset=ds, verbose=False, device=args.device)
    t_setup = time.time() - t0
    print(f"[evalproto] Trainer + device feature cache ready "
          f"({t_setup:.0f}s)", flush=True)

    # weights label: a timing artifact whose metrics come from random init
    # must SAY so machine-readably; checkpoint mode makes the protocol eval
    # double as an end-to-end quality canary
    if args.load_checkpoint:
        from cooperativeimagecaptioning_tpu_torch.training import (
            checkpoint as ck)
        params = ck.load_params_into(tr.params, args.load_checkpoint)
        weights = os.path.abspath(args.load_checkpoint)
        print(f"[evalproto] loaded checkpoint {weights}", flush=True)
    else:
        params = tr.params
        weights = "random/untrained (timing-only run; metrics are floor noise)"

    ev = tr.evaluator()
    eval_kwargs = {"split": "val", "dataset": opt.input_json}
    eval_kwargs.update(vars(opt))

    timings = {}
    stats = None
    for label in ("warmup", "steady"):
        t1 = time.time()
        # the predictions and metrics come back to the host: the pass has
        # ended on the device when eval_split returns
        val_loss, predictions, lang_stats = ev.eval_split(
            params, tr.loader, eval_kwargs,
            use_gen_sent=opt.rank_on_gen_captions)
        # ms precision: tiny-dim runs finish in <50ms and must not round
        # to a 0.0 that reads as "didn't run"
        timings[label] = round(time.time() - t1, 3)
        stats = {"n_predictions": len(predictions),
                 "CIDEr": (lang_stats or {}).get("CIDEr"),
                 "rsum": (val_loss.get("rsum")
                          if isinstance(val_loss, dict) else None)}
        timings["phases_" + label] = getattr(ev, "last_timings", None)
        print(f"[evalproto] {label} pass: {timings[label]}s "
              f"({len(predictions)} captions; phases "
              f"{timings['phases_' + label]})", flush=True)
    tr.close()

    out = {"protocol": {"val_images": n_val, "beam": args.beam,
                        "batch": args.batch, "vocab": args.vocab,
                        "language_eval": 1, "rank_on_gen_captions": True},
           "weights": weights,
           "platform": platform(tr.device),
           "setup_s": round(t_setup, 1),
           "eval_first_pass_s": timings["warmup"],
           "eval_steady_s": timings["steady"],
           "phases_steady": timings.get("phases_steady"), **stats}
    path = os.path.join(args.workdir, "eval_protocol_timing.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
