#!/usr/bin/env python3
"""Times of the f32 vocabulary heads (kernels B and C) at the f32 paths'
shapes on one Hopper GPU, for comparing two checkouts on one card.

    python3 head_bench.py                     # this checkout
    python3 head_bench.py --root build/parent # another checkout's package
    python3 head_bench.py --eval              # and evaluation images/s

--root DIR times the package of the checkout at DIR (its own kernels,
built into DIR/build/kernels at first use), e.g. a parent commit unpacked
there with `git archive`, with this script's shapes and timing; run the two
in turns (parent, change, change, parent) in one call on one card.

time  -- device ms of a wrapper call (first pass + merge) of the greedy
         head at R=128 (the SCST / joint greedy baseline) and 512 (the f32
         service's bucket) and of the beam head at kk=2, R=256 (the
         evaluation's beam-2 decode) and 1024 (the f32 beam service), and
         on the vocab slice of a model axis of 2 (R=256 kk=2: G; R=128
         kk=1: H), H=512, V+1=9488, timed as chip_smoke.py times; beside
         the plain version, `h @ w` alone (f32, TF32 off; a yardstick the
         port never calls), the f32 operations bound (2*R*H*V over 67
         TFLOP/s) and the split product's floor (three TF32 products at 495
         TFLOP/s); the first pass the launch took (per-pass counts) and the
         largest error against the plain version.
eval  -- Evaluator.eval_split of chip_smoke.py's phase-4 run dir (random
         weights from its seed), f32, beam 2, language_eval 0, the test
         split of its evaluation dataset (1536 images, 12 batches of 128):
         images/s of three passes after a warm-up.
Prints one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# (kernel, rows, kk, shards: 0 for the whole logit layer, 2 for a slice)
SHAPES = (("greedy_head", 128, 1, 0), ("greedy_head", 512, 1, 0),
          ("beam_head", 256, 2, 0), ("beam_head", 1024, 2, 0),
          ("beam_head", 256, 2, 2), ("beam_head", 128, 1, 2))
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
ITERS = 20


def time_heads(cs):
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import (
        _dispatch, beam_head, logit_head)
    g = torch.Generator(device="cpu").manual_seed(cs.SEED)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to("cuda")
    H, V1 = cs.WIDTH, cs.VOCAB + 1
    w, b = rn(H, V1, scale=0.1), rn(V1, scale=0.1)
    out = []
    for name, rows, kk, shards in SHAPES:
        V = V1 // shards if shards else V1
        ws, bs = w[:, :V].contiguous(), b[:V].contiguous()
        h = rn(rows, H, scale=0.5)
        if name == "greedy_head":
            def kernel():
                return logit_head.greedy_head(h, ws, bs)

            def plain():
                return logit_head.greedy_head_reference(h, ws, bs)
        else:
            def kernel():
                return beam_head.beam_head(h, ws, bs, kk)

            def plain():
                return beam_head.beam_head_reference(h, ws, bs, kk)
        _dispatch.reset_launches()
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        passes = {k: v for k, v in _dispatch.head_pass_launches().items()
                  if v}
        err = max((a.float() - c.float()).abs().max().item()
                  for a, c in zip(got, want) if a.is_floating_point())
        ms, plain_ms = cs.timed_pair(kernel, plain, ITERS)
        mm = cs.cuda_ms(lambda: h @ ws, ITERS)
        ops = 2 * rows * H * V
        r = {"kernel": name, "rows": rows, "kk": kk, "V": V, "ms": ms,
             "plain_ms": plain_ms, "matmul_ms": mm,
             "bound_ms": ops / F32_OPS_PER_S * 1e3,
             "split_floor_ms": 3 * ops / TF32_OPS_PER_S * 1e3,
             "passes": passes, "max_abs_err": err}
        out.append(r)
        print(f"  {name:12s} f32 R={rows:<5d} kk={kk} V={V:<5d} kernel "
              f"{ms:.4f} ms  plain {plain_ms:.4f}  h @ w {mm:.4f}  bound "
              f"{r['bound_ms']:.4f}  split floor {r['split_floor_ms']:.4f}  "
              f"pass {passes}  err {err:.2e}", flush=True)
        del h, ws, bs
    return out


def eval_rate(cs, device="cuda"):
    import torch
    from cooperativeimagecaptioning_tpu_torch import config, data
    from cooperativeimagecaptioning_tpu_torch.evaluation.eval_split import (
        Evaluator)
    from cooperativeimagecaptioning_tpu_torch.training import checkpoint
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    cs.write_run_dir(cs.RUN_DIR)
    opt = config.load_infos(os.path.join(cs.RUN_DIR, "infos_.pkl"))["opt"]
    params = checkpoint.load_params(
        os.path.join(cs.RUN_DIR, "model-best.pth"), device=device)
    loader = data.DataLoader(opt, dataset=cs.eval_dataset())
    n = len(loader.split_ix["test"])
    ev = Evaluator(opt, device=device)
    ek = {"split": "test", "beam_size": 2, "language_eval": 0,
          "num_images": -1}
    ev.eval_split(params, loader, ek)  # warm-up
    rates = []
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        ev.eval_split(params, loader, ek)
        sync()
        rates.append(n / (time.perf_counter() - t0))
    print(f"  evaluation, f32, beam 2, {n} test images: "
          + ", ".join(f"{r:.1f}" for r in rates) + " images/s", flush=True)
    return {"images": n, "images_per_s": rates}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=HERE,
                   help="the checkout whose package is timed")
    p.add_argument("--eval", action="store_true",
                   help="also evaluation images/s (f32, beam 2)")
    a = p.parse_args(argv)
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("head_bench: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0].strip()
    print(f"card: {smi}; package of {root}", flush=True)
    result = {"card": smi, "root": root, "time": time_heads(cs)}
    if a.eval:
        result["eval"] = eval_rate(cs)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
