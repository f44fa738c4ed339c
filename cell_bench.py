#!/usr/bin/env python3
"""Checks and times of the fused maxout-LSTM cell (kernel F,
csrc/cell_step.cu) on one Hopper GPU, for tuning it and for the numbers
beside it.

    python3 cell_bench.py

check -- F against cell_plain (cell_reference in f32 on the same inputs)
         with attention and without, f32 and bf16, at B = 1, 17, 128, 130,
         512, 2100 and 4096 (D = H = 512): the largest error of h' and c',
         where it sits (the plain value there) and how many elements are
         off the tolerance of chip_smoke.py (f32 1e-4, bf16 3e-2).
time  -- device ms of a call of F and of cell_reference (the cell that runs
         with CIC_FUSED_CELL unset) at the shapes chip_smoke.py times, in
         turns plain, kernel, kernel, plain, with the bound, timed as
         chip_smoke.py times.
Prints one JSON object as its last line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
TIMED = (("float32", 128), ("float32", 512), ("float32", 4096),
         ("bfloat16", 512), ("bfloat16", 4096))


def main():
    import torch
    import chip_smoke as cs
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import (
        _build, cell_step)
    if not torch.cuda.is_available():
        print("cell_bench: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0].strip()
    print(f"card: {smi}", flush=True)
    info = _build.build()
    for name, res in sorted(info["resources"].items()):
        if "cell_" in name:
            print(f"  {name}: {res}", flush=True)
    g = torch.Generator(device="cpu").manual_seed(cs.SEED)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to("cuda")

    result = {"card": smi, "check": {}, "time": {}}
    os.environ["CIC_FUSED_CELL"] = "1"
    for dn in ("float32", "bfloat16"):
        dt = getattr(torch, dn)
        tol = cs.TOL[("cell", dn)]
        for B in (1, 17, 128, 130, 512, 2100, 4096):
            for with_att in (True, False):
                args = cs.cell_args(rn, B, dt, with_att)
                got = cell_step.fused_cell(*args)
                torch.cuda.synchronize()
                want = cell_step.cell_plain(*args)
                row = {}
                for what, a, b in zip(("h", "c"), got, want):
                    d = (a.float() - b.float()).abs()
                    at = int(d.argmax())
                    row[what] = {"err": d.max().item(),
                                 "plain_there": b.flatten()[at].item(),
                                 "off": int((d > tol).sum())}
                key = f"{dn} B={B} {'att2in2' if with_att else 'fc'}"
                result["check"][key] = row
                print(f"  check {key:26s} h {row['h']['err']:.3e} (off "
                      f"{row['h']['off']})  c {row['c']['err']:.3e} at "
                      f"|c| {abs(row['c']['plain_there']):.3f} (off "
                      f"{row['c']['off']})", flush=True)
    for dn, B in TIMED:
        dt = getattr(torch, dn)
        args = cs.cell_args(rn, B, dt, True)
        ms, plain = cs.timed_pair(lambda: cell_step.fused_cell(*args),
                                  lambda: cell_step.cell_reference(*args))
        h_new, c_new = cell_step.fused_cell(*args)
        bound = cs.bound_ms(args + [h_new, c_new],
                            2 * B * cs.WIDTH * (5 + 5 + 2) * cs.WIDTH, dn)
        result["time"][f"{dn} B={B}"] = {"ms": ms, "plain_ms": plain,
                                         "bound_ms": bound[0]}
        print(f"  time cell {dn:9s} B={B:<5d} kernel {ms:.4f} ms  plain "
              f"{plain:.4f} ms  bound {bound[0]:.4f} ms ({bound[1]})",
              flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
