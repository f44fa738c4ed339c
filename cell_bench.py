#!/usr/bin/env python3
"""Checks and times of the fused maxout-LSTM cell (kernel F,
csrc/cell_step.cu) on one Hopper GPU, for tuning it and for the numbers
beside it.

    python3 cell_bench.py

check -- F against cell_plain (cell_reference in f32 on the same inputs)
         with attention and without, f32 and bf16, at B = 1, 17, 128, 130,
         512, 2100 and 4096 (D = H = 512), f32 with each of the split-TF32
         kernel's two column tiles (8 and 16 j a block), and at D = H = 500
         (no multiple of 8: the FMA kernel): the largest error of h' and c',
         where it sits (the plain value there), how many elements are off
         the tolerance of chip_smoke.py (f32 1e-4, bf16 3e-2), and the
         kernel each launch took (`_dispatch.cell_pass_launches`).
time  -- device ms of a call of F, beside cell_reference on the same
         inputs, in turns plain, kernel, kernel, plain, as chip_smoke.py
         times: f32 at B = 128, 256, 512, 640 and 4096 with the split-TF32
         kernel at both column tiles and with the FMA kernel (the f32 pass
         before the split-TF32 kernel), and the three products alone
         through torch.matmul (TF32 off); bf16 at B = 512 and 4096.  Each
         with its bound (operations at the card's f32 FMA or bf16 rate) and,
         in f32, the split product's floor (three TF32 products at 495
         TFLOP/s).
Prints one JSON object as its last line.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
CHECKED = (1, 17, 128, 130, 512, 2100, 4096)
F32_TIMED = (128, 256, 512, 640, 4096)
BF16_TIMED = (512, 4096)


def main():
    import torch
    import chip_smoke as cs
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import (
        _build, _dispatch, cell_step)
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

    @contextlib.contextmanager
    def forced(cols=None, force=None):
        """F with the split-TF32 tile of `cols` j and / or the kernel
        `force` in place of the wrapper's choice."""
        saved = cell_step.tf32x3_cols, cell_step.cell_pass
        if cols is not None:
            cell_step.tf32x3_cols = lambda B: cols
        if force is not None:
            cell_step.cell_pass = lambda *a, **k: force
        try:
            yield
        finally:
            cell_step.tf32x3_cols, cell_step.cell_pass = saved

    def run(args, cols=None):
        """One call of F -> (outputs, {kernel: launches})."""
        before = _dispatch.cell_pass_launches()
        with forced(cols):
            out = cell_step.fused_cell(*args)
        torch.cuda.synchronize()
        after = _dispatch.cell_pass_launches()
        return out, {k: after[k] - before[k] for k in after
                     if after[k] != before[k]}

    result = {"card": smi, "check": {}, "time": {}}
    cases = [(dn, B, cs.WIDTH, cols) for dn in ("float32", "bfloat16")
             for B in CHECKED
             for cols in ((8, 16) if dn == "float32" else (None,))]
    cases += [(dn, B, 500, None) for dn in ("float32", "bfloat16")
              for B in (17, 130)]
    for dn, B, width, cols in cases:
        dt = getattr(torch, dn)
        tol = cs.TOL[("cell", dn)]
        for with_att in (True, False):
            args = cs.cell_args(rn, B, dt, with_att, width)
            got, passes = run(args, cols)
            want = cell_step.cell_plain(*args)
            row = {"passes": passes}
            for what, a, b in zip(("h", "c"), got, want):
                d = (a.float() - b.float()).abs()
                at = int(d.argmax())
                row[what] = {"err": d.max().item(),
                             "plain_there": b.flatten()[at].item(),
                             "off": int((d > tol).sum())}
            key = (f"{dn} B={B} D=H={width}"
                   f"{'' if cols is None else f' cols={cols}'} "
                   f"{'att2in2' if with_att else 'fc'}")
            result["check"][key] = row
            print(f"  check {key:40s} {passes}  h {row['h']['err']:.3e} "
                  f"(off {row['h']['off']})  c {row['c']['err']:.3e} at "
                  f"|c| {abs(row['c']['plain_there']):.3f} (off "
                  f"{row['c']['off']})", flush=True)
    for dn, B in ([("float32", B) for B in F32_TIMED]
                  + [("bfloat16", B) for B in BF16_TIMED]):
        dt = getattr(torch, dn)
        args = cs.cell_args(rn, B, dt, True)
        ops = cs.cell_ops(B)
        h_new, c_new = cell_step.fused_cell(*args)
        bound = cs.bound_ms(args + [h_new, c_new], ops, dn)
        variants = ([("tf32x3 cols=8", 8, None), ("tf32x3 cols=16", 16, None),
                     ("fma", None, "fma")] if dn == "float32"
                    else [("mma", None, None)])
        row = {"bound_ms": bound[0], "bound_by": bound[1]}
        if dn == "float32":
            row["split_floor_ms"] = 3 * ops / cs.TF32_OPS_PER_S * 1e3
            xt, h, _, att, wi, _, wh, _, wc, _ = args
            row["matmul_ms"] = cs.cuda_ms(
                lambda: (xt @ wi, h @ wh, att @ wc), 20)
        for name, cols, force in variants:
            with forced(cols, force):
                ms, plain = cs.timed_pair(
                    lambda: cell_step.fused_cell(*args),
                    lambda: cell_step.cell_reference(*args))
            row[name] = {"ms": ms, "plain_ms": plain}
            print(f"  time cell {dn:9s} B={B:<5d} {name:15s} kernel "
                  f"{ms:.4f} ms  cell_reference {plain:.4f} ms  bound "
                  f"{bound[0]:.4f} ms ({bound[1]})"
                  + (f"  split floor {row['split_floor_ms']:.4f} ms  "
                     f"products alone {row['matmul_ms']:.4f} ms"
                     if dn == "float32" else ""), flush=True)
        result["time"][f"{dn} B={B}"] = row
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
