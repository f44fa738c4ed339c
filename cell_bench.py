#!/usr/bin/env python3
"""Checks and times of the fused maxout-LSTM cell (kernel F,
csrc/cell_step.cu) on one Hopper GPU, for tuning it and for the numbers
beside it.

    python3 cell_bench.py

check -- F against cell_plain (cell_reference in f32 on the same inputs)
         with attention and without, f32 and bf16, at B = 1, 17, 128, 130,
         512, 1024, 2100 and 4096 (D = H = 512), f32 with each of the
         split-TF32 kernel's two column tiles (8 and 16 j a block), bf16
         with each of the wgmma kernel's two tiles (64 or 128 rows x 32
         j), and at D = H = 500 (no multiple of 8: the FMA kernel): the
         largest error of h' and c',
         where it sits (the plain value there), how many elements are off
         the tolerance of chip_smoke.py (f32 1e-4, bf16 3e-2), and the
         kernel each launch took (`_dispatch.cell_pass_launches`).
time  -- device ms of a call of F, beside cell_reference on the same
         inputs, in turns plain, kernel, kernel, plain, as chip_smoke.py
         times: f32 at B = 128, 256, 512, 640 and 4096 with the split-TF32
         kernel at both column tiles and with the FMA kernel (the f32 pass
         before the split-TF32 kernel), and the three products alone
         through torch.matmul (TF32 off).  bf16 at B = 130, 512, 1024 and
         4096, with attention and without: the wgmma kernel at each of its
         tiles, in one sequence and then in reverse (each time the mean of
         the two), beside cell_reference and the three products alone
         through torch.matmul; and the host microseconds of a call of the
         C entry `cic_cell` (for the wgmma kernel it encodes three row
         tensor maps, finds the weights' in its cache and launches; for the
         FMA kernel on the same bf16 inputs it only launches), in turns.
         Each with its bound (operations at the card's f32 FMA or bf16
         rate) and, in f32, the split product's floor (three TF32 products
         at 495 TFLOP/s).
Prints one JSON object as its last line.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
CHECKED = (1, 17, 128, 130, 512, 1024, 2100, 4096)
F32_TIMED = (128, 256, 512, 640, 4096)
BF16_TIMED = (130, 512, 1024, 4096)
# the wgmma kernel's tiles: (rows, j) a block
WGMMA_TILES = ((64, 32), (128, 32))
HOST_CALLS = 500


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
    def forced(cols=None, force=None, tile=None):
        """F with the split-TF32 tile of `cols` j, the wgmma tile `tile`
        and / or the kernel `force` in place of the wrapper's choice."""
        saved = (cell_step.tf32x3_cols, cell_step.cell_pass,
                 cell_step.wgmma_tile)
        if cols is not None:
            cell_step.tf32x3_cols = lambda B: cols
        if force is not None:
            cell_step.cell_pass = lambda *a, **k: force
        if tile is not None:
            cell_step.wgmma_tile = lambda B, H: tile
        try:
            yield
        finally:
            (cell_step.tf32x3_cols, cell_step.cell_pass,
             cell_step.wgmma_tile) = saved

    def run(args, cols=None, force=None, tile=None):
        """One call of F -> (outputs, {kernel: launches})."""
        before = _dispatch.cell_pass_launches()
        with forced(cols, force, tile):
            out = cell_step.fused_cell(*args)
        torch.cuda.synchronize()
        after = _dispatch.cell_pass_launches()
        return out, {k: after[k] - before[k] for k in after
                     if after[k] != before[k]}

    result = {"card": smi, "check": {}, "time": {}}
    # (type, B, D = H, split-TF32 cols, forced kernel, wgmma tile)
    cases = [("float32", B, cs.WIDTH, cols, None, None) for B in CHECKED
             for cols in (8, 16)]
    cases += [("bfloat16", B, cs.WIDTH, None, "wgmma", tile)
              for B in CHECKED for tile in WGMMA_TILES]
    cases += [(dn, B, 500, None, None, None) for dn in ("float32", "bfloat16")
              for B in (17, 130)]
    for dn, B, width, cols, force, tile in cases:
        dt = getattr(torch, dn)
        tol = cs.TOL[("cell", dn)]
        for with_att in (True, False):
            args = cs.cell_args(rn, B, dt, with_att, width)
            got, passes = run(args, cols, force, tile)
            want = cell_step.cell_plain(*args)
            row = {"passes": passes}
            for what, a, b in zip(("h", "c"), got, want):
                d = (a.float() - b.float()).abs()
                at = int(d.argmax())
                row[what] = {"err": d.max().item(),
                             "plain_there": b.flatten()[at].item(),
                             "off": int((d > tol).sum())}
            key = (f"{dn} B={B} D=H={width}"
                   f"{'' if cols is None else f' cols={cols}'}"
                   f"{'' if force is None else f' {force}'}"
                   f"{'' if tile is None else f' tile={tile[0]}x{tile[1]}'}"
                   f" {'att2in2' if with_att else 'fc'}")
            result["check"][key] = row
            print(f"  check {key:52s} {passes}  h {row['h']['err']:.3e} "
                  f"(off {row['h']['off']})  c {row['c']['err']:.3e} at "
                  f"|c| {abs(row['c']['plain_there']):.3f} (off "
                  f"{row['c']['off']})", flush=True)
    for B in F32_TIMED:
        args = cs.cell_args(rn, B, torch.float32, True)
        ops = cs.cell_ops(B)
        h_new, c_new = cell_step.fused_cell(*args)
        bound = cs.bound_ms(args + [h_new, c_new], ops, "float32")
        row = {"bound_ms": bound[0], "bound_by": bound[1],
               "split_floor_ms": 3 * ops / cs.TF32_OPS_PER_S * 1e3}
        xt, h, _, att, wi, _, wh, _, wc, _ = args
        row["matmul_ms"] = cs.cuda_ms(
            lambda: (xt @ wi, h @ wh, att @ wc), 20)
        for name, cols, force in (("tf32x3 cols=8", 8, None),
                                  ("tf32x3 cols=16", 16, None),
                                  ("fma", None, "fma")):
            with forced(cols, force):
                ms, plain = cs.timed_pair(
                    lambda: cell_step.fused_cell(*args),
                    lambda: cell_step.cell_reference(*args))
            row[name] = {"ms": ms, "plain_ms": plain}
            print(f"  time cell float32   B={B:<5d} {name:15s} kernel "
                  f"{ms:.4f} ms  cell_reference {plain:.4f} ms  bound "
                  f"{bound[0]:.4f} ms ({bound[1]})  split floor "
                  f"{row['split_floor_ms']:.4f} ms  products alone "
                  f"{row['matmul_ms']:.4f} ms", flush=True)
        result["time"][f"float32 B={B}"] = row
    # bf16: every tile in one sequence, then in reverse
    names = {tile: f"wgmma {tile[0]}x{tile[1]}" for tile in WGMMA_TILES}
    for B in BF16_TIMED:
        for with_att in (True, False):
            args = cs.cell_args(rn, B, torch.bfloat16, with_att)
            ops = cs.cell_ops(B) if with_att else 2 * B * cs.WIDTH * 10 \
                * cs.WIDTH
            h_new, c_new = cell_step.fused_cell(*args)
            bound = cs.bound_ms(args + [h_new, c_new], ops, "bfloat16")
            xt, h, _, att, wi, _, wh, _, wc, _ = args
            runs = {tile: [] for tile in WGMMA_TILES}
            for order in (WGMMA_TILES, WGMMA_TILES[::-1]):
                for tile in order:
                    with forced(force="wgmma", tile=tile):
                        runs[tile].append(cs.cuda_ms(
                            lambda: cell_step.fused_cell(*args), 20))
            plain = [cs.cuda_ms(lambda: cell_step.cell_reference(*args), 20)
                     for _ in range(2)]
            row = {"bound_ms": bound[0], "bound_by": bound[1],
                   "matmul_ms": cs.cuda_ms(
                       (lambda: (xt @ wi, h @ wh, att @ wc)) if with_att
                       else (lambda: (xt @ wi, h @ wh)), 20),
                   "plain_ms": sum(plain) / 2,
                   **{names[t]: {"ms": sum(r) / 2, "runs": r}
                      for t, r in runs.items()}}
            key = f"bfloat16 B={B} {'att2in2' if with_att else 'fc'}"
            print(f"  time cell {key:26s} "
                  + "  ".join(f"{n} {row[n]['ms']:.4f}"
                              for n in names.values())
                  + f" ms  cell_reference {row['plain_ms']:.4f} ms  "
                  f"products alone {row['matmul_ms']:.4f} ms  bound "
                  f"{bound[0]:.4f} ms ({bound[1]})", flush=True)
            result["time"][key] = row
    # the host's time a call of the C entry, the card kept busy
    args = cs.cell_args(rn, 512, torch.bfloat16, True)
    outs = [torch.empty_like(args[1]) for _ in range(2)]
    ptrs = [_build.ptr(t) for t in args + outs]
    lib = _build.library()
    stream = _build.stream(args[1].device)
    busy = torch.ones(4096, 4096, device="cuda", dtype=torch.bfloat16)
    result["host_us"] = {}
    for which in ("wgmma", "fma", "fma", "wgmma"):
        rows, cols = (cell_step.wgmma_tile(512, cs.WIDTH)
                      if which == "wgmma" else (0, 0))

        def call():
            _build.check(lib, lib.cic_cell(
                *ptrs, 512, cs.WIDTH, cs.WIDTH, 1,
                cell_step.PASS_CODES[which], cols, rows, stream), "cell")
        call()
        torch.cuda.synchronize()
        for _ in range(200):
            busy @ busy
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            call()
        us = (time.perf_counter() - t0) / HOST_CALLS * 1e6
        torch.cuda.synchronize()
        result["host_us"].setdefault(which, []).append(us)
        print(f"  host cic_cell bf16 B=512 {which:6s} {us:.2f} us a call",
              flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
