#!/usr/bin/env python3
"""Times of the vocabulary heads (kernels B and C) on one Hopper GPU, at
the f32 paths' shapes or (--bf16) the bf16 service's, for comparing two
checkouts on one card.

    python3 head_bench.py                     # this checkout
    python3 head_bench.py --root build/parent # another checkout's package
    python3 head_bench.py --eval              # and evaluation images/s
    python3 head_bench.py --bf16              # the bf16 heads
    python3 head_bench.py --bf16 --plans 0,7  # and schedules of their pass
    python3 head_bench.py --bf16 --host-ab build/parent  # host time, A/B

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
bf16  -- the same for bf16 at BF16_SHAPES (chip_smoke.py's HEAD_BF16_TIMED:
         greedy at the buckets 512 and 4096; beam kk=2 at R=1024 and at the
         8192 rows of a beam-2 bucket of 4096, kk=16 and kk=32 -- two
         rounds -- at R=1024), beside the plain version, `h @ w` alone,
         the bf16 operations bound (989 TFLOP/s), and the wrapper call on
         the host's clock (`call_ms`: the median of 7 loops of 50 calls,
         each loop ended by a synchronize; `enqueue_ms`: the median of 15
         loops of 64 calls that the card still runs when the loop ends, the
         host's work alone), each head checked against the plain version
         first (ids equal but at near-ties of 1e-4, values and logsumexp
         within 1e-4).
plans -- with --bf16: the first pass alone (no merge) under other
         schedules of csrc/vocab_head_tma.cuh (head_bench_plans.cu, one
         library a plan, built in parallel beside the package's), at the
         kk <= 2 shapes, in turns with the package's own first pass; each
         plan's partials merged in PyTorch and checked as above first;
         each plan's registers and spills from ptxas's log.  `--splits64`
         adds the package's pass on splits in units of 64 columns (more
         blocks at R=512, more reads of h); `--plans-only` times the plans
         without building the package's library.
host-ab -- with --bf16: the host's work of a head call, this checkout's
         kernel library against another checkout's (DIR: its package's
         library, built there at first use), in one process: the C entry
         points (cic_greedy_head, cic_beam_head; the rest of a wrapper
         call is the same Python on both sides) called with the same
         arguments at BF16_SHAPES, each side's bf16 first pass; 31 loops
         of 64 calls a side, the sides in alternating order, each loop
         timed from an idle card to its last call's return (enqueue
         alone); the medians and the median of the paired differences.
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
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# (kernel, rows, kk, shards: 0 for the whole logit layer, 2 for a slice)
SHAPES = (("greedy_head", 128, 1, 0), ("greedy_head", 512, 1, 0),
          ("beam_head", 256, 2, 0), ("beam_head", 1024, 2, 0),
          ("beam_head", 256, 2, 2), ("beam_head", 128, 1, 2))
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
ITERS = 20
# (kernel, rows, kk): chip_smoke.py's HEAD_BF16_TIMED, kept here so that a
# parent checkout is timed at the same shapes
BF16_SHAPES = (("greedy_head", 512, 1), ("greedy_head", 4096, 1),
               ("beam_head", 1024, 2), ("beam_head", 1024, 16),
               ("beam_head", 8192, 2), ("beam_head", 1024, 32))
BF16_OPS_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
PLANS_SRC = os.path.join(HERE, "head_bench_plans.cu")


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


def host_call_ms(fn, calls=50, reps=7):
    """A call of fn() on the host's clock, in ms: the median of `reps`
    loops of `calls` calls back to back on an idle card, each ended by a
    synchronize (chip_smoke.call_ms; kept here so that a parent checkout
    is measured alike)."""
    import torch
    fn()
    loops = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        loops.append((time.perf_counter() - t0) * 1e3 / calls)
    return sorted(loops)[reps // 2]


def host_enqueue_ms(fn, calls=64, reps=15):
    """The host's work of a call of fn(), in ms: the median of `reps`
    loops of `calls` calls, each loop timed from an idle card to its last
    call's return, while the card still runs what the loop enqueued (a
    synchronize after each loop, outside the time)."""
    import torch
    fn()
    loops = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        loops.append((time.perf_counter() - t0) * 1e3 / calls)
        torch.cuda.synchronize()
    return sorted(loops)[reps // 2]


def head_error(name, got, want, logits, tol=1e-4):
    """The largest error of a head's float outputs against the plain
    version's; raises where ids differ other than at near-ties (plain
    logits of the two ids within `tol`) or an error exceeds `tol`."""
    import torch
    ids, ids_p = (got[0], want[0]) if name == "greedy_head" else \
        (got[1], want[1])
    ids, ids_p = ids.long().reshape(len(logits), -1), \
        ids_p.long().reshape(len(logits), -1)
    diff = ids != ids_p
    if diff.any():
        gap = (torch.gather(logits, 1, ids) - torch.gather(logits, 1, ids_p)
               ).abs()[diff].max().item()
        if gap > tol:
            raise RuntimeError(f"{name}: {int(diff.sum())} ids differ, not "
                               f"near-ties (logit gap {gap})")
    err = max((a.float() - c.float()).abs().max().item()
              for a, c in zip(got, want) if a.is_floating_point())
    if err > tol:
        raise RuntimeError(f"{name}: max abs error {err} above {tol}")
    return err


def build_plans(plans):
    """Start one nvcc a plan of head_bench_plans.cu (into
    build/head_plans/); returns {plan: (process, library path)}."""
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _build
    out = os.path.join(HERE, "build", "head_plans")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for plan in plans:
        path = os.path.join(out, f"libplan{plan}.so")
        procs[plan] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.COMPILE_FLAGS, "-shared",
             f"-I{_build.CSRC}", f"-DPLAN={plan}", "-o", path, PLANS_SRC],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            path)
    return procs


def load_plans(procs):
    """Wait for build_plans' nvcc processes; {plan: ctypes library}, each
    plan's registers and spills printed from ptxas's log."""
    import ctypes
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _build
    libs = {}
    for plan, (proc, path) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for plan {plan}:\n{log}")
        for kernel, res in _build.kernel_resources(log).items():
            print(f"  plan {plan} {kernel}: {res}", flush=True)
        for line in log.splitlines():
            if "C7515" in line:   # ptxas serialized a kernel's wgmma
                print(f"  plan {plan}: {line.strip()}", flush=True)
        lib = ctypes.CDLL(path)
        lib.bench_partials.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 \
            + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.bench_partials.restype = ctypes.c_int
        libs[plan] = lib
    return libs


def merged_partials(parts_buf, R, splits, slots, kk):
    """The heads' merge of a first pass's partials, in PyTorch: the top-kk
    over the splits' lists in (value desc, id asc) order and the
    logsumexp (float64 sum) -> (vals, ids, lse)."""
    import torch
    n = R * splits
    pv = parts_buf[:n * slots].view(R, splits * slots)
    pi = parts_buf[n * slots:2 * n * slots].view(torch.int32).view(
        R, splits * slots).long()
    pm = parts_buf[2 * n * slots:2 * n * slots + n].view(R, splits).double()
    ps = parts_buf[2 * n * slots + n:].view(R, splits).double()
    o = torch.argsort(pi, dim=1, stable=True)
    pv, pi = torch.gather(pv, 1, o), torch.gather(pi, 1, o)
    o = torch.argsort(pv, dim=1, descending=True, stable=True)
    vals = torch.gather(pv, 1, o)[:, :kk]
    ids = torch.gather(pi, 1, o)[:, :kk].int()
    mx = pm.max(dim=1).values
    lse = (mx + torch.log((ps * torch.exp(pm - mx[:, None])).sum(dim=1)))
    return vals, ids, lse.float()


def time_bf16(cs, plans, splits64, plans_only=False):
    """The bf16 heads at BF16_SHAPES; with `plans`, the first pass alone
    under each plan of head_bench_plans.cu at the kk <= 2 shapes;
    `plans_only`: those alone (the package's library is not built)."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import (
        _build, _dispatch, beam_head, logit_head)
    # the plans first (a few kernels each, so a compile error shows in
    # seconds), the package's library meanwhile
    procs = build_plans(plans) if plans else {}
    t0 = time.perf_counter()
    built = {}
    lib = threading.Thread(target=lambda: built.update(_build.build()),
                           daemon=True)
    if not plans_only:
        lib.start()
    libs = load_plans(procs)
    if not plans_only:
        lib.join()
        _build.library()
    print(f"  libraries ready in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, res in sorted(built.get("resources", {}).items()):
        if "vocab_partials" in name:   # the heads' first passes
            print(f"  {name}: {res}", flush=True)
    for name in built.get("serialized", []):
        print(f"  ptxas serialized the wgmma of {name} (C7515)", flush=True)
    g = torch.Generator(device="cpu").manual_seed(cs.SEED)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to("cuda")
    H, V = cs.WIDTH, cs.VOCAB + 1
    dt = torch.bfloat16
    w, b = rn(H, V, scale=0.1).to(dt), rn(V, scale=0.1).to(dt)
    sms = logit_head._sm_count(0)
    out = []
    for name, rows, kk in BF16_SHAPES:
        h = rn(rows, H, scale=0.5).to(dt)
        logits = logit_head.logits_f32(h, w, b)
        if name == "greedy_head":
            def kernel():
                return logit_head.greedy_head(h, w, b)

            def plain():
                return logit_head.greedy_head_reference(h, w, b)
            outs = rows * 8
        else:
            def kernel():
                return beam_head.beam_head(h, w, b, kk)

            def plain():
                return beam_head.beam_head_reference(h, w, b, kk)
            outs = rows * (8 * kk + 4)
        iters = ITERS if rows <= 1024 else 10
        if plans_only:
            if kk <= 2:
                r = {"kernel": name, "rows": rows, "kk": kk,
                     "first_pass_ms": plan_times(
                         cs, libs, h, w, b, kk, logits, plain(), name, sms,
                         splits64, iters)}
                out.append(r)
                print(f"  bf16 {name:12s} R={rows:<5d} kk={kk:<2d} first "
                      f"pass by plan {r['first_pass_ms']}", flush=True)
            continue
        _dispatch.reset_launches()
        err = head_error(name, kernel(), plain(), logits)
        passes = {k: v for k, v in _dispatch.head_pass_launches().items()
                  if v}
        ms, plain_ms = cs.timed_pair(kernel, plain, iters)
        mm = cs.cuda_ms(lambda: h @ w, iters)
        call = host_call_ms(kernel)
        enqueue = host_enqueue_ms(kernel)
        ops = 2 * rows * H * V
        nbytes = 2 * (h.numel() + w.numel() + b.numel()) + outs
        bound = max(ops / BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
        r = {"kernel": name, "rows": rows, "kk": kk, "ms": ms,
             "plain_ms": plain_ms, "matmul_ms": mm, "bound_ms": bound,
             "call_ms": call, "enqueue_ms": enqueue, "passes": passes,
             "max_abs_err": err}
        if libs and kk <= 2:
            r["first_pass_ms"] = plan_times(
                cs, libs, h, w, b, kk, logits, plain(), name, sms, splits64,
                iters)
        out.append(r)
        print(f"  bf16 {name:12s} R={rows:<5d} kk={kk:<2d} kernel {ms:.4f} "
              f"ms  plain {plain_ms:.4f}  h @ w {mm:.4f}  bound {bound:.4f} "
              f"({ms / bound:.1f}x)  call {call:.4f} ms  enqueue "
              f"{enqueue:.4f} ms  pass {passes}  err "
              f"{err:.2e}"
              + (f"  first pass by plan {r['first_pass_ms']}"
                 if "first_pass_ms" in r else ""), flush=True)
        del h, logits
    return out


def plan_times(cs, libs, h, w, b, kk, logits, want, name, sms, splits64,
               iters):
    """{plan: ms of the first pass alone}, each plan checked first (its
    partials merged in PyTorch against the plain version), timed in turns
    (the plans in order, then in reverse)."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import (
        _build, logit_head)
    R, H = h.shape
    V = w.shape[1]
    runs = {str(p): (lib, logit_head.TMA_SPLIT_UNIT)
            for p, lib in libs.items()}
    if splits64 and 0 in libs:
        runs["0@64"] = (libs[0], logit_head.TMA_COL_TILE)
    calls = {}
    for key, (lib, unit) in runs.items():
        splits, split_cols = logit_head.mma_split(R, V, sms, unit)
        buf, parts = logit_head.partials_scratch(R, splits, kk, h.device)

        def call(lib=lib, parts=parts, splits=splits, split_cols=split_cols):
            code = lib.bench_partials(
                kk, h.data_ptr(), w.data_ptr(), b.data_ptr(), *parts, R, H,
                V, splits, split_cols, _build.stream(h.device))
            if code != 0:
                raise RuntimeError(f"plan {key}: CUDA error {code}")
        call()
        torch.cuda.synchronize()
        vals, ids, lse = merged_partials(buf, R, splits, kk, kk)
        got = (ids[:, 0], vals[:, 0] - lse) if name == "greedy_head" \
            else (vals, ids, lse)
        head_error(f"{name} plan {key}", got, want, logits)
        calls[key] = (call, buf)
    times = {k: [] for k in calls}
    for order in (list(calls), list(calls)[::-1]):
        for k in order:
            times[k].append(cs.cuda_ms(calls[k][0], iters))
    return {k: sum(v) / len(v) for k, v in times.items()}


def other_library(root):
    """(ctypes library, bf16 pass code) of the checkout at `root`: its
    package's kernel library, built by a Python of its own in `root`, and
    the code its PASS_CODES gives its bf16 tensor-core pass."""
    import ast
    import ctypes
    import re
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _build
    path = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, '.'); from cooperativeimagecaptioning"
         "_tpu_torch.ops.kernels import _build; print(_build.build()['path'])"],
        cwd=root, capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-1]
    src = open(os.path.join(
        root, "cooperativeimagecaptioning_tpu_torch", "ops", "kernels",
        "logit_head.py")).read()
    codes = ast.literal_eval(
        re.search(r"^PASS_CODES = (\{.*?\})", src, re.M | re.S).group(1))
    (code,) = [c for k, c in codes.items() if k not in ("fma", "tf32x3")]
    lib = ctypes.CDLL(path)
    for name in ("cic_greedy_head", "cic_beam_head"):
        getattr(lib, name).argtypes = _build.SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    return lib, code


def host_ab(cs, root, calls=64, reps=31):
    """The host's work of a head's C entry point, this checkout's library
    (A) against the one at `root` (B), in one process (see the module's
    docstring): {shape: ms of A, of B, and the median of A - B}."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import (
        _build, beam_head, logit_head)
    other, other_code = other_library(root)
    this = _build.library()
    g = torch.Generator(device="cpu").manual_seed(cs.SEED)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to("cuda")
    H, V = cs.WIDTH, cs.VOCAB + 1
    dt = torch.bfloat16
    w, b = rn(H, V, scale=0.1).to(dt), rn(V, scale=0.1).to(dt)
    dev = w.device
    P = _build.ptr
    out = []
    for name, rows, kk in BF16_SHAPES:
        h = rn(rows, H, scale=0.5).to(dt)
        which, splits, split_cols = logit_head.plan_first_pass(
            rows, 8, h, w, b)
        codes = {"A": logit_head.PASS_CODES[which], "B": other_code}
        st = _build.stream(dev)
        if name == "greedy_head":
            _, parts = logit_head.partials_scratch(rows, splits, 1, dev)
            it = torch.empty(rows, dtype=torch.int32, device=dev)
            lp = torch.empty(rows, dtype=torch.float32, device=dev)

            def call(lib, code):
                return lib.cic_greedy_head(
                    P(h), P(w), P(b), *parts, P(it), P(lp), rows, H, V,
                    splits, split_cols, 1, code, st)
        else:
            slots = next((x for x in beam_head.SLOTS if x >= kk),
                         beam_head.ROUND_KK)
            _, parts = logit_head.partials_scratch(rows, splits, slots, dev)
            vals = torch.empty((rows, kk), dtype=torch.float32, device=dev)
            idx = torch.empty((rows, kk), dtype=torch.int32, device=dev)
            lse = torch.empty(rows, dtype=torch.float32, device=dev)
            thr = torch.empty(2 * rows, dtype=torch.float32, device=dev)

            def call(lib, code):
                return lib.cic_beam_head(
                    P(h), P(w), P(b), *parts, P(vals), P(idx), P(lse),
                    P(thr) if kk > slots else None, rows, H, V, kk, slots,
                    splits, split_cols, 1, code, st)
        libs = {"A": this, "B": other}
        for k in libs:
            code = call(libs[k], codes[k])
            if code != 0:
                raise RuntimeError(f"{name} R={rows} kk={kk} side {k}: "
                                   f"CUDA error {code}")
        torch.cuda.synchronize()
        t = {"A": [], "B": []}
        for r in range(reps):
            for k in ("A", "B") if r % 2 == 0 else ("B", "A"):
                lib, code = libs[k], codes[k]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(calls):
                    call(lib, code)
                t[k].append((time.perf_counter() - t0) * 1e3 / calls)
                torch.cuda.synchronize()
        diff = sorted(a - b for a, b in zip(t["A"], t["B"]))[reps // 2]
        r = {"kernel": name, "rows": rows, "kk": kk,
             "enqueue_ms_A": sorted(t["A"])[reps // 2],
             "enqueue_ms_B": sorted(t["B"])[reps // 2],
             "enqueue_diff_ms": diff}
        out.append(r)
        print(f"  host {name:12s} R={rows:<5d} kk={kk:<2d} enqueue A (this) "
              f"{r['enqueue_ms_A'] * 1e3:.2f} us  B ({root}) "
              f"{r['enqueue_ms_B'] * 1e3:.2f} us  A - B "
              f"{diff * 1e3:+.2f} us", flush=True)
        del h
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
    p.add_argument("--bf16", action="store_true",
                   help="the bf16 heads at BF16_SHAPES, not the f32 ones")
    p.add_argument("--plans", default="",
                   help="with --bf16: comma-separated plans of "
                        "head_bench_plans.cu to time the first pass under")
    p.add_argument("--splits64", action="store_true",
                   help="with --plans: plan 0 on splits of 64-column units")
    p.add_argument("--host-ab", default="", metavar="DIR",
                   help="with --bf16: the host's work of a head call, this "
                        "library against DIR's, instead of the timings")
    p.add_argument("--plans-only", action="store_true",
                   help="with --plans: time the plans alone, without "
                        "building the package's library")
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
    if a.bf16 and a.host_ab:
        result = {"card": smi, "root": root,
                  "host_ab": host_ab(cs, os.path.abspath(a.host_ab))}
    elif a.bf16:
        plans = [int(x) for x in a.plans.split(",") if x]
        result = {"card": smi, "root": root,
                  "bf16": time_bf16(cs, plans, a.splits64, a.plans_only)}
    else:
        result = {"card": smi, "root": root, "time": time_heads(cs)}
    if a.eval:
        result["eval"] = eval_rate(cs)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
