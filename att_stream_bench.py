#!/usr/bin/env python3
"""Times and checks of the attention kernels (A b-major, E K-major, D int8)
on one Hopper GPU, for tuning their stream and for the numbers beside them.

    python3 att_stream_bench.py                 # check, then time the plans
    python3 att_stream_bench.py --root DIR      # another checkout's kernels
    python3 att_stream_bench.py --turns DIR     # DIR, this, this, DIR
    python3 att_stream_bench.py --tanh 0,1,2    # also the tanh variants
    python3 att_stream_bench.py --sweep         # also grid / slots / stages
    python3 att_stream_bench.py --probe dependent,packed,1,2,4
    python3 att_stream_bench.py --probe dependent --repeat 4
    python3 att_stream_bench.py --host-ab DIR   # host time, A/B

Builds only csrc/att_step.cu (and common.cu) with nvcc into
<root>/build/att_bench_<variant>/ (kept while the sources and flags are the
same), so a run costs one short compile a variant.  --root DIR times the
package of the checkout at DIR (e.g. a parent commit unpacked there with
`git archive`) with this script's shapes and timing; --turns DIR runs
DIR's, this checkout's, this checkout's and DIR's times in four processes,
one after the other, in one call on one card, and prints them side by side.
Phases:
  check  -- the pre-pass alone against h @ W + b, and A, E and D against
            their plain versions (f32 and bf16, masked and unmasked, aligned
            and unaligned widths, ragged B, B = 1, K up to 256), and A's
            and D's two launches captured into a CUDA graph (the graph's
            nodes, edges and programmatic edges).
  time   -- device ms of a wrapper call of A, E and D (and of the pre-pass
            alone, beside torch.addmm of the same product and its own
            bound) at the shapes the paths run: bf16 B=512, 1024, 4096 and
            f32 B=128, 256, 640 (K=36, H=A=512), and K=196 at bf16 B=512 and
            f32 B=128, timed as chip_smoke.py times (events around calls
            enqueued on a busy card, no L2 flush).
  --tanh -- the same times with the kernel's tanh compiled as the identity
            (0), as tanhf (1) and as the exp form (2): the share of the tanh.
  --sweep - the same times under other plans (grid, slots a stage, stages)
            than stream_plan's.
  --probe - the same times under variants: "dependent" (the stream a
            programmatic dependent of the pre-pass, or not, against the
            plan's choice; --repeat N rounds of both, in alternating
            order), "packed" (D's bf16 calls in the f32 arithmetic:
            CIC_ATT_PACKED=0), and numbers, parts of the stream kernel
            compiled out (CIC_ATT_PROBE: 1 the score arithmetic, 2 the
            weighted sum's, 3 both: the copies and barriers alone, 4 the
            copies: the arithmetic alone); their results are wrong, only
            their times count.
  --host-ab DIR - the host's work of a call, this checkout's kernel library
            against DIR's, in one process: the C entry points (cic_attention,
            cic_attention_q) with the same tensors, each side's own plan; 31
            loops of 64 calls a side, the sides in alternating order, each
            loop timed from an idle card to its last call's return (the
            enqueue alone); medians and the median paired difference; and
            this checkout's whole wrapper call the same way.
Prints one JSON object as its last line and writes it to --out (default
<root>/build/att_stream_bench.json).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
K = 36
WIDTH = 512
SHAPES = (("bfloat16", 512, K), ("bfloat16", 1024, K), ("bfloat16", 4096, K),
          ("float32", 128, K), ("float32", 256, K), ("float32", 640, K),
          ("bfloat16", 512, 196), ("float32", 128, 196))
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
TF32_OPS_PER_S = 495e12
ROOT = HERE


def build_variant(tag, flags=()):
    """Compile the root's att_step.cu + common.cu into
    <root>/build/att_bench_<tag>/ (unless an up-to-date build is there) and
    make it the library the wrappers launch."""
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _build
    out_dir = os.path.join(ROOT, "build", f"att_bench_{tag}")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "libatt.so")
    srcs = [str(_build.CSRC / "att_step.cu"), str(_build.CSRC / "common.cu")]
    cmd = [_build.nvcc_path(), *_build.COMPILE_FLAGS, *flags, "-shared",
           f"-I{_build.CSRC}", "-o", lib_path, *srcs]
    digest = hashlib.sha256(" ".join(cmd).encode())
    for p in sorted(_build.CSRC.glob("*.cu*")):
        digest.update(p.read_bytes())
    stamp = os.path.join(out_dir, "libatt.sha256")
    log_path = os.path.join(out_dir, "ptxas.log")
    t0 = time.perf_counter()
    if not (os.path.isfile(lib_path) and os.path.isfile(stamp)
            and open(stamp).read() == digest.hexdigest()):
        done = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{done.stdout}")
        with open(log_path, "w") as f:
            f.write(done.stdout)
        with open(stamp, "w") as f:
            f.write(digest.hexdigest())
    lib = ctypes.CDLL(lib_path)
    for name, argtypes in _build.SIGNATURES.items():
        if name.startswith("cic_att"):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.cic_error_string.argtypes = [ctypes.c_int]
    lib.cic_error_string.restype = ctypes.c_char_p
    _build._lib = lib
    res = _build.kernel_resources(open(log_path).read())
    print(f"build {tag} {list(flags)}: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return res


def cuda_ms(fn, iters=20):
    import torch
    for _ in range(3):
        fn()
    busy = torch.ones(4096, 4096, device="cuda", dtype=torch.bfloat16)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    for _ in range(24):
        busy @ busy
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def make_case(rn, B, dt, H=WIDTH, A=WIDTH, k=K):
    import torch
    h = rn(B, H, scale=0.5).to(dt)
    emb = rn(B, k, H).relu().to(dt)
    p_att = rn(B, k, A).to(dt)
    weights = (rn(H, A, scale=H ** -0.5).to(dt), rn(A, scale=0.05).to(dt),
               rn(A, 1, scale=A ** -0.5).to(dt), rn(1, scale=0.05).to(dt))
    mask = torch.ones(B, k, device="cuda")
    if k > 1:
        mask[::3, k // 2:] = 0.0
        mask[1::7, 1:] = 0.0
    return h, emb, p_att, weights, mask


def pre_bound_ms(B, H, A, dn):
    """The pre-pass's own bound: bytes of h, W, b and the f32 att_h over
    the memory rate, operations over the type's peak; and for f32 the floor
    of three TF32 products."""
    item = 2 if dn == "bfloat16" else 4
    by_bytes = (item * (B * H + H * A + A) + 4 * B * A) / HBM_BYTES_PER_S
    ops = 2 * B * H * A
    by_ops = ops / PEAK_OPS_PER_S[dn]
    out = {"bound_ms": max(by_bytes, by_ops) * 1e3,
           "bound_by": "bytes" if by_bytes >= by_ops else "operations"}
    if dn == "float32":
        out["split_floor_ms"] = 3 * ops / TF32_OPS_PER_S * 1e3
    return out


def check(rn):
    """Largest errors of the pre-pass, A, E and D over a set of shapes;
    raises on a miss (f32 1e-4, bf16 3e-2; the pre-pass 1e-5 / 3e-2)."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import (
        _dispatch, att_step)
    worst = {}
    cases = [(512, WIDTH, WIDTH, K), (4099, WIDTH, WIDTH, K),
             (1, WIDTH, WIDTH, K), (7, WIDTH, WIDTH, 1),
             (128, WIDTH, WIDTH, K), (640, WIDTH, WIDTH, K),
             (13, 96, 80, 6), (9, 96, 80, 64), (8, 96, 80, 1),
             (37, 100, 72, 5), (33, 97, 83, 7), (140, 1024, 256, 36),
             (3, 4000, 64, 3), (64, WIDTH, WIDTH, 196), (5, 40, 40, 196),
             (3, 96, 80, 256), (300, WIDTH, WIDTH, 256)]
    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).split(".")[-1]
        tol = 1e-4 if dt == torch.float32 else 3e-2
        for B, H, A, k in cases:
            h, emb, p_att, weights, mask = make_case(rn, B, dt, H, A, k)
            got = att_step.att_h_kernel(h, weights[0], weights[1])
            want = h.float() @ weights[0].float() + weights[1].float()
            err = (got - want).abs().max().item()
            worst[f"att_h {dn}"] = max(worst.get(f"att_h {dn}", 0.0), err)
            assert err <= (1e-5 if dt == torch.float32 else 3e-2), \
                f"att_h {dn} B={B} H={H} A={A}: {err}"
            emb_t = emb.movedim(0, 1).contiguous()
            p_t = p_att.movedim(0, 1).contiguous()
            q = att_step.quantize_features(emb, p_att)
            for mk in (mask, None):
                before = _dispatch.att_width_launches()
                a = att_step.attention_kernel(h, emb, p_att, *weights, mk)
                e = att_step.attention_kmajor_kernel(h, emb_t, p_t, *weights,
                                                     mk)
                d = att_step.attention_q_kernel(h, *q, *weights, mk)
                torch.cuda.synchronize()
                after = _dispatch.att_width_launches()
                for name, item in (("attention", h.element_size()),
                                   ("attention_kmajor", h.element_size()),
                                   ("attention_q", 1)):
                    width = "vec" if att_step.vector_width(
                        H, A, item) > 1 else "scalar"
                    key = f"{name}_{width}"
                    assert after[key] - before[key] == 1, (key, after)
                ref = att_step.attention_reference(h, emb, p_att, *weights,
                                                   mk)
                ref_q = att_step.attention_reference_q(h, *q, *weights, mk)
                err = (d.float() - ref_q.float()).abs().max().item()
                worst[f"D {dn}"] = max(worst.get(f"D {dn}", 0.0), err)
                assert err <= tol, (f"D {dn} B={B} H={H} A={A} K={k} "
                                    f"masked={mk is not None}: {err}")
                for name, out in (("A", a), ("E", e)):
                    err = (out.float() - ref.float()).abs().max().item()
                    key = f"{name} {dn}"
                    worst[key] = max(worst.get(key, 0.0), err)
                    assert err <= tol, (f"{name} {dn} B={B} H={H} A={A} "
                                        f"K={k} masked={mk is not None}: "
                                        f"{err}")
    # all-zero mask rows: NaN, as the plain version gives
    h, emb, p_att, weights, mask = make_case(rn, 64, torch.float32)
    mask[5] = 0.0
    out = att_step.attention_kernel(h, emb, p_att, *weights, mask)
    torch.cuda.synchronize()
    assert bool(out[5].isnan().all()) and not bool(out[4].isnan().any())
    print("check: " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()),
          flush=True)
    return worst


def check_graphs(rn):
    """A's and D's calls captured into a CUDA graph and replayed once
    (graph_capture.py of this script's checkout): their outputs against the
    plain versions, and what the graph holds."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import att_step
    sys.path.insert(0, HERE)
    import graph_capture
    lib = graph_capture.load(graph_capture.start(
        os.path.join(ROOT, "build", "graph_capture")))
    out = {}
    for dn, B in (("float32", 128), ("bfloat16", 512)):
        dt = getattr(torch, dn)
        h, emb, p_att, weights, mask = make_case(rn, B, dt)
        q = att_step.quantize_features(emb, p_att)
        for name, fn, ctx, plain in (
                ("A", att_step.attention_kernel, (emb, p_att),
                 att_step.attention_reference),
                ("D", att_step.attention_q_kernel, q,
                 att_step.attention_reference_q)):
            got, counts = graph_capture.captured(lib, fn, h, *ctx, *weights,
                                                 mask)
            err = (got.float() - plain(h, *ctx, *weights, mask).float()) \
                .abs().max().item()
            tol = 1e-4 if dt == torch.float32 else 3e-2
            assert err <= tol, f"graph {name} {dn} B={B}: {err}"
            out[f"{name} {dn} B={B}"] = {**counts, "max_abs_err": err}
            print(f"  graph {name} {dn} B={B}: {counts}, max_abs_err "
                  f"{err:.2e}", flush=True)
    return out


def time_shapes(rn, label, tweak=None):
    """{shape: {"A": ms, "E": ms, "D": ms, "att_h": ms, ...}} under the
    current library (and, with `tweak`, under tweak(stream_plan's plan, B),
    a plan with some fields replaced)."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import att_step
    real_plan = att_step.stream_plan
    if tweak:
        def patched(*args):
            return tweak(real_plan(*args), args[0])
        att_step.stream_plan = patched
    out = {}
    try:
        for dn, B, k in SHAPES:
            dt = getattr(torch, dn)
            h, emb, p_att, weights, mask = make_case(rn, B, dt, k=k)
            emb_t = emb.movedim(0, 1).contiguous()
            p_t = p_att.movedim(0, 1).contiguous()
            q = att_step.quantize_features(emb, p_att)
            iters = 10 if B >= 4096 else 20
            row = {
                "A": cuda_ms(lambda: att_step.attention_kernel(
                    h, emb, p_att, *weights, mask), iters),
                "E": cuda_ms(lambda: att_step.attention_kmajor_kernel(
                    h, emb_t, p_t, *weights, mask), iters),
                "D": cuda_ms(lambda: att_step.attention_q_kernel(
                    h, *q, *weights, mask), iters),
                "att_h": cuda_ms(lambda: att_step.att_h_kernel(
                    h, weights[0], weights[1]), iters),
                "addmm": cuda_ms(lambda: torch.addmm(
                    weights[1], h, weights[0]), iters),
                **pre_bound_ms(B, WIDTH, WIDTH, dn)}
            plan = att_step.stream_plan(
                B, k, WIDTH, WIDTH, h.element_size(), False)
            plan_q = att_step.stream_plan(B, k, WIDTH, WIDTH, 1, False)
            row["plan"] = plan._asdict()
            row["plan_q"] = plan_q._asdict()
            row["blocks_per_sm"] = att_step.resident_blocks(
                plan, k, WIDTH, WIDTH, dt)
            row["blocks_per_sm_q"] = att_step.resident_blocks(
                plan_q, k, WIDTH, WIDTH, dt, "attention_q")
            row["A2"] = cuda_ms(lambda: att_step.attention_kernel(
                h, emb, p_att, *weights, mask), iters)
            out[f"{dn} B={B} K={k}"] = row
            print(f"  {label:24s} {dn:8s} B={B:<5d} K={k:<3d} A "
                  f"{row['A']:.4f} ({row['A2']:.4f}) ms  E {row['E']:.4f} ms  "
                  f"D {row['D']:.4f} ms  att_h alone {row['att_h']:.4f} ms "
                  f"(addmm {row['addmm']:.4f}, bound {row['bound_ms']:.4f}) "
                  f"({row['blocks_per_sm']} blocks an SM, D "
                  f"{row['blocks_per_sm_q']}; grid {row['plan']['grid']})",
                  flush=True)
            del h, emb, p_att, emb_t, p_t, q
    finally:
        att_step.stream_plan = real_plan
    return out


def _module_at(root, rel, name):
    """A module of the checkout at `root` by file, under another name."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(root, "cooperativeimagecaptioning_tpu_torch",
                           *rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_ab(rn, other_root, calls=64, reps=31):
    """The host's work of an attention call's C entry point, this checkout's
    library (A) against the one at `other_root` (B), in one process: {shape:
    us of A, of B, their median paired difference, and A's wrapper call}."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import (
        _build, att_step)
    path = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--root", other_root,
         "--build-only"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-1]
    o_build = _module_at(other_root, ("ops", "kernels", "_build.py"),
                         "other_build")
    o_att = _module_at(other_root, ("ops", "kernels", "att_step.py"),
                       "other_att_step")
    other = ctypes.CDLL(path)
    for name in ("cic_attention", "cic_attention_q"):
        getattr(other, name).argtypes = o_build.SIGNATURES[name]
        getattr(other, name).restype = ctypes.c_int
    this = _build.library()
    P = _build.ptr
    out = []
    for dn, B in (("bfloat16", 512), ("bfloat16", 4096), ("float32", 128)):
        dt = getattr(torch, dn)
        h, emb, p_att, weights, mask = make_case(rn, B, dt)
        q = att_step.quantize_features(emb, p_att)
        st = _build.stream(h.device)
        res = torch.empty_like(h)
        ah = torch.empty(B, WIDTH, dtype=torch.float32, device=h.device)
        for entry, ctx, item in (("cic_attention", (emb, p_att),
                                  h.element_size()),
                                 ("cic_attention_q", q, 1)):
            def plan_ints(mod):
                plan = mod.stream_plan(B, K, WIDTH, WIDTH, item, False)
                if hasattr(plan, "dependent"):
                    return (plan.grid, plan.slots, plan.stages,
                            int(plan.dependent))
                return (plan.rows, plan.slots, plan.stages)
            args = {
                "A": (this, plan_ints(att_step)),
                "B": (other, plan_ints(o_att))}

            def call(side):
                lib, ints = args[side]
                return getattr(lib, entry)(
                    P(h), *(P(t) for t in ctx), *(P(w) for w in weights),
                    P(mask), P(ah), P(res), B, K, WIDTH, WIDTH,
                    int(dt == torch.bfloat16), 1, *ints, st)
            for side in "AB":
                code = call(side)
                if code != 0:
                    raise RuntimeError(f"{entry} {dn} B={B} side {side}: "
                                       f"CUDA error {code}")
            kernel = (att_step.attention_kernel if entry == "cic_attention"
                      else att_step.attention_q_kernel)
            t = {"A": [], "B": [], "wrapper": []}
            torch.cuda.synchronize()
            for r in range(reps):
                order = ("A", "B", "wrapper") if r % 2 == 0 else \
                    ("B", "A", "wrapper")
                for side in order:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    if side == "wrapper":
                        for _ in range(calls):
                            kernel(h, *ctx, *weights, mask)
                    else:
                        for _ in range(calls):
                            call(side)
                    t[side].append((time.perf_counter() - t0) * 1e6 / calls)
                    torch.cuda.synchronize()
            diff = sorted(a - b for a, b in zip(t["A"], t["B"]))[reps // 2]
            r = {"entry": entry, "dtype": dn, "B": B,
                 "enqueue_us_A": sorted(t["A"])[reps // 2],
                 "enqueue_us_B": sorted(t["B"])[reps // 2],
                 "enqueue_diff_us": diff,
                 "wrapper_us_A": sorted(t["wrapper"])[reps // 2]}
            out.append(r)
            print(f"  host {entry:16s} {dn:8s} B={B:<5d} enqueue A (this) "
                  f"{r['enqueue_us_A']:.2f} us  B ({other_root}) "
                  f"{r['enqueue_us_B']:.2f} us  A - B {diff:+.2f} us; "
                  f"A's wrapper call {r['wrapper_us_A']:.2f} us", flush=True)
    return out


def turns(other_root, out_path):
    """other_root's times, this checkout's, this checkout's, other_root's:
    four processes in turn; {label: times}."""
    result = {}
    for i, root in enumerate((other_root, HERE, HERE, other_root)):
        label = f"{i}:{'this' if root == HERE else 'other'}"
        path = f"{out_path}.turn{i}.json"
        subprocess.run([sys.executable, os.path.join(HERE, __file__),
                        "--root", root, "--time-only", "--out", path],
                       check=True)
        with open(path) as f:
            result[label] = json.load(f)["times"]["default"]
    print("turns (A / E / D / pre-pass alone, ms; other, this, this, "
          "other):", flush=True)
    for shape in result["0:other"]:
        cells = []
        for key in ("A", "E", "D", "att_h"):
            cells.append(f"{key} " + " / ".join(
                f"{result[lab][shape][key]:.4f}" for lab in result))
        print(f"  {shape:24s} " + "  ".join(cells), flush=True)
    return result


def main():
    global ROOT
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE,
                    help="the checkout whose package is timed")
    ap.add_argument("--turns", default="", metavar="DIR",
                    help="DIR, this, this, DIR: times in four processes")
    ap.add_argument("--time-only", action="store_true",
                    help="skip the checks")
    ap.add_argument("--build-only", action="store_true",
                    help="build the root's att_step library, print its path")
    ap.add_argument("--tanh", default="", help="variants of CIC_ATT_TANH, "
                    "e.g. 0,1,2")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--probe", default="", help="dependent, packed, or "
                    "variants of CIC_ATT_PROBE (bit 0: no score arithmetic, "
                    "bit 1: no weighted sum, bit 2: no copies), e.g. "
                    "dependent,packed,1,2,4")
    ap.add_argument("--host-ab", default="", metavar="DIR",
                    help="the host's work of a call, this library against "
                         "DIR's, instead of the timings")
    ap.add_argument("--repeat", type=int, default=1,
                    help="--probe dependent: rounds of on and off, in "
                         "alternating order")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    ROOT = os.path.abspath(args.root)
    sys.path.insert(0, ROOT)
    out_path = args.out or os.path.join(ROOT, "build",
                                        "att_stream_bench.json")
    import torch
    if not torch.cuda.is_available():
        print("att_stream_bench: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0].strip()
    print(f"card: {smi}; package of {ROOT}", flush=True)
    g = torch.Generator(device="cpu").manual_seed(args.seed)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to("cuda")

    result = {"card": smi, "root": ROOT, "times": {}}
    if args.build_only:
        build_variant("default")
        print(os.path.join(ROOT, "build", "att_bench_default", "libatt.so"))
        return 0
    if args.turns:
        result["turns"] = turns(os.path.abspath(args.turns), out_path)
    else:
        res = build_variant("default")
        result["resources"] = {k: v for k, v in res.items()
                               if "attention_kernel" in k or "att_h" in k}
        for name, r in sorted(result["resources"].items()):
            print(f"  {name}: {r}", flush=True)
        if args.host_ab:
            result["host_ab"] = host_ab(rn, os.path.abspath(args.host_ab))
        else:
            if not args.time_only:
                result["check"] = check(rn)
                result["graphs"] = check_graphs(rn)
            result["times"]["default"] = time_shapes(rn, "default")
    if args.sweep:
        sweeps = {  # label: plan, B -> plan
            "3 blocks an SM": lambda p, B: p._replace(grid=min(B, 396)),
            "3 blocks an SM, 5 stages": lambda p, B: p._replace(
                grid=min(B, 396), stages=5),
            "2 blocks an SM, 8 stages": lambda p, B: p._replace(
                grid=min(B, 264), stages=8),
            "3 stages": lambda p, B: p._replace(stages=3)}
        for label, tweak in sweeps.items():
            try:
                result["times"][label] = time_shapes(rn, label, tweak)
            except (RuntimeError, ValueError) as e:  # a plan refused
                print(f"  {label}: {e}", flush=True)
                torch.cuda.synchronize()
    for mode in [m for m in args.tanh.split(",") if m]:
        build_variant(f"tanh{mode}", (f"-DCIC_ATT_TANH={mode}",))
        result["times"][f"tanh={mode}"] = time_shapes(rn, f"tanh={mode}")
    for mode in [m for m in args.probe.split(",") if m]:
        if mode == "dependent":
            build_variant("default")
            for r in range(args.repeat):
                for dep in (True, False) if r % 2 == 0 else (False, True):
                    label = f"dependent={int(dep)}" + (
                        f" round {r}" if args.repeat > 1 else "")
                    result["times"][label] = time_shapes(
                        rn, label, lambda p, B, dep=dep: p._replace(
                            dependent=dep))
            continue
        if mode == "packed":
            build_variant("packed0", ("-DCIC_ATT_PACKED=0",))
            result["times"]["packed=0"] = time_shapes(rn, "packed=0")
            continue
        build_variant(f"probe{mode}", (f"-DCIC_ATT_PROBE={mode}",))
        result["times"][f"probe={mode}"] = time_shapes(rn, f"probe={mode}")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
