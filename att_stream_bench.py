#!/usr/bin/env python3
"""Times and checks of the attention kernels (A b-major, E K-major, D int8)
on one Hopper GPU, for tuning their stream and for the numbers beside them.

    python3 att_stream_bench.py                 # check, then time the plans
    python3 att_stream_bench.py --tanh 0,1,2    # also the tanh variants
    python3 att_stream_bench.py --sweep         # also rows / slots / stages

Builds only csrc/att_step.cu (and common.cu) with nvcc into
build/att_bench_<variant>/, so a run costs one short compile a variant.
Phases:
  check  -- the pre-pass alone against h @ W + b, and A, E and D against
            their plain versions (f32 and bf16, masked and unmasked, aligned
            and unaligned widths, ragged B, K up to 196).
  time   -- device ms of a wrapper call of A, E and D (and of the pre-pass
            alone) at the shapes the paths run: bf16 B=512, 1024, 4096 and
            f32 B=128, 256, 640 (K=36, H=A=512), and K=196 at bf16 B=512 and
            f32 B=128, timed as chip_smoke.py times (events around calls
            enqueued on a busy card, no L2 flush).
  --tanh -- the same times with the kernel's tanh compiled as the identity
            (0), as tanhf (1) and as the exp form (2): the share of the tanh.
  --sweep - the same times under other plans (rows a block, slots a stage,
            stages) than stream_plan's.
  --probe - the same times with parts of the stream kernel compiled out
            (CIC_ATT_PROBE: 1 the score arithmetic, 2 the weighted sum's, 3
            both: the copies and barriers alone, 4 the copies: the arithmetic
            alone); their results are wrong, only their times count.
Prints one JSON object as its last line and writes it to --out (default
build/att_stream_bench.json).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
K = 36
WIDTH = 512
SHAPES = (("bfloat16", 512, K), ("bfloat16", 1024, K), ("bfloat16", 4096, K),
          ("float32", 128, K), ("float32", 256, K), ("float32", 640, K),
          ("bfloat16", 512, 196), ("float32", 128, 196))


def build_variant(tag, flags=()):
    """Compile att_step.cu + common.cu into build/att_bench_<tag>/ and make
    it the library the wrappers launch."""
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _build
    out_dir = os.path.join(REPO, "build", f"att_bench_{tag}")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "libatt.so")
    t0 = time.perf_counter()
    cmd = [_build.nvcc_path(), *_build.COMPILE_FLAGS, *flags, "-shared",
           f"-I{_build.CSRC}", "-o", lib_path,
           str(_build.CSRC / "att_step.cu"), str(_build.CSRC / "common.cu")]
    done = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{done.stdout}")
    lib = ctypes.CDLL(lib_path)
    for name, argtypes in _build.SIGNATURES.items():
        if name.startswith("cic_att"):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.cic_error_string.argtypes = [ctypes.c_int]
    lib.cic_error_string.restype = ctypes.c_char_p
    _build._lib = lib
    res = _build.kernel_resources(done.stdout)
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


def check(rn):
    """Largest errors of the pre-pass, A, E and D over a set of shapes;
    raises on a miss (f32 1e-4, bf16 3e-2; the pre-pass 1e-5 / 3e-2)."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import (
        _dispatch, att_step)
    worst = {}
    cases = [(512, WIDTH, WIDTH, K), (4099, WIDTH, WIDTH, K),
             (13, 96, 80, 6), (9, 96, 80, 64), (8, 96, 80, 1),
             (37, 100, 72, 5), (33, 97, 83, 7), (140, 1024, 256, 36),
             (3, 4000, 64, 3), (64, WIDTH, WIDTH, 196), (5, 40, 40, 196),
             (3, 96, 80, 256)]
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
    print("check: " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()),
          flush=True)
    return worst


def time_shapes(rn, label, plan_override=None):
    """{shape: {"A": ms, "E": ms, "D": ms, "att_h": ms}} under the current
    library (and, with plan_override, under stream_plan's result with those
    fields replaced)."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import att_step
    real_plan = att_step.stream_plan
    if plan_override:
        def patched(*args):
            return real_plan(*args)._replace(**plan_override)
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
                    h, weights[0], weights[1]), iters)}
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
                  f"D {row['D']:.4f} ms  att_h alone {row['att_h']:.4f} ms  "
                  f"({row['blocks_per_sm']} blocks an SM, D "
                  f"{row['blocks_per_sm_q']}; grid {row['plan']['grid']})",
                  flush=True)
            del h, emb, p_att, emb_t, p_t, q
    finally:
        att_step.stream_plan = real_plan
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tanh", default="", help="variants of CIC_ATT_TANH, "
                    "e.g. 0,1,2")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--probe", default="", help="variants of CIC_ATT_PROBE "
                    "(bit 0: no score arithmetic, bit 1: no weighted sum, "
                    "bit 2: no copies), e.g. 1,2,3,4")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--out", default=os.path.join(REPO, "build",
                                                  "att_stream_bench.json"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("att_stream_bench: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0].strip()
    print(f"card: {smi}", flush=True)
    g = torch.Generator(device="cpu").manual_seed(args.seed)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to("cuda")

    result = {"card": smi, "times": {}}
    res = build_variant("default")
    result["resources"] = {k: v for k, v in res.items()
                           if "attention_kernel" in k or "att_h" in k}
    for name, r in sorted(result["resources"].items()):
        print(f"  {name}: {r}", flush=True)
    result["check"] = check(rn)
    result["times"]["default"] = time_shapes(rn, "default")
    if args.sweep:
        for override in ({"stages": 3}, {"stages": 6}, {"stages": 8},
                         {"slots": 4}, {"slots": 4, "stages": 8},
                         {"rows": 1}, {"rows": 2}, {"rows": 8}):
            label = ",".join(f"{k}={v}" for k, v in override.items())
            try:
                result["times"][label] = time_shapes(rn, label, override)
            except RuntimeError as e:  # a plan the launch refuses
                print(f"  {label}: {e}", flush=True)
                torch.cuda.synchronize()
    for mode in [m for m in args.tanh.split(",") if m]:
        build_variant(f"tanh{mode}", (f"-DCIC_ATT_TANH={mode}",))
        result["times"][f"tanh={mode}"] = time_shapes(rn, f"tanh={mode}")
    for mode in [m for m in args.probe.split(",") if m]:
        build_variant(f"probe{mode}", (f"-DCIC_ATT_PROBE={mode}",))
        result["times"][f"probe={mode}"] = time_shapes(rn, f"probe={mode}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
