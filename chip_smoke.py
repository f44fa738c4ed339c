#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one Hopper GPU (H100).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device   -- a CUDA device of capability 9.0; prints the card's name and
                 power limit (nvidia-smi).
  2. build    -- builds the hand-written kernels from the package's csrc/
                 with nvcc (timed) and prints the registers, stack and
                 spills ptxas reports for the heads' tensor-core pass, the
                 attention's pre-pass and stream kernels and the cell's two
                 kernels (no spill allowed).
  3. kernels  -- each kernel against its plain PyTorch version on the card,
                 at the shapes the paths give it, in float32 and bfloat16:
                 attention (masked and unmasked; the b-major, the int8 and
                 the K-major kernels at the training step's B=128, the
                 service's B=512, 4096 and beam-expanded R=1024 and at the
                 evaluation's R=256 and 640 rows, all at K=36, and at K=196,
                 the repo's own 14 x 14 feature grid, at B=128 and 512; the
                 b-major and the K-major kernel timed at bf16 B=512, 1024,
                 4096 and f32 B=128, 256, 640 and bf16 B=512 K=196, the int8
                 kernel beside them at bf16 B=512, 4096, B=512 K=196 and f32
                 B=128; their att_h pre-pass alone against h @ W + b and
                 timed; every such launch must take the 16-byte vector width;
                 the int8 kernel at H=A=40 must take width 1),
                 the quantizer on the card against the same function on the
                 CPU, greedy head and beam head (random rows and rows with
                 exact ties planted at every seam of the tensor-core pass's
                 merge, which must resolve to the lower id: greedy at B=512,
                 4096 and 300 rows; beam kk = 2, 3, 6, 16 at R=1024 and kk = 2
                 at the evaluation's R=256, at 300 and at 8192 rows, and kk =
                 17, 32, 64 at R=1024, in rounds of 16, with a group of 24
                 tied ids across the rounds' seam; every bf16 launch must
                 take the tensor-core pass, every f32 launch the FMA pass).
                 Each check prints its maximum error beside its tolerance;
                 each kernel is timed beside its plain version.  The fused
                 maxout-LSTM cell (kernel F, CIC_FUSED_CELL=1) against its
                 plain version with and without attention, f32 at B=128 and
                 f32 / bf16 at B=512, 4096 and 130 (a partial row tile),
                 bf16 on the tensor-core kernel and f32 on the FMA kernel;
                 the attention's autograd Function (kernel forward,
                 recomputed backward; the b-major and the int8 call) against
                 plain autograd, f32 at B=128.  Every timed shape gets its own
                 bound: the larger of its bytes over the card's memory rate
                 and its operations over the card's peak rate.  The heads are
                 timed at B=512 and 4096 (greedy) and R=1024 and 8192 (beam,
                 kk=2), each beside torch.matmul of h @ w alone, a yardstick
                 the port never calls.
  4. slice    -- writes a full-width run dir (Att2in2, vocab 9487, 512-wide,
                 K=36, L=16, random weights from a numpy seed), serves it
                 through CaptioningService.from_run_dir + warmup +
                 make_http_server (greedy and beam 2, bf16), checks the
                 answers and that every request went through the kernels
                 (launch counts; every head launch of a bf16 service on the
                 tensor-core pass, of an f32 service on the FMA pass),
                 compares the CUDA services with CPU
                 services (plain versions) in float32 and in bfloat16, and
                 times captions/s.  Then the same for the two other decode
                 layouts of the attention context, att_quant="int8" and
                 att_kmajor=1 (every step through their own attention
                 kernel, none through the b-major one), their ids against the
                 b-major and the CPU services in float32, captions/s of the
                 three layouts side by side, and the device memory of a
                 bucket-4096 request in bf16 and int8.  Then services through
                 from_run_dir(max_att_len=196) fed 196-slot features (greedy
                 and beam 2, bf16 and f32; every step through the attention
                 kernel; f32 ids against the CPU service's), and a run dir
                 whose checkpoint lacks a leaf, which from_run_dir must
                 report and fill.  CIC_FUSED_CELL is unset here (the
                 default: the cell is the plain version).
  5. training -- phase-2 MLE training at full width through
                 training.loop.train / Trainer over the shared
                 SyntheticDataset (f32, B=128, drop_prob_lm 0.5), with
                 CIC_FUSED_CELL=1: the attention and cell launch counts of
                 three steps (2*T each per step: forward, and the
                 checkpointed recompute in backward); the first step at
                 B=16 on the card against the same step on the CPU port
                 (loss and every gradient leaf); the loss falling over 20
                 steps on one batch; it/s with and without the cell kernel;
                 and the trained speaker served once (greedy, bucket 512).
  6. evaluation -- the trained speaker's run dir through eval.eval (the
                 final-eval protocol: beam 2, language metrics, the test
                 split of a SyntheticDataset) and Evaluator.eval_split on the
                 card, once each with the b-major, the int8 and the K-major
                 context: one prediction per image, finite loss and metrics,
                 the launch counts the batch count and L give, the batches
                 drained inside the loop (twelve batches a split, four in
                 flight), the evaluator's timings and images/s.  Then the
                 first batches on the card against the CPU port, beam 2:
                 the captions and loss_cap of phase 4's random-weight
                 speaker with each layout, and of the trained speaker.
Two lines before the last name the card and describe the kernels (one JSON
object); the last line is {"ok": true, "device": {...}}.

Imports no JAX.  Writes only under build/ in the checkout.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import pickle
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
RUN_DIR = os.path.join(REPO, "build", "chip_smoke_run")
TRAIN_RUN_DIR = os.path.join(REPO, "build", "chip_smoke_train_run")
SEED = 1234
VOCAB = 9487
L = 16
K = 36
FEAT = 2048
WIDTH = 512

ATT_SRC = "cooperativeimagecaptioning_tpu_torch/csrc/att_step.cu"
GREEDY_SRC = "cooperativeimagecaptioning_tpu_torch/csrc/logit_head.cu"
BEAM_SRC = "cooperativeimagecaptioning_tpu_torch/csrc/beam_head.cu"
CELL_SRC = "cooperativeimagecaptioning_tpu_torch/csrc/cell_step.cu"
REPLACES = {
    "attention": "cooperativeimagecaptioning_tpu/ops/pallas/att_step.py:130",
    "attention_q":
        "cooperativeimagecaptioning_tpu/ops/pallas/att_step.py:192",
    "attention_kmajor":
        "cooperativeimagecaptioning_tpu/ops/pallas/att_step.py:348",
    "greedy_head":
        "cooperativeimagecaptioning_tpu/ops/pallas/logit_head.py:138",
    "beam_head": "cooperativeimagecaptioning_tpu/ops/pallas/beam_head.py:58",
    "cell": "cooperativeimagecaptioning_tpu/ops/pallas/cell_step.py:75",
}
SOURCES = {"attention": ATT_SRC, "attention_q": ATT_SRC,
           "attention_kmajor": ATT_SRC, "greedy_head": GREEDY_SRC,
           "beam_head": BEAM_SRC, "cell": CELL_SRC}
# the attention kernel each decode layout of the context must go through
LAYOUTS = {"b-major": ({}, "attention"),
           "int8": ({"att_quant": "int8"}, "attention_q"),
           "k-major": ({"att_kmajor": 1}, "attention_kmajor")}
# slots of the repo's own feature grid (preprocess/feats.py: 14 x 14)
K_GRID = 196
# (type, rows, slots) at which kernels A and E are timed, and D beside them
ATT_TIMED = (("bfloat16", 512, K), ("bfloat16", 1024, K),
             ("bfloat16", 4096, K), ("float32", 128, K), ("float32", 256, K),
             ("float32", 640, K), ("bfloat16", 512, K_GRID))
ATT_Q_TIMED = (("bfloat16", 512, K), ("bfloat16", 4096, K),
               ("float32", 128, K), ("bfloat16", 512, K_GRID))
TRAIN_B = 128        # scripts/bench_train.py's batch
TRAIN_IMAGES = 256   # synthetic images (153 in the train split)
LEARN_STEPS = 20
EVAL_IMAGES = 3840   # synthetic images of the evaluation: 1536 in each of the
EVAL_B = 128         # val and test splits (0.2 / 0.4 / 0.4), 12 batches of 128
EVAL_R = 2 * EVAL_B  # rows of the evaluation's beam-2 decode
EVAL_ROWS = 5 * EVAL_B  # rows of its loss: five captions an image
EVAL_CPU_BATCHES = 2
DEVICE = "cuda"

# The card's published peaks (NVIDIA's H100 SXM data sheet, dense): device
# memory rate, and operations per second by input type (bf16 on the tensor
# cores, f32 outside them).  A kernel's bound is the larger of its bytes over
# the first and its operations over the second.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

# Tolerances (kernel vs plain version on the same inputs, max abs error):
#  attention out: f32 differs only by summation order -> 1e-4; bf16 output
#    is rounded to bf16 on both sides, so 1-2 bf16 ulps at |x| < 4 -> 3e-2.
#  head logprob / logit / logsumexp outputs are f32 on both sides, from the
#    same inputs with f32 accumulation: summation order only -> 1e-4.
#  head ids: equal, except where the plain logits of the two ids are within
#    1e-4 (a near-tie that summation order may flip); planted exact ties
#    must be equal.
#  cell h', c': the same rule as the attention (f32: summation order only;
#    bf16: both sides round the f32 result) -> 1e-4 / 3e-2.
#  gradients (kernel forward + recomputed plain backward vs plain autograd,
#    f32): relative to the largest gradient entry, 1e-4.
#  the int8 and K-major attention kernels: the attention's rule, each
#    against its own plain version on the same (quantized, transposed) inputs.
#  quantize_features on the card vs the CPU: int8 values equal, scales to a
#    relative 1e-6 (the same IEEE division and rounding on both).
#  the attention's pre-pass (att_h = h @ W + b as f32) against the same
#    product in f32 through torch: summation order only -> 1e-5 (f32); bf16
#    inputs are exact in f32 and the sums are f32 on both sides, held to the
#    bf16 tolerance of the call -> 3e-2 (observed ~3e-6).
TOL = {("attention", "float32"): 1e-4, ("attention", "bfloat16"): 3e-2,
       ("att_h", "float32"): 1e-5, ("att_h", "bfloat16"): 3e-2,
       ("cell", "float32"): 1e-4, ("cell", "bfloat16"): 3e-2,
       "head": 1e-4, "grad": 1e-4}
# CUDA vs CPU port, the first training step at B=16 (f32, no TF32, dropout
# off so both draw nothing): loss to a relative 1e-4; every gradient leaf
# elementwise within atol + rtol * |cpu| -- the two devices sum in other
# orders over B and the 17 steps.
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_RTOL = 1e-3
STEP_GRAD_ATOL = 1e-5
# Rows of ids equal between the CUDA service and the CPU service (the plain
# versions) on one 64-image request.  In f32 only near-tie flips under
# another summation order may differ.  In bf16 both sides round at the same
# points, but a 1-ulp difference in a rounded activation can flip a later
# word, and the rest of the row with it: an H100 gave 98.4% (greedy) and
# 92.2% (beam 2) on this request.  The K-major service does the b-major
# service's arithmetic on another layout, and the int8 service on the card
# the int8 CPU service's: both are held to the f32 rule.
AGREE_F32 = 0.99
AGREE_BF16 = 0.85
# loss_cap of the evaluation on the card vs the CPU port, same batches, f32
EVAL_LOSS_RTOL = 1e-4


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


@contextlib.contextmanager
def fused_cell_switch(on):
    """Set (on) or unset CIC_FUSED_CELL, the JAX package's switch for the
    fused cell, for the block; restore it after."""
    old = os.environ.pop("CIC_FUSED_CELL", None)
    if on:
        os.environ["CIC_FUSED_CELL"] = "1"
    try:
        yield
    finally:
        os.environ.pop("CIC_FUSED_CELL", None)
        if old is not None:
            os.environ["CIC_FUSED_CELL"] = old


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    require(torch.cuda.is_available(), "no CUDA device is available")
    cap = torch.cuda.get_device_capability(0)
    require(cap == (9, 0), f"needs a Hopper card (capability 9.0), got {cap}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0].strip()
    print(f"card: {smi}", flush=True)
    return smi


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

def phase_build():
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _build
    info = _build.build()
    _build.library()
    how = "compiled" if info["compiled"] else "up to date"
    print(f"build: {how} from {os.path.relpath(str(_build.CSRC), REPO)}/ "
          f"for sm_90a in {info['seconds']:.1f} s -> "
          f"{os.path.relpath(info['path'], REPO)}", flush=True)
    # what ptxas gave the tensor-core pass: KK is the top-list length
    for name, res in sorted(info["resources"].items()):
        if "vocab_partials_mma" in name:
            kk = name.split("vocab_partials_mmaILi")[1].split("E")[0]
            src = "logit_head_mma" if "logit_head_mma" in name else \
                "beam_head_mma"
            print(f"  {src} vocab_partials_mma<KK={kk}>: {res['registers']} "
                  f"registers, {res['stack_bytes']} bytes of stack, "
                  f"{res['spill_bytes']} bytes spilled", flush=True)
            require(res["spill_bytes"] == 0, f"{name} spills registers")
    # the attention's pre-pass and stream kernels (template arguments as
    # mangled: type, vector width, columns a thread, layout) and the cell's
    # two kernels (mma: warps along the rows; fma: type, asynchronous fill)
    for name, res in sorted(info["resources"].items()):
        for src, kernel in (("att_step", "att_h_mma_kernel"),
                            ("att_step", "att_h_fma_kernel"),
                            ("att_step", "attention_kernel"),
                            ("cell_step", "cell_mma_kernel"),
                            ("cell_step", "cell_fma_kernel")):
            if kernel in name:
                args = name.split(kernel)[1].split("EEv")[0]
                print(f"  {src} {kernel}<{args}>: {res['registers']} "
                      f"registers, {res['stack_bytes']} bytes of stack, "
                      f"{res['spill_bytes']} bytes spilled", flush=True)
                require(res["spill_bytes"] == 0, f"{name} spills registers")


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------

def cuda_ms(fn, iters):
    """Device time of one fn() in ms: CUDA events around `iters` calls that
    were enqueued while the card was still busy with earlier work (a few
    milliseconds of matrix products), so that the host's time to enqueue a
    call -- tens of microseconds for a wrapper that allocates and launches
    twice -- is not counted where the call's kernels take less than that."""
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


def timed_pair(kernel_fn, plain_fn, iters=20):
    """(kernel ms, plain ms), measured in turns: plain, kernel, kernel,
    plain."""
    p1 = cuda_ms(plain_fn, iters)
    k1 = cuda_ms(kernel_fn, iters)
    k2 = cuda_ms(kernel_fn, iters)
    p2 = cuda_ms(plain_fn, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound_ms(tensors, ops, dtype_name):
    """(bound in ms, "bytes" or "operations"): the least time the card could
    take for a call that reads each input and writes each output in `tensors`
    once and does `ops` operations on inputs of `dtype_name`."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors
                 if t is not None)
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = ops / PEAK_OPS_PER_S[dtype_name]
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def attention_ops(B, H, A, k=K):
    """att_h (2*H*A a row), scores (add, tanh, multiply-add: 4*A a slot) and
    the weighted sum (2*H a slot)."""
    return 2 * B * H * A + B * k * (4 * A + 2 * H)


def report(name, what, err, tol):
    ok = err <= tol
    print(f"  {name:12s} {what:40s} max_abs_err {err:.3e}  tol {tol:.0e}  "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    require(ok, f"{name} {what}: max abs error {err} above {tol}")


def ids_agree(name, what, ids_k, ids_p, logits, tol):
    """Kernel ids must equal the plain ids, except at near-ties of the plain
    f32 logits (|logit[id_k] - logit[id_p]| <= tol)."""
    import torch
    diff = ids_k.long() != ids_p.long()
    n = int(diff.sum())
    if n:
        lk = torch.gather(logits, 1, ids_k.long().reshape(logits.shape[0], -1))
        lp = torch.gather(logits, 1, ids_p.long().reshape(logits.shape[0], -1))
        gap = (lk - lp).abs().reshape(diff.shape)[diff].max().item()
        require(gap <= tol, f"{name} {what}: {n} ids differ, not near-ties "
                f"(logit gap {gap})")
    print(f"  {name:12s} {what:40s} ids differing {n} (near-ties only)",
          flush=True)


def plant_ties(w, b):
    """Zero W's columns at the tie ids and give them equal biases: their
    logits are exact ties in any summation order.  The ids sit at the seams
    of the tensor-core pass's merge, for every grid this script gives it
    (vocab splits of 256 to 4864 columns): 2 and 3 are one thread's two
    adjacent accumulator columns, 4 another lane of the same quad, 130 the
    same lane in the block's next 128-column tile, 5000 another vocab split,
    and V the last column of the ragged last tile.  Expected order of the
    top 8 for every row: [2, 3, 4, 130, 5000, V, 5, 4000]."""
    V1 = w.shape[1]
    top = [2, 3, 4, 130, 5000, V1 - 1]
    nxt = [5, 4000]
    for c in top + nxt:
        w[:, c] = 0
    b[top] = 10.0
    b[nxt] = 9.0
    return top + nxt


def plant_tie_group(w, b):
    """Zero 24 of W's columns and give them one bias: a group of exact ties
    longer than a round of the beam head (16), holding the seams of
    `plant_ties` (2, 3, 4, 130, 5000, V) and ids on both sides of the round
    seam.  Expected order of the top 24 for every row: the ids sorted."""
    V1 = w.shape[1]
    group = sorted({2, 3, 4, 130, 5000, V1 - 1, 17, 18, 300, 301, 1024,
                    2047, 2048, 3000, 4095, 4096, 6000, 7000, 7001, 8191,
                    8192, 9000, 9100, 9200})
    for c in group:
        w[:, c] = 0
    b[group] = 10.0
    return group


# beam widths above the longest list of a round (kk 17 to 64: rounds of 16)
BEAM_LONG_KK = (17, 32, 64)


def head_passes_moved(before):
    """The per-pass head launch counts that moved since `before`."""
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    after = _dispatch.head_pass_launches()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def att_widths_moved(before):
    """The per-width launch counts of the dense attentions that moved since
    `before`."""
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    after = _dispatch.att_width_launches()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def require_vector_width(what, launches):
    """Every launch of the three attention kernels since the last reset took
    the 16-byte vector width (`launches`: _dispatch.launches())."""
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    widths = _dispatch.att_width_launches()
    for k in ("attention", "attention_kmajor", "attention_q"):
        require(widths[f"{k}_vec"] == launches[k]
                and widths[f"{k}_scalar"] == 0,
                f"{what}: every {k} launch at H=A={WIDTH} must take the "
                f"vector width, counted {widths} of {launches[k]} launches")


def check_heads(rn, dt, errs):
    """Kernels B and C against their plain versions in type `dt`, random rows
    and rows with planted exact ties, at every row count a path gives them
    and a few it does not: greedy at the buckets 512 and 4096 and at 300 rows
    (no multiple of the 64-row warpgroup tile); beam at the service's R=1024
    (kk 2, 3, 6 and the longest list, 16), the evaluation's R=256, 300 rows,
    and the 8192 rows of a beam-2 bucket of 4096.  Each launch must take the
    first pass its type asks for: the tensor-core pass in bf16, the FMA pass
    in f32 (the per-pass launch counts).  Returns (w, b) for the timings."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import (
        _dispatch, beam_head, logit_head)
    dn = str(dt).split(".")[-1]
    first_pass = "mma" if dt == torch.bfloat16 else "fma"
    H, V1, R = WIDTH, VOCAB + 1, 1024

    def launch(head, fn):
        before = _dispatch.head_pass_launches()
        out = fn()
        torch.cuda.synchronize()
        moved = head_passes_moved(before)
        require(moved == {f"{head}_{first_pass}": 1},
                f"{head} {dn}: expected one launch on the {first_pass} pass, "
                f"counted {moved}")
        return out

    w = rn(H, V1, scale=0.1).to(dt)
    b = rn(V1, scale=0.1).to(dt)
    wt, bt = w.clone(), b.clone()
    planted = plant_ties(wt, bt)
    wg, bg = w.clone(), b.clone()
    group = plant_tie_group(wg, bg)
    for kk in BEAM_LONG_KK:
        # beam widths above 16 (rounds), random rows and the tie group
        for ww, bb, what in ((w, b, "random"), (wg, bg, "tie group")):
            hb = rn(R, H, scale=0.5).to(dt)
            logits_b = logit_head.logits_f32(hb, ww, bb)
            vals, idx, lse = launch(
                "beam_head", lambda: beam_head.beam_head(hb, ww, bb, kk))
            vals_p, idx_p, lse_p = beam_head.beam_head_reference(
                hb, ww, bb, kk)
            require(vals.shape == idx.shape == (R, kk),
                    "beam head output shapes")
            err = max((vals - vals_p).abs().max().item(),
                      (lse - lse_p).abs().max().item())
            errs["beam_head"] = max(errs["beam_head"], err)
            report("beam_head", f"{dn} {what} R={R} kk={kk} vals/lse", err,
                   TOL["head"])
            if what == "tie group":
                n = min(kk, len(group))
                want = torch.tensor(group[:n], dtype=torch.int32,
                                    device=idx.device)
                require(bool((idx[:, :n] == want[None]).all()),
                        f"beam head kk={kk}: the tie group across the "
                        f"rounds' seam not in lower-id order")
            ids_agree("beam_head", f"{dn} {what} R={R} kk={kk} ids", idx,
                      idx_p, logits_b, TOL["head"])
            del hb, logits_b
    del wg, bg
    for ww, bb, what in ((w, b, "random"), (wt, bt, "planted ties")):
        for rows in (512, 4096, 300):
            h = rn(rows, H, scale=0.5).to(dt)
            logits = logit_head.logits_f32(h, ww, bb)
            it, lp = launch("greedy_head",
                            lambda: logit_head.greedy_head(h, ww, bb))
            it_p, lp_p = logit_head.greedy_head_reference(h, ww, bb)
            require(it.dtype == torch.int32 and lp.dtype == torch.float32
                    and it.shape == lp.shape == (rows,),
                    "greedy head output types/shapes")
            err = (lp - lp_p).abs().max().item()
            errs["greedy_head"] = max(errs["greedy_head"], err)
            report("greedy_head", f"{dn} {what} B={rows} lp", err,
                   TOL["head"])
            if what == "planted ties":
                require(bool((it == planted[0]).all()),
                        "greedy head: planted tie not resolved to the lower "
                        "id")
                require(bool((it == it_p).all()), "greedy head ids (ties)")
            ids_agree("greedy_head", f"{dn} {what} B={rows} ids", it, it_p,
                      logits, TOL["head"])
        for rows, kk in ((R, 2), (R, 3), (R, 6), (R, 16), (EVAL_R, 2),
                         (300, 2), (8192, 2)):
            hb = rn(rows, H, scale=0.5).to(dt)
            logits_b = logit_head.logits_f32(hb, ww, bb)
            vals, idx, lse = launch(
                "beam_head", lambda: beam_head.beam_head(hb, ww, bb, kk))
            vals_p, idx_p, lse_p = beam_head.beam_head_reference(
                hb, ww, bb, kk)
            require(vals.shape == idx.shape == (rows, kk)
                    and lse.shape == (rows,), "beam head output shapes")
            err = max((vals - vals_p).abs().max().item(),
                      (lse - lse_p).abs().max().item())
            errs["beam_head"] = max(errs["beam_head"], err)
            report("beam_head", f"{dn} {what} R={rows} kk={kk} vals/lse",
                   err, TOL["head"])
            if what == "planted ties":
                n = min(kk, len(planted))
                want = torch.tensor(planted[:n], dtype=torch.int32,
                                    device=idx.device)
                require(bool((idx[:, :n] == want[None]).all()),
                        f"beam head kk={kk}: planted ties not in "
                        f"lower-id order")
                require(bool((idx[:, :n] == idx_p[:, :n]).all()),
                        f"beam head kk={kk} ids (ties)")
            ids_agree("beam_head", f"{dn} {what} R={rows} kk={kk} ids",
                      idx, idx_p, logits_b, TOL["head"])
            del hb, logits_b, vals_p, idx_p, lse_p
    return w, b


def time_heads(rn, w, b):
    """bf16 times of B (buckets 512 and 4096) and C (kk=2 at R=1024 and at
    the 8192 rows of a beam-2 bucket of 4096; kk=32, two rounds, at
    R=1024), each beside its plain version,
    its bound, and `h @ w` alone through torch.matmul: a yardstick for the
    product inside the kernel, which the port never calls for the heads;
    and the wrapper call on the host's clock, back to back on an idle card
    (`call_ms`: what a decode loop pays where enqueueing takes longer than
    the kernels).  Returns {(kernel, rows, kk): {"ms", "plain_ms",
    "bound_ms", "bound_by", "matmul_ms", "call_ms"}}."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import (
        beam_head, logit_head)
    H, V1 = w.shape
    out = {}
    for name, rows, kk in (("greedy_head", 512, 1), ("greedy_head", 4096, 1),
                           ("beam_head", 1024, 2), ("beam_head", 8192, 2),
                           ("beam_head", 1024, 32)):
        h = rn(rows, H, scale=0.5).to(w.dtype)
        iters = 20 if rows <= 1024 else 10
        if name == "greedy_head":
            def kernel():
                return logit_head.greedy_head(h, w, b)

            def plain():
                return logit_head.greedy_head_reference(h, w, b)
            outs = (torch.empty(rows, dtype=torch.int32),
                    torch.empty(rows, dtype=torch.float32))
        else:
            def kernel():
                return beam_head.beam_head(h, w, b, kk)

            def plain():
                return beam_head.beam_head_reference(h, w, b, kk)
            outs = (torch.empty(rows, kk), torch.empty(rows, kk).int(),
                    torch.empty(rows))
        pair = timed_pair(kernel, plain, iters)
        bound = bound_ms((h, w, b) + outs, 2 * rows * H * V1, "bfloat16")
        mm = cuda_ms(lambda: h @ w, iters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            kernel()
        torch.cuda.synchronize()
        call = (time.perf_counter() - t0) * 1e3 / iters
        out[name, rows, kk] = {"ms": pair[0], "plain_ms": pair[1],
                               "bound_ms": bound[0], "bound_by": bound[1],
                               "matmul_ms": mm, "call_ms": call}
        print(f"  time {name:12s} bf16 rows={rows:<5d} kk={kk:<2d} kernel "
              f"{pair[0]:.4f} ms  plain {pair[1]:.4f} ms  bound "
              f"{bound[0]:.4f} ms "
              f"({bound[1]}; {pair[0] / bound[0]:.1f}x)  h @ w alone "
              f"{mm:.4f} ms  wrapper on the host's clock {call:.4f} ms",
              flush=True)
        del h
    return out


def phase_kernels():
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import (
        _dispatch, att_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(SEED)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    B, R, H, A = 512, 1024, WIDTH, WIDTH
    errs = {k: 0.0 for k in _dispatch.KERNELS}
    # times / bounds: one shape a kernel, the `kernels` line's; shapes: every
    # timed shape of a kernel, each with its own bound
    times, bounds, shapes = {}, {}, {k: [] for k in _dispatch.KERNELS}
    print("kernels vs plain versions (serving shapes: B=512, K=36, "
          "H=A=512, V+1=9488, R=1024 beam rows)", flush=True)
    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).split(".")[-1]
        h = rn(B, H, scale=0.5).to(dt)
        emb = rn(B, K, H).relu().to(dt)
        p_att = rn(B, K, A).to(dt)
        wh = rn(H, A, scale=H ** -0.5).to(dt)
        bh = rn(A, scale=0.05).to(dt)
        wa = rn(A, 1, scale=A ** -0.5).to(dt)
        ba = rn(1, scale=0.05).to(dt)
        mask = torch.ones(B, K, device=dev)
        mask[::3, 20:] = 0.0   # a third of the rows partly masked
        mask[1::7, 1:] = 0.0   # some with a single valid slot
        for mk, what in ((mask, "masked"), (None, "unmasked")):
            out = att_step.fused_attention(h, emb, p_att, wh, bh, wa, ba, mk)
            torch.cuda.synchronize()
            ref = att_step.attention_reference(h, emb, p_att, wh, bh, wa, ba,
                                               mk)
            require(out.dtype == dt and out.shape == (B, H),
                    "attention output type/shape")
            err = (out.float() - ref.float()).abs().max().item()
            errs["attention"] = max(errs["attention"], err)
            report("attention", f"{dn} {what}", err,
                   TOL[("attention", dn)])

        w, b = check_heads(rn, dt, errs)

        if dt == torch.bfloat16:  # serving dtype: time the heads
            for (name, rows, kk), t in time_heads(rn, w, b).items():
                label = f"bf16 rows={rows}" + (f" kk={kk}" if kk > 2 else "")
                shapes[name].append({"shape": label, **t})
                if (name, rows, kk) in (("greedy_head", B, 1),
                                        ("beam_head", R, 2)):
                    times[name] = (t["ms"], t["plain_ms"])
                    bounds[name] = (t["bound_ms"], t["bound_by"])
        del w, b
    errs["cell"], times["cell"], bounds["cell"] = check_cell(rn, shapes)
    errs["attention"] = max(errs["attention"],
                            check_attention_grad(rn))
    check_attention_variants(rn, errs, times, bounds, shapes)
    torch.cuda.synchronize()
    return errs, times, bounds, shapes


def timed_shape(shape, pair, bound):
    """One entry of a kernel's list of timed shapes."""
    return {"shape": shape, "ms": pair[0], "plain_ms": pair[1],
            "bound_ms": bound[0], "bound_by": bound[1]}


def cell_args(rn, B, dt, with_att):
    H = D = WIDTH
    args = [rn(B, D), rn(B, H, scale=0.5), rn(B, H),
            rn(B, H) if with_att else None,
            rn(D, 5 * H, scale=D ** -0.5), rn(5 * H, scale=0.1),
            rn(H, 5 * H, scale=H ** -0.5), rn(5 * H, scale=0.1),
            rn(H, 2 * H, scale=H ** -0.5) if with_att else None,
            rn(2 * H, scale=0.1) if with_att else None]
    return [None if x is None else x.to(dt) for x in args]


def check_cell(rn, shapes):
    """Kernel F against cell_plain (cell_reference in f32 on the same
    inputs), with attention (Att2in2) and without (FC), at the training
    shape (f32, B=128), the decode buckets (f32 and bf16, B=512 and 4096)
    and a partial row tile (B=130); every bf16 launch must take the
    tensor-core kernel, every f32 launch the FMA kernel.  Each
    with-attention case but B=130 is timed beside cell_reference in the
    inputs' type, the cell that runs with CIC_FUSED_CELL unset, and gets its
    own bound (appended to shapes["cell"]).  Returns (max error, (kernel ms,
    plain ms) at the training shape, its bound)."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import (
        _dispatch, cell_step)
    f32, bf16 = torch.float32, torch.bfloat16
    print("cell (kernel F) vs its plain version (D=H=512; CIC_FUSED_CELL=1)",
          flush=True)
    worst, timed, bound = 0.0, {}, {}
    with fused_cell_switch(True):
        for B, dts in ((TRAIN_B, (f32,)), (512, (f32, bf16)),
                       (4096, (f32, bf16)), (130, (f32, bf16))):
            for dt in dts:
                dn = str(dt).split(".")[-1]
                for with_att in (True, False):
                    args = cell_args(rn, B, dt, with_att)
                    before = _dispatch.cell_pass_launches()
                    h_new, c_new = cell_step.fused_cell(*args)
                    torch.cuda.synchronize()
                    which = "cell_mma" if dt == bf16 else "cell_fma"
                    after = _dispatch.cell_pass_launches()
                    require(after[which] - before[which] == 1,
                            f"cell {dn} B={B}: expected one launch of "
                            f"{which}, counted {after} (before {before})")
                    h_p, c_p = cell_step.cell_plain(*args)
                    require(h_new.dtype == dt and c_new.shape == (B, WIDTH),
                            "cell output type/shape")
                    err = max((h_new.float() - h_p.float()).abs().max()
                              .item(), (c_new.float() - c_p.float()).abs()
                              .max().item())
                    worst = max(worst, err)
                    what = f"{dn} B={B} {'att2in2' if with_att else 'fc'}"
                    report("cell", what, err, TOL[("cell", dn)])
                    if with_att and B != 130:
                        timed[(B, dn)] = timed_pair(
                            lambda: cell_step.fused_cell(*args),
                            lambda: cell_step.cell_reference(*args))
                        # three products: [B,D]x[D,5H], [B,H]x[H,5H] and
                        # [B,H]x[H,2H]
                        bound[(B, dn)] = bound_ms(
                            args + [h_new, c_new],
                            2 * B * WIDTH * (5 + 5 + 2) * WIDTH, dn)
    for (B, dn), (k_ms, p_ms) in timed.items():
        bd = bound[(B, dn)]
        print(f"  time cell B={B:<5d} {dn:9s} kernel {k_ms:.4f} ms  plain "
              f"{p_ms:.4f} ms  bound {bd[0]:.4f} ms ({bd[1]})", flush=True)
        shapes["cell"].append(timed_shape(f"{dn} B={B}", (k_ms, p_ms), bd))
    at = (TRAIN_B, "float32")
    return worst, timed[at], bound[at]


def check_attention_grad(rn):
    """The attention's autograd Function on the card (kernel forward,
    attention_reference recomputed in backward) against plain autograd of
    attention_reference, f32, at the training shape.  Returns the largest
    gradient error relative to the largest gradient entry."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import att_step
    B, H, A = TRAIN_B, WIDTH, WIDTH
    args = [rn(B, H, scale=0.5), rn(B, K, H).relu(), rn(B, K, A),
            rn(H, A, scale=H ** -0.5), rn(A, scale=0.05),
            rn(A, 1, scale=A ** -0.5), rn(1, scale=0.05)]
    args = [x.requires_grad_(True) for x in args]
    mask = torch.ones(B, K, device=args[0].device)
    mask[::3, 20:] = 0.0
    out = att_step.fused_attention(*args, mask)
    require(out.grad_fn is not None, "attention: no autograd Function")
    got = torch.autograd.grad(out.square().sum(), args)
    want = torch.autograd.grad(
        att_step.attention_reference(*args, mask).square().sum(), args)
    err = max((g - w).abs().max().item() / max(1.0, w.abs().max().item())
              for g, w in zip(got, want))
    report("attention", "f32 B=128 gradient (relative)", err, TOL["grad"])
    return err


def check_attention_variants(rn, errs, times, bounds, shapes):
    """The three attention kernels (A, the int8 kernel D, the K-major kernel
    E) against their plain versions, masked and unmasked, f32 and bf16, at
    every row count a path gives them: the training step's B=128, the
    service's B=512, its beam-expanded R=1024 and B=4096, and the
    evaluation's R=256 (batch 128, beam 2) and 640 (its loss: five captions
    an image; only A runs there), all at K=36; and at K=196 (the repo's own
    14 x 14 feature grid) at B=128 and 512.  Every launch must take the
    vector width.  Their att_h pre-pass alone against h @ W + b in f32
    through torch, and timed.  Then D at widths that are no multiple of 16
    (vector width 1), the quantizer on the card against the same function
    on the CPU, and the gradient of the quantized call.  A and E are timed
    at ATT_TIMED and D beside them at ATT_Q_TIMED, in one call a shape, each
    beside its plain version and its bound (appended to `shapes`; no L2
    flush between calls: a decode re-reads the same context every step, and
    at bf16 B=512 its 37.7 MB nearly fit the 50 MB L2).  Fills errs for the
    three kernels, times (B=512, K=36, bf16) and bounds for D and E."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import (
        _dispatch, att_step)
    H = A = WIDTH
    dev = torch.device("cuda")
    print("attention by context layout vs the plain versions (H=A=512, "
          f"K={K} and {K_GRID}): b-major (A), int8 (D), K-major (E)",
          flush=True)
    timed = {}
    errs["att_h"] = 0.0
    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).split(".")[-1]
        wh = rn(H, A, scale=H ** -0.5).to(dt)
        bh = rn(A, scale=0.05).to(dt)
        wa = rn(A, 1, scale=A ** -0.5).to(dt)
        ba = rn(1, scale=0.05).to(dt)
        weights = (wh, bh, wa, ba)
        for B, k in ((TRAIN_B, K), (EVAL_R, K), (512, K), (EVAL_ROWS, K),
                     (1024, K), (4096, K), (TRAIN_B, K_GRID), (512, K_GRID)):
            h = rn(B, H, scale=0.5).to(dt)
            emb = rn(B, k, H).relu().to(dt)
            p_att = rn(B, k, A).to(dt)
            mask = torch.ones(B, k, device=dev)
            mask[::3, 20:] = 0.0
            mask[1::7, 1:] = 0.0
            q = att_step.quantize_features(emb, p_att)
            at = f"B={B}" if k == K else f"B={B} K={k}"
            if B == 512 and k == K:
                q_cpu = att_step.quantize_features(emb.cpu(), p_att.cpu())
                for name, on_card, on_cpu in zip(
                        ("emb_q", "emb_scale", "p_q", "p_scale"), q, q_cpu):
                    if on_card.dtype == torch.int8:
                        n = int((on_card.cpu() != on_cpu).sum())
                        print(f"  quantize     {dn} {name}: {n} int8 values "
                              f"differ from the CPU's (need 0)", flush=True)
                        require(n == 0, f"quantize_features {name}: {n} "
                                f"values differ between card and CPU")
                    else:
                        rel = ((on_card.cpu() - on_cpu).abs()
                               / on_cpu).max().item()
                        report("quantize", f"{dn} {name} (relative)", rel,
                               1e-6)
            emb_t = emb.movedim(0, 1).contiguous()
            p_t = p_att.movedim(0, 1).contiguous()
            calls = {
                "attention": (att_step.fused_attention,
                              att_step.attention_reference, (emb, p_att)),
                "attention_q": (att_step.fused_attention_q,
                                att_step.attention_reference_q, q),
                "attention_kmajor": (att_step.fused_attention_kmajor,
                                     att_step.attention_reference_kmajor,
                                     (emb_t, p_t))}
            if k == K:  # the pre-pass of the three alone
                got = att_step.att_h_kernel(h, wh, bh)
                torch.cuda.synchronize()
                err = (got - (h.float() @ wh.float() + bh.float())).abs() \
                    .max().item()
                errs["att_h"] = max(errs["att_h"], err)
                report("att_h", f"{dn} B={B} pre-pass vs h @ W + b", err,
                       TOL[("att_h", dn)])
            for name, (kernel, plain, ctx) in calls.items():
                for mk, what in ((mask, "masked"), (None, "unmasked")):
                    widths = _dispatch.att_width_launches()
                    out = kernel(h, *ctx, *weights, mk)
                    torch.cuda.synchronize()
                    require(att_widths_moved(widths) == {f"{name}_vec": 1},
                            f"{name} {dn} {at}: expected one launch at the "
                            f"vector width, counted "
                            f"{att_widths_moved(widths)}")
                    ref = plain(h, *ctx, *weights, mk)
                    require(out.dtype == dt and out.shape == (B, H),
                            f"{name} output type/shape")
                    err = (out.float() - ref.float()).abs().max().item()
                    errs[name] = max(errs[name], err)
                    report(name, f"{dn} {at} {what}", err,
                           TOL[("attention", dn)])
            if (dn, B, k) in ATT_TIMED or (dn, B, k) in ATT_Q_TIMED:
                short = "bf16" if dt == torch.bfloat16 else dn
                iters = 20 if B <= 1024 else 10
                for name, (kernel, plain, ctx) in calls.items():
                    if (dn, B, k) not in (ATT_Q_TIMED if name == "attention_q"
                                          else ATT_TIMED):
                        continue
                    timed[(name, B, k)] = timed_pair(
                        lambda: kernel(h, *ctx, *weights, mask),
                        lambda: plain(h, *ctx, *weights, mask), iters=iters)
                    out = torch.empty_like(h)
                    bound = bound_ms((h, *ctx, *weights, mask, out),
                                     attention_ops(B, H, A, k), dn)
                    k_ms, p_ms = timed[(name, B, k)]
                    print(f"  time {name:16s} {short} {at:11s} kernel "
                          f"{k_ms:.4f} ms  plain {p_ms:.4f} ms  bound "
                          f"{bound[0]:.4f} ms ({bound[1]}; "
                          f"{k_ms / bound[0]:.1f}x)", flush=True)
                    shapes[name].append(timed_shape(
                        f"{short} {at}", timed[(name, B, k)], bound))
                    if (dn, B, k) == ("bfloat16", 512, K):
                        times[name], bounds[name] = timed[(name, B, k)], bound
                if (dn, B, k) in ATT_TIMED:
                    pre = cuda_ms(lambda: att_step.att_h_kernel(h, wh, bh),
                                  iters)
                    mm = cuda_ms(lambda: torch.addmm(bh, h, wh), iters)
                    plans = {}
                    for name, item in (("attention", h.element_size()),
                                       ("attention_q", 1)):
                        plan = att_step.stream_plan(B, k, H, A, item, False)
                        plans[name] = (
                            f"{plan.rows} rows a block, {plan.slots} slots x "
                            f"{plan.stages} stages, {plan.smem_bytes} bytes "
                            f"of shared memory, grid {plan.grid}, "
                            f"{att_step.resident_blocks(plan, k, H, A, dt, name)}"
                            f" blocks an SM")
                    print(f"  time att_h pre-pass   {short} {at:11s} kernel "
                          f"{pre:.4f} ms (torch.addmm of the same product, a "
                          f"yardstick the port never calls here: {mm:.4f} "
                          f"ms); stream plan: {plans['attention']}; int8: "
                          f"{plans['attention_q']}", flush=True)
                    for name in ("attention", "attention_kmajor"):
                        shapes[name][-1].update(att_h_ms=pre,
                                                att_h_addmm_ms=mm)
            del h, emb, p_att, q, emb_t, p_t, calls

        # D at widths that are no multiple of 16: vector width 1
        B, k, Hn = 64, K, 40
        h = rn(B, Hn, scale=0.5).to(dt)
        q = att_step.quantize_features(rn(B, k, Hn).relu().to(dt),
                                       rn(B, k, Hn).to(dt))
        small = (rn(Hn, Hn, scale=Hn ** -0.5).to(dt), rn(Hn, scale=0.05).to(dt),
                 rn(Hn, 1, scale=Hn ** -0.5).to(dt), rn(1, scale=0.05).to(dt))
        mask = torch.ones(B, k, device=dev)
        mask[::3, 20:] = 0.0
        widths = _dispatch.att_width_launches()
        out = att_step.fused_attention_q(h, *q, *small, mask)
        torch.cuda.synchronize()
        require(att_widths_moved(widths) == {"attention_q_scalar": 1},
                f"attention_q {dn} H=A={Hn}: expected one launch at width 1, "
                f"counted {att_widths_moved(widths)}")
        err = (out.float() - att_step.attention_reference_q(
            h, *q, *small, mask).float()).abs().max().item()
        errs["attention_q"] = max(errs["attention_q"], err)
        report("attention_q", f"{dn} B={B} H=A={Hn} (width 1) masked", err,
               TOL[("attention", dn)])

    # the quantized call's gradient: kernel forward, the dequantized
    # reference recomputed in backward, against plain autograd (f32)
    B = TRAIN_B
    live = [rn(B, H, scale=0.5), rn(H, A, scale=H ** -0.5),
            rn(A, scale=0.05), rn(A, 1, scale=A ** -0.5), rn(1, scale=0.05)]
    live = [x.requires_grad_(True) for x in live]
    q = att_step.quantize_features(rn(B, K, H).relu(), rn(B, K, A))
    mask = torch.ones(B, K, device=dev)
    mask[::3, 20:] = 0.0
    out = att_step.fused_attention_q(live[0], *q, *live[1:], mask)
    require(out.grad_fn is not None, "attention_q: no autograd Function")
    got = torch.autograd.grad(out.square().sum(), live)
    want = torch.autograd.grad(att_step.attention_reference_q(
        live[0], *q, *live[1:], mask).square().sum(), live)
    err = max((g - w).abs().max().item() / max(1.0, w.abs().max().item())
              for g, w in zip(got, want))
    report("attention_q", "f32 B=128 gradient (relative)", err, TOL["grad"])
    errs["attention_q"] = max(errs["attention_q"], err)


# ---------------------------------------------------------------------------
# 4. the slice: serving at full width
# ---------------------------------------------------------------------------

def write_run_dir(params=None, run_dir=RUN_DIR):
    """A full-width Att2in2 run dir holding `params` (a joint tree), or
    random weights from SEED."""
    from cooperativeimagecaptioning_tpu_torch.config import Options
    from cooperativeimagecaptioning_tpu_torch.training import checkpoint, joint
    opt = Options(caption_model="att2in2", vse_model="None", phase=2,
                  vocab_size=VOCAB, rnn_size=WIDTH,
                  input_encoding_size=WIDTH, att_hid_size=WIDTH,
                  fc_feat_size=FEAT, att_feat_size=FEAT, seq_length=L,
                  max_att_len=K, batch_size=EVAL_B, language_eval=1,
                  id="smoke", checkpoint_path=run_dir)
    os.makedirs(run_dir, exist_ok=True)
    vocab = {str(i): f"w{i}" for i in range(1, VOCAB + 1)}
    with open(os.path.join(run_dir, "infos_.pkl"), "wb") as f:
        pickle.dump({"opt": opt, "vocab": vocab}, f)
    if params is None:
        params = joint.init_params(SEED, opt)
    checkpoint.save_params(params, os.path.join(run_dir, "model-best.pth"))
    return opt


def features(n, seed, k=K):
    rng = np.random.default_rng(seed)
    fc = rng.standard_normal((n, FEAT), dtype=np.float32)
    att = np.maximum(rng.standard_normal((n, k, FEAT), dtype=np.float32), 0)
    masks = np.ones((n, k), np.float32)
    masks[::4, k - k // 6:] = 0.0  # images with fewer regions
    return fc, att, masks


def post_npz(base, fc, att, masks):
    buf = io.BytesIO()
    np.savez(buf, fc=fc, att=att, att_masks=masks)
    req = urllib.request.Request(
        base + "/caption", data=buf.getvalue(),
        headers={"Content-Type": "application/x-npz"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def serve_requests(svc, label, kernel, att_kernel="attention",
                   sizes=(1, 5, 64, 300)):
    """POST npz requests of 1, 5, 64 and 300 images to a bf16 service; check
    the answers, that each bucket call launched `att_kernel` and `kernel`
    seq_length times and no other kernel, and that every head launch took
    the tensor-core pass.  Returns the ids of the 64-image request."""
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    from cooperativeimagecaptioning_tpu_torch.serving import make_http_server
    srv = make_http_server(svc, "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    ids64 = None
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            hz = json.loads(r.read())
        require(hz["status"] == "ok" and hz["beam_size"] == svc.beam_size,
                f"/healthz answered {hz}")
        for n in sizes:
            fc, att, masks = features(n, seed=n)
            before = _dispatch.launches()
            passes = _dispatch.head_pass_launches()
            out = post_npz(base, fc, att, masks)
            after = _dispatch.launches()
            passes = head_passes_moved(passes)
            ids = np.asarray(out["ids"])
            require(ids.shape == (n, L), f"{label} n={n}: ids {ids.shape}")
            require(ids.min() >= 0 and ids.max() <= VOCAB,
                    f"{label} n={n}: ids out of range")
            caps = out["captions"]
            require(len(caps) == n and all(isinstance(c, str) for c in caps),
                    f"{label} n={n}: captions")
            for row, cap in zip(ids, caps):
                nz = np.flatnonzero(row == 0)
                length = int(nz[0]) if nz.size else L
                require(len(cap.split()) == length,
                        f"{label} n={n}: caption does not decode its ids")
            calls = 1  # every n here fits one bucket
            for k in _dispatch.KERNELS:
                want = L * calls if k in (att_kernel, kernel) else 0
                got = after[k] - before[k]
                require(got == want, f"{label} n={n}: {k} launched {got} "
                        f"times, expected {want}")
            require(passes == {f"{kernel}_mma": L * calls},
                    f"{label} n={n}: the bf16 head launches must all take "
                    f"the tensor-core pass, counted {passes}")
            print(f"  {label}: n={n:3d} -> bucket {svc._bucket_for(n)}, "
                  f"{len(caps)} captions, e.g. {caps[0][:60]!r}", flush=True)
            if n == 64:
                ids64 = ids
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=60)
    return ids64


def captions_per_s(svc, n, reps=3):
    fc, att, masks = features(n, seed=10_000 + n)
    svc.caption_ids(fc[:1], att[:1], masks[:1])
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        ids = svc.caption_ids(fc, att, masks)
        ts.append(time.perf_counter() - t0)
        require(ids.shape == (n, L), "throughput run ids shape")
    return n / float(np.median(ts))


def phase_slice(smi):
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    from cooperativeimagecaptioning_tpu_torch.serving import CaptioningService
    opt = write_run_dir()
    print(f"slice: run dir {os.path.relpath(RUN_DIR, REPO)} (att2in2, vocab "
          f"{VOCAB}, width {WIDTH}, K={K}, L={opt.seq_length}, seed {SEED})",
          flush=True)
    t0 = time.perf_counter()
    greedy = CaptioningService.from_run_dir(RUN_DIR,
                                            compute_dtype="bfloat16")
    greedy.warmup()
    beam = CaptioningService.from_run_dir(RUN_DIR, beam_size=2,
                                          compute_dtype="bfloat16")
    beam.warmup()
    torch.cuda.synchronize()
    print(f"  services loaded and warmed (buckets {greedy.buckets}) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # the main path: counts from 0 to the end of the served requests
    _dispatch.reset_launches()
    ids_greedy = serve_requests(greedy, "greedy bf16", "greedy_head")
    ids_beam = serve_requests(beam, "beam-2 bf16", "beam_head")
    main_launches = _dispatch.launches()
    for k in ("attention", "greedy_head", "beam_head"):
        require(main_launches[k] > 0, f"{k} was never launched on the "
                f"main path")
    require_vector_width("serving", main_launches)
    print(f"  main-path launches: {main_launches}; heads by first pass: "
          f"{_dispatch.head_pass_launches()}; attention by width: "
          f"{_dispatch.att_width_launches()}", flush=True)

    # the CUDA services against CPU services (the plain versions) on the
    # same 64-image request, at the same bucket
    fc, att, masks = features(64, seed=64)
    for m, ids_served in ((0, ids_greedy), (2, ids_beam)):
        mode = "beam-2" if m else "greedy"
        cpu = {dn: CaptioningService.from_run_dir(
            RUN_DIR, beam_size=m, compute_dtype=dn, buckets=(64,),
            device="cpu").caption_ids(fc, att, masks)
            for dn in ("float32", "bfloat16")}
        gpu32 = CaptioningService.from_run_dir(
            RUN_DIR, beam_size=m, compute_dtype="float32", buckets=(64,))
        passes = _dispatch.head_pass_launches()
        ids32 = gpu32.caption_ids(fc, att, masks)
        passes = head_passes_moved(passes)
        head = "beam_head" if m else "greedy_head"
        require(passes == {f"{head}_fma": L},
                f"f32 {mode} service: the head launches must all take the "
                f"FMA pass, counted {passes}")
        for what, ids_a, ids_b, floor in (
                ("f32 cuda vs f32 cpu", ids32, cpu["float32"], AGREE_F32),
                ("bf16 cuda vs bf16 cpu", ids_served, cpu["bfloat16"],
                 AGREE_BF16),
                ("bf16 cuda vs f32 cpu", ids_served, cpu["float32"], None)):
            rate = float((ids_a == ids_b).all(axis=1).mean())
            need = f"need >= {floor * 100:.0f}%" if floor else "reported"
            print(f"  {what}, {mode}: {rate * 100:.1f}% of 64 rows equal "
                  f"({need})", flush=True)
            require(floor is None or rate >= floor,
                    f"{what}, {mode}: {rate} of rows equal, below {floor}")
        del gpu32

    rates = {"greedy bucket 512": captions_per_s(greedy, 512),
             "greedy bucket 4096": captions_per_s(greedy, 4096),
             "beam-2 bucket 512": captions_per_s(beam, 512)}
    print(f"throughput ({smi}; bf16, host features to ids, serial "
          f"requests): " + "; ".join(f"{k}: {v:.1f} captions/s"
                                     for k, v in rates.items()), flush=True)
    layout_launches = phase_layouts(smi, {0: greedy, 2: beam},
                                    {0: ids_greedy, 2: ids_beam}, rates)
    grid_launches = phase_grid_features()
    check_missing_leaf()
    return {k: main_launches[k] + layout_launches[k] + grid_launches[k]
            for k in main_launches}


def phase_grid_features():
    """Services of the same run dir through from_run_dir(max_att_len=196),
    fed 196-slot features (the repo's own 14 x 14 grid): greedy and beam 2,
    bf16 and f32, every step through the attention kernel and the head, and
    the f32 ids against the CPU service's.  Returns the launch counts."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    from cooperativeimagecaptioning_tpu_torch.serving import CaptioningService
    n = 64
    fc, att, masks = features(n, seed=196, k=K_GRID)
    print(f"196-slot features: from_run_dir(max_att_len={K_GRID}), {n} "
          f"images", flush=True)
    total = {k: 0 for k in _dispatch.KERNELS}
    for m in (0, 2):
        mode = "beam-2" if m else "greedy"
        head = "beam_head" if m else "greedy_head"
        ids = {}
        for dn in ("bfloat16", "float32"):
            svc = CaptioningService.from_run_dir(
                RUN_DIR, beam_size=m, compute_dtype=dn, buckets=(n,),
                max_att_len=K_GRID)
            _dispatch.reset_launches()
            ids[dn] = svc.caption_ids(fc, att, masks)
            torch.cuda.synchronize()
            got = _dispatch.launches()
            require_vector_width(f"{K_GRID}-slot {dn} {mode}", got)
            for k in _dispatch.KERNELS:
                want = L if k in ("attention", head) else 0
                require(got[k] == want, f"{K_GRID}-slot {dn} {mode}: {k} "
                        f"launched {got[k]} times, expected {want}")
                total[k] += got[k]
            require(ids[dn].shape == (n, L), f"{K_GRID}-slot ids shape")
            del svc
        cpu = CaptioningService.from_run_dir(
            RUN_DIR, beam_size=m, compute_dtype="float32", buckets=(n,),
            max_att_len=K_GRID, device="cpu").caption_ids(fc, att, masks)
        for what, a, b, floor in (
                ("f32 cuda vs f32 cpu", ids["float32"], cpu, AGREE_F32),
                ("bf16 cuda vs f32 cpu", ids["bfloat16"], cpu, None)):
            rate = float((a == b).all(axis=1).mean())
            need = f"need >= {floor * 100:.0f}%" if floor else "reported"
            print(f"  {K_GRID} slots, {what}, {mode}: {rate * 100:.1f}% of "
                  f"{n} rows equal ({need})", flush=True)
            require(floor is None or rate >= floor,
                    f"{K_GRID} slots, {what}, {mode}: {rate} of rows equal")
    return total


def check_missing_leaf():
    """A run dir whose checkpoint lacks one leaf (the logit layer's bias):
    from_run_dir fills it from the template of the run's opt
    (joint.init_params(0, opt)), reports it, and serves the same ids as a
    service built on the checkpoint's tree with that leaf filled in."""
    import copy
    from cooperativeimagecaptioning_tpu_torch.config import load_infos
    from cooperativeimagecaptioning_tpu_torch.serving import CaptioningService
    from cooperativeimagecaptioning_tpu_torch.training import checkpoint, joint
    run_dir = os.path.join(REPO, "build", "chip_smoke_leaf_run")
    os.makedirs(run_dir, exist_ok=True)
    opt = load_infos(os.path.join(RUN_DIR, "infos_.pkl"))["opt"]
    full = checkpoint.load_params(os.path.join(RUN_DIR, "model-best.pth"))
    cut = copy.deepcopy(full)
    del cut["speaker"]["logit"]["b"]
    checkpoint.save_params(cut, os.path.join(run_dir, "model-best.pth"))
    with open(os.path.join(RUN_DIR, "infos_.pkl"), "rb") as f, \
            open(os.path.join(run_dir, "infos_.pkl"), "wb") as g:
        g.write(f.read())
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        svc = CaptioningService.from_run_dir(run_dir, buckets=(64,),
                                             compute_dtype="float32")
    require("logit.b not in loaded checkpoint" in out.getvalue(),
            f"missing leaf not reported: {out.getvalue()}")
    full["speaker"]["logit"]["b"] = joint.init_params(
        0, opt)["speaker"]["logit"]["b"]
    vocab = load_infos(os.path.join(RUN_DIR, "infos_.pkl"))["vocab"]
    want_svc = CaptioningService(opt, full, vocab, buckets=(64,),
                                 compute_dtype="float32")
    fc, att, masks = features(64, seed=65)
    a = svc.caption_ids(fc, att, masks)
    b = want_svc.caption_ids(fc, att, masks)
    require(a.shape == (64, L) and (a == b).all(),
            "the filled leaf: ids differ from the tree filled by hand")
    print("  a checkpoint without logit.b: reported, filled from the "
          "template, 64 of 64 rows equal to the tree filled by hand",
          flush=True)


def decode_memory(svc, n=4096):
    """Device memory of one greedy decode of `n` images on `svc`'s speaker:
    (bytes of the resident attention context, peak bytes allocated during
    the decode beyond what was allocated before the request).  The context
    is made as the service makes it, the features freed before the decode."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops import decoding
    _, att, masks = features(n, seed=7)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    with torch.inference_mode():
        ctx = svc.speaker.encode_features(
            None, svc._to_device(att),
            torch.from_numpy(masks).to(svc.device))
        if svc.att_quant == "int8":
            ctx = svc.speaker.quantize_ctx(ctx)
        elif getattr(svc.opt, "att_kmajor", 0):
            ctx = svc.speaker.kmajor_ctx(ctx)
        ctx_bytes = sum(t.numel() * t.element_size() for t in ctx.values())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        decoding.sample(svc.speaker, ctx, svc.opt.seq_length, mode="greedy")
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
    return ctx_bytes, peak


def request_memory(svc, n=4096):
    """torch.cuda.max_memory_allocated over one request of `n` images."""
    import torch
    fc, att, masks = features(n, seed=7)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    svc.caption_ids(fc, att, masks)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


def phase_layouts(smi, plain, plain_ids, plain_rates):
    """The two other decode layouts of the attention context through the
    service: att_quant="int8" (kernel D) and att_kmajor=1 (kernel E), greedy
    and beam 2, bf16, from_run_dir + warmup + the HTTP server.  `plain`,
    `plain_ids` and `plain_rates` are the b-major services of the same run
    dir, the ids they served for the 64-image request and their captions/s.
    Returns the launch counts of the served requests."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    from cooperativeimagecaptioning_tpu_torch.serving import CaptioningService
    print("decode layouts of the attention context: int8 (att_quant), "
          "K-major (att_kmajor=1)", flush=True)
    svcs = {}
    t0 = time.perf_counter()
    for name in ("int8", "k-major"):
        kw, _ = LAYOUTS[name]
        for m in (0, 2):
            svcs[name, m] = CaptioningService.from_run_dir(
                RUN_DIR, beam_size=m, compute_dtype="bfloat16", **kw)
            svcs[name, m].warmup()
    torch.cuda.synchronize()
    print(f"  four services loaded and warmed in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    _dispatch.reset_launches()
    served = {}
    for (name, m), svc in svcs.items():
        mode = "beam-2" if m else "greedy"
        served[name, m] = serve_requests(
            svc, f"{name} {mode} bf16", "beam_head" if m else "greedy_head",
            att_kernel=LAYOUTS[name][1])
    launches = _dispatch.launches()
    require(launches["attention"] == 0 and launches["attention_q"] > 0
            and launches["attention_kmajor"] > 0,
            f"decode layouts: launches {launches}")
    require_vector_width("decode layouts", launches)
    print(f"  launches of the int8 and K-major requests: {launches}",
          flush=True)

    # ids, one 64-image request at one bucket: f32 K-major on the card vs
    # f32 b-major on the card; f32 int8 on the card vs the f32 int8 CPU
    # service; how often int8 ids equal the unquantized ids (reported)
    fc, att, masks = features(64, seed=64)
    for m in (0, 2):
        mode = "beam-2" if m else "greedy"

        def ids(device="cuda", **kw):
            return CaptioningService.from_run_dir(
                RUN_DIR, beam_size=m, compute_dtype="float32", buckets=(64,),
                device=device, **kw).caption_ids(fc, att, masks)
        passes = _dispatch.head_pass_launches()
        base = ids()
        q_gpu = ids(att_quant="int8")
        passes = head_passes_moved(passes)
        head = "beam_head" if m else "greedy_head"
        require(passes == {f"{head}_fma": 2 * L},
                f"f32 {mode} services: the head launches must all take the "
                f"FMA pass, counted {passes}")
        for what, a, b, floor in (
                ("f32 K-major cuda vs f32 b-major cuda", ids(att_kmajor=1),
                 base, AGREE_F32),
                ("f32 int8 cuda vs f32 int8 cpu", q_gpu,
                 ids("cpu", att_quant="int8"), AGREE_F32),
                ("f32 int8 cuda vs f32 unquantized cuda", q_gpu, base, None),
                ("bf16 int8 cuda vs bf16 unquantized cuda",
                 served["int8", m], plain_ids[m], None),
                ("bf16 K-major cuda vs bf16 b-major cuda",
                 served["k-major", m], plain_ids[m], None)):
            rate = float((a == b).all(axis=1).mean())
            need = f"need >= {floor * 100:.0f}%" if floor else "reported"
            print(f"  {what}, {mode}: {rate * 100:.1f}% of 64 rows equal "
                  f"({need})", flush=True)
            require(floor is None or rate >= floor,
                    f"{what}, {mode}: {rate} of rows equal, below {floor}")

    rows = {"b-major": plain_rates}
    for name in ("int8", "k-major"):
        rows[name] = {
            "greedy bucket 512": captions_per_s(svcs[name, 0], 512),
            "greedy bucket 4096": captions_per_s(svcs[name, 0], 4096),
            "beam-2 bucket 512": captions_per_s(svcs[name, 2], 512)}
    for name, r in rows.items():
        print(f"throughput by layout ({smi}; bf16, host features to ids, "
              f"serial requests) {name}: "
              + "; ".join(f"{k}: {v:.1f} captions/s" for k, v in r.items()),
              flush=True)

    for name, svc in (("bf16 b-major", plain[0]), ("int8", svcs["int8", 0]),
                      ("bf16 k-major", svcs["k-major", 0])):
        ctx_bytes, decode_peak = decode_memory(svc)
        print(f"memory ({smi}; greedy, 4096 images) {name}: context "
              f"{ctx_bytes / 2 ** 20:.1f} MiB resident; peak during the "
              f"decode {decode_peak / 2 ** 20:.1f} MiB above the service; "
              f"max_memory_allocated over the whole request "
              f"{request_memory(svc) / 2 ** 20:.1f} MiB", flush=True)
    return launches


# ---------------------------------------------------------------------------
# 5. training: phase-2 MLE at full width
# ---------------------------------------------------------------------------

def train_opt(batch_size, drop_prob_lm=0.5):
    """Phase-2 MLE options at reference width (scripts/bench_train.py's
    configuration, f32; use_bn off as the options default it)."""
    from cooperativeimagecaptioning_tpu_torch.config import Options
    return Options(caption_model="att2in2", vse_model="None", phase=2,
                   caption_loss_weight=1, batch_size=batch_size,
                   seq_per_img=1, rnn_size=WIDTH, input_encoding_size=WIDTH,
                   att_hid_size=WIDTH, fc_feat_size=FEAT, att_feat_size=FEAT,
                   max_att_len=K, drop_prob_lm=drop_prob_lm,
                   save_checkpoint_every=10 ** 9, losses_log_every=1,
                   prefetch_batches=0, seed=SEED,
                   checkpoint_path=TRAIN_RUN_DIR)


def train_dataset():
    """The shared SyntheticDataset at the reference's shapes: vocab 9487,
    L=16, up to 36 regions of 2048-d features."""
    from cooperativeimagecaptioning_tpu_torch.data import SyntheticDataset
    return SyntheticDataset(num_images=TRAIN_IMAGES, vocab_size=VOCAB,
                            seq_length=L, fc_feat_size=FEAT,
                            att_feat_size=FEAT, max_K=K, seed=SEED)


def iterations_per_s(trainer, data, n=10):
    """Training iterations per second on one fixed host batch (its copy to
    the card included), after one warm-up iteration."""
    import torch
    trainer.train_iteration(data)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        trainer.train_iteration(data)
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t0)


def compare_first_step(ds):
    """The first step at B=16 on the card against the same step on the CPU
    port: same params, same batch, dropout off (the two devices' generators
    draw different masks)."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.training import joint
    from cooperativeimagecaptioning_tpu_torch.training.loop import Trainer
    from cooperativeimagecaptioning_tpu_torch.utils.tree import (
        leaves, to_numpy, to_torch, trainable)
    opt = train_opt(16, drop_prob_lm=0.0)
    tr = Trainer(opt, dataset=ds, device="cuda", verbose=False)
    data = tr.loader.get_batch("train")
    batch = tr._prepare_batch(data)
    fn = joint.value_and_grad(opt, "optimizer")
    hp = joint.Hyper.from_opt(opt)
    (loss_g, _), grads_g = fn(tr.params, batch, tr.gen, hp)
    cpu_params = {"speaker": trainable(to_torch(to_numpy(
        tr.params["speaker"]), "cpu"))}
    cpu_batch = {k: None if v is None else v.cpu() for k, v in batch.items()}
    (loss_c, _), grads_c = fn(cpu_params, cpu_batch, torch.Generator(), hp)
    rel = abs(loss_g.item() - loss_c.item()) / abs(loss_c.item())
    print(f"  B=16 first step, cuda vs cpu port: loss {loss_g.item():.6f} "
          f"vs {loss_c.item():.6f} (relative {rel:.2e}, tol "
          f"{STEP_LOSS_RTOL:.0e})", flush=True)
    require(rel <= STEP_LOSS_RTOL, f"first-step loss: relative {rel}")
    worst, worst_key, max_abs = 0.0, "", 0.0
    cpu = dict(leaves(grads_c))
    for key, g in leaves(grads_g):
        g, c = g.cpu(), cpu[key]
        # > 1 means outside atol + rtol * |cpu| somewhere in the leaf
        ratio = ((g - c).abs() / (STEP_GRAD_ATOL + STEP_GRAD_RTOL * c.abs())
                 ).max().item()
        max_abs = max(max_abs, (g - c).abs().max().item())
        if ratio > worst:
            worst, worst_key = ratio, key
    print(f"  B=16 first step gradients, {len(cpu)} leaves: max abs "
          f"difference {max_abs:.3e}; worst leaf {worst_key} at "
          f"{worst:.3f} of its tolerance (rtol {STEP_GRAD_RTOL:.0e}, atol "
          f"{STEP_GRAD_ATOL:.0e})", flush=True)
    require(worst <= 1.0, f"first-step gradient {worst_key}: {worst} of "
            f"its tolerance")
    del tr
    return rel, max_abs


def phase_train(smi):
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    from cooperativeimagecaptioning_tpu_torch.serving import CaptioningService
    from cooperativeimagecaptioning_tpu_torch.training import loop
    require(not torch.backends.cuda.matmul.allow_tf32,
            "TF32 matmuls are on: the f32 checks need them off")
    ds = train_dataset()
    print(f"training: phase-2 MLE, att2in2 vocab {VOCAB}, width {WIDTH}, "
          f"K={K}, L={L}, B={TRAIN_B}, f32, drop_prob_lm 0.5, "
          f"CIC_FUSED_CELL=1, {TRAIN_IMAGES} synthetic images", flush=True)
    out = {}
    with fused_cell_switch(True):
        # the main path: three steps through the user's entry point
        steps = 3
        _dispatch.reset_launches()
        t0 = time.perf_counter()
        trainer = loop.train(train_opt(TRAIN_B), dataset=ds,
                             max_iterations=steps, device="cuda",
                             verbose=False)
        torch.cuda.synchronize()
        launches = _dispatch.launches()
        T = L + 1  # labels[:, :-1] of the [B, L+2] labels
        print(f"  train(max_iterations={steps}) in "
              f"{time.perf_counter() - t0:.1f} s; launches {launches}",
              flush=True)
        for k in _dispatch.KERNELS:
            want = steps * 2 * T if k in ("attention", "cell") else 0
            require(launches[k] == want, f"training: {k} launched "
                    f"{launches[k]} times in {steps} steps, expected {want} "
                    f"(forward + checkpointed recompute, T={T})")
        require_vector_width("training", launches)
        losses = [float(v) for v in trainer.loss_history.values()]
        require(len(losses) == steps and all(np.isfinite(losses)),
                f"training losses {losses}")
        require(trainer.optim.skipped_steps() == 0, "non-finite steps")

        out["step_rel"], out["step_abs"] = compare_first_step(ds)

        data = trainer.loader.get_batch("train")
        curve = [trainer.train_iteration(data)[0]["loss_cap"].item()
                 for _ in range(LEARN_STEPS)]
        print(f"  {LEARN_STEPS} steps on one batch: loss_cap "
              f"{curve[0]:.4f} -> {curve[-1]:.4f}", flush=True)
        require(all(np.isfinite(curve)) and curve[-1] < curve[0]
                and np.mean(curve[-5:]) < np.mean(curve[:5]),
                f"loss_cap did not fall: {curve}")
        out["loss_first"], out["loss_last"] = curve[0], curve[-1]

    # it/s with and without the cell kernel, in turns: on, off, off, on
    rates = {True: [], False: []}
    for on in (True, False, False, True):
        with fused_cell_switch(on):
            rates[on].append(iterations_per_s(trainer, data))
    out["its_cell_kernel"] = float(np.mean(rates[True]))
    out["its_plain_cell"] = float(np.mean(rates[False]))
    print(f"  throughput ({smi}; B={TRAIN_B}, f32, one fixed host batch): "
          f"{out['its_cell_kernel']:.2f} it/s with the cell kernel "
          f"({rates[True][0]:.2f}, {rates[True][1]:.2f}), "
          f"{out['its_plain_cell']:.2f} it/s with CIC_FUSED_CELL unset "
          f"({rates[False][0]:.2f}, {rates[False][1]:.2f})", flush=True)

    # serve the trained speaker: greedy, bucket 512, the cell kernel on
    write_run_dir(trainer.params, TRAIN_RUN_DIR)
    with fused_cell_switch(True):
        svc = CaptioningService.from_run_dir(TRAIN_RUN_DIR,
                                             compute_dtype="bfloat16",
                                             buckets=(512,))
        fc, att, masks = features(512, seed=512)
        svc.caption_ids(fc[:1], att[:1], masks[:1])
        _dispatch.reset_launches()
        ids = svc.caption_ids(fc, att, masks)
        torch.cuda.synchronize()
        served = _dispatch.launches()
        require(_dispatch.head_pass_launches()["greedy_head_mma"] == L,
                "serving the trained speaker in bf16: the greedy head must "
                "take the tensor-core pass")
    require(ids.shape == (512, L) and ids.min() >= 0 and ids.max() <= VOCAB,
            f"trained speaker ids {ids.shape}")
    for k in _dispatch.KERNELS:
        want = L if k in ("attention", "greedy_head", "cell") else 0
        require(served[k] == want, f"serving the trained speaker: {k} "
                f"launched {served[k]} times, expected {want}")
    print(f"  trained speaker served: 512 images -> ids {ids.shape}, "
          f"{len(np.unique(ids))} distinct ids; launches {served}",
          flush=True)
    return launches, out


# ---------------------------------------------------------------------------
# 6. evaluation: the trained speaker under the final-eval protocol
# ---------------------------------------------------------------------------

def eval_dataset():
    """A SyntheticDataset at the reference's shapes: twelve batches of
    EVAL_B images in the val and in the test split, three times what the
    evaluator keeps in flight."""
    from cooperativeimagecaptioning_tpu_torch.data import SyntheticDataset
    return SyntheticDataset(num_images=EVAL_IMAGES, vocab_size=VOCAB,
                            seq_length=L, fc_feat_size=FEAT,
                            att_feat_size=FEAT, max_K=K,
                            splits=(0.2, 0.4, 0.4), seed=SEED + 1)


def eval_against_cpu(ds, run_dir, who, layouts, min_distinct):
    """The first EVAL_CPU_BATCHES val batches through Evaluator.eval_split
    (f32, beam 2) on the card and on the CPU port, `run_dir`'s speaker, once
    for each context layout in `layouts`: the captions of at least AGREE_F32
    of the images equal (the vocabulary maps id i to "w<i>", so equal
    captions are equal ids up to the end token), at least `min_distinct`
    different captions among them, and loss_cap within EVAL_LOSS_RTOL."""
    from cooperativeimagecaptioning_tpu_torch import config, data
    from cooperativeimagecaptioning_tpu_torch.evaluation.eval_split import (
        Evaluator)
    from cooperativeimagecaptioning_tpu_torch.training import checkpoint
    model = os.path.join(run_dir, "model-best.pth")
    n = EVAL_CPU_BATCHES * EVAL_B
    ek = {"split": "val", "beam_size": 2, "language_eval": 0,
          "num_images": n}
    for name in layouts:
        got = {}
        for device in (DEVICE, "cpu"):
            opt = config.load_infos(os.path.join(run_dir, "infos_.pkl"))["opt"]
            for k, v in LAYOUTS[name][0].items():
                setattr(opt, k, v)
            loader = data.DataLoader(opt, dataset=ds)
            params = checkpoint.load_params(model, device)
            losses, preds, _ = Evaluator(opt, device=device).eval_split(
                params, loader, ek)
            got[device] = (losses["loss_cap"],
                           {p["image_id"]: p["caption"] for p in preds})
        (a, caps), (b, caps_cpu) = got[DEVICE], got["cpu"]
        require(len(caps) == n and sorted(caps) == sorted(caps_cpu),
                f"evaluation {who} {name}: images of the card and the CPU")
        rate = float(np.mean([caps[i] == caps_cpu[i] for i in caps]))
        distinct = len(set(caps.values()))
        rel = abs(a - b) / abs(b)
        print(f"  {who}, {name}, {n} val images, card vs cpu port: captions "
              f"of {rate * 100:.1f}% of the images equal (need >= "
              f"{AGREE_F32 * 100:.0f}%), {distinct} distinct captions (need "
              f">= {min_distinct}); loss_cap {a:.6f} vs {b:.6f} (relative "
              f"{rel:.2e}, tol {EVAL_LOSS_RTOL:.0e})", flush=True)
        require(rate >= AGREE_F32, f"evaluation {who} {name}: captions of "
                f"{rate} of the images equal the CPU port's")
        require(distinct >= min_distinct, f"evaluation {who} {name}: "
                f"{distinct} distinct captions")
        require(rel <= EVAL_LOSS_RTOL,
                f"evaluation {who} {name}: loss_cap relative {rel}")


def phase_eval(smi):
    """TRAIN_RUN_DIR (phase 5's trained speaker) through eval.eval and
    Evaluator.eval_split, f32, beam 2, with each context layout."""
    import torch
    from cooperativeimagecaptioning_tpu_torch import config, data
    from cooperativeimagecaptioning_tpu_torch import eval as eval_entry
    from cooperativeimagecaptioning_tpu_torch.evaluation.eval_split import (
        MAX_IN_FLIGHT, Evaluator)
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    from cooperativeimagecaptioning_tpu_torch.training import checkpoint
    model = os.path.join(TRAIN_RUN_DIR, "model-best.pth")
    infos = os.path.join(TRAIN_RUN_DIR, "infos_.pkl")
    t0 = time.perf_counter()
    ds = eval_dataset()
    n_test = sum(1 for im in ds.info["images"] if im["split"] == "test")
    batches = -(-n_test // EVAL_B)
    print(f"evaluation: {os.path.relpath(TRAIN_RUN_DIR, REPO)} (phase 5's "
          f"speaker), f32, beam 2, language_eval=1; {EVAL_IMAGES} synthetic "
          f"images made in {time.perf_counter() - t0:.1f} s, {n_test} in the "
          f"test split, batch {EVAL_B} ({batches} batches, 5 captions an "
          f"image in the loss)", flush=True)
    os.chdir(TRAIN_RUN_DIR)  # eval_results/ is written under the run dir
    T = L + 1
    total = {k: 0 for k in _dispatch.KERNELS}
    losses = {}
    for name, (kw, att_kernel) in LAYOUTS.items():
        # the user's entry point: eval.eval on the run dir
        opt = config.load_infos(infos)["opt"]
        for k, v in kw.items():
            setattr(opt, k, v)
        _dispatch.reset_launches()
        t0 = time.perf_counter()
        out = eval_entry.eval(opt, model, infos, split="test", dataset=ds,
                              device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _dispatch.launches()
        preds, stats = out["split_predictions"], out["lang_stats"]
        want_ids = sorted(im["id"] for im in ds.info["images"]
                          if im["split"] == "test")
        require(sorted(p["image_id"] for p in preds) == want_ids,
                f"evaluation {name}: not one prediction per test image")
        require(all(isinstance(p["caption"], str) for p in preds),
                f"evaluation {name}: captions")
        require(np.isfinite(out["loss"]["loss_cap"]),
                f"evaluation {name}: loss_cap {out['loss']['loss_cap']}")
        for metric in ("CIDEr", "Bleu_1", "Bleu_4", "ROUGE_L", "METEOR"):
            require(metric in stats and np.isfinite(stats[metric]),
                    f"evaluation {name}: {metric} {stats.get(metric)}")
        # the loss runs the b-major attention T times a batch (no recompute
        # in eval mode), the decode its layout's attention and the beam head
        # L times a batch
        want = {k: 0 for k in _dispatch.KERNELS}
        want["attention"] = batches * T
        want[att_kernel] += batches * L
        want["beam_head"] = batches * L
        require(launches == want, f"evaluation {name}: launches {launches}, "
                f"expected {want}")
        require_vector_width(f"evaluation {name}", launches)
        require(_dispatch.head_pass_launches()["beam_head_fma"]
                == want["beam_head"],
                f"evaluation {name}: the f32 beam head must take the FMA "
                f"pass")
        for k, v in launches.items():
            total[k] += v
        losses[name] = out["loss"]["loss_cap"]
        print(f"  eval.eval {name}: {len(preds)} predictions, loss_cap "
              f"{out['loss']['loss_cap']:.4f}, CIDEr {stats['CIDEr']:.4f}, "
              f"Bleu_4 {stats['Bleu_4']:.4f}, ROUGE_L {stats['ROUGE_L']:.4f}, "
              f"METEOR {stats['METEOR']:.4f}; {wall:.2f} s in all; launches "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)

        # the evaluator itself, for its timings: the val split
        loader = data.DataLoader(opt, dataset=ds)
        params = checkpoint.load_params(model, DEVICE)
        ev = Evaluator(opt, device=DEVICE)
        ek = {"split": "val", "beam_size": 2, "language_eval": 0,
              "num_images": -1}
        ev.eval_split(params, loader, ek)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, val_preds, _ = ev.eval_split(params, loader, ek)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        require(len(val_preds) == batches * EVAL_B
                and ev.drained_in_loop == batches - MAX_IN_FLIGHT > 0,
                f"evaluation {name}: {len(val_preds)} val images, "
                f"{ev.drained_in_loop} batches drained inside the loop")
        print(f"  Evaluator.eval_split {name} ({smi}; f32, beam 2, loss and "
              f"decode, no language metrics): {len(val_preds)} images in "
              f"{wall:.3f} s = {len(val_preds) / wall:.1f} images/s; "
              f"{ev.drained_in_loop} of {batches} batches drained inside "
              f"the loop (at most {MAX_IN_FLIGHT} in flight); last_timings "
              f"{ev.last_timings}", flush=True)
        del ev, params, loader
    spread = max(losses.values()) - min(losses.values())
    require(spread <= 1e-6 * abs(losses["b-major"]),
            f"the loss must not depend on the decode layout: {losses}")

    # the decode's ids and the loss against the CPU port: the random-weight
    # speaker of phase 4 (its captions differ from image to image) with each
    # layout, and the trained speaker evaluated above
    eval_against_cpu(ds, RUN_DIR, "random-weight speaker", LAYOUTS,
                     min_distinct=EVAL_CPU_BATCHES * EVAL_B // 16)
    eval_against_cpu(ds, TRAIN_RUN_DIR, "trained speaker", ("b-major",),
                     min_distinct=1)
    os.chdir(REPO)
    return total


def main():
    smi = phase_device()
    sys.path.insert(0, REPO)
    import torch
    t_start = time.perf_counter()
    phase_build()
    errs, times, bounds, shapes = phase_kernels()
    print(f"elapsed after the kernel checks: "
          f"{time.perf_counter() - t_start:.0f} s", flush=True)
    with fused_cell_switch(False):
        serve_launches = phase_slice(smi)
    print(f"elapsed after serving: {time.perf_counter() - t_start:.0f} s",
          flush=True)
    train_launches, _ = phase_train(smi)
    print(f"elapsed after training: {time.perf_counter() - t_start:.0f} s",
          flush=True)
    with fused_cell_switch(False):
        eval_launches = phase_eval(smi)
    print(f"elapsed after evaluation: {time.perf_counter() - t_start:.0f} s",
          flush=True)
    # each path's counts run from 0 just before it to just after it
    kernels = []
    for k in SOURCES:
        by_path = {"serve": serve_launches[k], "train": train_launches[k],
                   "eval": eval_launches[k]}
        require(sum(by_path.values()) > 0,
                f"{k} was never launched on a main path")
        kernels.append({
            "name": k, "route": "cuda", "source": SOURCES[k],
            "replaces": REPLACES[k], "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": errs[k],
            "ms": times[k][0], "plain_ms": times[k][1],
            "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
            # no single PyTorch call computes any of these functions
            "library_ms": None,
            # every shape the kernel was timed at, each with its own bound
            "timed_shapes": shapes[k]})
    print(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
