#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one Hopper GPU (H100).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device   -- a CUDA device of capability 9.0; prints the card's name and
                 power limit (nvidia-smi).
  2. build    -- builds the hand-written kernels from the package's csrc/
                 with nvcc (timed).
  3. kernels  -- each kernel against its plain PyTorch version on the card,
                 at serving shapes, in float32 and bfloat16: attention
                 (masked and unmasked), greedy head and beam head (random
                 rows and rows with planted exact ties, which must resolve
                 to the lower id; kk = 2, 3, 6).  Each check prints its
                 maximum error beside its tolerance; each kernel is timed
                 beside its plain version.
                 The fused maxout-LSTM cell (kernel F, CIC_FUSED_CELL=1)
                 against its plain version with and without attention, f32
                 at B=128 and f32 / bf16 at B=512 and 4096; the attention's
                 autograd Function (kernel forward, recomputed backward)
                 against plain autograd, f32 at B=128.
  4. slice    -- writes a full-width run dir (Att2in2, vocab 9487, 512-wide,
                 K=36, L=16, random weights from a numpy seed), serves it
                 through CaptioningService.from_run_dir + warmup +
                 make_http_server (greedy and beam 2, bf16), checks the
                 answers and that every request went through the kernels
                 (launch counts), compares the CUDA services with CPU
                 services (plain versions) in float32 and in bfloat16, and
                 times captions/s.  CIC_FUSED_CELL is unset here (the
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
The line before the last is one JSON object describing the kernels; the
last line is {"ok": true, "device": {...}}.

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
    "greedy_head":
        "cooperativeimagecaptioning_tpu/ops/pallas/logit_head.py:138",
    "beam_head": "cooperativeimagecaptioning_tpu/ops/pallas/beam_head.py:58",
    "cell": "cooperativeimagecaptioning_tpu/ops/pallas/cell_step.py:75",
}
SOURCES = {"attention": ATT_SRC, "greedy_head": GREEDY_SRC,
           "beam_head": BEAM_SRC, "cell": CELL_SRC}
TRAIN_B = 128        # scripts/bench_train.py's batch
TRAIN_IMAGES = 256   # synthetic images (153 in the train split)
LEARN_STEPS = 20

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
TOL = {("attention", "float32"): 1e-4, ("attention", "bfloat16"): 3e-2,
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
# 92.2% (beam 2) on this request.
AGREE_F32 = 0.99
AGREE_BF16 = 0.85


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


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------

def cuda_ms(fn, iters):
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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
    logits are exact ties in any summation order.  Expected order of the
    top 6 for every row: [7, 300, 5000, V, 11, 4000] (V = last column)."""
    V1 = w.shape[1]
    top = [7, 300, 5000, V1 - 1]    # same sweep, other split, last column
    nxt = [11, 4000]
    for c in top + nxt:
        w[:, c] = 0
    b[top] = 10.0
    b[nxt] = 9.0
    return top + nxt


def phase_kernels():
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import (
        _dispatch, att_step, beam_head, logit_head)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(SEED)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    B, R, H, A, V1 = 512, 1024, WIDTH, WIDTH, VOCAB + 1
    errs = {k: 0.0 for k in _dispatch.KERNELS}
    times = {}
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

        w = rn(H, V1, scale=0.1).to(dt)
        b = rn(V1, scale=0.1).to(dt)
        wt, bt = w.clone(), b.clone()
        planted = plant_ties(wt, bt)
        for ww, bb, what in ((w, b, "random"), (wt, bt, "planted ties")):
            logits = logit_head.logits_f32(h, ww, bb)
            it, lp = logit_head.greedy_head(h, ww, bb)
            torch.cuda.synchronize()
            it_p, lp_p = logit_head.greedy_head_reference(h, ww, bb)
            require(it.dtype == torch.int32 and lp.dtype == torch.float32,
                    "greedy head output types")
            err = (lp - lp_p).abs().max().item()
            errs["greedy_head"] = max(errs["greedy_head"], err)
            report("greedy_head", f"{dn} {what} lp", err, TOL["head"])
            if what == "planted ties":
                require(bool((it == planted[0]).all()),
                        "greedy head: planted tie not resolved to the lower "
                        "id")
                require(bool((it == it_p).all()), "greedy head ids (ties)")
            ids_agree("greedy_head", f"{dn} {what} ids", it, it_p, logits,
                      TOL["head"])

            hb = rn(R, H, scale=0.5).to(dt)
            logits_b = logit_head.logits_f32(hb, ww, bb)
            for kk in (2, 3, 6):
                vals, idx, lse = beam_head.beam_head(hb, ww, bb, kk)
                torch.cuda.synchronize()
                vals_p, idx_p, lse_p = beam_head.beam_head_reference(
                    hb, ww, bb, kk)
                err = max((vals - vals_p).abs().max().item(),
                          (lse - lse_p).abs().max().item())
                errs["beam_head"] = max(errs["beam_head"], err)
                report("beam_head", f"{dn} {what} kk={kk} vals/lse", err,
                       TOL["head"])
                if what == "planted ties":
                    want = torch.tensor(planted[:kk], dtype=torch.int32,
                                        device=dev)
                    require(bool((idx == want[None]).all()),
                            f"beam head kk={kk}: planted ties not in "
                            f"lower-id order")
                    require(bool((idx == idx_p).all()),
                            f"beam head kk={kk} ids (ties)")
                ids_agree("beam_head", f"{dn} {what} kk={kk} ids", idx,
                          idx_p, logits_b, TOL["head"])

        if dt == torch.bfloat16:  # serving dtype: time kernel vs plain
            times["attention"] = timed_pair(
                lambda: att_step.fused_attention(h, emb, p_att, wh, bh, wa,
                                                 ba, mask),
                lambda: att_step.attention_reference(h, emb, p_att, wh, bh,
                                                     wa, ba, mask))
            times["greedy_head"] = timed_pair(
                lambda: logit_head.greedy_head(h, w, b),
                lambda: logit_head.greedy_head_reference(h, w, b))
            hb = rn(R, H, scale=0.5).to(dt)
            times["beam_head"] = timed_pair(
                lambda: beam_head.beam_head(hb, w, b, 2),
                lambda: beam_head.beam_head_reference(hb, w, b, 2))
            for name, (k_ms, p_ms) in times.items():
                print(f"  time {name:12s} bf16 kernel {k_ms:.4f} ms  plain "
                      f"{p_ms:.4f} ms", flush=True)
            # the large bucket, for the record
            B4 = 4096
            h4 = rn(B4, H, scale=0.5).to(dt)
            emb4 = rn(B4, K, H).relu().to(dt)
            p4 = rn(B4, K, A).to(dt)
            m4 = torch.ones(B4, K, device=dev)
            big = {
                "attention B=4096": timed_pair(
                    lambda: att_step.fused_attention(h4, emb4, p4, wh, bh,
                                                     wa, ba, m4),
                    lambda: att_step.attention_reference(h4, emb4, p4, wh,
                                                         bh, wa, ba, m4),
                    iters=10),
                "greedy_head B=4096": timed_pair(
                    lambda: logit_head.greedy_head(h4, w, b),
                    lambda: logit_head.greedy_head_reference(h4, w, b),
                    iters=10),
            }
            for name, (k_ms, p_ms) in big.items():
                print(f"  time {name:20s} bf16 kernel {k_ms:.4f} ms  plain "
                      f"{p_ms:.4f} ms", flush=True)
            del h4, emb4, p4, m4
    errs["cell"], times["cell"] = check_cell(rn)
    errs["attention"] = max(errs["attention"], check_attention_grad(rn))
    torch.cuda.synchronize()
    return errs, times


def cell_args(rn, B, dt, with_att):
    H = D = WIDTH
    args = [rn(B, D), rn(B, H, scale=0.5), rn(B, H),
            rn(B, H) if with_att else None,
            rn(D, 5 * H, scale=D ** -0.5), rn(5 * H, scale=0.1),
            rn(H, 5 * H, scale=H ** -0.5), rn(5 * H, scale=0.1),
            rn(H, 2 * H, scale=H ** -0.5) if with_att else None,
            rn(2 * H, scale=0.1) if with_att else None]
    return [None if x is None else x.to(dt) for x in args]


def check_cell(rn):
    """Kernel F against cell_plain (cell_reference in f32 on the same
    inputs), with attention (Att2in2) and without (FC), at the training
    shape (f32, B=128) and the decode buckets (f32 and bf16, B=512 and
    4096).  Each with-attention case is timed beside cell_reference in the
    inputs' type, the cell that runs with CIC_FUSED_CELL unset.  Returns
    (max error, (kernel ms, plain ms) at the training shape)."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import cell_step
    f32, bf16 = torch.float32, torch.bfloat16
    print("cell (kernel F) vs its plain version (D=H=512; CIC_FUSED_CELL=1)",
          flush=True)
    worst, timed = 0.0, {}
    with fused_cell_switch(True):
        for B, dts in ((TRAIN_B, (f32,)), (512, (f32, bf16)),
                       (4096, (f32, bf16))):
            for dt in dts:
                dn = str(dt).split(".")[-1]
                for with_att in (True, False):
                    args = cell_args(rn, B, dt, with_att)
                    h_new, c_new = cell_step.fused_cell(*args)
                    torch.cuda.synchronize()
                    h_p, c_p = cell_step.cell_plain(*args)
                    require(h_new.dtype == dt and c_new.shape == (B, WIDTH),
                            "cell output type/shape")
                    err = max((h_new.float() - h_p.float()).abs().max()
                              .item(), (c_new.float() - c_p.float()).abs()
                              .max().item())
                    worst = max(worst, err)
                    what = f"{dn} B={B} {'att2in2' if with_att else 'fc'}"
                    report("cell", what, err, TOL[("cell", dn)])
                    if with_att:
                        timed[(B, dn)] = timed_pair(
                            lambda: cell_step.fused_cell(*args),
                            lambda: cell_step.cell_reference(*args))
    for (B, dn), (k_ms, p_ms) in timed.items():
        print(f"  time cell B={B:<5d} {dn:9s} kernel {k_ms:.4f} ms  plain "
              f"{p_ms:.4f} ms", flush=True)
    return worst, timed[(TRAIN_B, "float32")]


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
    plain = [x.detach() for x in args]
    k_ms, p_ms = timed_pair(lambda: att_step.fused_attention(*plain, mask),
                            lambda: att_step.attention_reference(*plain,
                                                                 mask))
    print(f"  time attention B={B} f32 (training shape) kernel {k_ms:.4f} ms"
          f"  plain {p_ms:.4f} ms", flush=True)
    return err


# ---------------------------------------------------------------------------
# 4. the slice: serving at full width
# ---------------------------------------------------------------------------

def write_run_dir(params=None, run_dir=RUN_DIR):
    """A full-width Att2in2 run dir holding `params` (a joint tree), or
    random weights from SEED."""
    from cooperativeimagecaptioning_tpu_torch.config import Options
    from cooperativeimagecaptioning_tpu_torch.training import checkpoint, joint
    opt = Options(caption_model="att2in2", vocab_size=VOCAB, rnn_size=WIDTH,
                  input_encoding_size=WIDTH, att_hid_size=WIDTH,
                  fc_feat_size=FEAT, att_feat_size=FEAT, seq_length=L,
                  checkpoint_path=run_dir)
    os.makedirs(run_dir, exist_ok=True)
    vocab = {str(i): f"w{i}" for i in range(1, VOCAB + 1)}
    with open(os.path.join(run_dir, "infos_.pkl"), "wb") as f:
        pickle.dump({"opt": opt, "vocab": vocab}, f)
    if params is None:
        params = joint.init_params(SEED, opt)
    checkpoint.save_params(params, os.path.join(run_dir, "model-best.pth"))
    return opt


def features(n, seed):
    rng = np.random.default_rng(seed)
    fc = rng.standard_normal((n, FEAT), dtype=np.float32)
    att = np.maximum(rng.standard_normal((n, K, FEAT), dtype=np.float32), 0)
    masks = np.ones((n, K), np.float32)
    masks[::4, 30:] = 0.0  # images with fewer regions
    return fc, att, masks


def post_npz(base, fc, att, masks):
    buf = io.BytesIO()
    np.savez(buf, fc=fc, att=att, att_masks=masks)
    req = urllib.request.Request(
        base + "/caption", data=buf.getvalue(),
        headers={"Content-Type": "application/x-npz"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def serve_requests(svc, label, kernel):
    """POST npz requests of 1, 5, 64 and 300 images; check the answers and
    that each bucket call launched attention and `kernel` seq_length times.
    Returns the ids of the 64-image request."""
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
        for n in (1, 5, 64, 300):
            fc, att, masks = features(n, seed=n)
            before = _dispatch.launches()
            out = post_npz(base, fc, att, masks)
            after = _dispatch.launches()
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
                want = L * calls if k in ("attention", kernel) else 0
                got = after[k] - before[k]
                require(got == want, f"{label} n={n}: {k} launched {got} "
                        f"times, expected {want}")
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
    print(f"  main-path launches: {main_launches}", flush=True)

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
        for what, ids_a, ids_b, floor in (
                ("f32 cuda vs f32 cpu", gpu32.caption_ids(fc, att, masks),
                 cpu["float32"], AGREE_F32),
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
    return main_launches


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


def main():
    smi = phase_device()
    sys.path.insert(0, REPO)
    import torch
    phase_build()
    errs, times = phase_kernels()
    with fused_cell_switch(False):
        serve_launches = phase_slice(smi)
    train_launches, _ = phase_train(smi)
    # each path's counts run from 0 just before it to just after it
    kernels = [{"name": k, "route": "cuda", "source": SOURCES[k],
                "replaces": REPLACES[k],
                "launches": serve_launches[k] + train_launches[k],
                "launches_by_path": {"serve": serve_launches[k],
                                     "train": train_launches[k]},
                "max_abs_err": errs[k], "ms": times[k][0],
                "plain_ms": times[k][1]} for k in SOURCES]
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
