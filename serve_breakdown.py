#!/usr/bin/env python3
"""Where a served request's time goes, for the PyTorch port on one GPU.

    python3 serve_breakdown.py                       # on a CUDA card
    python3 serve_breakdown.py --device cpu --cells greedy:8   # dry run

Serves chip_smoke.py's full-width run dir (Att2in2, vocab 9487, 512-wide,
K=36, L=16, random weights from a numpy seed) in bf16, one request at a
time, and splits a request of each cell into the service's own stages:

  request   CaptioningService.caption_ids, host features in, host ids out
  cast      the host-side f32 -> bf16 feature cast (CaptioningService._to_device)
  h2d       the copy of the cast features to the card (pageable memory)
  encode    AttModel.encode_features
  decode    decoding.sample / decoding.beam_search, and the host time to
            enqueue it (no synchronize inside)
  d2h       the ids back to the host

plus, for comparison, the f32 feature copy from pageable and from pinned
memory and a cast on the card.  Host-clock stages are medians of --reps
runs, each between two synchronizes.  One decode is traced with
torch.profiler: its GPU kernels, summed by name and by group (the vocabulary
heads: both first passes and both merge kernels; the attention kernels; the
rest), and the device's idle share over the decode (1 - union of the traced
kernel intervals / the untraced decode's host-clock time; tracing slows the
host, not the kernels).

The last line is one JSON object with every number printed.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

import chip_smoke as cs


def median_ms(fn, sync, reps):
    out, ts = None, []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3, out


def busy_ms(intervals):
    """Length of the union of (start, end) intervals, in the intervals'
    unit (microseconds for profiler events) / 1e3."""
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


# substrings of the hand-written kernels' names, by group: the heads' first
# passes (vocab_partials, vocab_partials_tma, vocab_partials_tf32) and the
# two merge kernels; the attention's stream kernel (all three layouts) and
# its att_h pre-pass
KERNEL_GROUPS = {"head": ("vocab_partials", "greedy_merge", "beam_merge"),
                 "attention": ("attention_kernel", "att_h_mma_kernel",
                               "att_h_fma_kernel")}


def kernel_group(name):
    for group, parts in KERNEL_GROUPS.items():
        if any(p in name for p in parts):
            return group
    return "rest"


def kernel_events(prof):
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def breakdown(svc, n, reps, device):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cooperativeimagecaptioning_tpu_torch.ops import decoding

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    L, m = svc.opt.seq_length, svc.beam_size
    fc, att, masks = cs.features(n, seed=n)
    svc.caption_ids(fc[:2], att[:2], masks[:2])

    def decode(ctx):
        if m > 1:
            return decoding.beam_search(svc.speaker, ctx, L, m)
        return decoding.sample(svc.speaker, ctx, L)

    r = {}
    r["request"], _ = median_ms(lambda: svc.caption_ids(fc, att, masks),
                                sync, reps)
    r["cast"], x = median_ms(lambda: torch.from_numpy(np.ascontiguousarray(
        att, dtype=np.float32)).to(svc._dtype), sync, reps)
    r["h2d"], xd = median_ms(lambda: x.to(device), sync, reps)
    r["h2d_f32_pageable"], x32 = median_ms(
        lambda: torch.from_numpy(att).to(device), sync, reps)
    r["device_cast"], _ = median_ms(lambda: x32.to(svc._dtype), sync, reps)
    if cuda:
        pinned = torch.from_numpy(att).pin_memory()
        r["h2d_f32_pinned"], _ = median_ms(
            lambda: pinned.to(device, non_blocking=True), sync, reps)
    am = torch.from_numpy(masks).to(device)
    with torch.inference_mode():
        r["encode"], ctx = median_ms(
            lambda: svc.speaker.encode_features(None, xd, am), sync, reps)
        r["decode"], out = median_ms(lambda: decode(ctx), sync, reps)
        r["d2h"], _ = median_ms(lambda: out.seq.cpu(), sync, reps)
        sync()
        t0 = time.perf_counter()
        decode(ctx)
        r["decode_enqueue"] = (time.perf_counter() - t0) * 1e3
        sync()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            decode(ctx)
            sync()
            wall = (time.perf_counter() - t0) * 1e3
    kern = kernel_events(prof)
    busy = busy_ms((e.time_range.start, e.time_range.end) for e in kern)
    r["traced_decode"] = wall
    r["kernel_busy"] = busy
    r["device_idle_share"] = 1.0 - busy / r["decode"] if cuda else None
    by_name = {}
    for e in kern:
        c, t = by_name.get(e.name[:90], (0, 0.0))
        by_name[e.name[:90]] = (c + 1, t + e.time_range.elapsed_us() / 1e3)
    r["kernels"] = sorted(([k, c, t] for k, (c, t) in by_name.items()),
                          key=lambda row: -row[2])[:12]
    r["kernel_groups"] = {g: 0.0 for g in (*KERNEL_GROUPS, "rest")}
    for e in kern:
        r["kernel_groups"][kernel_group(e.name)] += \
            e.time_range.elapsed_us() / 1e3
    return r


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--cells", nargs="+",
                   default=["greedy:512", "greedy:4096", "beam2:512"],
                   help="mode:bucket, mode in greedy / beam2")
    p.add_argument("--reps", type=int, default=3)
    a = p.parse_args(argv)
    import torch

    from cooperativeimagecaptioning_tpu_torch.serving import CaptioningService
    device = torch.device(a.device)
    card = cs.phase_device() if device.type == "cuda" else "cpu"
    cs.write_run_dir()
    results = {"card": card}
    for cell in a.cells:
        mode, bucket = cell.split(":")
        beam = 2 if mode == "beam2" else 0
        svc = CaptioningService.from_run_dir(
            cs.RUN_DIR, beam_size=beam, compute_dtype="bfloat16",
            buckets=(int(bucket),), device=a.device)
        r = breakdown(svc, int(bucket), a.reps, device)
        results[cell] = r
        print(f"== {cell} ({card}): request {r['request']:.2f} ms = "
              f"{int(bucket) / r['request'] * 1e3:.1f} captions/s", flush=True)
        print("  " + " | ".join(f"{k} {r[k]:.2f} ms" for k in (
            "cast", "h2d", "encode", "decode", "decode_enqueue", "d2h")))
        print("  f32 features instead: h2d pageable "
              f"{r['h2d_f32_pageable']:.2f} ms"
              + (f", pinned {r['h2d_f32_pinned']:.2f} ms"
                 if "h2d_f32_pinned" in r else "")
              + f", cast on the device {r['device_cast']:.2f} ms")
        if r["device_idle_share"] is not None:
            print(f"  traced decode {r['traced_decode']:.2f} ms, kernels busy "
                  f"{r['kernel_busy']:.2f} ms, device idle share "
                  f"{r['device_idle_share']:.3f} of the untraced decode")
        print("  kernel time by group: " + ", ".join(
            f"{g} {ms:.3f} ms" for g, ms in r["kernel_groups"].items()))
        for name, count, ms in r["kernels"]:
            print(f"    {ms:8.3f} ms {count:5d}x  {name}")
        del svc
        if device.type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps(results))


if __name__ == "__main__":
    main()
