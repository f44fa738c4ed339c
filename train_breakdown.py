#!/usr/bin/env python3
"""Where a phase-2 training step's time goes, for the PyTorch port on one GPU.

    python3 train_breakdown.py                       # on a CUDA card
    python3 train_breakdown.py --device cpu --batch 4 --width 16 --vocab 50
                                                     # dry run, tiny width

Trains chip_smoke.py's configuration (Att2in2, vocab 9487, 512-wide, K=36,
L=16, f32, drop_prob_lm 0.5, synthetic batches) and splits one step into
its three stages, each between two synchronizes:

  forward   joint.loss_fn: encode, the 17 checkpointed teacher-forced steps
  backward  torch.autograd.grad: each step's recompute (the checkpoint), the
            attention's and the cell's recomputed plain backward, the rest
  adam      OptimizerManager.step: the guarded Adam over the param tree

Each stage is then traced in its own torch.profiler session, and its GPU
time is summed into:
the attention kernel, the cell kernel, the logits and log-softmax (every
op that touches a [*, V+1] tensor: the logit product and its two backward
products, log-softmax and its backward, the target gather), other matrix
products, and the remaining elementwise and reduction kernels; the six
ops with the most GPU time are listed by name.  Each stage
also gets its device idle share (1 - traced kernel time / its untraced
host-clock time).  It does so with CIC_FUSED_CELL=1 (the cell kernel) and
with it unset (the plain cell), and times it/s for both.

The last line is one JSON object with every number printed.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

import chip_smoke as cs

STAGES = ("forward", "backward", "adam")
MATMULS = ("aten::mm", "aten::addmm", "aten::bmm")
# the kernels' autograd Functions: the profiler records each as an op whose
# self GPU time is the package kernel it launched, counted by kernel name
FUNCTIONS = ("Attention", "Cell")


def category(e, v1):
    """Category of a CPU op by its name and input shapes."""
    shapes = getattr(e, "input_shapes", None) or []
    if any(v1 in s for s in shapes if isinstance(s, (list, tuple))):
        return "logits+log_softmax"
    if e.name in MATMULS:
        return "other matmul"
    return "elementwise+reduce"


def step_stages(trainer, data, sync, wrap=None):
    """Run one training step as its three stages, each ending in a
    synchronize and run inside `wrap(stage)` (a context manager; the
    profiler) when given.  Returns {stage: host-clock ms}."""
    import contextlib

    import torch
    from cooperativeimagecaptioning_tpu_torch import models as model_zoo
    from cooperativeimagecaptioning_tpu_torch.training import joint
    from cooperativeimagecaptioning_tpu_torch.utils.tree import (
        from_leaves, leaves)
    opt = trainer.opt
    modules = {"speaker": model_zoo.setup(opt, opt.caption_model,
                                          "caption_model")}
    batch = trainer._prepare_batch(data)
    named = leaves(trainer.params)
    out, ms = {}, {}

    def forward():
        out["loss"], _ = joint.loss_fn(modules, trainer.params, opt, batch,
                                       trainer.gen, trainer._hyper(),
                                       "optimizer")

    def backward():
        got = torch.autograd.grad(out["loss"], [x for _, x in named])
        out["grads"] = from_leaves(
            (path, g) for (path, _), g in zip(named, got))

    def adam():
        trainer.optim.step(trainer.params, out["grads"], "optimizer")

    sync()
    for stage, fn in zip(STAGES, (forward, backward, adam)):
        with (wrap(stage) if wrap else contextlib.nullcontext()):
            t0 = time.perf_counter()
            fn()
            sync()
            ms[stage] = (time.perf_counter() - t0) * 1e3
    return ms


def breakdown(trainer, data, device, reps):
    """Untraced stage times (median of reps), then one step traced stage by
    stage: one profiler session for each stage, so that every kernel and op
    belongs to the stage it ran in (the backward runs on autograd's own
    thread)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    v1 = trainer.opt.vocab_size + 1
    step_stages(trainer, data, sync)  # warm-up
    walls = {s: [] for s in STAGES}
    for _ in range(reps):
        for s, v in step_stages(trainer, data, sync).items():
            walls[s].append(v)
    r = {"wall_ms": {s: float(np.median(v)) for s, v in walls.items()}}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    profs = {}

    def wrap(stage):
        profs[stage] = profile(activities=acts, record_shapes=True)
        return profs[stage]

    step_stages(trainer, data, sync, wrap)
    table = {s: {} for s in STAGES}
    kernel_ms = {s: 0.0 for s in STAGES}
    top_ops = {}
    for stage, prof in profs.items():
        cats = table[stage]
        ops = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                ms = e.time_range.elapsed_us() / 1e3
                kernel_ms[stage] += ms
                # the package's own kernels launch through ctypes, under no
                # op (the attention's att_h pre-pass counts with it)
                for name, key in (("attention_kernel", "attention kernel"),
                                  ("att_h_", "attention kernel"),
                                  ("cell_mma_kernel", "cell kernel"),
                                  ("cell_fma_kernel", "cell kernel")):
                    if name in e.name:
                        cats[key] = cats.get(key, 0.0) + ms
            elif e.self_device_time_total > 0 and e.name not in FUNCTIONS:
                ms = e.self_device_time_total / 1e3
                key = category(e, v1)
                cats[key] = cats.get(key, 0.0) + ms
                ops[e.name] = ops.get(e.name, 0.0) + ms
        top_ops[stage] = sorted(ops.items(), key=lambda kv: -kv[1])[:6]
    r["traced_kernel_ms"] = kernel_ms
    r["top_ops_ms"] = top_ops
    r["by_category_ms"] = table
    r["idle_share"] = ({s: 1.0 - kernel_ms[s] / r["wall_ms"][s]
                        for s in STAGES} if cuda else None)
    return r


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--batch", type=int, default=cs.TRAIN_B)
    p.add_argument("--width", type=int, default=cs.WIDTH,
                   help="rnn / input-encoding / att-hid size (a dry run "
                        "cuts it)")
    p.add_argument("--vocab", type=int, default=cs.VOCAB)
    p.add_argument("--reps", type=int, default=3)
    a = p.parse_args(argv)
    import torch

    from cooperativeimagecaptioning_tpu_torch.training.loop import Trainer
    device = torch.device(a.device)
    card = cs.phase_device() if device.type == "cuda" else "cpu"
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    cs.WIDTH, cs.VOCAB = a.width, a.vocab
    ds = cs.train_dataset()
    results = {"card": card, "batch": a.batch, "width": a.width,
               "vocab": a.vocab}
    for cell, on in (("cell_kernel", True), ("plain_cell", False)):
        with cs.fused_cell_switch(on):
            tr = Trainer(cs.train_opt(a.batch), dataset=ds, device=a.device,
                         verbose=False)
            data = tr.loader.get_batch("train")
            r = breakdown(tr, data, device, a.reps)
            if device.type == "cuda":
                r["it_per_s"] = cs.iterations_per_s(tr, data)
        results[cell] = r
        print(f"== {cell} ({card}; B={a.batch}, f32): "
              + " | ".join(f"{s} {r['wall_ms'][s]:.2f} ms" for s in STAGES)
              + (f" | {r['it_per_s']:.2f} it/s" if "it_per_s" in r else ""),
              flush=True)
        for s in STAGES:
            cats = ", ".join(f"{k} {v:.3f}" for k, v in sorted(
                r["by_category_ms"][s].items(), key=lambda kv: -kv[1]))
            idle = (f"; idle share {r['idle_share'][s]:.3f}"
                    if r["idle_share"] else "")
            print(f"  {s:8s} traced kernels {r['traced_kernel_ms'][s]:.3f} "
                  f"ms{idle}: {cats}", flush=True)
            print("           top ops: " + ", ".join(
                f"{k} {v:.3f}" for k, v in r["top_ops_ms"][s]), flush=True)
        del tr
        if device.type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps(results))


if __name__ == "__main__":
    main()
