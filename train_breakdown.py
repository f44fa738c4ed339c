#!/usr/bin/env python3
"""Where a training step's time goes, for the PyTorch port on one GPU.

    python3 train_breakdown.py                       # on a CUDA card
    python3 train_breakdown.py --scst                # self-critical steps
    python3 train_breakdown.py --joint               # joint DISC steps
    python3 train_breakdown.py --reinforce           # joint REINFORCE turns
    python3 train_breakdown.py --device-cider        # SCST, host and device
                                                     # reward side by side
    python3 train_breakdown.py --fused 8             # fused chunks vs steps
    python3 train_breakdown.py --device cpu --batch 4 --width 16 --vocab 50
                                                     # dry run, tiny width

Trains chip_smoke.py's configuration (Att2in2, vocab 9487, 512-wide, K=36,
L=16, f32, drop_prob_lm 0.5, synthetic batches) and splits one step into
its stages, each between two synchronizes.  A phase-2 (MLE) step:

  forward   joint.loss_fn: encode, the 17 checkpointed teacher-forced steps
  backward  torch.autograd.grad: each step's recompute (the checkpoint), the
            attention's and the cell's recomputed plain backward, the rest
  adam      OptimizerManager.step: the guarded Adam over the param tree

A self-critical step (--scst: cider_optimization 1, no caption loss, chip
smoke's phase 7 without its resume):

  stage_a   joint.sampler: a sampled and a greedy 16-step decode, no grad
  reward    the ids to the host, CIDEr-D of 2B captions, the reward back
  stage_b   joint.value_and_grad: the sampled decode again under autograd
            (15 checkpointed steps) and its backward
  adam      as above

A joint step (--joint: scripts/run_joint.py -o gumbel, chip smoke's
phase 8 without its seeding: the Att2in2 speaker and the VSE listener,
one effective turn, DISC 0.01 and CIDEr-D 0.99 on DISC's sample) has the
self-critical step's stages: stage_a samples in the gumbel_st mode, stage_b
adds the listener's contrastive loss of the relaxed one-hots and the
backward into both agents, adam steps both.

A joint REINFORCE step (--reinforce: scripts/run_joint.py -o reinforce -v
1, the gt baseline, chip smoke's phase 10 without its seeding) is split by
turn.  The speaker turn has the self-critical step's stages: stage_a
samples in the multinomial mode, stage_b adds the listener's no-grad
forwards of the sample and the GT captions (the REINFORCE coefficient),
adam steps the speaker.  The listener turn has two: stage_b (a sampled
decode of the frozen speaker without autograd, the listener's contrastive
loss of it and its backward) and adam (the listener).

An SCST step with the device reward (--device-cider: on_device_cider 1)
has two stages, stage_b (the sampled decode under autograd, the greedy
baseline and the hashed n-gram CIDEr-D on the card, the backward) and
adam; the same call splits the host-reward SCST step beside it.

--fused K times phase-2 steps with the device feature cache as fused
chunks of K (one CUDA graph of an iteration, replayed per step) against
single steps, K iterations at a time in turns (per-step, fused, fused,
per-step) after a warm-up chunk of each, and traces one chunk of each for
its kernel time and idle share.

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
import functools
import json
import time

import numpy as np

import chip_smoke as cs

MLE_STAGES = ("forward", "backward", "adam")
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


def mle_stages(trainer, data):
    """The stages of one phase-2 step: {name: fn}, in order."""
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
    out = {}

    def forward():
        out["loss"], _ = joint.loss_fn(modules, trainer.params, opt, batch,
                                       trainer.iteration_streams(),
                                       trainer._hyper(), "optimizer")

    def backward():
        got = torch.autograd.grad(out["loss"], [x for _, x in named])
        out["grads"] = from_leaves(
            (path, g) for (path, _), g in zip(named, got))

    def adam():
        trainer.optim.step(trainer.params, out["grads"], "optimizer")

    return dict(zip(MLE_STAGES, (forward, backward, adam)))


def step_stages(stages, trainer, data, sync, wrap=None):
    """Run one step's stages (`stages(trainer, data)`), each followed by a
    synchronize and run inside `wrap(stage)` (a context manager; the
    profiler) when given.  Returns {stage: host-clock ms}."""
    import contextlib
    ms = {}
    sync()
    for stage, fn in stages(trainer, data).items():
        with (wrap(stage) if wrap else contextlib.nullcontext()):
            t0 = time.perf_counter()
            fn()
            sync()
            ms[stage] = (time.perf_counter() - t0) * 1e3
    return ms


def breakdown(stages, trainer, data, device, reps):
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
    names = tuple(stages(trainer, data))
    step_stages(stages, trainer, data, sync)  # warm-up
    walls = {s: [] for s in names}
    for _ in range(reps):
        for s, v in step_stages(stages, trainer, data, sync).items():
            walls[s].append(v)
    r = {"wall_ms": {s: float(np.median(v)) for s, v in walls.items()}}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    profs = {}

    def wrap(stage):
        profs[stage] = profile(activities=acts, record_shapes=True)
        return profs[stage]

    step_stages(stages, trainer, data, sync, wrap)
    table = {s: {} for s in names}
    kernel_ms = {s: 0.0 for s in names}
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
                        for s in names} if cuda else None)
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
    step = p.add_mutually_exclusive_group()
    step.add_argument("--scst", action="store_true",
                      help="self-critical steps instead of phase-2 steps")
    step.add_argument("--joint", action="store_true",
                      help="joint DISC steps (run_joint.py -o gumbel) "
                           "instead of phase-2 steps")
    step.add_argument("--reinforce", action="store_true",
                      help="joint REINFORCE turns (run_joint.py -o "
                           "reinforce -v 1), speaker and listener, instead "
                           "of phase-2 steps")
    step.add_argument("--device-cider", action="store_true",
                      help="SCST steps with the device reward "
                           "(on_device_cider 1) beside SCST steps with the "
                           "host reward")
    step.add_argument("--fused", type=int, default=0, metavar="K",
                      help="phase-2 it/s in fused chunks of K against "
                           "single steps, with the device feature cache")
    a = p.parse_args(argv)
    if a.fused:
        return fused_rates(a)
    import torch

    from cooperativeimagecaptioning_tpu_torch.training.loop import Trainer
    device = torch.device(a.device)
    card = cs.phase_device() if device.type == "cuda" else "cpu"
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    cs.WIDTH, cs.VOCAB = a.width, a.vocab
    ds = cs.train_dataset()
    results = {"card": card, "batch": a.batch, "width": a.width,
               "vocab": a.vocab,
               "step": "scst" if a.scst else "joint" if a.joint else
               "reinforce" if a.reinforce else "device_cider"
               if a.device_cider else "mle"}
    opt = cs.train_opt(a.batch)
    # (result key suffix, stages, options) of each split: one step, one a
    # turn, or one a reward tier
    splits = [("", mle_stages)]
    opts = None
    if a.device_cider:
        opt = opt.replace(phase=3, cider_optimization=1,
                          caption_loss_weight=0)
        splits = [("_host_reward", cs.scst_stages),
                  ("_device_reward", cs.scst_stages)]
        opts = [opt, opt.replace(on_device_cider=1)]
    elif a.scst:
        opt = opt.replace(phase=3, cider_optimization=1,
                          caption_loss_weight=0)
        splits = [("", cs.scst_stages)]
    elif a.joint:
        opt = cs.listener_opt({**cs.JOINT_BASE, **cs.joint_flags("gumbel")},
                              a.batch, checkpoint_path=cs.DISC_RUN_DIR)
        splits = [("", cs.scst_stages)]
    elif a.reinforce:
        opt = cs.listener_opt(
            {**cs.JOINT_BASE, **cs.joint_flags("reinforce", vse=1)},
            a.batch, checkpoint_path=cs.REINFORCE_RUN_DIR)
        splits = [(f"_{turn}", functools.partial(cs.scst_stages, turn=turn))
                  for turn in ("speaker", "listener")]
    for cell, on in (("cell_kernel", True), ("plain_cell", False)):
        with cs.fused_cell_switch(on):
            if opts is not None:
                # one Trainer (and it/s) a reward tier
                rs = {}
                for (key, stages), o in zip(splits, opts):
                    tr = Trainer(o.replace(), dataset=ds, device=a.device,
                                 verbose=False)
                    data = tr.loader.get_batch("train")
                    rs[cell + key] = breakdown(stages, tr, data, device,
                                               a.reps)
                    if device.type == "cuda":
                        rs[cell + key]["it_per_s"] = cs.iterations_per_s(
                            tr, data)
                    del tr
                for name, r in rs.items():
                    results[name] = r
                    print_split(name, r, card, a.batch)
                continue
            tr = Trainer(opt.replace(), dataset=ds, device=a.device,
                         verbose=False)
            data = tr.loader.get_batch("train")
            rs = {cell + key: breakdown(stages, tr, data, device, a.reps)
                  for key, stages in splits}
            if device.type == "cuda":
                # whole iterations: with turns, the turns in turn
                its = cs.iterations_per_s(tr, data)
                if len(splits) == 1:
                    rs[cell]["it_per_s"] = its
                else:
                    results[f"{cell}_alternating_it_per_s"] = its
                    print(f"== {cell}, the turns in turn: {its:.2f} it/s",
                          flush=True)
        for name, r in rs.items():
            results[name] = r
            print_split(name, r, card, a.batch)
        del tr
        if device.type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps(results))


def print_split(name, r, card, batch):
    print(f"== {name} ({card}; B={batch}, f32): "
          + " | ".join(f"{s} {v:.2f} ms" for s, v in r["wall_ms"].items())
          + (f" | {r['it_per_s']:.2f} it/s" if "it_per_s" in r else ""),
          flush=True)
    for s in r["wall_ms"]:
        cats = ", ".join(f"{k} {v:.3f}" for k, v in sorted(
            r["by_category_ms"][s].items(), key=lambda kv: -kv[1]))
        idle = (f"; idle share {r['idle_share'][s]:.3f}"
                if r["idle_share"] else "")
        print(f"  {s:8s} traced kernels "
              f"{r['traced_kernel_ms'][s]:.3f} ms{idle}: {cats}", flush=True)
        print("           top ops: " + ", ".join(
            f"{k} {v:.3f}" for k, v in r["top_ops_ms"][s]), flush=True)


def fused_rates(a):
    """--fused K: phase-2 it/s with the feature cache, fused chunks of K
    against single steps, in turns, CIC_FUSED_CELL=1; one traced chunk of
    each: its kernel time and idle share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cooperativeimagecaptioning_tpu_torch.training.loop import Trainer
    device = torch.device(a.device)
    cuda = device.type == "cuda"
    card = cs.phase_device() if cuda else "cpu"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cs.WIDTH, cs.VOCAB = a.width, a.vocab
    ds = cs.train_dataset()
    K = a.fused
    results = {"card": card, "batch": a.batch, "width": a.width,
               "vocab": a.vocab, "step": "mle", "fused_steps": K}
    trs = {}
    with cs.fused_cell_switch(True):
        for k in (1, K):
            trs[k] = Trainer(cs.train_opt(a.batch).replace(
                fused_steps=k, device_feature_cache=1), dataset=ds,
                device=a.device, verbose=False)

        def chunk(k):
            tr = trs[k]
            sync()
            t0 = time.perf_counter()
            tr.train(max_iterations=tr.iteration + K)
            sync()
            return K / (time.perf_counter() - t0)

        for k in (1, K):
            chunk(k)  # warm-up (the fused trainer captures its graph)
        rates = {1: [], K: []}
        for k in (1, K, K, 1):
            rates[k].append(chunk(k))
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        for k, name in ((1, "per_step"), (K, "fused")):
            wall = K / np.mean(rates[k])
            with profile(activities=acts) as prof:
                chunk(k)
            kernel_s = sum(e.time_range.elapsed_us() for e in prof.events()
                           if e.device_type == DeviceType.CUDA) / 1e6
            results[name] = {
                "it_per_s": float(np.mean(rates[k])),
                "in_turns": rates[k],
                "traced_kernel_ms_per_step": kernel_s / K * 1e3,
                "idle_share": (1.0 - kernel_s / wall) if cuda else None}
            print(f"== {name} ({card}; B={a.batch}, f32, K={K}): "
                  f"{results[name]['it_per_s']:.2f} it/s (in turns "
                  + ", ".join(f"{r:.2f}" for r in rates[k])
                  + f"); traced kernels "
                  f"{results[name]['traced_kernel_ms_per_step']:.3f} ms a "
                  f"step" + (f", idle share "
                             f"{results[name]['idle_share']:.3f}"
                             if cuda else ""), flush=True)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
