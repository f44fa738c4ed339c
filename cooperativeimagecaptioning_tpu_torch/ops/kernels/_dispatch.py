"""Device policy and launch counts for the hand-written kernels.

Counterpart of the JAX package's ops/pallas/_dispatch.py, with one rule in
place of its try-and-fall-back:

* a tensor on the CPU takes the kernel's plain PyTorch version;
* a tensor on a CUDA device launches the Hopper kernel, or raises.

There is no fallback from a failing kernel to the plain version: a kernel
that cannot build or launch is an error the caller sees.  No switch turns a
kernel off (the JAX package's CIC_FUSED_CELL is not read: the cell kernel
runs on every CUDA step).

Each kernel has one plain integer launch count, raised by one in its wrapper
right after the launch succeeded and nowhere else, so a run can show that
its main path went through the kernels.  The two vocabulary heads have three
first passes (wgmma fed by TMA for bf16, split TF32 on mma.sync for f32,
FMAs for the shapes neither takes: `logit_head.head_pass`); a second count
per head and pass, raised with the head's own, shows which one a launch
took, and the cell's three kernels (split TF32 for aligned f32, wgmma for
aligned bf16, FMAs for the rest: `cell_step.cell_pass`) are counted the
same way.
The three attention kernels have two widths (16-byte
vectors, or single elements for unaligned shapes: `att_step.vector_width`),
counted the same way, and by the att_h pre-pass they took (split TF32 for
f32, mma.sync below `att_step.PRE_MANY_ROWS` rows of bf16 and a ring of
stages from there, FMAs for unaligned shapes: `att_step.pre_pass`).

A registered vocabulary mesh (`set_vocab_mesh`, the JAX package's
_dispatch.py:53-83) switches the two heads to their vocab-sharded paths:
each rank of a model group runs kernel C on its slice of the logit layer
and `head_merge` merges the group's candidates.  It is process-level state,
set by the Trainer and the Evaluator of a mesh run and cleared by
`Trainer.close()`.
"""

from __future__ import annotations

import torch

KERNELS = ("attention", "attention_q", "attention_kmajor", "greedy_head",
           "beam_head", "cell", "head_merge")

# the heads' launches by first pass: "<head>_tma" (wgmma fed by TMA, bf16),
# "<head>_tf32x3" (split TF32, f32) or "<head>_fma"; the cell's by kernel:
# "cell_tf32x3" (split TF32, f32), "cell_wgmma" (wgmma, bf16) or "cell_fma"
HEAD_PASSES = ("greedy_head_tma", "greedy_head_tf32x3", "greedy_head_fma",
               "beam_head_tma", "beam_head_tf32x3", "beam_head_fma")
CELL_PASSES = ("cell_tf32x3", "cell_wgmma", "cell_fma")

# the dense attentions' launches by width: "<kernel>_vec" or "<kernel>_scalar"
ATT_WIDTHS = ("attention_vec", "attention_scalar", "attention_kmajor_vec",
              "attention_kmajor_scalar", "attention_q_vec",
              "attention_q_scalar")

# the attention calls' launches by att_h pre-pass: "att_h_<pre-pass>"
ATT_PRE = ("att_h_tf32x3", "att_h_mma", "att_h_ring", "att_h_fma")

_launches = {name: 0 for name in
             KERNELS + HEAD_PASSES + CELL_PASSES + ATT_WIDTHS + ATT_PRE}


_vocab_mesh = None


def set_vocab_mesh(mesh, vocab_size: int = 0) -> None:
    """Register (or clear, mesh=None) the mesh whose model axis shards the
    vocabulary matrices of a speaker of `vocab_size` words (logit [H, V+1],
    embedding [V+2, D]); a model axis of 1 clears it.  The port's ranks hold
    local slices, whose shapes do not show the global vocabulary, so it is
    registered beside the mesh (the JAX package reads it off the global
    arrays)."""
    global _vocab_mesh
    if mesh is None or mesh.n_model <= 1:
        _vocab_mesh = None
    else:
        _vocab_mesh = (mesh, int(vocab_size))


def vocab_mesh():
    """(mesh, vocab_size) while a model-sharded mesh is registered, else
    None."""
    return _vocab_mesh


def use_kernel(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (take the plain version).  Any other device raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain path for device {x.device}")


def count(name: str, variant: str = "", pre: str = "") -> None:
    """One launch of kernel `name`; a head also names the pass it took
    ("tma", "tf32x3" or "fma"), the cell its kernel ("tf32x3", "wgmma" or
    "fma"), an attention kernel its width ("vec" or "scalar") and its
    pre-pass (`pre`: "tf32x3", "mma", "ring" or "fma")."""
    _launches[name] += 1
    if variant:
        _launches[f"{name}_{variant}"] += 1
    if pre:
        _launches[f"att_h_{pre}"] += 1


def launches() -> dict:
    """{kernel name: launches since the last reset}."""
    return {name: _launches[name] for name in KERNELS}


def head_pass_launches() -> dict:
    """{"<head>_<pass>": launches since the last reset}; for each head the
    three passes add up to its entry in `launches()`."""
    return {name: _launches[name] for name in HEAD_PASSES}


def cell_pass_launches() -> dict:
    """{"cell_<pass>": launches since the last reset}; together the
    cell's entry in `launches()`."""
    return {name: _launches[name] for name in CELL_PASSES}


def att_width_launches() -> dict:
    """{"<attention kernel>_<width>": launches since the last reset}; for
    each of the three attention kernels the widths add up to its entry in
    `launches()`."""
    return {name: _launches[name] for name in ATT_WIDTHS}


def att_pre_launches() -> dict:
    """{"att_h_<pre-pass>": launches since the last reset}; together the
    launches of the three attention kernels in `launches()`."""
    return {name: _launches[name] for name in ATT_PRE}


def reset_launches() -> None:
    for name in _launches:
        _launches[name] = 0


def forward_only(name: str, *tensors) -> None:
    """The vocabulary heads and the K-major attention have no backward
    (decode only): refuse inputs that would need one."""
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.requires_grad:
            raise RuntimeError(
                f"{name} is forward-only: an input requires grad (it runs "
                f"in decode only)")


def reference_vjp(reference, xs, consts, needs, grads_out):
    """Gradients of `reference(*xs, *consts)` with respect to the xs whose
    `needs` flag is set (None for the others), recomputed under autograd:
    the backward of the kernels' autograd Functions."""
    with torch.enable_grad():
        leaves = [None if x is None else x.detach().requires_grad_(n)
                  for x, n in zip(xs, needs)]
        out = reference(*leaves, *consts)
        out = out if isinstance(out, tuple) else (out,)
        wanted = [x for x, n in zip(leaves, needs) if n]
        got = iter(torch.autograd.grad(out, wanted, grads_out)
                   if wanted else ())
    return tuple(next(got) if n else None for n in needs)


def check_cuda_inputs(name: str, tensors: dict, dtype) -> None:
    """Every named tensor must be a contiguous CUDA tensor of `dtype` on one
    device."""
    dev = None
    for key, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {key} is on {t.device}, expected cuda")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, others on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
