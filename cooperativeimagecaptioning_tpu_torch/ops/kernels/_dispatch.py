"""Device policy and launch counts for the hand-written kernels.

Counterpart of the JAX package's ops/pallas/_dispatch.py, with one rule in
place of its try-and-fall-back:

* a tensor on the CPU takes the kernel's plain PyTorch version;
* a tensor on a CUDA device launches the Hopper kernel, or raises.

There is no fallback from a failing kernel to the plain version: a kernel
that cannot build or launch is an error the caller sees.  The one switch is
the JAX package's own: the fused cell runs only under CIC_FUSED_CELL=1
(`fused_cell_enabled`), off by default as in ops/pallas/cell_step.py; with
it unset the cell is the plain version on every device.

Each kernel has one plain integer launch count, raised by one in its wrapper
right after the launch succeeded and nowhere else, so a run can show that
its main path went through the kernels.  The two vocabulary heads have two
first passes (tensor cores for bf16, FMAs for the rest: `logit_head.head_pass`);
a second count per head and pass, raised with the head's own, shows which
one a launch took, and the cell's two kernels (tensor cores for aligned
bf16, FMAs for the rest: `cell_step.cell_pass`) are counted the same way.
The three attention kernels have two widths (16-byte
vectors, or single elements for unaligned shapes: `att_step.vector_width`),
counted the same way.
"""

from __future__ import annotations

import os

import torch

KERNELS = ("attention", "attention_q", "attention_kmajor", "greedy_head",
           "beam_head", "cell")

# the heads' launches by first pass: "<head>_mma" (wgmma) or "<head>_fma";
# the cell's by kernel: "cell_mma" (mma.sync) or "cell_fma"
HEAD_PASSES = ("greedy_head_mma", "greedy_head_fma", "beam_head_mma",
               "beam_head_fma")
CELL_PASSES = ("cell_mma", "cell_fma")

# the dense attentions' launches by width: "<kernel>_vec" or "<kernel>_scalar"
ATT_WIDTHS = ("attention_vec", "attention_scalar", "attention_kmajor_vec",
              "attention_kmajor_scalar", "attention_q_vec",
              "attention_q_scalar")

_launches = {name: 0 for name in
             KERNELS + HEAD_PASSES + CELL_PASSES + ATT_WIDTHS}


def use_kernel(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (take the plain version).  Any other device raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain path for device {x.device}")


def count(name: str, variant: str = "") -> None:
    """One launch of kernel `name`; a head or the cell also names the pass
    it took ("mma" or "fma"), an attention kernel its width ("vec" or
    "scalar")."""
    _launches[name] += 1
    if variant:
        _launches[f"{name}_{variant}"] += 1


def launches() -> dict:
    """{kernel name: launches since the last reset}."""
    return {name: _launches[name] for name in KERNELS}


def head_pass_launches() -> dict:
    """{"<head>_<pass>": launches since the last reset}; for each head the
    two passes add up to its entry in `launches()`."""
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


def reset_launches() -> None:
    for name in _launches:
        _launches[name] = 0


def fused_cell_enabled() -> bool:
    """CIC_FUSED_CELL=1, read at call time as the JAX package reads it
    (ops/pallas/cell_step.py:128-129); off by default."""
    return os.environ.get("CIC_FUSED_CELL") == "1"


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
