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
its main path went through the kernels.
"""

from __future__ import annotations

import os

import torch

KERNELS = ("attention", "greedy_head", "beam_head", "cell")

_launches = {name: 0 for name in KERNELS}


def use_kernel(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (take the plain version).  Any other device raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain path for device {x.device}")


def count(name: str) -> None:
    _launches[name] += 1


def launches() -> dict:
    """{kernel name: launches since the last reset}."""
    return dict(_launches)


def reset_launches() -> None:
    for name in _launches:
        _launches[name] = 0


def fused_cell_enabled() -> bool:
    """CIC_FUSED_CELL=1, read at call time as the JAX package reads it
    (ops/pallas/cell_step.py:128-129); off by default."""
    return os.environ.get("CIC_FUSED_CELL") == "1"


def forward_only(name: str, *tensors) -> None:
    """The vocabulary heads have no backward (decode only): refuse inputs
    that would need one."""
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.requires_grad:
            raise RuntimeError(
                f"{name} is forward-only: an input requires grad (the "
                f"heads run in decode only)")


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
