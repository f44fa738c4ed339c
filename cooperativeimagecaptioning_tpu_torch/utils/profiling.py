"""Tracing and profiling (counterpart of the JAX package's
utils/profiling.py): `torch.profiler` traces of the host and the card, a
step timer that synchronizes the device, and named trace regions."""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


def sync(tree):
    """Hard device sync: wait for the device of the tree's last tensor
    (a device executes its stream in order)."""
    last = None
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, torch.Tensor):
            last = x
    if last is not None and last.is_cuda:
        torch.cuda.synchronize(last.device)
    return tree


class StepTimer:
    """Rolling per-step wall-clock stats (ref prints time/batch per
    iteration)."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times = []
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)
        if len(self.times) > self.window:
            self.times.pop(0)

    @property
    def mean(self):
        return float(np.mean(self.times)) if self.times else 0.0

    @property
    def p50(self):
        return float(np.median(self.times)) if self.times else 0.0


def activities():
    """What a trace records: the host, and the card when there is one."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


class Trace:
    """A `torch.profiler` trace of the host and the card, written into
    `log_dir` as a Chrome trace (`path`) when it stops."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.path = os.path.join(log_dir,
                                 f"trace_{time.strftime('%Y%m%d_%H%M%S')}_"
                                 f"{os.getpid()}.json")
        self.prof = torch.profiler.profile(activities=activities())

    def start(self):
        self.prof.start()
        return self

    def stop(self) -> str:
        self.prof.stop()
        os.makedirs(self.log_dir, exist_ok=True)
        self.prof.export_chrome_trace(self.path)
        return self.path


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace of the host and the card into `log_dir`."""
    t = Trace(log_dir).start()
    try:
        yield t
    finally:
        t.stop()


def start_server(port: int = 9999):
    """The JAX package's on-demand profiling endpoint
    (`jax.profiler.start_server`) has no counterpart in PyTorch: take a
    trace of a window of iterations instead (`trace`, or the Trainer's
    profile_dir / profile_start / profile_steps)."""
    raise NotImplementedError(
        "start_server: torch.profiler has no on-demand profiling server; "
        "use profiling.trace(log_dir) or --profile_dir")


def annotate(name: str):
    """Named region for traces (a `record_function` range)."""
    return torch.profiler.record_function(name)
