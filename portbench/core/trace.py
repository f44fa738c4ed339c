"""One traced stretch of a run, and what the per-layer metrics read from it.

`traced` runs a stretch under torch.profiler (CUPTI on the card), the
host's clock around it, between two synchronizes.  `Trace` keeps the
device operations (kernels, copies, fills) and the host's ops as (name,
start, end) in microseconds on the profiler's one timeline; the
reductions are the interval arithmetic of train_breakdown.py: the device
is busy over the union of its operations' intervals, idle elsewhere in
the window."""

from __future__ import annotations

import re
import time

TOP = 10  # entries of each breakdown list
SHORT_GAP_US = 5


def union(intervals):
    """Merged [(start, end)] of intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def short_name(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::",
                                                  "")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut][:160]


class Trace:
    def __init__(self, device, host, wall_s, units):
        self.device = device    # [(name, start_us, end_us)]
        self.host = host        # [(name, start_us, end_us)]
        self.wall_s = wall_s    # the host's clock around the stretch
        self.units = units      # work units the stretch ran (steps, requests)

    @property
    def window_s(self):
        """The traced window: from the first device operation's start to
        the last one's end (the stretch's ramp-up from an idle card and its
        final synchronize lie outside; every gap between is inside)."""
        if not self.device:
            return self.wall_s
        return (max(e for _, _, e in self.device)
                - min(s for _, s, _ in self.device)) / 1e6

    @property
    def busy_s(self):
        return sum(e - s for s, e in union(
            (s, e) for _, s, e in self.device)) / 1e6

    def matching(self, patterns):
        """Device operations whose name holds one of `patterns`."""
        return [d for d in self.device if any(p in d[0] for p in patterns)]

    def seconds(self, patterns):
        return sum(e - s for _, s, e in self.matching(patterns)) / 1e6

    def device_ops(self):
        """[[name, seconds]] of the device operations that took most time."""
        by = {}
        for name, s, e in self.device:
            key = short_name(name)
            by[key] = by.get(key, 0.0) + (e - s) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                ][:TOP]

    def idle_gaps(self):
        """[[what the host was doing, seconds]]: the device's idle time
        between its first and last operation, summed by what the host was
        doing: each gap of SHORT_GAP_US or more named by the innermost host
        op around its middle, the shorter ones (the bubbles between
        operations queued back to back) together."""
        busy = union((s, e) for _, s, e in self.device)
        by = {}
        for (_, a), (b, _) in zip(busy, busy[1:]):
            if b - a < SHORT_GAP_US:
                name = f"between queued operations (< {SHORT_GAP_US} us)"
            else:
                mid = (a + b) / 2
                around = [h for h in self.host if h[1] <= mid <= h[2]]
                name = min(around, key=lambda h: h[2] - h[1])[0] if around \
                    else "host (no op)"
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                ][:TOP]


def traced(fn, device):
    """Run fn() (which returns the work units it ran) under the profiler,
    the host's clock around it from one synchronize to the next."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        units = fn()
        torch.cuda.synchronize(device)
        window = time.perf_counter() - t0
    dev, host = [], []
    for e in prof.events():
        row = (e.name, e.time_range.start, e.time_range.end)
        (dev if e.device_type == DeviceType.CUDA else host).append(row)
    return Trace(dev, host, window, units)
