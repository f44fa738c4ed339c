"""The arithmetic the per-layer metrics share.  Each metric of
portbench/metrics/ is a file of its own whose `read(run)` calls one of
these for its cell's kind; a reader that finds nothing to read returns
None and the harness leaves the metric out of the line.

`run` carries: kind ('train' or 'decode'), window {'seconds', 'units',
'flops', 'precision'}, trace (core.trace.Trace of the traced stretch, or
None), peaks (core.peaks), kernel_shapes {family: shape}, counters."""

from __future__ import annotations

from portbench.core import spec


def mfu(run, kind):
    """Percent of the precision's peak: the products' FLOPs of the window's
    work over the window's seconds."""
    w = run.window
    if run.kind != kind or not w.get("units"):
        return None
    return 100.0 * w["flops"] / w["seconds"] / run.peaks[w["precision"]]


def idle_share(run, kind):
    """Percent of the traced window in which no operation ran on the card."""
    t = run.trace
    if run.kind != kind or t is None or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def device_ms_per_unit(run, kind):
    """Milliseconds the card was busy a unit of work (a step, a request)
    over the traced window."""
    t = run.trace
    if run.kind != kind or t is None or not t.device or not t.units:
        return None
    return 1e3 * t.busy_s / t.units


def roofline(run, family, kind):
    """Percent: the bound of the traced calls of a kernel family over the
    device time of its launches (None where none of it ran)."""
    t = run.trace
    shape = run.kernel_shapes.get(family)
    if run.kind != kind or t is None or shape is None:
        return None
    fam = spec.load_module("kernels", family)
    calls = len(t.matching((fam.CALL,)))
    seconds = t.seconds(fam.PATTERNS)
    if calls == 0 or seconds <= 0.0:
        return None
    return 100.0 * calls * fam.bound(shape, run.peaks) / seconds


def counter(run, name, kind):
    if run.kind != kind:
        return None
    return run.counters.get(name)
