"""Run one cell of the port's benchmark once, and print its result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The cell (BENCHMARK.json's `workloads`) names a configuration and a
traffic mix; the mix names its driver (portbench/drivers/).  A run: the
driver's set-up (building, drawing the inputs and weights from the seed,
warming up every shape the cell uses: `setup_s` counts from the start of
the process to here), the measured window of --seconds, with --trace 1 a
traced stretch after it, then the program's state freed and the plain
reference's comparison, which decides `correct`.  The last line of
standard output is the result, one JSON object; the numbers compared, with
their limits, are also the last lines of standard error.  It exits with a
code other than 0, printing no result, where there is no card or too few,
where a part of the cell is missing, and where JAX or the JAX package was
loaded.  Only the PyTorch port (cooperativeimagecaptioning_tpu_torch) is
run; nothing here imports JAX.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "cooperativeimagecaptioning_tpu")


def forbidden_modules():
    """The forbidden top-level names among sys.modules, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Run:
    """What the per-layer metrics read (core/readers.py)."""

    def __init__(self, kind, window, trace, peaks, kernel_shapes, counters):
        self.kind = kind
        self.window = window
        self.trace = trace
        self.peaks = peaks
        self.kernel_shapes = kernel_shapes
        self.counters = counters


def power_limit():
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(cell, seed, seconds, trace, device, t0=T0):
    """One run of `cell` on `device`; returns the result dict."""
    import torch

    from portbench.core import peaks as peaks_mod
    from portbench.core import spec, trace as trace_mod
    cuda = device.type == "cuda"
    drv = cell.driver()
    st = drv.setup(cell, seed, device)
    setup_s = time.perf_counter() - t0
    drv.window(st, seconds)
    tr = trace_mod.traced(lambda: drv.trace_stretch(st), device) \
        if trace and cuda else None
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    attempted, failed = drv.attempted(st)
    name = torch.cuda.get_device_name(device) if cuda else "cpu"
    result = {"correct": False, "attempted": int(attempted),
              "failed": int(failed), "metrics": {},
              "device": {"platform": "gpu" if cuda else "cpu", "kind": name,
                         "count": cell.chips, "memory_peak_bytes": peak}}
    if trace:
        run = Run(drv.KIND, drv.window_info(st), tr,
                  peaks_mod.peaks_of(name) if cuda else None,
                  drv.kernel_shapes(st), drv.counters(st))
        for m in cell.per_layer:
            v = spec.load_module("metrics", m["name"]).read(run) \
                if cuda else None
            if v is not None:
                result["metrics"][m["name"]] = {"value": float(v),
                                                "unit": m["unit"]}
        if tr is not None:
            result["device"]["busy_s"] = tr.busy_s
            result["device"]["window_s"] = tr.window_s
            result["breakdown"] = {"device_ops": tr.device_ops(),
                                   "idle_gaps": tr.idle_gaps()}
    else:
        values = dict(drv.end_to_end(st), setup_s=setup_s)
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = {"value": float(values[m["name"]]),
                                            "unit": m["unit"]}
    if cuda:
        result["device"]["power"] = power_limit()
    drv.release(st)
    numbers = drv.check(st)
    if set(numbers) != set(cell.limits):
        raise KeyError(f"numbers {sorted(numbers)} against limits "
                       f"{sorted(cell.limits)}")
    compared = {k: {"value": float(v), "limit": float(cell.limits[k])}
                for k, v in numbers.items()}
    result["correct"] = failed == 0 and all(
        c["value"] <= c["limit"] for c in compared.values())
    result["compared"] = compared
    for k, c in compared.items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    try:
        import torch

        from portbench.core import spec
        import cooperativeimagecaptioning_tpu_torch  # noqa: F401
        cell = spec.Cell(a.workload)
    except (ImportError, OSError, KeyError) as e:
        print(f"portbench: cannot run {a.workload!r}: {e!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {a.workload} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, "
              f"count {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    result = run_cell(cell, a.seed, a.seconds, a.trace, device)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 4
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
