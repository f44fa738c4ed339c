"""The readings a cell's limits are set from, on the card at the cell's own
sizes (the benchmark's runs do not run this):

    python3 portbench/controls.py --workload <name> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--faults 1] [--fault-kinds a,b] [--out FILE]

For each seed, the program's reading of every number the cell compares,
as a run reads it (training: its set-up's first steps against the
reference; decode: a short window at the cell's load, then its sampled
requests).  For each control seed also the control's: the reference put
in the program's place one precision lower than the configuration states
(training: float32 products in TF32, and the float32 reference's own
gap to a float64 one; decode: bf16 products' inputs in fp8 e4m3), and
with --faults 1 each planted fault's (faults.py; --fault-kinds: only
those).  One
JSON object on the last line of standard output, and in --out."""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

DECODE_WINDOW_S = 2.0  # a short window: its requests finish and are sampled


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def train_readings(cell, drv, seed, device, control, fault=None):
    import torch

    from portbench import faults
    out = {}
    with (faults.train(fault, cell.config["vocab_size"]) if fault
          else contextlib.nullcontext()):
        st = drv.setup(cell, seed, device)
    drv.release(st)
    ref = drv.reference(st)
    key = fault or "program"
    out[key] = drv.judged(st, st.program, ref)
    if control and not fault:
        out["control_tf32"] = drv.judged(st, drv.reference(st, tf32=True),
                                         ref)
        # a second witness: the float32 reference against float64
        out["reference_vs_f64"] = drv.compare(
            ref, drv.reference(st, dtype=torch.float64))
    return out


def decode_readings(cell, drv, seed, device, control, fault=None):
    from portbench import faults
    from portbench.reference import common
    with (faults.decode(fault, cell.config["vocab_size"]) if fault
          else contextlib.nullcontext()):
        st = drv.setup(cell, seed, device)
        drv.window(st, DECODE_WINDOW_S)
    drv.release(st)
    r = drv.read(st, drv.sample(st),
                 common.fp8 if control and not fault else None)
    out = {fault or "program": r["program"], "tokens_read": r["tokens_read"]}
    if r["control"] is not None:
        out["control_fp8"] = r["control"]
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", type=int, default=0)
    p.add_argument("--fault-kinds", default="")
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    import torch

    from portbench import faults, run
    from portbench.core import spec
    if not torch.cuda.is_available():
        print("controls: no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    cell = spec.Cell(a.workload)
    drv = cell.driver()
    readings = train_readings if drv.KIND == "train" else decode_readings
    kinds = faults.TRAIN if drv.KIND == "train" else faults.DECODE
    if a.fault_kinds:
        kinds = [k for k in kinds if k in a.fault_kinds.split(",")]
    ctrl = set(_seeds(a.control_seeds))
    rows = []
    for seed in sorted(set(_seeds(a.seeds)) | ctrl):
        t0 = time.perf_counter()
        row = {"seed": seed, **readings(cell, drv, seed, device,
                                        seed in ctrl)}
        if a.faults and seed in ctrl:
            for kind in kinds:
                row.update({k: v for k, v in readings(
                    cell, drv, seed, device, False, kind).items()
                    if k != "tokens_read"})
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), file=sys.stderr, flush=True)
    result = {"workload": a.workload, "device": torch.cuda.get_device_name(0),
              "power": run.power_limit(), "rows": rows}
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
