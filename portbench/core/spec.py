"""Finding a cell's parts by name.  BENCHMARK.json names each cell's
configuration and traffic mix; everything else is a file of its own under
portbench/, found by the name it serves:

    configs/<config>.json         the configuration as it is run
    traffic/<traffic>.json        the traffic mix; its 'driver' names
    drivers/<driver>.py           the code that runs that kind of traffic
    cells/<workload>.json         the limits of the comparison of `correct`
    metrics/<metric>.py           a per-layer metric's reader, read(run)
    kernels/<family>.py           a kernel family's names, operations, bytes
    reference/<caption_model>.py  the configuration's plain reference

so a later change adds a cell, a driver, a metric or a family by adding
files, and edits none."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]   # portbench/
ROOT = HERE.parent                            # the checkout


def _json(path: Path):
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT):
    return _json(root / "BENCHMARK.json")


def load_module(kind: str, name: str):
    """portbench/<kind>/<name>.py as a module (names may hold '.' and '-')."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT)}")
    mod_name = f"portbench_{kind}_" + "".join(
        ch if ch.isalnum() else "_" for ch in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of BENCHMARK.json's workloads with its parts loaded."""

    def __init__(self, name: str, bench=None, root: Path = ROOT):
        bench = bench if bench is not None else benchmark(root)
        # where the program may write its run dir (it writes nothing there
        # in a run): inside the checkout, at a fixed path
        self.run_dir = root / "build" / "portbench" / "run"
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.entry = found[0]
        self.name = name
        self.chips = int(self.entry["chips"])
        self.config = _json(HERE / "configs" / f"{self.entry['config']}.json")
        self.traffic = _json(HERE / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = _json(HERE / "cells" / f"{name}.json")["limits"]
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m["workloads"]]

    def driver(self):
        return load_module("drivers", self.traffic["driver"])
