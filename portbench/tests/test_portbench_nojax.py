"""No run leaves JAX or the JAX package among the top-level names of
sys.modules (compared whole: the port's name begins with the JAX
package's), and the entry point refuses to run without a card or without
the program beside it."""

from __future__ import annotations

import shutil
import subprocess
import sys

import pytest

from portbench import run
from portbench.core import spec

from .conftest import ROOT

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]

PROBE = """
import sys, time
sys.path.insert(0, {root!r})
import torch
from portbench import run
from portbench.tests.conftest import tiny_cell
cell = tiny_cell({name!r}, {tmp!r})
r = run.run_cell(cell, 5, 0.2, 0, torch.device("cpu"), time.perf_counter())
print("CORRECT", r["correct"])
print("TOP", ",".join(sorted({{m.split(".")[0] for m in sys.modules}})))
print("FORBIDDEN", run.forbidden_modules())
"""


@pytest.mark.parametrize("name", CELLS)
def test_a_run_loads_neither_jax_nor_the_jax_package(name, tmp_path):
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=str(ROOT), name=name,
                                            tmp=str(tmp_path))],
        capture_output=True, text=True, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = dict(ln.split(" ", 1) for ln in out.stdout.splitlines()
                 if ln.split(" ", 1)[0] in ("CORRECT", "TOP", "FORBIDDEN"))
    top = set(lines["TOP"].split(","))
    assert "cooperativeimagecaptioning_tpu_torch" in top
    assert not top & set(run.FORBIDDEN)
    assert lines["FORBIDDEN"] == "[]" and lines["CORRECT"] == "True"


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "cooperativeimagecaptioning_tpu_torch_x",
                        sys.modules[__name__])
    monkeypatch.setitem(sys.modules, "jaxlike", sys.modules[__name__])
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "cooperativeimagecaptioning_tpu.ops",
                        sys.modules[__name__])
    assert run.forbidden_modules() == ["cooperativeimagecaptioning_tpu"]


def _entry(cwd, tmp_path):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=str(cwd),
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
             "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result(tmp_path):
    out = _entry(ROOT, tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_benchmark_alone_does_not_run(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _entry(tmp_path, tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "cannot run" in out.stderr
