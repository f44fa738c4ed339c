"""BENCHMARK.json against the benchmark's contract, and every part of
every cell found by its name."""

from __future__ import annotations

import json
import re

import pytest

from portbench.core import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
CONFIGS = [c["name"] for c in BENCH["configs"]]
TRAFFIC = sorted({w["traffic"] for w in BENCH["workloads"]})
METRICS = [m["name"] for m in BENCH["per_layer"]]
FAMILIES = ["attention", "beam_head", "cell"]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_full_check_fits_its_time():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_keys():
    names = []
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        names.append(w["name"])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_end_to_end_bounds_and_sources():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in CELLS:
        reported = [n for n, m in e2e.items()
                    if w in m.get("workloads", [w])]
        assert "setup_s" in reported and len(reported) >= 2


def test_per_layer_metrics_move_a_reported_metric():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "\n" not in m["layer"] and m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
    for w in CELLS:
        assert spec.Cell(w).per_layer


@pytest.mark.parametrize("name", CONFIGS)
def test_config_loads_by_name(name):
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    assert entry["file"] == f"portbench/configs/{name}.json"
    cfg = json.loads((spec.ROOT / entry["file"]).read_text())
    assert cfg["name"] == name and cfg["reduced"] == entry["reduced"]
    assert cfg["source"].startswith(entry["source"])
    from portbench.reference import speaker
    mod = speaker.model(cfg["caption_model"])
    assert mod.leaves(cfg)


@pytest.mark.parametrize("name", TRAFFIC)
def test_traffic_and_its_driver_load_by_name(name):
    tr = json.loads((spec.HERE / "traffic" / f"{name}.json").read_text())
    drv = spec.load_module("drivers", tr["driver"])
    for fn in ("setup", "window", "trace_stretch", "end_to_end", "check",
               "release", "attempted", "window_info", "kernel_shapes",
               "counters"):
        assert callable(getattr(drv, fn))
    assert drv.KIND in ("train", "decode")


@pytest.mark.parametrize("name", METRICS)
def test_metric_reader_loads_by_name(name):
    assert callable(spec.load_module("metrics", name).read)


@pytest.mark.parametrize("name", FAMILIES)
def test_kernel_family_loads_by_name(name):
    fam = spec.load_module("kernels", name)
    assert any(fam.CALL in p or p in fam.CALL for p in fam.PATTERNS)
    assert callable(fam.bound)


@pytest.mark.parametrize("name", CELLS)
def test_cell_limits_load_by_name(name):
    cell = spec.Cell(name)
    assert cell.limits and all(v > 0 for v in cell.limits.values())


def test_roofline_metrics_name_their_family():
    for m in METRICS:
        assert "roofline" not in m or "_roofline." in m
        if "_roofline." in m:
            assert m.split("_roofline.")[0] in FAMILIES
            assert m.split(".")[-1] in ("train", "decode")
