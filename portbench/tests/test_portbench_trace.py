"""The trace reductions and the per-layer readers on a made-up trace: the
device's busy time is the union of its operations, a roofline share is
the family's bound over its launches' time, a reader with nothing to read
returns None."""

from __future__ import annotations

import pytest

from portbench.core import peaks, spec
from portbench.core.trace import Trace, short_name, union
from portbench.run import Run

H100 = peaks.peaks_of("NVIDIA H100 80GB HBM3")
SHAPE = {"rows": 8192, "slots": 196, "hidden": 512, "att_hid": 512,
         "dtype": "bfloat16"}


def _trace():
    # two attention calls (pre-pass + stream), an overlap, a long gap
    dev = [("void att_h_ring_kernel<1>(float*)", 0.0, 10.0),
           ("void attention_kernel<bf16, 8>(float*)", 8.0, 1008.0),
           ("void att_h_ring_kernel<1>(float*)", 1010.0, 1020.0),
           ("void attention_kernel<bf16, 8>(float*)", 1020.0, 2020.0),
           ("Memcpy DtoH", 2520.0, 2530.0)]
    host = [("aten::copy_", 2021.0, 2600.0), ("cudaMemcpyAsync", 2030.0,
                                               2525.0)]
    return Trace(dev, host, wall_s=0.005, units=2)


def test_union_merges_overlaps():
    assert union([(0, 2), (1, 3), (5, 6)]) == [[0, 3], [5, 6]]


def test_busy_idle_and_breakdown():
    t = _trace()
    assert t.busy_s == pytest.approx((1008 + 1010 + 10) / 1e6)
    gaps = dict(t.idle_gaps())
    assert gaps["cudaMemcpyAsync"] == pytest.approx(500 / 1e6)
    assert sum(gaps.values()) == pytest.approx((2 + 500) / 1e6)
    ops = dict(t.device_ops())
    assert ops["attention_kernel<bf16, 8>"] == pytest.approx(2000 / 1e6)
    assert short_name("void k<a, b>(int, float)") == "k<a, b>"
    assert short_name("void (anonymous namespace)::k<(anonymous "
                      "namespace)::L>(int)") == "k<L>"


def test_readers():
    t = _trace()
    run = Run("decode", {"seconds": 2.0, "units": 10, "flops": 4e13,
                         "precision": "bfloat16"}, t, H100,
              {"attention": SHAPE}, {"enqueue_ms_per_step": 2.5})
    fam = spec.load_module("kernels", "attention")
    want = 100 * 2 * fam.bound(SHAPE, H100) / (2020 / 1e6)
    read = {m: spec.load_module("metrics", m).read(run) for m in (
        "attention_roofline.decode", "cell_roofline.decode",
        "idle_share.decode", "idle_share.train", "mfu.decode",
        "enqueue_ms_per_step.decode")}
    assert read["attention_roofline.decode"] == pytest.approx(want)
    assert read["cell_roofline.decode"] is None      # no shape, no launch
    assert read["idle_share.train"] is None          # another kind
    assert t.window_s == pytest.approx(2530 / 1e6)
    assert read["idle_share.decode"] == pytest.approx(
        100 * (1 - t.busy_s / t.window_s))
    assert read["mfu.decode"] == pytest.approx(100 * 2e13 / 989e12)
    assert read["enqueue_ms_per_step.decode"] == 2.5


def test_no_trace_reads_nothing():
    run = Run("train", {"seconds": 1.0, "units": 0, "flops": 0.0,
                        "precision": "float32"}, None, H100, {}, {})
    for m in spec.benchmark()["per_layer"]:
        assert spec.load_module("metrics", m["name"]).read(run) is None
