"""Each cell run whole at tiny widths on the CPU through the harness's own
code (the look for a card skipped): the program agrees with the plain
reference, and the training cells hand the program the benchmark's device
cache, which it takes without copying."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import run
from portbench.core import spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
CPU = torch.device("cpu")


@pytest.mark.parametrize("name", CELLS)
def test_a_tiny_run_is_correct(name, tiny, capsys):
    cell = tiny(name)
    r = run.run_cell(cell, 2 ** 31 + 5, 0.5, 0, CPU, time.perf_counter())
    assert r["correct"], r["compared"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert list(r)[-1] == "compared"
    assert set(r["compared"]) == set(cell.limits)
    err = capsys.readouterr().err.strip().splitlines()
    assert [ln.split()[0] for ln in err[-len(cell.limits):]] == \
        list(r["compared"])


@pytest.mark.parametrize("name", [c for c in CELLS if ".mle-" in c])
def test_the_trainer_takes_the_device_cache(name, tiny):
    cell = tiny(name)
    drv = cell.driver()
    st = drv.setup(cell, 9, CPU)
    cache = st.dataset._device_feat_cache
    assert st.trainer._feat_cache is cache
    assert st.trainer.feature_cache_seconds == 0.0
    assert ("att" in cache) == st.model.USES_ATT
    assert len(st.batches) == cell.traffic["check_steps"]
    drv.release(st)


@pytest.mark.parametrize("name", CELLS)
def test_the_same_seed_draws_the_same_inputs(name, tiny):
    cell = tiny(name)
    drv = cell.driver()
    a, b = (drv.setup(cell, 21, CPU) for _ in range(2))
    if drv.KIND == "train":
        assert a.program["loss"] == b.program["loss"]
        assert all((x["labels"] == y["labels"]).all()
                   for x, y in zip(a.batches, b.batches))
    else:
        assert torch.equal(a.pool, b.pool)
        assert list(a.order) == list(b.order)


def test_the_decode_reads_every_served_token_of_its_sample(tiny):
    cell = tiny("att2in2-coco.beam2-grid196-b4096")
    drv = cell.driver()
    st = drv.setup(cell, 3, CPU)
    for k in range(6):   # a window of as many requests as the sample takes
        drv.window(st, 0.3 * 2 ** k)
        if len(st.window_log) >= cell.traffic["check_requests"]:
            break
    picked = drv.sample(st)
    assert len(picked) == cell.traffic["check_requests"]
    assert len({p[0] for p in picked}) == len(picked)
    drv.release(st)
    n = drv.read(st, picked)["tokens_read"]
    ids = [p[1] for p in picked]
    # up to and including each caption's first EOS
    want = sum(int(min(L, (row == 0).argmax() + 1 if (row == 0).any()
                       else L)) for a in ids for row in a
               for L in [a.shape[1]])
    assert n == want


@pytest.mark.parametrize("name", [c for c in CELLS if ".mle-" in c])
def test_the_training_cells_run_scheduled_sampling(name, tiny):
    """The window's epoch samples a quarter of the rows' inputs (the
    program's use_ss graph), and the reference follows those draws: without
    them it parts from the program."""
    cell = tiny(name)
    drv = cell.driver()
    st = drv.setup(cell, 13, CPU)
    assert st.trainer.opt.ss_prob == 0.25
    assert set(st.trainer._fused) == {("optimizer", True)}
    drv.release(st)
    assert drv.compare(st.program, drv.reference(st))["loss_gap"] < 1e-5
    cell.traffic["epoch"] = 0   # the reference without scheduled sampling
    assert drv.compare(st.program, drv.reference(st))["loss_gap"] > 1e-4


def test_a_near_tie_taken_the_other_way_is_judged_against_its_reference(
        tiny, monkeypatch):
    """A side whose sampled word fell the other way at a near-tie is
    compared with the reference that takes it so, and matches it."""
    from portbench.reference import speaker
    cell = tiny("fc-coco.mle-b128")
    drv = cell.driver()
    st = drv.setup(cell, 17, CPU)
    drv.release(st)
    monkeypatch.setattr(speaker, "NEAR_TIE", float("inf"))
    ref = drv.reference(st)
    assert ref["ties"]
    j, t, b, word = ref["ties"][0]
    other = drv.reference(st, flips={(j, t, b): word})
    assert drv.compare(other, ref)["loss_gap"] > 0.0
    assert max(drv.judged(st, other, ref).values()) == 0.0
