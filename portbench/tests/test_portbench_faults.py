"""A run with the timed path broken underneath comes out not correct: for
each cell, each fault that cell can have (faults.py), planted in the
program, with the rest of the run as the harness drives it on the CPU."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import faults, run
from portbench.core import spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
CASES = [(c, f) for c in CELLS
         for f in (faults.TRAIN if ".mle-" in c else faults.DECODE)]
# a decode wide enough that its tokens follow the state, not the bias
WIDE = dict(rnn_size=128, input_encoding_size=64, att_hid_size=32,
            vocab_size=1000)


@pytest.mark.parametrize("name,fault", CASES)
def test_a_planted_fault_is_not_correct(name, fault, tiny):
    cell = tiny(name, **({} if ".mle-" in name else WIDE))
    if ".mle-" not in name:
        cell.traffic.update(images_per_request=16, check_block=16)
    kind = faults.train if ".mle-" in name else faults.decode
    with kind(fault, cell.config["vocab_size"]):
        r = run.run_cell(cell, 77, 0.3, 0, torch.device("cpu"),
                         time.perf_counter())
    assert not r["correct"], r["compared"]


def test_a_fault_is_put_back():
    from cooperativeimagecaptioning_tpu_torch.training import optim
    before = optim.guarded_update
    with faults.train("state_unchanged", 10):
        assert optim.guarded_update is not before
    assert optim.guarded_update is before
