"""The controls at a size a test run holds: the reference put in the
program's place one precision below the configuration's reads above the
program.  The cells' limits were set from controls.py's readings on the
card at the cells' own sizes (PERF.md); here the same readings run small:
the fp8 decode control on the CPU, the TF32 training control on the card."""

from __future__ import annotations

import pytest
import torch

from portbench import controls

WIDE = dict(rnn_size=128, input_encoding_size=64, att_hid_size=32,
            vocab_size=1000)


def test_the_fp8_decode_control_reads_above_the_program(tiny, monkeypatch):
    monkeypatch.setattr(controls, "DECODE_WINDOW_S", 0.3)
    cell = tiny("att2in2-coco.beam2-grid196-b4096", **WIDE)
    cell.traffic.update(images_per_request=16, check_block=16)
    r = controls.decode_readings(cell, cell.driver(), 12, torch.device("cpu"),
                                 True)
    assert r["program"]["token_gap"] == 0.0   # float32 on both sides
    assert r["control_fp8"]["token_gap"] > 1e-3
    assert r["tokens_read"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["att2in2-coco.mle-b128",
                                  "fc-coco.mle-b128"])
def test_the_tf32_training_control_reads_above_the_program(name, tiny,
                                                            card):
    cell = tiny(name, rnn_size=256, input_encoding_size=256,
                att_hid_size=256, fc_feat_size=512, att_feat_size=512,
                vocab_size=2000)
    cell.traffic["options"].update(batch_size=64)
    r = controls.train_readings(cell, cell.driver(), 31, card, True)
    prog, ctrl = r["program"], r["control_tf32"]
    assert max(ctrl[k] / max(prog[k], 1e-12) for k in prog) >= 3.0


def test_the_float64_witness_reads_the_reference_close(tiny):
    cell = tiny("att2in2-coco.mle-b128")
    r = controls.train_readings(cell, cell.driver(), 8, torch.device("cpu"),
                                True)
    assert max(r["reference_vs_f64"].values()) < 1e-4
    assert set(r["program"]) == set(cell.limits)
