"""Test settings of the port's benchmark: the `cuda` marker of tests that
need the card (they skip inside the `card` fixture where there is none),
and cells cut to tiny widths that run on the CPU through the harness's
own code."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_CONFIG = dict(vocab_size=60, rnn_size=24, input_encoding_size=16,
                   att_hid_size=12, fc_feat_size=20, att_feat_size=20,
                   train_images=300)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips where there is none")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def tiny_cell(name, tmp_path, **config):
    """The cell `name` of BENCHMARK.json with its widths and sizes cut so
    that a run takes seconds on the CPU; everything else as committed."""
    from portbench.core import spec
    cell = spec.Cell(name)
    cfg = {**cell.config, **TINY_CONFIG, **config}
    if "max_att_len" in cfg:
        cfg["max_att_len"] = 5
    tr = copy.deepcopy(cell.traffic)
    if tr["driver"] == "train_mle":
        tr["options"].update(batch_size=8, fused_steps=2)
        tr["warm_seconds"] = 0
    else:
        tr.update(images_per_request=6, att_len=7, pool_requests=3,
                  check_block=4, dtype="float32")
    cell.config, cell.traffic = cfg, tr
    cell.run_dir = Path(tmp_path) / "run"
    return cell


@pytest.fixture
def tiny(tmp_path):
    return lambda name, **config: tiny_cell(name, tmp_path, **config)
