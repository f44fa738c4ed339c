"""The kernel families' bounds against PERF.md's kernel table (H100 peaks:
3.35 TB/s, 989 TFLOP/s bf16, 67 TFLOP/s float32)."""

from __future__ import annotations

import pytest

from portbench.core import peaks, spec

H100 = peaks.peaks_of("NVIDIA H100 80GB HBM3")


@pytest.mark.parametrize("family,shape,ms", [
    # A, bf16, B=512, K=36: bytes-bound
    ("attention", {"rows": 512, "slots": 36, "hidden": 512, "att_hid": 512,
                   "dtype": "bfloat16"}, 0.0118),
    # A, f32, B=128
    ("attention", {"rows": 128, "slots": 36, "hidden": 512, "att_hid": 512,
                   "dtype": "float32"}, 0.0061),
    # A, bf16, B=512, K=196
    ("attention", {"rows": 512, "slots": 196, "hidden": 512, "att_hid": 512,
                   "dtype": "bfloat16"}, 0.0619),
    # C, bf16, R=8192, kk=2: operations-bound
    ("beam_head", {"rows": 8192, "hidden": 512, "vocab": 9488, "kk": 2,
                   "dtype": "bfloat16"}, 0.0805),
    # F, f32, B=128, Att2in2: operations-bound
    ("cell", {"rows": 128, "input": 512, "hidden": 512, "att": True,
              "dtype": "float32"}, 0.0120),
    # F, bf16, B=4096
    ("cell", {"rows": 4096, "input": 512, "hidden": 512, "att": True,
              "dtype": "bfloat16"}, 0.0261),
])
def test_bound_matches_the_kernel_table(family, shape, ms):
    fam = spec.load_module("kernels", family)
    assert round(fam.bound(shape, H100) * 1e3, 4) == ms


def test_the_beams_of_an_image_share_its_context():
    fam = spec.load_module("kernels", "attention")
    rows = {"rows": 8192, "slots": 196, "hidden": 512, "att_hid": 512,
            "dtype": "bfloat16"}
    shared = dict(rows, images=4096)
    per_row = fam.nbytes(rows) - 2 * 2 * 8192 * 512  # h in, out
    per_image = fam.nbytes(shared) - 2 * 2 * 8192 * 512
    assert per_image / per_row == pytest.approx(0.5, abs=1e-3)
    assert fam.flops(shared) == fam.flops(rows)


def test_unknown_card_has_no_peaks():
    with pytest.raises(KeyError):
        peaks.peaks_of("some other card")
