"""Published peaks of the card, and the bound of one kernel call.

NVIDIA H100 SXM5 data sheet, dense rates, at the full 700 W power limit:
989 TFLOP/s bf16 and fp16, 495 TFLOP/s TF32, 67 TFLOP/s float32 outside
the tensor cores, 3.35 TB/s of HBM3.  A share of a peak is stated against
these, with the card's power limit beside it in the run's output."""

from __future__ import annotations

PEAKS = {
    "H100": {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
             "float32": 67e12, "bytes_per_s": 3.35e12},
}


def peaks_of(device_name: str):
    """The peaks of a card by its name (torch.cuda.get_device_name)."""
    for key, table in PEAKS.items():
        if key in device_name:
            return table
    raise KeyError(f"no published peaks for {device_name!r}")


def bound_s(flops, nbytes, dtype, peaks):
    """The least time a call could take: the larger of its operations over
    the precision's peak and its bytes (inputs read once, outputs written
    once) over the memory's."""
    return max(flops / peaks[dtype], nbytes / peaks["bytes_per_s"])


ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2}
