"""Percent of the card's float32 peak (67 TFLOP/s) that the window's
training products reach: 3x the forward's 2 m n k of every step trained,
over the window's seconds."""

from portbench.core import readers


def read(run):
    return readers.mfu(run, 'train')
