"""Percent of the card's bf16 peak (989 TFLOP/s) that the window's decode
products reach: the encode and the 16 steps of every request served,
over the window's seconds."""

from portbench.core import readers


def read(run):
    return readers.mfu(run, 'decode')
