"""Milliseconds the card is busy a training iteration (gather, forward,
backward, Adam; one replay), over the traced stretch."""

from portbench.core import readers


def read(run):
    return readers.device_ms_per_unit(run, 'train')
