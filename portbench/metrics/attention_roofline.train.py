"""Percent: kernel A's bound over its device time (pre-pass and stream), in
training."""

from portbench.core import readers


def read(run):
    return readers.roofline(run, 'attention', 'train')
