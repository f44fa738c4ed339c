"""Percent: kernel F's bound over its device time, in training."""

from portbench.core import readers


def read(run):
    return readers.roofline(run, 'cell', 'train')
