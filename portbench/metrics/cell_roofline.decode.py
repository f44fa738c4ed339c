"""Percent: kernel F's bound over its device time, in the decode."""

from portbench.core import readers


def read(run):
    return readers.roofline(run, 'cell', 'decode')
