"""Percent: kernel C's bound over its device time (first pass and merge),
in the decode."""

from portbench.core import readers


def read(run):
    return readers.roofline(run, 'beam_head', 'decode')
