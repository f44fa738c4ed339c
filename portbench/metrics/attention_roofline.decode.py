"""Percent: kernel A's bound over its device time (pre-pass and stream), in
the decode."""

from portbench.core import readers


def read(run):
    return readers.roofline(run, 'attention', 'decode')
