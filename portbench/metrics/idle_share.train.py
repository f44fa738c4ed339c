"""Percent of the traced training stretch in which no operation ran on the
card."""

from portbench.core import readers


def read(run):
    return readers.idle_share(run, 'train')
