"""Host milliseconds a decode step takes to enqueue: the host clock of the
unsynchronised beam_search call over its steps, the median over the
window's requests."""

from portbench.core import readers


def read(run):
    return readers.counter(run, 'enqueue_ms_per_step', 'decode')
