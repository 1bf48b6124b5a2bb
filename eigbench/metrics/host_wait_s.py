"""Host decisions: the seconds the host was blocked reading a decision off
the device (``sync.WAIT_S`` over every site) per design iteration, in s."""

from ..spans import per_iteration


def read(run):
    return per_iteration(run, "WAIT_S")
