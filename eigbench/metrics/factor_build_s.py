"""Shift-invert factors: the time of the span ``eigd.factor.build`` per
design iteration, in s."""

from ..spans import per_iteration


def read(run):
    return per_iteration(run, "SPAN_S", "eigd.factor.build")
