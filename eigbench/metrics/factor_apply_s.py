"""Shift-invert factors: the time of the outermost spans
``eigd.factor.apply`` (each public apply of a factor, its PCG loops and
refinement inside) per design iteration, in s."""

from ..spans import per_iteration


def read(run):
    return per_iteration(run, "SPAN_S", "eigd.factor.apply")
