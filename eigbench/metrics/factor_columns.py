"""Shift-invert factors: the columns the outermost factor applies took (1
for a vector, k for an (n, k) block: ``SPAN_WORK["eigd.factor.apply"]``)
per design iteration."""

from ..spans import per_iteration


def read(run):
    return per_iteration(run, "SPAN_WORK", "eigd.factor.apply")
