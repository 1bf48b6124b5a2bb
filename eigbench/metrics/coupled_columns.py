"""Shift-invert factors: the columns whose level-0 couplings a BCR factor
applied through its grid stencil (``SPAN_WORK["eigd.factor.coupling"]``,
each apply's columns once) per design iteration; None where no such
factor ran, as on a program without the span."""

from ..spans import per_iteration


def read(run):
    if not per_iteration(run, "SPAN_N", "eigd.factor.coupling"):
        return None  # no trace, or no factor coupled through a stencil
    return per_iteration(run, "SPAN_WORK", "eigd.factor.coupling")
