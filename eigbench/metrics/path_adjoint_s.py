"""Static path: the inclusive time of the span ``eigd.static.adjoint`` (the
path adjoint through the preload: one apply of the static factor, an
``eigd.factor.apply``, and the bilinear-form VJP of K) per design
iteration, in s; None where the program never entered it."""

from ..spans import per_iteration


def read(run):
    if not per_iteration(run, "SPAN_N", "eigd.static.adjoint"):
        return None  # no trace, or a program without the span
    return per_iteration(run, "SPAN_S", "eigd.static.adjoint")
