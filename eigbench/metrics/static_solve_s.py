"""Static path: the inclusive time of the span ``eigd.static.solve`` (the
preload's factor build, an ``eigd.factor.build``, and its apply to the
loads) per design iteration, in s; None where the program never entered
it."""

from ..spans import per_iteration


def read(run):
    if not per_iteration(run, "SPAN_N", "eigd.static.solve"):
        return None  # no trace, or a program without the span
    return per_iteration(run, "SPAN_S", "eigd.static.solve")
