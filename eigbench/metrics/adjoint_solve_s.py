"""Adjoint solve: the self time of the span ``eigd.adjoint.solve`` (LAA,
SIBK or the configured method, the corrections and the total-derivative
weights, less the factor applies inside it) per design iteration, in s."""

from ..spans import per_iteration


def read(run):
    return per_iteration(run, "SELF_S", "eigd.adjoint.solve")
