"""Eigensolver: the self time of the span ``eigd.eig.lanczos`` (the
deflation rows and the Lanczos solve, less the factor applies inside it)
per design iteration, in s."""

from ..spans import per_iteration


def read(run):
    return per_iteration(run, "SELF_S", "eigd.eig.lanczos")
