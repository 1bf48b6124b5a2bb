"""Models: the self time of the protocol spans (``eigd.protocol.initialize``
and ``eigd.protocol.finalize_adjoint``: filter, densities, assembly, the
bilinear-form VJP, the VJP back through densities and filter, sign
alignment, the closing synchronise) per design iteration, in s."""

from ..spans import per_iteration


def read(run):
    return per_iteration(run, "SELF_S", "eigd.protocol.initialize",
                         "eigd.protocol.finalize_adjoint")
