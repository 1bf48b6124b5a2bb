"""Kernels, K1 (f32 stencil): the least time its calls' bytes need at the
published HBM rate over the device time of the kernels launched inside
the calls, in %. Nothing where no call ran or no trace was taken."""

from ..trace import roofline


def read(run):
    return roofline(run, "k1")
