"""Kernels, K2 (f64 stencil): as ``k1_roofline``, for the f64 calls."""

from ..trace import roofline


def read(run):
    return roofline(run, "k2")
