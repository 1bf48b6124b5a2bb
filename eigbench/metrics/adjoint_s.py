"""Protocol, reverse: the mean over the window of the model's
``profile["adjoint solution time"]`` (``finalize_adjoint``: the autodiff
boundary, the adjoint solve, and the VJP of assembly and filter), in s."""

import statistics


def read(run):
    return (statistics.fmean(run.adjoint_times) if run.adjoint_times
            else None)
