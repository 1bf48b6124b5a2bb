"""Protocol, forward: the mean over the window of the model's
``profile["eigenvalue solve time"]`` (host clock ending in a device
synchronise, ``initialize``), in s."""

import statistics


def read(run):
    return statistics.fmean(run.init_times) if run.init_times else None
