"""Device: the share of the traced window in which no kernel, copy or
memset ran on the card (1 - union of their intervals / window), in %."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
