"""The program's spans and counters (``eigd_tpu_torch.ops.sync``), read for
the per-layer metrics: the spans record only while a torch profiler
records, and the traced window is the one profiled part of a run, so the
Counters hold that window's totals."""


def per_iteration(run, counter, *names):
    """``sync``'s Counter ``counter`` summed over ``names`` (over every key
    where none are named), per design iteration of the traced window;
    None where no trace was taken or the program has no such Counter."""
    if run.trace is None:
        return None
    from eigd_tpu_torch.ops import sync

    totals = getattr(sync, counter, None)
    if totals is None:
        return None
    keys = names or list(totals)
    return sum(totals[k] for k in keys) / run.iterations
