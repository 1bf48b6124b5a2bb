"""Structured profiling: counterpart of ``eigd_tpu/utils/profile.py``.

``FactorCounter`` wraps a factor and counts the columns it applies (the
reference's convention) in a device scalar, read only when asked.
``Profile`` records phase wall times and solver metadata and writes them
as JSON; ``Profile.trace`` records a ``torch.profiler`` trace with the
card's activity. ``eigd_tpu_torch.diag.profile`` is a separate tool: it
breaks one evaluation down by profiler range.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict

import torch


class FactorCounter:
    """A factor whose ``mv`` adds the columns it applies to ``count``, a
    0-d int64 tensor on the device of the applied vectors."""

    def __init__(self, factor, count=None):
        self.factor = factor
        self.count = count

    @property
    def shape(self):
        return self.factor.shape

    @property
    def dtype(self):
        return self.factor.dtype

    def mv(self, x):
        if self.count is None:
            self.count = torch.zeros((), dtype=torch.int64, device=x.device)
        self.count += 1 if x.ndim == 1 else x.shape[1]
        return self.factor.mv(x)

    def __call__(self, x):
        return self.mv(x)

    def reset(self):
        self.count = None


def _synchronize():
    """Wait for the card, where this process has used it."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Profile:
    """Phase-timed structured metrics."""

    def __init__(self, **static_info):
        self.data: Dict[str, Any] = dict(static_info)

    @contextlib.contextmanager
    def phase(self, name):
        """Record the wall time of the block as ``"<name> time"``, up to
        the end of its work on the card."""
        t0 = time.perf_counter()
        yield
        _synchronize()
        self.data[f"{name} time"] = time.perf_counter() - t0

    @contextlib.contextmanager
    def trace(self, logdir):
        """Record a ``torch.profiler`` trace of the block (CPU, and CUDA
        when the card is there) to ``logdir/trace.json``."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(logdir, exist_ok=True)
        with torch.profiler.profile(activities=acts) as prof:
            yield prof
            _synchronize()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))

    def record(self, name, value):
        if hasattr(value, "tolist"):
            value = value.tolist()
        self.data[name] = value

    def to_json(self):
        def clean(v):
            try:
                json.dumps(v)
                return v
            except TypeError:
                return str(v)

        return json.dumps({k: clean(v) for k, v in self.data.items()},
                          indent=2)

    def __getitem__(self, k):
        return self.data[k]

    def __setitem__(self, k, v):
        self.data[k] = v

    def __contains__(self, k):
        return k in self.data
