"""The traced run: the harness's own ranges around the program's calls, and
the reduction of one ``torch.profiler`` window to device busy time, idle
gaps, device time by class and the stencil kernels' device time.

Ranges (``record_function``, CPU side), opened by the harness only:

* ``eigbench.window`` around the measured iterations;
* ``eigbench.initialize``, ``eigbench.seeds``, ``eigbench.finalize_adjoint``
  around the protocol's calls (the objective modules);
* ``eigbench.k1`` / ``eigbench.k2`` around each CUDA call of the module
  attributes ``ops.cuda_stencil.matvec_planes``, ``stencil_matvec32`` (K1)
  and ``stencil_matvec64`` (K2), which every caller looks up at call time;
  each call's (X, Y, ndof, k, itemsize) is recorded, whatever kernel
  implements it;
* ``eigbench.sync.<site>`` around each host decision of ``ops.sync``, by
  the names the solver modules bound at import.

The patches are undone when the window closes.
"""

from __future__ import annotations

import bisect
import collections
import functools

import torch
from torch.profiler import ProfilerActivity, record_function

from .frozen import bound, classify, stencil_work

SYNC_USERS = (("ops.multigrid", "host_flags"), ("ops.blockfactor",
                                                "host_flags"),
              ("ops.lanczos", "host_bool"), ("ops.adjoint", "host_bool"),
              ("ops.restart", "host_bool"))


class Tracer:
    def __init__(self):
        self.calls = {"k1": [], "k2": []}
        self._undo = []

    def _patch(self, module, name, wrapper):
        orig = getattr(module, name)
        setattr(module, name, functools.wraps(orig)(wrapper(orig)))
        self._undo.append((module, name, orig))

    def patch(self):
        import importlib

        from eigd_tpu_torch.ops import cuda_stencil

        def stencil(kind, itemsize, planes):
            def wrap(orig):
                def call(Wp, x, nx, ny, ndof):
                    if not x.is_cuda:
                        return orig(Wp, x, nx, ny, ndof)
                    k = x.shape[1] if (planes or x.ndim == 2) else 1
                    self.calls[kind].append((nx + 1, ny + 1, ndof, k,
                                             itemsize))
                    with record_function(f"eigbench.{kind}"):
                        return orig(Wp, x, nx, ny, ndof)
                return call
            return wrap

        self._patch(cuda_stencil, "matvec_planes", stencil("k1", 4, True))
        self._patch(cuda_stencil, "stencil_matvec32", stencil("k1", 4, False))
        self._patch(cuda_stencil, "stencil_matvec64", stencil("k2", 8, False))

        def sync(orig):
            def call(t, site):
                with record_function(f"eigbench.sync.{site}"):
                    return orig(t, site)
            return call

        for mod, name in SYNC_USERS:
            self._patch(importlib.import_module(f"eigd_tpu_torch.{mod}"),
                        name, sync)

    def unpatch(self):
        for module, name, orig in reversed(self._undo):
            setattr(module, name, orig)
        self._undo.clear()


def profiler():
    return torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA])


def _inside(t, spans):
    """Whether time t falls in one of the sorted, disjoint spans."""
    i = bisect.bisect_right(spans[0], t) - 1
    return i >= 0 and t <= spans[1][i]


def _sorted_spans(spans):
    spans = sorted(spans)
    return [a for a, _ in spans], [b for _, b in spans]


def analyse(prof, top=10):
    """The window's numbers from the raw events of ``prof``: busy_s (the
    union of the intervals of kernels, copies and memsets), window_s,
    device time by class, idle time by the innermost harness range open at
    each gap's middle, and the device time of the kernels launched inside
    the k1 and k2 ranges: by the CPU time of each kernel's launch (the
    runtime call that carries the kernel's correlation id), or, where the
    trace links no launch, by the range's span on the device timeline."""
    cuda = torch.autograd.DeviceType.CUDA
    window = None
    ranges = []  # (start, end, name) of the harness's ranges
    cpu_calls = {"k1": [], "k2": []}
    dev_calls = {"k1": [], "k2": []}
    launch = {}  # correlation id -> CPU time of the runtime call
    dev = []  # (start, end, name, correlation id)
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s = e.start_ns()
        if e.device_type() == cuda:
            t = s + e.duration_ns()
            if name.startswith("eigbench."):
                if name[-2:] in dev_calls:
                    dev_calls[name[-2:]].append((s, t))
            elif not getattr(e, "is_user_annotation", lambda: False)():
                dev.append((s, t, name, e.correlation_id()))
        elif name.startswith("cu"):  # a CUDA runtime or driver call
            launch[e.correlation_id()] = s
        elif name.startswith("eigbench."):
            span = (s, s + e.duration_ns(), name)
            if name == "eigbench.window":
                window = span[:2]
            elif name[-2:] in cpu_calls and name.count(".") == 1:
                cpu_calls[name[-2:]].append(span[:2])
            ranges.append(span)
    if window is None or not dev:
        return None
    w0, w1 = window
    cpu_spans = {k: _sorted_spans(v) for k, v in cpu_calls.items()}
    dev_spans = {k: _sorted_spans(v) for k, v in dev_calls.items()}
    dev = [d for d in dev if d[1] > w0 and d[0] < w1]
    dev.sort()
    by_class = collections.Counter()
    by_launch = collections.Counter()
    by_span = collections.Counter()
    busy = []
    for s, t, name, corr in dev:
        by_class[classify(name)] += (t - s) * 1e-9
        at = launch.get(corr)
        for k in ("k1", "k2"):
            if at is not None and _inside(at, cpu_spans[k]):
                by_launch[k] += (t - s) * 1e-9
            if _inside(s, dev_spans[k]) and _inside(t, dev_spans[k]):
                by_span[k] += (t - s) * 1e-9
        s, t = max(s, w0), min(t, w1)
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], t)
        else:
            busy.append([s, t])
    gaps = []
    edge = w0
    for s, t in busy:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, t)
    if edge < w1:
        gaps.append((edge, w1))
    idle = _idle_by_range(gaps, ranges)
    return {"window_s": (w1 - w0) * 1e-9,
            "busy_s": sum(t - s for s, t in busy) * 1e-9,
            "device_ops": by_class.most_common(top),
            "idle_gaps": idle.most_common(top),
            "kernel_s": dict(by_launch) or dict(by_span),
            "kernel_s_by_span": dict(by_span),
            "calls": {k: len(v) for k, v in cpu_calls.items()},
            "device_events": len(dev), "launches": len(launch)}


def _idle_by_range(gaps, ranges):
    """Idle seconds by the innermost harness range open at the middle of
    each gap (the ranges nest, one host thread)."""
    points = []  # (time, order, payload): opens, then gap middles, closes
    for i, (s, t, _) in enumerate(ranges):
        points.append((s, 0, i))
        points.append((t, 2, i))
    for s, t in gaps:
        points.append(((s + t) // 2, 1, t - s))
    points.sort()
    out = collections.Counter()
    open_ = []
    for _, order, payload in points:
        if order == 0:
            open_.append(payload)
        elif order == 2:
            if open_ and open_[-1] == payload:
                open_.pop()
            else:
                open_.remove(payload)
        else:
            name = ranges[open_[-1]][2] if open_ else "eigbench.window"
            out[name] += payload * 1e-9
    return out


def roofline(run, kind):
    """The least time of ``kind``'s recorded calls at the published HBM
    rate over the device time of their kernels, in %; None where either
    is missing."""
    if run.trace is None or not run.kernel_calls.get(kind):
        return None
    device_s = run.trace["kernel_s"].get(kind, 0.0)
    if device_s <= 0.0:
        return None
    least_ms = 0.0
    for X, Y, ndof, k, itemsize in run.kernel_calls[kind]:
        nbytes, flops = stencil_work(X, Y, ndof, k, itemsize)
        least_ms += bound(nbytes, flops, itemsize)[0]
    return 100.0 * least_ms * 1e-3 / device_s
