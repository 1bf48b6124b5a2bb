"""Host decisions on device values, and the program's spans.

JAX runs the solvers' data-dependent loops (PCG, the Lanczos adaptive
exit, the SIBK ladder and rounds) as ``lax.while_loop`` on the device.
Eager PyTorch evaluates each loop condition on the host, which waits for
the device. Every such decision goes through ``host_bool`` or
``host_flags`` so that a run can count them: ``HOST_SYNCS[site]`` is the
number of decisions the loop named ``site`` made, each a device-to-host
wait on a CUDA tensor (on a CPU tensor the same decision costs no wait, but
is counted all the same, so CPU and CUDA runs count alike). Library calls
that wait on their own, such as cuSOLVER's eigh, are not counted.

``LOOP_EXITS["site.reason"]`` counts why loops ended: a PCG solve on
convergence, on stagnation (``stag_bad`` iterations without a 10% gain)
or at its iteration cap; the Lanczos sweep on its adaptive exit or after
its last block. ``LOOP_STEPS[site]`` sums the steps those loops ran (PCG
iterations, Lanczos blocks). Recording an exit costs no wait: the reason
is read from flags the last decision already brought to the host.

Spans (``span``) mark the boundaries of the program's layers: the
protocol calls (``eigd.protocol.*``), the shift-invert factor's build and
applies (``eigd.factor.*``), the Lanczos eigensolve (``eigd.eig.lanczos``),
the adjoint solve (``eigd.adjoint.solve``), and the static solve of a
preload with its path adjoint (``eigd.static.solve``, holding its
factor's ``eigd.factor.build``, and ``eigd.static.adjoint``). They record
only while a torch profiler records: then each is a ``record_function``
range on the profiler's timeline, and adds its host time to
``SPAN_S[name]`` (inclusive), ``SELF_S[name]`` (less the spans inside
it), its entries to ``SPAN_N[name]`` and its work to ``SPAN_WORK[name]``;
each host decision adds the seconds the host was blocked in it to
``WAIT_S[site]``. With no profiler a span is a null context and a
decision reads no clock.
"""

import collections
import functools
import time

import torch
from torch.autograd import _profiler_enabled
from torch.profiler import record_function

HOST_SYNCS = collections.Counter()
LOOP_EXITS = collections.Counter()
LOOP_STEPS = collections.Counter()
SPAN_S = collections.Counter()
SELF_S = collections.Counter()
SPAN_N = collections.Counter()
SPAN_WORK = collections.Counter()
WAIT_S = collections.Counter()

# the open spans of the process, innermost last, each [name, start ns, ns
# of the spans inside it, the frame it opened in]: one stack for every
# thread, so a backward pass on autograd's device thread nests under the
# protocol call the main thread waits in
_OPEN = []


def _timed(read, t, site):
    """read(t), its seconds added to WAIT_S[site]."""
    t0 = time.perf_counter_ns()
    out = read(t)
    WAIT_S[site] += (time.perf_counter_ns() - t0) * 1e-9
    return out


def host_bool(t, site):
    """bool(t) for a 0-d tensor, counted in HOST_SYNCS[site]."""
    HOST_SYNCS[site] += 1
    return _timed(bool, t, site) if _profiler_enabled() else bool(t)


def host_flags(t, site):
    """The bools of a 1-d bool tensor, read in one wait, counted once in
    HOST_SYNCS[site]."""
    HOST_SYNCS[site] += 1
    if _profiler_enabled():
        return _timed(torch.Tensor.tolist, t, site)
    return t.tolist()


def loop_exit(site, reason, steps):
    """Count one exit of the loop ``site`` for ``reason``, after
    ``steps`` steps."""
    LOOP_EXITS[f"{site}.{reason}"] += 1
    LOOP_STEPS[site] += steps


def columns(_self, x, *args, **kwargs):
    """The columns a factor method applies to x: 1 for a vector, k for an
    (n, k) block (``utils.profile.FactorCounter``'s count)."""
    return 1 if x.ndim == 1 else x.shape[1]


class _Named:
    """A span's name and work, and its decorator form: the wrapped call
    runs inside the span while a profiler records, with ``work`` a number
    or a function of the call's arguments (``columns``)."""

    __slots__ = ("name", "work")

    def __init__(self, name, work):
        self.name, self.work = name, work

    def __call__(self, fn):
        name, work = self.name, self.work

        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiler_enabled():
                return fn(*args, **kwargs)
            n = work(*args, **kwargs) if callable(work) else work
            with _Span(name, n):
                return fn(*args, **kwargs)

        return call


class _Null(_Named):
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _Span(_Named):
    __slots__ = ("_frame", "_range")

    def __enter__(self):
        outer = _OPEN[-1] if _OPEN else None
        if outer is not None and outer[0] == self.name:
            self._frame = None  # counted by the span around it
            return self
        self._range = record_function(self.name)
        self._range.__enter__()
        self._frame = [self.name, time.perf_counter_ns(), 0, outer]
        _OPEN.append(self._frame)
        return self

    def __exit__(self, *exc):
        frame = self._frame
        if frame is None:
            return False
        ns = time.perf_counter_ns() - frame[1]
        for i in range(len(_OPEN) - 1, -1, -1):
            if _OPEN[i] is frame:
                del _OPEN[i]
                break
        name = self.name
        SPAN_S[name] += ns * 1e-9
        SELF_S[name] += (ns - frame[2]) * 1e-9
        SPAN_N[name] += 1
        SPAN_WORK[name] += self.work
        if frame[3] is not None:
            frame[3][2] += ns
        self._range.__exit__(*exc)
        return False


_NULL = {}  # one null span a name


def span(name, work=0):
    """The span ``name``, a context manager and a decorator (where ``work``
    may be a function of the wrapped call's arguments). It records only
    while a torch profiler records; otherwise it is the name's shared null
    context, which reads no clock. A span inside a span of the same name
    counts neither time nor work again (a factor applied through another
    factor's apply)."""
    if callable(work):
        return _Named(name, work)
    if _profiler_enabled():
        return _Span(name, work)
    if work:
        return _Null(name, work)
    null = _NULL.get(name)
    if null is None:
        null = _NULL[name] = _Null(name, 0)
    return null


def clear():
    """Reset the counters."""
    for counter in (HOST_SYNCS, LOOP_EXITS, LOOP_STEPS, SPAN_S, SELF_S,
                    SPAN_N, SPAN_WORK, WAIT_S):
        counter.clear()
