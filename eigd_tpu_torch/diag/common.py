"""Timing, bounds and library yardsticks shared by the diagnostic entry
points and ``chip_smoke.py``.

Bounds use the published peaks of one NVIDIA H100 SXM (NVIDIA's data
sheet): 3.35 TB/s of HBM3, 67 TFLOP/s in f32 and 34 TFLOP/s in f64 outside
the tensor cores. A kernel's bound is the larger of its bytes (each input
read once, each output written once) over the memory rate and its flops
over the rate of their type.
"""

from __future__ import annotations

import statistics
import subprocess
import sys

import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}


def require_cuda():
    """Exit with a message unless a CUDA device is present."""
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        raise SystemExit(1)


def card():
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def cuda_time_ms(fn, warmup=3, iters=20):
    """Mean device time of fn() in ms, by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def graph_ms(fns, iters=20, windows=5):
    """Device time in ms of each function of ``fns``, with the host taken
    out: ``iters`` calls of each are captured once in a
    ``torch.cuda.CUDAGraph`` (launches through ctypes take the current
    stream, which is the capture stream), and each graph is replayed
    ``windows`` times between two CUDA events, the functions in turns
    (A B B A A B ... for two). Returns (median, least, largest) time a
    call over the windows, for each function."""
    graphs = []
    for fn in fns:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        g.replay()
        graphs.append(g)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    times = [[] for _ in fns]
    order = list(range(len(fns)))
    for w in range(windows):
        for i in order if w % 2 == 0 else order[::-1]:
            t0.record()
            graphs[i].replay()
            t1.record()
            t1.synchronize()
            times[i].append(t0.elapsed_time(t1) / iters)
    return [(statistics.median(t), min(t), max(t)) for t in times]


def bound(nbytes, flops, dtype=torch.float32):
    """(least time in ms, "bytes" or "operations") for the given work."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def result(name, ms, plain_ms, library_ms, nbytes, flops,
           dtype=torch.float32):
    """One measured kernel line: its times, its work and its bound."""
    b_ms, b_by = bound(nbytes, flops, dtype)
    return {"name": name, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bytes": nbytes, "flops": flops,
            "bound_ms": b_ms, "bound_by": b_by}


def timed(name, kernel, plain, library, nbytes, flops, dtype=torch.float32,
          library_in_graph=True):
    """A ``result`` timed with the host taken out: ``ms`` and
    ``library_ms`` are the medians of ``graph_ms`` over the kernel and the
    library call in turns (``*_range``: least and largest window), beside
    their back-to-back event times (``event_ms``, ``library_event_ms``,
    by ``cuda_time_ms``) and the plain twin's. ``library`` may be None; a
    library call that is not ``library_in_graph`` is timed by events
    only."""
    event_ms = cuda_time_ms(kernel)
    plain_ms = cuda_time_ms(plain)
    lib_event = None if library is None else cuda_time_ms(library)
    graphed = [kernel] + ([library] if library and library_in_graph else [])
    g = graph_ms(graphed)
    lib_ms, lib_range = lib_event, None
    if len(g) == 2:
        lib_ms, lib_range = g[1][0], g[1][1:]
    return dict(result(name, g[0][0], plain_ms, lib_ms, nbytes, flops,
                       dtype),
                ms_range=g[0][1:], event_ms=event_ms,
                library_range=lib_range, library_event_ms=lib_event)


def _ms(value, rng=None, events=None):
    """A time, with its graph range and its event time where kept."""
    out = f"{value:.4f} ms"
    if rng is not None:
        out += f" [{rng[0]:.4f}-{rng[1]:.4f}]"
    if events is not None:
        out += f" (events {events:.4f})"
    return out


def line(r):
    """One printed line of a ``result``: time, effective rate, bound and
    its share of the time, plain twin and library times. A ``timed``
    result shows the graph-replayed median with its range, then the
    back-to-back event time."""
    if r["library_ms"] is None:
        lib = "none"
    elif r.get("library_range") is not None:
        lib = _ms(r["library_ms"], r["library_range"], r["library_event_ms"])
    else:
        lib = _ms(r["library_ms"]) + (" by events" if "event_ms" in r else "")
    ms = _ms(r["ms"], r.get("ms_range"), r.get("event_ms"))
    return (f"[{r['name']}] {ms}  "
            f"{r['bytes'] / r['ms'] / 1e6:.0f} GB/s  bound "
            f"{r['bound_ms'] * 1e3:.1f} us by {r['bound_by']} "
            f"({r['bytes'] / 1e6:.1f} MB, share {r['bound_ms'] / r['ms']:.2f})"
            f"  plain {r['plain_ms']:.4f} ms  library {lib}")


def stencil_work(X, Y, ndof, k, itemsize):
    """(bytes, flops) of one 9-point block-stencil matvec on k columns of
    an (X, Y) node grid: the 9*ndof^2 W planes, x and y once each."""
    nodes = X * Y
    nbytes = (9 * ndof * ndof + 2 * ndof * k) * nodes * itemsize
    return nbytes, 2 * 9 * ndof * ndof * k * nodes


def stencil_csr(W, nx, ny, ndof, dtype=None):
    """The stencil W (nx+1, ny+1, 3, 3, ndof, ndof) as a CSR matrix with
    its 9*ndof nonzeros per row (fewer at the grid edges).

    The index arithmetic of ``ops.multigrid.stencil_to_dense``: row
    ndof*node(i, j) + a, column ndof*node(i+di, j+dj) + b. Taken in
    (i, j, a, di, dj, b) order the entries come sorted by row and by column
    within a row. For the library yardstick ``torch.sparse.mm`` only.
    """
    X, Y = nx + 1, ny + 1
    dev = W.device
    Wr = W.permute(0, 1, 4, 2, 3, 5)  # (i, j, a, di, dj, b)
    shape = Wr.shape

    def ax(n, dim, lo=0):
        v = torch.arange(lo, lo + n, device=dev)
        return v.reshape([n if d == dim else 1 for d in range(6)])

    i, j, a = ax(X, 0), ax(Y, 1), ax(ndof, 2)
    di, dj, b = ax(3, 3, -1), ax(3, 4, -1), ax(ndof, 5)
    ii, jj = i + di, j + dj
    valid = ((ii >= 0) & (ii < X) & (jj >= 0) & (jj < Y)).expand(shape)
    row = (ndof * (i * Y + j) + a).expand(shape)[valid]
    col = (ndof * (ii * Y + jj) + b).expand(shape)[valid]
    val = Wr[valid].to(dtype or W.dtype)
    n = X * Y * ndof
    crow = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(torch.bincount(row, minlength=n), 0)
    return torch.sparse_csr_tensor(crow, col, val, (n, n),
                                   check_invariants=True)
