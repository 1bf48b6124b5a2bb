"""Timing, bounds and library yardsticks shared by the diagnostic entry
points and ``chip_smoke.py``.

Bounds use the published peaks of one NVIDIA H100 SXM (NVIDIA's data
sheet): 3.35 TB/s of HBM3, 67 TFLOP/s in f32 and 34 TFLOP/s in f64 outside
the tensor cores. A kernel's bound is the larger of its bytes (each input
read once, each output written once) over the memory rate and its flops
over the rate of their type.
"""

from __future__ import annotations

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


def line(r):
    """One printed line of a ``result``: time, effective rate, bound and
    its share of the time, plain twin and library times."""
    lib = ("none" if r["library_ms"] is None
           else f"{r['library_ms']:.4f} ms")
    return (f"[{r['name']}] {r['ms']:.4f} ms  "
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
