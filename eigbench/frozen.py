"""Frozen copies of the program's yardsticks, so that a later change to
the program cannot move the benchmark's arithmetic.

Copied at commit fc1c7d8 of this repository:

* ``HBM_BYTES_PER_S``, ``PEAK_FLOPS``, ``bound`` and ``stencil_work`` from
  ``eigd_tpu_torch/diag/common.py``: the published peaks of one NVIDIA
  H100 SXM (NVIDIA's data sheet: 3.35 TB/s of HBM3, 67 TFLOP/s in f32 and
  34 TFLOP/s in f64 outside the tensor cores) and the least time of a
  9-point block-stencil matvec, whose bytes are the 9*ndof^2 W planes, x
  and y, each once. The dtypes are keyed by item size here, so the module
  needs no torch.
* ``CLASSES`` and ``classify`` from ``eigd_tpu_torch/diag/profile.py``:
  the class of a device operation by its kernel name.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {4: 67e12, 8: 34e12}  # by item size: f32, f64


def bound(nbytes, flops, itemsize=4):
    """(least time in ms, "bytes" or "operations") for the given work."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[itemsize] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def stencil_work(X, Y, ndof, k, itemsize):
    """(bytes, flops) of one 9-point block-stencil matvec on k columns of
    an (X, Y) node grid: the 9*ndof^2 W planes, x and y once each."""
    nodes = X * Y
    nbytes = (9 * ndof * ndof + 2 * ndof * k) * nodes * itemsize
    return nbytes, 2 * 9 * ndof * ndof * k * nodes


CLASSES = (("K1", ("stencil_kernel<float",)),
           ("K2", ("stencil_kernel<double",)),
           ("GEMM", ("gemm", "gemv", "xmma", "cutlass", "dot_kernel")),
           ("copy/memset", ("Memcpy", "Memset", "CatArrayBatchedCopy",
                            "copy_kernel")),
           ("reduction", ("reduce", "Reduce")),
           ("elementwise", ("elementwise", "vectorized", "index_elementwise",
                            "where_kernel")))


def classify(name):
    for cls, keys in CLASSES:
        if any(k in name for k in keys):
            return cls
    return "other"
