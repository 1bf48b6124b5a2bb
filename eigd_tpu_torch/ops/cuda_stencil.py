"""Wrappers of the hand-written CUDA stencil kernels, and their plain twins.

Replaces ``eigd_tpu/ops/pallas_stencil.py``:

* K1 (f32) replaces ``_kernel`` via ``_matvec_planes_impl``
  (pallas_stencil.py:121): ``matvec_planes`` (plane layout, the V-cycle
  and the f32 plane PCG) and ``stencil_matvec32`` (vector layout, f32
  ``GridStencilOperator.mv`` in the mixed SIBK ladder).
* K2 (f64) replaces the compensated double-float ``_dd_kernel`` via
  ``_dd_stencil_matvec_impl`` (pallas_stencil.py:299):
  ``stencil_matvec64`` (vector layout, the outer-PCG residual and every
  solver-side f64 ``A.mv``/``B.mv``). Native FP64: no Dekker split, no
  (s, c) pair and no k <= 4 chunking.

Both kernels are one template in ``csrc/stencil.cu``, bound by memory: a
call reads the 9*ndof^2 W planes once (each thread keeps its node's W
values in registers for all k columns), x once through shared-memory halo
tiles, and writes y once. The kernel takes element strides, so the vector
layout is read in place instead of being transposed to planes and back
(two extra passes over x and y per call); the TPU wrapper's padding,
row-shifted copies and TX row tiles are BlockSpec/VMEM artifacts and have
no counterpart. ``launch_plan`` says how a call is cut into blocks.

A CPU tensor goes to the plain twin (``matvec_planes_ref`` for K1,
``stencil.stencil_matvec`` for K2). A CUDA tensor goes to the kernel, or
the call raises: there is no fallback. The kernels have no autograd rule,
so a CUDA input that requires grad under grad mode raises too
(``refuse_grad``); the twins differentiate. ``K1_LAUNCHES``/``K2_LAUNCHES``
count launches and nothing else. The host path of a call is kept short
(the C entry point is bound once; the stream is read as a raw handle):
at the small grids of the V-cycle the host time of a call exceeds the
kernel's.
"""

from __future__ import annotations

import collections
import functools

import torch
import torch.nn.functional as F

from . import stencil as _stencil

K1_LAUNCHES = 0
K2_LAUNCHES = 0


def stencil_planes(W, ndof, dtype=torch.float32):
    """Stencil (X, Y, 3, 3, ndof, ndof) -> contiguous (9*ndof^2, X, Y)
    planes, plane t = (3*(di+1) + (dj+1))*ndof^2 + a*ndof + b."""
    Wp = W.permute(2, 3, 4, 5, 0, 1)
    s = Wp.shape
    return Wp.reshape(9 * ndof * ndof, s[4], s[5]).to(dtype).contiguous()


def planes_to_stencil(Wp, ndof):
    """Inverse of ``stencil_planes`` (without the dtype cast)."""
    X, Y = Wp.shape[1], Wp.shape[2]
    return Wp.reshape(3, 3, ndof, ndof, X, Y).permute(4, 5, 0, 1, 2, 3)


def to_planes(x, nx, ny, ndof):
    """(n, k) vector layout -> contiguous (ndof, k, X, Y) channel planes."""
    X, Y = nx + 1, ny + 1
    k = x.shape[1]
    return x.reshape(X, Y, ndof, k).permute(2, 3, 0, 1).contiguous()


def from_planes(xq, nx, ny, ndof):
    """(ndof, k, X, Y) channel planes -> (n, k) vector layout."""
    X, Y = nx + 1, ny + 1
    k = xq.shape[1]
    return xq.permute(2, 3, 0, 1).reshape(X * Y * ndof, k)


def matvec_planes_ref(Wp, xq, nx, ny, ndof):
    """Plain PyTorch K1: y = A x on (ndof, k, X, Y) planes (zero halo),
    accumulated in the TPU kernel's order (di, b, dj, a)."""
    X, Y = nx + 1, ny + 1
    xpad = F.pad(xq, (1, 1, 1, 1))
    acc = [None] * ndof
    for di in (-1, 0, 1):
        for b in range(ndof):
            xb0 = xpad[b, :, 1 + di: 1 + di + X]  # (k, X, Y+2)
            for dj in (-1, 0, 1):
                xb = xb0[:, :, 1 + dj: 1 + dj + Y]
                for a in range(ndof):
                    t = (3 * (di + 1) + (dj + 1)) * ndof * ndof + a * ndof + b
                    term = Wp[t][None] * xb
                    acc[a] = term if acc[a] is None else acc[a] + term
    return torch.stack(acc)


# The kernel's tile (TX rows of TY nodes), as in csrc/stencil.cu. A grid
# of fewer tiles than FILL_BLOCKS (two blocks on each of an H100's 132 SMs)
# splits its columns over blockIdx.y. In the plane layout x comes in
# double-buffered chunks of KC columns. In the vector layout with k > 1
# (each node's columns contiguous, y "staged") a block takes all its
# columns in one chunk while its shared memory stays within SHARED_BUDGET
# (two blocks an SM), so that each node's run of columns is read and
# written at once, and y goes out through shared-memory staging rows of
# 32 bytes of columns.
TILE = (8, 32)
KC = 4
FILL_BLOCKS = 2 * 132
SHARED_BUDGET = 110 * 1024

LaunchPlan = collections.namedtuple(
    "LaunchPlan", "grid cols_per_group cols_per_chunk shared_bytes")


@functools.lru_cache(maxsize=256)
def launch_plan(X, Y, ndof, k, itemsize, staged):
    """The kernel's launch on k columns of an (X, Y) grid: its grid (node
    tiles, column groups), the columns of one group and of one chunk (the
    two numbers the kernel is given; it derives the rest from them) and one
    block's dynamic shared memory, as csrc/stencil.cu sets them. Block
    (t, g) computes tile t for columns [g*cpg, (g+1)*cpg).
    staged: y's j stride exceeds ndof (the vector layout with k > 1), so
    y goes out through staging rows."""
    TX, TY = TILE
    tiles = -(-X // TX) * -(-Y // TY)
    want = -(-FILL_BLOCKS // tiles)
    cpg = k if want <= 1 else max(1, k // want)
    slab = ndof * (TX + 2) * (TY + 2) + 1
    stage = (32 // itemsize) * ndof * (TX * TY + 2) if staged else 0
    if not staged:
        kc = min(KC, cpg)
    elif (cpg * slab + stage) * itemsize <= SHARED_BUDGET:
        kc = cpg
    else:
        kc = max(1, (SHARED_BUDGET // itemsize - stage) // (2 * slab))
    nbuf = 2 if cpg > kc else 1
    return LaunchPlan((tiles, -(-k // cpg)), cpg, kc,
                      (nbuf * kc * slab + stage) * itemsize)


def refuse_grad(*tensors):
    """Raise where autograd would need a gradient of a kernel's output: a
    kernel fills a new tensor through a ctypes launch, which autograd does
    not see, so the output would have no ``grad_fn`` and the gradient
    would be lost. A caller that wants one takes the plain path (as
    ``GridStencilOperator.with_kernels`` and ``mgshard.
    sharded_stencil_matvec`` do)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "a CUDA kernel has no autograd rule and was given an input that "
            "requires grad under grad mode: take the plain path for a "
            "gradient, or call it under torch.no_grad()")


def _check(Wp, x, ndof, X, Y, dtype):
    """Raise on what the kernel cannot take (x's shape is checked by the
    caller)."""
    refuse_grad(Wp, x)
    if not x.is_cuda or Wp.get_device() != x.get_device():
        raise ValueError(f"kernel needs W and x on one CUDA device, got "
                         f"{Wp.device} and {x.device}")
    if Wp.dtype != dtype or x.dtype != dtype:
        raise TypeError(f"kernel needs {dtype}, got W {Wp.dtype}, "
                        f"x {x.dtype}")
    if ndof != 1 and ndof != 2:
        raise ValueError(f"kernel supports ndof 1 and 2, got {ndof}")
    if Wp.shape != (9 * ndof * ndof, X, Y) or not Wp.is_contiguous():
        raise ValueError(f"W planes must be contiguous "
                         f"{(9 * ndof * ndof, X, Y)}, got {tuple(Wp.shape)}")
    if x.numel() >= 2**31 or Wp.numel() >= 2**31:
        raise ValueError("kernel indexes with 32-bit strides")


_ENTRY = {}  # the library's C entry points, bound at first launch


def _launch(fn, Wp, x, y, X, Y, ndof, k, xs, ys):
    entry = _ENTRY.get(fn)
    if entry is None:
        from . import _build

        entry = _ENTRY[fn] = getattr(_build.load(), fn)
    plan = launch_plan(X, Y, ndof, k, x.element_size(), ys[3] > ndof)
    rc = entry(Wp.data_ptr(), x.data_ptr(), y.data_ptr(), X, Y, ndof, k,
               *xs, *ys, plan.cols_per_group, plan.cols_per_chunk,
               torch._C._cuda_getCurrentRawStream(x.get_device()))
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError {rc}")


def _vector_strides(t, Y, ndof):
    """(b, column, i, j) element strides of an (n, k) vector-layout tensor
    whose rows are ordered (i, j, b)."""
    sn, sk = t.stride()
    return (sn, sk, Y * ndof * sn, ndof * sn)


def _launch_vector(fn, dtype, Wp, x, nx, ny, ndof):
    """Kernel ``fn`` on an (n, k) vector-layout x, read in place; y is a
    new contiguous (n, k) tensor."""
    X, Y = nx + 1, ny + 1
    n, k = x.shape
    if n != X * Y * ndof:
        raise ValueError(f"x must have {X * Y * ndof} rows, got {n}")
    _check(Wp, x, ndof, X, Y, dtype)
    y = x.new_empty((n, k))
    _launch(fn, Wp, x, y, X, Y, ndof, k, _vector_strides(x, Y, ndof),
            (k, 1, Y * ndof * k, ndof * k))
    return y


def matvec_planes(Wp, xq, nx, ny, ndof):
    """K1: y = A x on f32 (ndof, k, X, Y) planes; Wp from
    ``stencil_planes``. Any strides of xq are read in place."""
    global K1_LAUNCHES
    if xq.is_cpu:
        return matvec_planes_ref(Wp, xq, nx, ny, ndof)
    X, Y = nx + 1, ny + 1
    k = xq.shape[1]
    if xq.shape != (ndof, k, X, Y):
        raise ValueError(f"x must have shape {(ndof, k, X, Y)}, got "
                         f"{tuple(xq.shape)}")
    _check(Wp, xq, ndof, X, Y, torch.float32)
    y = xq.new_empty((ndof, k, X, Y))
    _launch("eigd_stencil_f32", Wp, xq, y, X, Y, ndof, k, xq.stride(),
            (k * X * Y, X * Y, Y, 1))
    K1_LAUNCHES += 1
    return y


def stencil_matvec32(Wp, x, nx, ny, ndof):
    """K1 on the (n,) or (n, k) f32 vector layout."""
    global K1_LAUNCHES
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    if x.is_cpu:
        y = from_planes(matvec_planes_ref(Wp, to_planes(x, nx, ny, ndof),
                                          nx, ny, ndof), nx, ny, ndof)
    else:
        y = _launch_vector("eigd_stencil_f32", torch.float32, Wp, x, nx, ny,
                           ndof)
        K1_LAUNCHES += 1
    return y[:, 0] if squeeze else y


def stencil_matvec64(Wp, x, nx, ny, ndof):
    """K2: y = A x in f64 on the (n,) or (n, k) vector layout; Wp are the
    f64 planes from ``stencil_planes(W, ndof, torch.float64)``."""
    global K2_LAUNCHES
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    if x.is_cpu:
        y = _stencil.stencil_matvec(planes_to_stencil(Wp, ndof), x, nx, ny,
                                    ndof)
    else:
        y = _launch_vector("eigd_stencil_f64", torch.float64, Wp, x, nx, ny,
                           ndof)
        K2_LAUNCHES += 1
    return y[:, 0] if squeeze else y
