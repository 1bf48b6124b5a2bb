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

Both kernels are one template in ``csrc/stencil.cu``. They are bound by
memory: each output node and column reads 9*ndof^2 W values and 9*ndof x
values. The kernel takes element strides, so the vector layout is read in
place instead of being transposed to planes and back (two extra passes
over x and y per call); the TPU wrapper's padding, row-shifted copies and
TX row tiles are BlockSpec/VMEM artifacts and have no counterpart.

A CPU tensor goes to the plain twin (``matvec_planes_ref`` for K1,
``stencil.stencil_matvec`` for K2). A CUDA tensor goes to the kernel, or
the call raises: there is no fallback. ``K1_LAUNCHES``/``K2_LAUNCHES``
count launches and nothing else.
"""

from __future__ import annotations

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


def _check(Wp, x, ndof, X, Y, dtype, xshape):
    if tuple(x.shape) != tuple(xshape):
        raise ValueError(f"x must have shape {tuple(xshape)}, got "
                         f"{tuple(x.shape)}")
    if x.device.type != "cuda" or Wp.device != x.device:
        raise ValueError(f"kernel needs W and x on one CUDA device, got "
                         f"{Wp.device} and {x.device}")
    if Wp.dtype != dtype or x.dtype != dtype:
        raise TypeError(f"kernel needs {dtype}, got W {Wp.dtype}, "
                        f"x {x.dtype}")
    if ndof not in (1, 2):
        raise ValueError(f"kernel supports ndof 1 and 2, got {ndof}")
    if tuple(Wp.shape) != (9 * ndof * ndof, X, Y) or not Wp.is_contiguous():
        raise ValueError(f"W planes must be contiguous "
                         f"{(9 * ndof * ndof, X, Y)}, got {tuple(Wp.shape)}")
    if max(x.numel(), Wp.numel()) >= 2**31:
        raise ValueError("kernel indexes with 32-bit strides")


def _launch(fn, Wp, x, y, X, Y, ndof, k, xs, ys):
    from . import _build

    lib = _build.load()
    rc = getattr(lib, fn)(Wp.data_ptr(), x.data_ptr(), y.data_ptr(), X, Y,
                          ndof, k, *xs, *ys,
                          torch.cuda.current_stream(x.device).cuda_stream)
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
    _check(Wp, x, ndof, X, Y, dtype, (X * Y * ndof, x.shape[1]))
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    _launch(fn, Wp, x, y, X, Y, ndof, x.shape[1],
            _vector_strides(x, Y, ndof), _vector_strides(y, Y, ndof))
    return y


def matvec_planes(Wp, xq, nx, ny, ndof):
    """K1: y = A x on f32 (ndof, k, X, Y) planes; Wp from
    ``stencil_planes``. Any strides of xq are read in place."""
    global K1_LAUNCHES
    if xq.device.type == "cpu":
        return matvec_planes_ref(Wp, xq, nx, ny, ndof)
    X, Y = nx + 1, ny + 1
    k = xq.shape[1]
    _check(Wp, xq, ndof, X, Y, torch.float32, (ndof, k, X, Y))
    y = torch.empty((ndof, k, X, Y), dtype=xq.dtype, device=xq.device)
    _launch("eigd_stencil_f32", Wp, xq, y, X, Y, ndof, k, xq.stride(),
            y.stride())
    K1_LAUNCHES += 1
    return y


def stencil_matvec32(Wp, x, nx, ny, ndof):
    """K1 on the (n,) or (n, k) f32 vector layout."""
    global K1_LAUNCHES
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    if x.device.type == "cpu":
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
    if x.device.type == "cpu":
        y = _stencil.stencil_matvec(planes_to_stencil(Wp, ndof), x, nx, ny,
                                    ndof)
    else:
        y = _launch_vector("eigd_stencil_f64", torch.float64, Wp, x, nx, ny,
                           ndof)
        K2_LAUNCHES += 1
    return y[:, 0] if squeeze else y
