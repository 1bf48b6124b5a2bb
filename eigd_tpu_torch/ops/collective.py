"""Reductions over the DOF dimension (single device).

Counterpart of ``eigd_tpu/ops/collective.py:19-28,243`` for ``axis=None``.
The JAX package's double-float GEMMs (``dd_dot``, ``dd_dot_rowsT``,
``dd_mul_small``) exist because XLA:TPU emulates f64; on the CPU JAX
already takes them as plain f64 products, and Hopper has native FP64, so
the port writes them as plain ``@``. ``chunked_dot_f32`` stays: it is the
f32 re-orthogonalization sweep of the local-ortho block Lanczos, not a
workaround.
"""

from __future__ import annotations

import torch


def _single_device(axis):
    if axis is not None:
        raise NotImplementedError(
            "sharded solves (axis != None) are not ported (ROADMAP queue 1, "
            "item 16)")


def psum(x, axis=None):
    """All-reduce over the shard axis: the identity on one device."""
    _single_device(axis)
    return x


def pdot(x, y, axis=None):
    """Inner product / contraction over the DOF dim."""
    _single_device(axis)
    return x @ y


def chunked_dot_f32(X, w, chunk=8192):
    """(m, n) @ (n, p) in f32 with f64 accumulation across n-chunks.

    A plain f32 product over large n accumulates rounding ~ n*eps32;
    contracting each ``chunk`` in f32 and summing the partials in f64 bounds
    it at the chunk's while keeping the f32 rate.
    """
    X = X.to(torch.float32)
    w = w.to(torch.float32)
    m, n = X.shape
    p = w.shape[1]
    nch = n // chunk
    if nch < 2:
        return (X @ w).to(torch.float64)
    n_main = nch * chunk
    Xr = X[:, :n_main].reshape(m, nch, chunk).transpose(0, 1)
    wr = w[:n_main].reshape(nch, chunk, p)
    out = torch.bmm(Xr, wr).to(torch.float64).sum(dim=0)
    if n_main < n:
        out = out + (X[:, n_main:] @ w[n_main:]).to(torch.float64)
    return out


def qr_tall(R, axis=None):
    """Thin QR of a tall (n, k) block."""
    _single_device(axis)
    return torch.linalg.qr(R)
