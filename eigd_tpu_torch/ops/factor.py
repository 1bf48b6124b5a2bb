"""Shift-invert factorizations: ``factor.mv(x) = (A - sigma*B)^{-1} x``
(normal mode) or ``(B + sigma*A)^{-1} x`` (buckling mode).

Counterpart of ``eigd_tpu/ops/factor.py``:

* ``CholeskyFactor``: dense Cholesky of the shifted matrix, valid when it
  is SPD (sigma below the spectrum in normal mode, below the first load
  factor in buckling mode); each apply is two
  triangular solves plus ``refine`` steps of iterative refinement.
* ``EighFactor``: the inverse through a full symmetric eigendecomposition,
  robust to indefinite shifted matrices.
* ``CGFactor``: a matrix-free Jacobi-preconditioned CG "inexact factor"
  that runs a fixed number of iterations and freezes converged columns,
  as JAX's ``scan`` does: it never waits for the device.

On a CUDA tensor the factorizations and solves are cuSOLVER/cuBLAS calls
through ``torch.linalg``, as in JAX they are XLA's, outside any kernel of
the package. Every factor applies to (n,) vectors and (n, k) blocks.
"""

from __future__ import annotations

import torch

from .operators import DenseOperator, as_operator
from .sync import columns, span


class CholeskyFactor:
    """Dense Cholesky factor: mv(x) = (L L^T)^{-1} x.

    ``refine`` steps of iterative refinement (y += solve(x - M y)) remove
    the triangular solves' backward-error floor; they need the matrix.
    """

    def __init__(self, chol, mat=None, refine=1):
        self.chol = chol
        self.mat = mat
        self.refine = refine if mat is not None else 0

    @classmethod
    def from_matrix(cls, mat, refine=1):
        # cholesky_ex does not raise on a matrix that is not SPD; NaNs in
        # its place keep ok() (and JAX's NaN factor) meaningful without a
        # host wait
        L, info = torch.linalg.cholesky_ex(mat)
        L = torch.where(info == 0, L, torch.nan)
        return cls(L, mat=mat if refine else None, refine=refine)

    @property
    def shape(self):
        return tuple(self.chol.shape)

    @property
    def dtype(self):
        return self.chol.dtype

    def _solve(self, x):
        squeeze = x.ndim == 1
        if squeeze:
            x = x[:, None]
        y = torch.linalg.solve_triangular(self.chol, x, upper=False)
        y = torch.linalg.solve_triangular(self.chol.T, y, upper=True)
        return y[:, 0] if squeeze else y

    @span("eigd.factor.apply", work=columns)
    def mv(self, x):
        y = self._solve(x)
        for _ in range(self.refine):
            y = y + self._solve(x - self.mat @ y)
        return y

    @span("eigd.factor.apply", work=columns)
    def __call__(self, x):
        return self.mv(x)

    def ok(self):
        """False if the matrix was not SPD (NaNs in the factor)."""
        return torch.all(torch.isfinite(self.chol))


class EighFactor:
    """mv(x) = Q diag(1/w) Q^T x from the symmetric eigendecomposition."""

    def __init__(self, w, q):
        self.w = w
        self.q = q

    @classmethod
    def from_matrix(cls, mat):
        w, q = torch.linalg.eigh(mat)
        return cls(w, q)

    @property
    def shape(self):
        n = self.w.shape[0]
        return (n, n)

    @property
    def dtype(self):
        return self.w.dtype

    @span("eigd.factor.apply", work=columns)
    def mv(self, x):
        t = self.q.T @ x
        t = t / (self.w if x.ndim == 1 else self.w[:, None])
        return self.q @ t

    @span("eigd.factor.apply", work=columns)
    def __call__(self, x):
        return self.mv(x)


class CGFactor:
    """Matrix-free Jacobi-preconditioned CG inexact factor.

    Runs exactly ``maxiter`` iterations; a column whose residual norm is at
    or below ``tol`` freezes (its search direction is zeroed). All columns
    of a block advance together.
    """

    def __init__(self, op, diag, maxiter=200, tol=1e-12):
        self.op = op  # the shifted operator
        self.diag = diag  # its diagonal, for the Jacobi preconditioner
        self.maxiter = maxiter
        self.tol = tol

    @property
    def shape(self):
        return self.op.shape

    @property
    def dtype(self):
        return self.diag.dtype

    @span("eigd.factor.apply", work=columns)
    def mv(self, b):
        squeeze = b.ndim == 1
        if squeeze:
            b = b[:, None]
        minv = (1.0 / self.diag)[:, None]
        x = torch.zeros_like(b)
        r = b
        p = minv * r
        rz = torch.sum(r * p, dim=0)
        for _ in range(self.maxiter):
            ap = self.op.mv(p)
            pap = torch.sum(p * ap, dim=0)
            zero = pap == 0.0
            alpha = torch.where(zero, 0.0, rz / torch.where(zero, 1.0, pap))
            x = x + alpha[None, :] * p
            r = r - alpha[None, :] * ap
            z = minv * r
            rz_new = torch.sum(r * z, dim=0)
            zero = rz == 0.0
            beta = torch.where(zero, 0.0, rz_new / torch.where(zero, 1.0, rz))
            active = torch.sqrt(torch.sum(r * r, dim=0)) > self.tol
            p = torch.where(active[None, :], z + beta[None, :] * p, 0.0)
            rz = rz_new
        return x[:, 0] if squeeze else x

    @span("eigd.factor.apply", work=columns)
    def __call__(self, x):
        return self.mv(x)


def make_shift_factor(A, B, sigma, mode="normal", kind="cholesky", **kwargs):
    """The shift-invert factor from the dense forms of A and B (tensors or
    operators with ``to_dense``):

        normal:   (A - sigma B)^{-1}
        buckling: (B + sigma A)^{-1}, the pencil (A, B) = (G, K)

    ``kind``: "cholesky", "eigh" or "cg" (``kwargs`` go to CGFactor)."""
    A, B = as_operator(A), as_operator(B)
    if mode == "normal":
        mat = A.to_dense() - sigma * B.to_dense()
    elif mode == "buckling":
        mat = B.to_dense() + sigma * A.to_dense()
    else:
        raise ValueError(f"Unknown mode {mode!r}")
    if kind == "cholesky":
        return CholeskyFactor.from_matrix(mat)
    if kind == "eigh":
        return EighFactor.from_matrix(mat)
    if kind == "cg":
        return CGFactor(DenseOperator(mat), torch.diagonal(mat), **kwargs)
    raise ValueError(f"Unknown factor kind {kind!r}")
