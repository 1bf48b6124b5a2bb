"""Thick-restart shift-invert Lanczos and the ``IRAM`` class.

Counterpart of ``eigd_tpu/ops/restart.py``: the reference's ARPACK path
bounds memory to m basis vectors. Each cycle keeps the k best Ritz
directions under the mode's own ordering (compressing the basis V, its B
products BV and the raw operator outputs W by one (k, m) x (m, n) GEMM
each; the operator is linear, so W compresses as V does) and expands
back to m with the CGS2 steps of the direct solver. The Rayleigh-Ritz
matrix is the fully measured one, BV W^T symmetrized, so no arrowhead
bookkeeping is needed. ``torch.linalg.eigh`` in f64 takes the place of
JAX's ``eigh_accurate``. The compressed basis is no Krylov chain, so
``IRAM`` refuses the ``dl`` adjoint, as the reference does.
"""

from __future__ import annotations

import warnings

import torch

from .lanczos import (BasicLanczos, LanczosResult, _uniform_block,
                      map_ritz_values)
from .operators import as_operator
from .sync import host_bool, loop_exit


def thick_restart_solve(A, B, factor, sigma, N, m, k=None, ncycle=4,
                        mode="normal", seed=12345, v0=None,
                        tol=None) -> LanczosResult:
    """The N wanted eigenpairs with the basis bounded by m vectors.

    k : Ritz directions kept a restart (default min(2N, m - 2)).
    ncycle : the most cycles (the first expansion counts as one).
    tol : with it set, the cycles end once the N wanted pairs have
        measured B-norm residuals ``||Op phi - theta phi||_B < tol *
        max(max|theta|, 1)``: one host decision a cycle
        (``sync.HOST_SYNCS["restart"]``; ``sync.LOOP_EXITS`` counts the
        reason). With tol=None all ncycle cycles run.
    v0 : (n,) start vector; by default drawn from a ``torch.Generator``
        seeded with ``seed`` (JAX draws from ``jax.random``: parity runs
        pass v0).

    ``niter`` of the result is the expansion steps run,
    m + (cycles - 1) (m - k).
    """
    A, B = as_operator(A), as_operator(B)
    n = A.shape[0]
    dtype, device = A.dtype, A.device
    if k is None:
        k = min(2 * N, m - 2)
    if v0 is None:
        v0 = _uniform_block(n, 1, seed, dtype, device)[:, 0]
    col = torch.arange(m + 1, device=device)

    def expand(V, BV, W, start):
        """CGS2 shift-invert steps start..m-1, in place. A step whose new
        direction has B-norm^2 <= 1e-60 (an invariant subspace) leaves a
        zero vector instead of dividing by ~0."""
        for i in range(start, m):
            w = factor.mv(BV[i])
            W[i] = w
            mask = (col <= i).to(dtype)
            w = w - V.T @ ((BV @ w) * mask)
            w = w - V.T @ ((BV @ w) * mask)
            bw = B.mv(w)
            b2 = w @ bw
            ok = b2 > 1e-60
            scale = ok.to(dtype) / torch.sqrt(torch.where(ok, b2, 1.0))
            V[i + 1] = scale * w
            BV[i + 1] = scale * bw

    def ritz():
        Hf = BV[:m] @ W.T
        H = 0.5 * (Hf + Hf.T)
        theta, Y = torch.linalg.eigh(H)
        lam_all, order = map_ritz_values(theta, sigma, mode)
        return H, theta, Y, lam_all, order

    def wanted_res(theta, Y, order):
        """Measured B-norm residuals of the N wanted Ritz pairs."""
        sel = order[:N]
        Y0 = Y[:, sel]
        R = W.T @ Y0 - (V[:m].T @ Y0) * theta[sel][None, :]
        return torch.sqrt(torch.abs(torch.sum(R * B.mv(R), dim=0)))

    def converged():
        _, theta, Y, _, order = ritz()
        scale = torch.clamp(torch.max(torch.abs(theta)), min=1.0)
        return host_bool(torch.all(wanted_res(theta, Y, order)
                                   < tol * scale), "restart")

    bv0 = B.mv(v0)
    b0 = torch.sqrt(v0 @ bv0)
    V = torch.zeros((m + 1, n), dtype=dtype, device=device)
    BV = torch.zeros((m + 1, n), dtype=dtype, device=device)
    W = torch.zeros((m, n), dtype=dtype, device=device)
    V[0] = v0 / b0
    BV[0] = bv0 / b0
    expand(V, BV, W, 0)

    ncyc = 0
    done = tol is not None and converged()
    while ncyc < ncycle - 1 and not done:
        # keep the k best Ritz directions under the mode's own order
        # (buckling: by -1/lam, so the wanted load factors stay)
        _, _, Y, _, order = ritz()
        Ys = Y[:, order[:k]].T  # (k, m)
        V[:k], V[k] = Ys @ V[:m], V[m].clone()
        BV[:k], BV[k] = Ys @ BV[:m], BV[m].clone()
        W[:k] = Ys @ W
        V[k + 1:] = 0.0
        BV[k + 1:] = 0.0
        W[k:] = 0.0
        expand(V, BV, W, k)
        ncyc += 1
        done = tol is not None and converged()
    if tol is not None:
        loop_exit("restart", "converged" if done else "last_cycle", ncyc + 1)

    H, theta, Y, lam_all, order = ritz()
    sel = order[:N]
    Y0 = Y[:, sel]
    Phi = V[:m].T @ Y0
    R = W.T @ Y0 - Phi * theta[sel][None, :]
    eig_res = torch.sqrt(torch.abs(torch.sum(R * B.mv(R), dim=0)))
    beta = torch.cat([torch.diagonal(H, 1), H.new_zeros(1)])
    return LanczosResult(
        lam=lam_all[sel], Phi=Phi, V=V, BV=BV, alpha=torch.diagonal(H).clone(),
        beta=beta, H=H, theta=theta, Y=Y, order=order, lam_all=lam_all,
        eig_res=eig_res, sigma=torch.tensor(sigma, dtype=dtype, device=device),
        niter=m + ncyc * (m - k))


class IRAM:
    """The reference IRAM's class surface (solve / solve_adjoint /
    add_total_derivative) over ``thick_restart_solve``.

    m is at least max(20, 2N + 1). ``tol <= 0`` is ARPACK's "to machine
    precision": the cycles end at a measured residual of 1e-13, at most
    ``ncycle`` of them. ``v0`` as in ``thick_restart_solve``.
    """

    def __init__(self, N=10, m=None, eig_atol=1e-5, tol=0.0, mode="normal",
                 ncycle=10, seed=12345, v0=None):
        self.N = N
        self.m = max(20, 2 * N + 1, m or 0)
        self.eig_atol = eig_atol
        self.tol = tol
        self.mode = mode
        self.ncycle = ncycle
        self.seed = seed
        self.v0 = v0

    def solve(self, A, B, factor, sigma):
        self.A, self.B = as_operator(A), as_operator(B)
        self.factor, self.sigma = factor, sigma
        self.res = thick_restart_solve(
            self.A, self.B, factor, sigma, self.N, self.m,
            ncycle=self.ncycle, mode=self.mode, seed=self.seed, v0=self.v0,
            tol=self.tol if self.tol > 0.0 else 1e-13)
        self.niter = self.res.niter
        if self.N < self.m and abs(float(
                self.res.lam_all[self.res.order[self.N]]
                - self.res.lam[-1])) < self.eig_atol:
            warnings.warn("IRAM: Ritz values at the N boundary are "
                          "numerically repeated.")
        self.lam0, self.Phi = self.res.lam, self.res.Phi
        self.eig_res = self.res.eig_res.cpu().numpy()
        return self.lam0, self.Phi

    def _proxy(self):
        """A BasicLanczos holding this solve, for its adjoint methods."""
        proxy = BasicLanczos.__new__(BasicLanczos)
        proxy.A, proxy.B, proxy.factor = self.A, self.B, self.factor
        proxy.sigma, proxy.mode = self.sigma, self.mode
        proxy.eig_atol, proxy.res, proxy.N = self.eig_atol, self.res, self.N
        return proxy

    def solve_adjoint(self, Phib, method="sibk", **kwargs):
        if method == "dl":
            raise ValueError(
                "dl requires the unrestarted Lanczos chain; use BasicLanczos"
                " (the reference's IRAM has the same restriction)")
        return self._proxy().solve_adjoint(Phib, method=method, **kwargs)

    def eval_adjoint_residual_norm(self, Phib, psi, b_ortho=False):
        return self._proxy().eval_adjoint_residual_norm(Phib, psi,
                                                        b_ortho=b_ortho)

    def add_total_derivative(self, lamb, Phib, psi, dAdx, dBdx, dfdx,
                             adj_corr_data=None, deriv_type="tensor"):
        return self._proxy().add_total_derivative(
            lamb, Phib, psi, dAdx, dBdx, dfdx, adj_corr_data=adj_corr_data,
            deriv_type=deriv_type)
