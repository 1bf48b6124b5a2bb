"""Plain reference of the thermal family (the upstream eigd
``examples/thermal.py`` model: ``ThermalTopologyAnalysis`` on the grid of
its ``make_model``; Li and Kennedy, SMO 68:4, 2024).

From a configuration's ``model`` keywords and a design x (one density a
node) it builds, with NumPy and SciPy alone: the grid, the ``center``
element set of ``make_model`` (elements nx/2 <= i < 3nx/4, ny/2 <= j <
3ny/4) and its mean vector, the (r0 - d) density filter at r0 = rfact
Ly/ny (``nf.density_filter``), the element densities, the scalar Q4
conduction and capacitance matrices (2x2 Gauss)

    K = sum_e kappa ((1 - beta) rhoE^p + beta) int B^T B
    M = sum_e c0 ((1 - beta) rhoE + beta) int N N^T,  c0 = density c_p,

the N + 4 lowest pairs nearest the shift (the program solves N + 4 and
keeps the spare modes; ``eig.lowest_pairs``), and the total derivative of
a function of them back through assembly, densities and filter.

The conduction is pure Neumann: K's rows sum to zero at every design, so
mode 0 is the constant field with lambda_0 = 0 exactly, and the objectives
of this family use it (``ThermalOpt``'s transient takes all N + 4 modes).
Both sides return its eigenvalue as rounding, so the check judges it on
the scale of lambda_1 (``null_modes``; ``judge.compare``). Its adjoint
needs no care of its own: Nelson's pinned solve is nonsingular on a
pure-Neumann K, and phi_0^T dK phi_0 = 0 since dK keeps the zero row sums.

Departures from the program, none of which changes the model: the mean
vector is the set's element areas summed at its nodes and normalised, the
program's detJ at each Gauss point summed there (equal on the uniform
grid, to rounding); the element matrices of one element serve every
element (the grid is uniform); the Gauss points are summed in another
order.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from . import eig
from .nf import density_filter, grid

SPARE = 4  # modes solved beyond N, as the program's Nmax = N + 4


def _q4_scalar(hx, hy):
    """Ke0 = int B^T B and Me0 = int N N^T (4, 4) of one hx x hy element,
    nodes (i,j), (i+1,j), (i+1,j+1), (i,j+1)."""
    xi_n = np.array([-1.0, 1.0, 1.0, -1.0])
    eta_n = np.array([-1.0, -1.0, 1.0, 1.0])
    g = 1.0 / np.sqrt(3.0)
    Ke = np.zeros((4, 4))
    Me = np.zeros((4, 4))
    detJ = hx * hy / 4.0
    for xi in (-g, g):
        for eta in (-g, g):
            N = 0.25 * (1 + xi * xi_n) * (1 + eta * eta_n)
            B = np.stack([0.25 * xi_n * (1 + eta * eta_n) * 2.0 / hx,
                          0.25 * eta_n * (1 + xi * xi_n) * 2.0 / hy])
            Ke += detJ * B.T @ B
            Me += detJ * np.outer(N, N)
    return Ke, Me


def center_elements(nx, ny):
    """``make_model``'s ``center`` element set (element i + nx j)."""
    return (np.arange(nx // 2, 3 * nx // 4)[None, :]
            + nx * np.arange(ny // 2, 3 * ny // 4)[:, None]).reshape(-1)


class Problem:
    """The reference model of one configuration."""

    # the constant field: lambda_0 = 0 exactly, at every design
    null_modes = 1

    def __init__(self, model):
        kw = dict(model)
        nx, ny = kw["nx"], kw["ny"]
        Lx, Ly = kw.get("Lx", 1.0), kw.get("Ly", 1.0)
        N = kw.get("Ntarget") or kw.get("N", 10)
        self.nmodes = N + SPARE
        self.sigma = kw.get("sigma", -0.1)
        self.p = kw.get("p", 3)
        self.beta = kw.get("beta", 1e-6)
        self.kappa = kw.get("kappa", 1.0)
        self.c0 = kw.get("density", 1.0) * kw.get("heat_capacity", 1.0)
        _, X, self.conn = grid(nx, ny, Lx, Ly)
        self.n = self.ndv = X.shape[0]
        self.F = density_filter(X, kw.get("rfact", 4.0) * Ly / ny)
        self.Ke0, self.Me0 = _q4_scalar(Lx / nx, Ly / ny)
        self.rows = np.repeat(self.conn, 4, axis=1).reshape(-1)
        self.cols = np.tile(self.conn, (1, 4)).reshape(-1)
        # the set's mean vector: each node weighs the area of its elements
        # in the set, all of one size here
        v = np.bincount(self.conn[center_elements(nx, ny)].reshape(-1),
                        minlength=self.n).astype(np.float64)
        self.mean_vecs = {"center": v / v.sum()}
        self.next_lam = None

    def densities(self, x):
        """x -> element densities rhoE."""
        return (self.F @ x)[self.conn].mean(axis=1)

    def _assemble(self, coef, Ke):
        vals = (coef[:, None, None] * Ke[None]).reshape(-1)
        return sp.csr_matrix((vals, (self.rows, self.cols)),
                             shape=(self.n, self.n))

    def matrices(self, x):
        rhoE = self.densities(x)
        b = self.beta
        K = self._assemble(self.kappa * ((1 - b) * rhoE**self.p + b),
                           self.Ke0)
        M = self._assemble(self.c0 * ((1 - b) * rhoE + b), self.Me0)
        return rhoE, K, M

    def solve(self, x, dtype=np.float64):
        """(lam, Phi, K, M) of the N + 4 lowest modes at x, the constant
        mode 0 first; the next eigenvalue is kept as ``next_lam``."""
        rhoE, K, M = self.matrices(np.asarray(x, dtype=np.float64))
        lam, Phi = eig.lowest_pairs(K, M, self.sigma, self.nmodes + 1,
                                    dtype)
        self._rhoE = rhoE.astype(dtype)
        self.next_lam = lam[-1]  # the first mode not asked for
        return lam[:-1], Phi[:, :-1], K, M

    def gradient(self, UK, UM, V):
        """d/dx of sum_i UK_i^T K(x) V_i + UM_i^T M(x) V_i at the x of the
        last ``solve``."""
        rhoE = self._rhoE
        Ve = V[self.conn]  # (ne, 4, N)
        sK = np.einsum("eai,ab,ebi->e", UK[self.conn], self.Ke0, Ve)
        sM = np.einsum("eai,ab,ebi->e", UM[self.conn], self.Me0, Ve)
        drho_e = (1 - self.beta) * (
            self.kappa * self.p * rhoE ** (self.p - 1) * sK + self.c0 * sM)
        drho = np.bincount(self.conn.reshape(-1),
                           weights=np.repeat(0.25 * drho_e, 4),
                           minlength=self.n)
        return self.F.T @ drho
