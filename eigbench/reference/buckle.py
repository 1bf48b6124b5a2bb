"""Plain reference of the buckling family (the upstream eigd
``examples/buckling.py`` compressed column: linearized buckling of a
plane-stress column clamped on its left edge under a compressive load on
a centred strip of its right edge).

From a configuration's ``model`` keywords and a design x it builds, with
NumPy and SciPy alone: the grid, the spatial (r0 - d) density filter as a
sparse row-normalised matrix (one design variable a node), the element
densities, the Q4 plane-stress stiffness with SIMP, the static preload
K u = f by SuperLU on the free DOFs, the stress stiffness G(x, u) from
the element stresses at the 2x2 Gauss points,

    G_e = sum_q detJ_q H_q^T S_q H_q (on the x and on the y DOFs alike),
    S_q = [[s_xx, s_xy], [s_xy, s_yy]],  s_q = c_G(rho_e) C B_q u_e,

with H_q = [dN/dx; dN/dy] (2, 4), and the load factors of
K phi = lam (-G) phi nearest above the shift sigma by ARPACK in buckling
mode on a SuperLU factor of K + sigma G, the shift halved until that
matrix is positive definite (a design may move the first load factor
below the configuration's shift). The pairs are returned with
M = -G and Phi^T M Phi = I, so ``eig.adjoint_pairs`` (Nelson on
K - lam M) turns the seeds into the bilinear forms, and ``gradient``
differentiates them in the design: directly through rho in K and G, and
through u(x) by one more solve with K (the path adjoint).

``load_nodes`` and ``load_dofs`` are the benchmark's own account of the
loaded strip, shared by the reference and the ``ksagg`` objective's
program side.
"""

from __future__ import annotations

import sys

import numpy as np
import scipy.sparse as sp
from scipy.sparse import linalg as spla
from scipy.spatial import cKDTree

from . import eig

GAUSS = 1.0 / np.sqrt(3.0)


def load_nodes(model):
    """The right-edge nodes of the loaded strip: rows j of the centred
    ``load_frac`` of the edge, ends included, node (nx, j) numbered
    nx*(ny+1) + j."""
    nx, ny = model["nx"], model["ny"]
    lf = model.get("load_frac", 0.2)
    rows = np.arange(int(ny * (0.5 - lf / 2)), int(ny * (0.5 + lf / 2)) + 1)
    return nx * (ny + 1) + rows


def load_dofs(model):
    """The y-DOFs of the loaded nodes: the eigenvector aggregate's set."""
    return 2 * load_nodes(model) + 1


def _q4(hx, hy, E, nu):
    """(Ke0 (8, 8), CB (4, 3, 8), H (4, 2, 4), w) of one hx x hy element
    at the four Gauss points: C B_q, the shape-function gradients H_q and
    the quadrature weight w = detJ. DOFs (ux, uy) node-major; nodes
    counter-clockwise from the lower left."""
    C = E / (1.0 - nu**2) * np.array([[1.0, nu, 0.0], [nu, 1.0, 0.0],
                                      [0.0, 0.0, 0.5 * (1.0 - nu)]])
    sx = np.array([-1.0, 1.0, 1.0, -1.0])
    sy = np.array([-1.0, -1.0, 1.0, 1.0])
    w = hx * hy / 4.0
    Ke0 = np.zeros((8, 8))
    CB = np.zeros((4, 3, 8))
    H = np.zeros((4, 2, 4))
    for q, (a, b) in enumerate([(-GAUSS, -GAUSS), (GAUSS, -GAUSS),
                                (-GAUSS, GAUSS), (GAUSS, GAUSS)]):
        H[q, 0] = 0.25 * sx * (1.0 + b * sy) * 2.0 / hx
        H[q, 1] = 0.25 * sy * (1.0 + a * sx) * 2.0 / hy
        B = np.zeros((3, 8))
        B[0, 0::2] = H[q, 0]
        B[1, 1::2] = H[q, 1]
        B[2, 0::2] = H[q, 1]
        B[2, 1::2] = H[q, 0]
        CB[q] = C @ B
        Ke0 += w * B.T @ CB[q]
    return Ke0, CB, H, w


class Problem:
    """The reference model of one configuration."""

    def __init__(self, model):
        kw = dict(model)
        for key in ("ptype_K", "ptype_G"):
            if kw.get(key, "simp") != "simp":
                raise ValueError(f"{key} {kw[key]!r}: the reference has SIMP")
        nx, ny = kw["nx"], kw["ny"]
        Lx, Ly = kw.get("Lx", 2.0), kw.get("Ly", 1.0)
        self.N = kw.get("N", 6)
        self.sigma = float(kw["sigma"])
        self.p = kw.get("p", 3.0)
        self.rho0_K = kw.get("rho0_K", 1e-6)
        self.rho0_G = kw.get("rho0_G", 1e-9)
        nodes = np.arange((nx + 1) * (ny + 1)).reshape(nx + 1, ny + 1)
        xv, yv = np.meshgrid(np.linspace(0.0, Lx, nx + 1),
                             np.linspace(0.0, Ly, ny + 1), indexing="ij")
        X = np.stack([xv.reshape(-1), yv.reshape(-1)], axis=1)
        ii, jj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
        self.conn = np.stack([nodes[ii, jj], nodes[ii + 1, jj],
                              nodes[ii + 1, jj + 1], nodes[ii, jj + 1]],
                             axis=-1).reshape(-1, 4)
        self.nnodes = X.shape[0]
        self.ndv = self.nnodes
        self.n = 2 * self.nnodes
        # the spatial filter: weights r0 - d over the nodes within r0,
        # normalised to sum 1 in each row (the node itself at d = 0)
        r0 = kw.get("rfact", 2.0) * Ly / ny
        tree = cKDTree(X)
        D = tree.sparse_distance_matrix(tree, r0, output_type="coo_matrix")
        off = D.row != D.col
        diag = np.arange(self.nnodes)
        F = sp.csr_matrix(
            (np.concatenate([r0 - D.data[off], np.full(self.nnodes, r0)]),
             (np.concatenate([D.row[off], diag]),
              np.concatenate([D.col[off], diag]))),
            shape=(self.nnodes,) * 2)
        self.F = sp.diags(1.0 / np.asarray(F.sum(axis=1)).ravel()) @ F
        # clamped left edge; the compressive unit load in -x on the strip
        fixed = np.zeros(self.n, dtype=bool)
        fixed[2 * nodes[0]] = fixed[2 * nodes[0] + 1] = True
        self.free = np.nonzero(~fixed)[0]
        self.f = np.zeros(self.n)
        loaded = load_nodes(kw)
        self.f[2 * loaded] = -1.0 / len(loaded)
        self.aggregate_dofs = load_dofs(kw)
        self.Ke0, self.CB, self.H, self.w = _q4(
            Lx / nx, Ly / ny, kw.get("E", 1.0), kw.get("nu", 0.3))
        self.dofs = np.stack([2 * self.conn, 2 * self.conn + 1],
                             axis=-1).reshape(-1, 8)
        self.rows = np.repeat(self.dofs, 8, axis=1).reshape(-1)
        self.cols = np.tile(self.dofs, (1, 8)).reshape(-1)
        self.next_lam = None

    def _assemble(self, Ke):
        """The free-DOF block of the sum of the element matrices Ke."""
        A = sp.csr_matrix((Ke.reshape(-1), (self.rows, self.cols)),
                          shape=(self.n, self.n))
        return A[self.free][:, self.free]

    def _full(self, v):
        out = np.zeros((self.n,) + v.shape[1:], dtype=v.dtype)
        out[self.free] = v
        return out

    def solve(self, x, dtype=np.float64):
        """(lam, Phi, K, M) of the N lowest load factors at x, on the free
        DOFs, with M = -G and Phi^T M Phi = I; the next load factor is
        kept as ``next_lam``."""
        x = np.asarray(x, dtype=np.float64)
        rhoE = (self.F @ x)[self.conn].mean(axis=1).astype(dtype)
        cK = rhoE**self.p + dtype(self.rho0_K)
        cG = rhoE**self.p + dtype(self.rho0_G)
        Ke0 = self.Ke0.astype(dtype)
        K = self._assemble(cK[:, None, None] * Ke0[None])
        lu_K = eig._lu(K)
        u = self._full(eig._solve(K, lu_K, self.f[self.free].astype(dtype)))
        # element stresses at the Gauss points, then G_e = sum_q w H^T S H
        s = cG[:, None, None] * np.einsum("qkl,el->eqk",
                                          self.CB.astype(dtype),
                                          u[self.dofs])
        S = np.stack([np.stack([s[..., 0], s[..., 2]], -1),
                      np.stack([s[..., 2], s[..., 1]], -1)], -2)
        Hd = self.H.astype(dtype)
        G4 = dtype(self.w) * np.einsum("qia,eqij,qjb->eab", Hd, S, Hd)
        Ge = np.zeros((len(rhoE), 8, 8), dtype=dtype)
        Ge[:, 0::2, 0::2] = G4
        Ge[:, 1::2, 1::2] = G4
        G = self._assemble(Ge)
        M = -G
        k = self.N + 1
        # the buckling mode's k load factors nearest the shift are the k
        # lowest only for 0 < sigma < lam_1, where K + sigma G is positive
        # definite: its pivots (symmetric order, diagonal pivots) are all
        # positive by Sylvester's law of inertia. Halve the shift until so.
        sigma = self.sigma
        while True:
            lu = eig._lu(K - dtype(sigma) * M)
            if np.all(lu.U.diagonal() > 0):
                break
            sigma *= 0.5
        op = spla.LinearOperator(K.shape, matvec=lu.solve, dtype=dtype)
        v0 = np.random.default_rng(0).uniform(-1.0, 1.0, K.shape[0])
        lam, Phi = spla.eigsh(K, k=k, M=M, sigma=sigma, OPinv=op,
                              mode="buckling", v0=v0.astype(dtype))
        order = np.argsort(lam)
        lam, Phi = lam[order].astype(dtype), Phi[:, order]
        Phi = (Phi / np.sqrt(np.einsum("ij,ij->j", Phi, M @ Phi))[None, :]
               ).astype(dtype)
        self.next_lam = lam[-1]
        gaps = np.diff(lam) / lam[:-1]
        print(f"[reference] load factors / the configuration's sigma "
              f"{(lam / self.sigma).tolist()} (shift {sigma!r}); smallest "
              f"relative gap among the {k}: {float(gaps.min())!r} (after "
              f"factor {int(gaps.argmin()) + 1})", file=sys.stderr,
              flush=True)
        self._state = (rhoE, u, K, lu_K, dtype)
        return lam[:-1], Phi[:, :-1], K, M

    def gradient(self, UK, UM, V):
        """d/dx of sum_i UK_i^T K(x) V_i + UM_i^T M(x, u(x)) V_i at the x of
        the last ``solve``, M = -G(x, u(x)), u(x) = K(x)^{-1} f."""
        rhoE, u, K, lu_K, dtype = self._state
        p = self.p
        UKe, UMe, Ve = (self._full(a)[self.dofs] for a in (UK, UM, V))
        # K: d(c_K)/d(rho) UK^T Ke0 V
        sK = np.einsum("eai,ab,ebi->e", UKe, self.Ke0.astype(dtype), Ve)
        # -G: Z_eqk = d(UM^T G_e V)/d(s_eqk), summed over modes and over
        # the x and y DOFs
        Hd = self.H.astype(dtype)
        Z = np.zeros((len(rhoE), 4, 3), dtype=dtype)
        for c in (0, 1):  # the x and the y DOFs
            HU = np.einsum("qpa,eai->eqpi", Hd, UMe[:, c::2])
            HV = np.einsum("qpa,eai->eqpi", Hd, Ve[:, c::2])
            Z[..., 0] += np.einsum("eqi,eqi->eq", HU[:, :, 0], HV[:, :, 0])
            Z[..., 1] += np.einsum("eqi,eqi->eq", HU[:, :, 1], HV[:, :, 1])
            Z[..., 2] += (np.einsum("eqi,eqi->eq", HU[:, :, 0], HV[:, :, 1])
                          + np.einsum("eqi,eqi->eq", HU[:, :, 1], HV[:, :, 0]))
        Z *= dtype(self.w)
        CBd = self.CB.astype(dtype)
        eps = np.einsum("qkl,el->eqk", CBd, u[self.dofs])  # s / c_G
        cG = rhoE**p + dtype(self.rho0_G)
        dc = p * rhoE ** (p - 1)
        # the direct terms in rho: K's, and -G's through c_G
        drho_e = dc * (sK - np.einsum("eqk,eqk->e", eps, Z))
        # through u: g = d(-UM^T G V)/du, w = K^{-1} g, then -w^T dK u
        gu_e = -cG[:, None] * np.einsum("eqk,qkl->el", Z, CBd)
        gu = np.zeros(self.n, dtype=dtype)
        np.add.at(gu, self.dofs, gu_e)
        w = self._full(eig._solve(K, lu_K, gu[self.free]))
        drho_e = drho_e - dc * np.einsum("ea,ab,eb->e", w[self.dofs],
                                         self.Ke0.astype(dtype),
                                         u[self.dofs])
        drho = np.zeros(self.nnodes, dtype=dtype)
        for c in range(4):
            np.add.at(drho, self.conn[:, c], 0.25 * drho_e)
        return self.F.T @ drho
