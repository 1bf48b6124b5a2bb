"""Plain reference of the natural-frequency family (the upstream eigd
``examples/natural_frequency.py`` model on a uniform grid).

From a configuration's ``model`` keywords and a design x it builds, with
NumPy and SciPy alone: the grid, the quarter-symmetric design map with its
frozen point-mass node sets, the (r0 - d) density filter as a sparse
row-normalised matrix, the element densities, the Q4 plane-stress
stiffness and consistent mass (2x2 Gauss), K and M as sparse matrices, the
free-free eigenpairs above the three rigid modes, and the total derivative
of a function of them back through assembly, densities, filter and design
map (``eig.adjoint_pairs``).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.spatial import cKDTree

from . import eig

RIGID = 3  # two translations and a rotation: K's null space, free-free


def grid(nx, ny, Lx, Ly):
    """Node (i, j) is i*(ny+1) + j; element i + nx*j has the nodes
    (i,j), (i+1,j), (i+1,j+1), (i,j+1)."""
    nodes = np.arange((nx + 1) * (ny + 1)).reshape(nx + 1, ny + 1)
    xv, yv = np.meshgrid(np.linspace(0.0, Lx, nx + 1),
                         np.linspace(0.0, Ly, ny + 1), indexing="ij")
    X = np.stack([xv.reshape(-1), yv.reshape(-1)], axis=1)
    ii, jj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    conn = np.zeros((nx * ny, 4), dtype=np.int64)
    e = (ii + nx * jj).reshape(-1)
    conn[e] = np.stack([nodes[ii, jj], nodes[ii + 1, jj],
                        nodes[ii + 1, jj + 1], nodes[ii, jj + 1]],
                       axis=-1).reshape(-1, 4)
    return nodes, X, conn


def _design_map(nodes, nx, ny, Mx, My, ns, rfact):
    """The upstream model's point-mass node sets (frozen at density 1,
    map entry -1) on an Mx x My lattice, and the quarter-symmetric map of
    the other nodes onto the design variables."""
    dvmap = np.zeros((nx + 1, ny + 1), dtype=np.int64)
    sets = {}
    ns = max(int(ns * ny // 32), int(rfact // 2))
    sx, sy = nx // (Mx - 1), ny // (My - 1)

    def span(i, M, s, n, lo_off, hi_off):
        if i < M // 2:
            return max(0, s * i + lo_off), min(n, s * i + hi_off)
        lo_t = max(0, s * (M - i - 1) + lo_off)
        hi_t = min(n, s * (M - i - 1) + hi_off)
        return max(0, n - hi_t), min(n, n - lo_t)

    for i in range(Mx):
        for j in range(My):
            i0, i1 = span(i, Mx, sx, nx, -ns + 1, ns + 1)
            j0, j1 = span(j, My, sy, ny, -ns, ns)
            sets[f"node[{i},{j}]"] = nodes[i0:i1, j0:j1].reshape(-1)
            dvmap[i0:i1, j0:j1] = -1
    index = 0
    for i in range(nx // 2 + 1):
        for j in range(ny // 2 + 1):
            if dvmap[i, j] >= 0:
                for a, b in ((i, j), (nx - i, j), (i, ny - j),
                             (nx - i, ny - j)):
                    dvmap[a, b] = index
                index += 1
    return dvmap.reshape(-1), index, sets


def design_points(model):
    """(ndv, 2): where each design variable lies, at the first-quadrant
    node of the four it maps (the others are its mirror images)."""
    nx, ny = model["nx"], model["ny"]
    nodes, X, _ = grid(nx, ny, model.get("Lx", 1.0), model.get("Ly", 1.0))
    dvmap, ndv, _ = _design_map(nodes, nx, ny, model.get("Mx", 3),
                                model.get("My", 3), model.get("ns", 2),
                                model.get("rfact", 4.0))
    free = dvmap >= 0
    points = np.full((ndv, 2), np.inf)
    np.minimum.at(points, dvmap[free], X[free])
    return points


def density_filter(X, r0):
    """The density filter as a sparse matrix: weights (r0 - d) over the
    nodes within r0, normalised to sum 1 in each row."""
    nnodes = X.shape[0]
    tree = cKDTree(X)
    D = tree.sparse_distance_matrix(tree, r0 * (1 + 1e-12),
                                    output_type="coo_matrix")
    off = D.row != D.col  # the node itself is added below, at d = 0
    diag = np.arange(nnodes)
    F = sp.csr_matrix(
        (np.concatenate([np.maximum(r0 - D.data[off], 0.0),
                         np.full(nnodes, r0)]),
         (np.concatenate([D.row[off], diag]),
          np.concatenate([D.col[off], diag]))),
        shape=(nnodes,) * 2)
    rows = np.asarray(F.sum(axis=1)).ravel()
    return sp.diags(1.0 / rows) @ F


def _q4_plane_stress(hx, hy, E, nu):
    """Ke0, Me0 (8, 8) of one hx x hy element, DOFs (ux, uy) node-major."""
    C = E / (1.0 - nu**2) * np.array([[1.0, nu, 0.0], [nu, 1.0, 0.0],
                                      [0.0, 0.0, 0.5 * (1.0 - nu)]])
    xi_n = np.array([-1.0, 1.0, 1.0, -1.0])
    eta_n = np.array([-1.0, -1.0, 1.0, 1.0])
    g = 1.0 / np.sqrt(3.0)
    Ke = np.zeros((8, 8))
    Me = np.zeros((8, 8))
    detJ = hx * hy / 4.0
    for xi in (-g, g):
        for eta in (-g, g):
            N = 0.25 * (1 + xi * xi_n) * (1 + eta * eta_n)
            Nx = 0.25 * xi_n * (1 + eta * eta_n) * 2.0 / hx
            Ny = 0.25 * eta_n * (1 + xi * xi_n) * 2.0 / hy
            B = np.zeros((3, 8))
            B[0, 0::2] = Nx
            B[1, 1::2] = Ny
            B[2, 0::2] = Ny
            B[2, 1::2] = Nx
            H = np.zeros((2, 8))
            H[0, 0::2] = N
            H[1, 1::2] = N
            Ke += detJ * B.T @ C @ B
            Me += detJ * H.T @ H
    return Ke, Me


class Problem:
    """The reference model of one configuration."""

    def __init__(self, model):
        kw = dict(model)
        self.nx, self.ny = kw["nx"], kw["ny"]
        Lx, Ly = kw.get("Lx", 1.0), kw.get("Ly", 1.0)
        rfact = kw.get("rfact", 4.0)
        self.N = kw.get("N", 10)
        self.sigma = kw.get("sigma", -10.0)
        self.p = kw.get("p", 3.0)
        self.rho0_K = kw.get("rho0_K", 1e-6)
        self.density = kw.get("density", 1.0)
        E, nu = kw.get("E", 1.0), kw.get("nu", 0.3)
        nodes, self.X, self.conn = grid(self.nx, self.ny, Lx, Ly)
        self.nnodes = self.X.shape[0]
        self.n = 2 * self.nnodes
        self.dvmap, self.ndv, self.node_sets = _design_map(
            nodes, self.nx, self.ny, kw.get("Mx", 3), kw.get("My", 3),
            kw.get("ns", 2), rfact)
        self.F = density_filter(self.X, rfact * Ly / self.ny)
        free = self.dvmap >= 0
        self.P = sp.csr_matrix((np.ones(int(free.sum())),
                                (np.nonzero(free)[0], self.dvmap[free])),
                               shape=(self.nnodes, self.ndv))
        self.frozen = (~free).astype(np.float64)
        self.Ke0, self.Me0 = _q4_plane_stress(Lx / self.nx, Ly / self.ny,
                                              E, nu)
        self.dofs = np.stack([2 * self.conn, 2 * self.conn + 1],
                             axis=-1).reshape(-1, 8)
        self.rows = np.repeat(self.dofs, 8, axis=1).reshape(-1)
        self.cols = np.tile(self.dofs, (1, 8)).reshape(-1)

    def densities(self, x):
        """x -> element densities rhoE."""
        rho = self.F @ (self.P @ x + self.frozen)
        return rho[self.conn].mean(axis=1)

    def _assemble(self, coef, Ke):
        vals = (coef[:, None, None] * Ke[None]).reshape(-1)
        return sp.csr_matrix((vals, (self.rows, self.cols)),
                             shape=(self.n, self.n))

    def matrices(self, x):
        rhoE = self.densities(x)
        K = self._assemble(rhoE**self.p + self.rho0_K, self.Ke0)
        M = self._assemble(self.density * rhoE, self.Me0)
        return rhoE, K, M

    def solve(self, x, dtype=np.float64):
        """(lam, Phi, K, M) of the N lowest elastic modes at x; the next
        eigenvalue is kept as ``next_lam``."""
        x = np.asarray(x, dtype=np.float64)
        rhoE, K, M = self.matrices(x)
        lam, Phi = eig.lowest_pairs(K, M, self.sigma, self.N + RIGID + 1,
                                    dtype)
        self._rhoE = rhoE.astype(dtype)
        self.next_lam = lam[-1]  # the first mode not asked for
        return lam[RIGID:-1], Phi[:, RIGID:-1], K, M

    def gradient(self, UK, UM, V):
        """d/dx of sum_i UK_i^T K(x) V_i + UM_i^T M(x) V_i at the x of the
        last ``solve``."""
        rhoE = self._rhoE
        Ve = V[self.dofs]  # (ne, 8, N)
        sK = np.einsum("eai,ab,ebi->e", UK[self.dofs], self.Ke0, Ve)
        sM = np.einsum("eai,ab,ebi->e", UM[self.dofs], self.Me0, Ve)
        drho_e = self.p * rhoE ** (self.p - 1) * sK + self.density * sM
        drho = np.zeros(self.nnodes, dtype=rhoE.dtype)
        for c in range(4):
            np.add.at(drho, self.conn[:, c], 0.25 * drho_e)
        return self.P.T @ (self.F.T @ drho)
