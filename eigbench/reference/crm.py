"""Plain reference of the CRM wingbox family (the upstream eigd
``examples/crm.py`` modal-compliance model on the parametric wingbox).

From a configuration's ``model`` keywords and the five component
thicknesses it builds, with NumPy, SciPy and plain torch on the CPU: the
wingbox mesh, the flat-shell element matrices, K and M as sparse matrices
in the natural 6-DOF-a-node order reduced to the DOFs off the clamped root
station, the lowest N eigenpairs (shift sigma, SuperLU and ARPACK), and
the total derivative of a function of them in the thicknesses
(``eig.adjoint_pairs``, then torch's autograd of the element bilinear
forms in the thickness).

Frozen copies, as they stood at commit fc1c7d8 of this repository (the
reference may not import the program, and these routines are its model's
definition, not its solver): ``shape_functions`` and ``_grads`` from
``eigd_tpu_torch/fem/quad.py``; ``element_frames``, ``_scatter`` and
``shell_element_matrices`` from ``eigd_tpu_torch/fem/shell.py``;
``make_wingbox_mesh`` from ``eigd_tpu_torch/models/crm.py``. Each is a
copy of the upstream eigd routine of the same name.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.sparse as sp
import torch

from . import eig

GAUSS = (-1.0 / math.sqrt(3.0), 1.0 / math.sqrt(3.0))
_U, _V, _W, _T1, _T2, _T3 = range(6)


def shape_functions(xi, eta):
    """Q4 shape functions and parametric derivatives, as (4,) f64 tensors
    on the CPU (plain floats in, so there is no device to follow)."""
    def t(vals):
        return torch.tensor(vals, dtype=torch.float64)

    N = 0.25 * t([(1.0 - xi) * (1.0 - eta), (1.0 + xi) * (1.0 - eta),
                  (1.0 + xi) * (1.0 + eta), (1.0 - xi) * (1.0 + eta)])
    Nxi = 0.25 * t([-(1.0 - eta), (1.0 - eta), (1.0 + eta), -(1.0 + eta)])
    Neta = 0.25 * t([-(1.0 - xi), -(1.0 + xi), (1.0 + xi), (1.0 - xi)])
    return N, Nxi, Neta


def _grads(xe, ye, xi, eta):
    """Physical shape-function gradients and detJ at one quadrature point.

    xe, ye: (nelems, 4) element nodal coordinates.
    Returns N (4,), Nx, Ny (nelems, 4), detJ (nelems,).
    """
    N, Nxi, Neta = (v.to(xe.device, xe.dtype)
                    for v in shape_functions(xi, eta))
    J00 = xe @ Nxi
    J10 = ye @ Nxi
    J01 = xe @ Neta
    J11 = ye @ Neta
    detJ = J00 * J11 - J01 * J10
    Nx = torch.outer(J11 / detJ, Nxi) + torch.outer(-J10 / detJ, Neta)
    Ny = torch.outer(-J01 / detJ, Nxi) + torch.outer(J00 / detJ, Neta)
    return N, Nx, Ny, detJ


def element_frames(Xe):
    """Local orthonormal frames of a batch of (possibly warped) quads.

    Xe: (nelems, 4, 3). Returns R (nelems, 3, 3) with rows (e1, e2, n) and
    the local in-plane coordinates xl, yl (nelems, 4).
    """
    d1 = Xe[:, 1] - Xe[:, 0] + Xe[:, 2] - Xe[:, 3]
    d2 = Xe[:, 3] - Xe[:, 0] + Xe[:, 2] - Xe[:, 1]
    n = torch.linalg.cross(d1, d2)
    n = n / torch.linalg.norm(n, dim=1, keepdim=True)
    e1 = d1 / torch.linalg.norm(d1, dim=1, keepdim=True)
    e2 = torch.linalg.cross(n, e1)
    R = torch.stack([e1, e2, n], dim=1)

    rel = Xe - Xe[:, :1]
    xl = torch.einsum("nij,nkj->nki", R, rel)
    return R, xl[:, :, 0], xl[:, :, 1]


def _scatter(rows, nelems, like):
    """A (nelems, len(rows), 24) B matrix: ``rows`` lists, per row, the
    (dof, values) pairs to place at the columns dof::6, values (nelems, 4)
    or (4,)."""
    B = like.new_zeros((nelems, len(rows), 24))
    for i, pairs in enumerate(rows):
        for dof, vals in pairs:
            B[:, i, dof::6] = vals
    return B


def shell_element_matrices(Xe, thickness, E=70e9, nu=0.3, rho=2700.0,
                           kappa_s=5.0 / 6.0, drill=1e-5):
    """Batched shell stiffness and mass matrices in GLOBAL coordinates.

    Xe : (nelems, 4, 3) element nodal coordinates.
    thickness : (nelems,) shell thickness (autograd flows through it).
    Returns Ke, Me : (nelems, 24, 24).
    """
    nelems = Xe.shape[0]
    R, xl, yl = element_frames(Xe)
    t = thickness
    f64 = dict(dtype=Xe.dtype, device=Xe.device)

    C0 = E / (1.0 - nu**2) * torch.tensor(
        [[1.0, nu, 0.0], [nu, 1.0, 0.0], [0.0, 0.0, 0.5 * (1.0 - nu)]], **f64)
    Gmod = E / (2.0 * (1.0 + nu))

    Kl = Xe.new_zeros((nelems, 24, 24))
    Ml = Xe.new_zeros((nelems, 24, 24))
    area = Xe.new_zeros(nelems)
    eye6 = torch.eye(6, **f64)
    trans = torch.tensor([1.0, 1.0, 1.0, 0.0, 0.0, 0.0], **f64)
    rot = torch.tensor([0.0, 0.0, 0.0, 1.0, 1.0, 0.0], **f64)

    for gx in GAUSS:
        for gy in GAUSS:
            N, Nx, Ny, dJ = _grads(xl, yl, gx, gy)
            area = area + dJ

            # membrane strains (u_x, v_y, u_y + v_x)
            Bm = _scatter([[(_U, Nx)], [(_V, Ny)], [(_U, Ny), (_V, Nx)]],
                          nelems, Xe)
            Kl = Kl + torch.einsum("e,e,eij,ik,ekl->ejl", t, dJ, Bm, C0, Bm)

            # bending curvatures: beta_x = t2, beta_y = -t1
            Bb = _scatter([[(_T2, Nx)], [(_T1, -Ny)],
                           [(_T2, Ny), (_T1, -Nx)]], nelems, Xe)
            Kl = Kl + torch.einsum("e,e,eij,ik,ekl->ejl", t**3 / 12.0, dJ,
                                   Bb, C0, Bb)

            # consistent mass: translations rho t, rotations t1, t2
            # rho t^3 / 12, each on the 4x4 N N^T of its DOF
            w = (rho * t * dJ)[:, None] * trans + (
                rho * t**3 / 12.0 * dJ)[:, None] * rot  # (nelems, 6)
            Ml = Ml + torch.einsum("ab,ec,cd->eacbd", torch.outer(N, N), w,
                                   eye6).reshape(nelems, 24, 24)

    # reduced (1-point) transverse shear: gamma = [w_x + beta_x, w_y + beta_y]
    N, Nx, Ny, dJ = _grads(xl, yl, 0.0, 0.0)
    Bs = _scatter([[(_W, Nx), (_T2, N)], [(_W, Ny), (_T1, -N)]], nelems, Xe)
    # the 1-point rule's weight is 4 (the full parametric area)
    Kl = Kl + torch.einsum("e,e,eij,eil->ejl", kappa_s * Gmod * t, 4.0 * dJ,
                           Bs, Bs)

    # drilling stiffness and a tiny rotary mass on t3 (K, M nonsingular)
    on_t3 = torch.zeros(24, **f64)
    on_t3[_T3::6] = 1.0
    Kl = Kl + torch.diag_embed((drill * E * t * area)[:, None] * on_t3)
    Ml = Ml + torch.diag_embed((drill * rho * t * area)[:, None] * on_t3)

    # rotate to global: T = blockdiag(R x 8), A_g = T^T A_l T
    T = torch.block_diag(*([torch.ones(3, 3, **f64)] * 8))[None] * R.repeat(
        1, 8, 8)

    def rotate(Al):
        A = T.mT @ Al @ T
        return 0.5 * (A + A.mT)

    return rotate(Kl), rotate(Ml)


def make_wingbox_mesh(nspan=8, nchord=4, nheight=2, span=10.0, c_root=3.0,
                      c_tip=1.2, h_root=0.6, h_tip=0.25, sweep=0.3,
                      nribs=3):
    """Parametric wingbox: top and bottom skins, front and rear spars,
    evenly spaced ribs. Returns (X (nnodes, 3), conn (nelems, 4),
    comp (nelems,), names); numpy, bitwise JAX's."""
    key2node = {}
    X = []

    def node(x, y, z):
        key = (round(x, 9), round(y, 9), round(z, 9))
        if key not in key2node:
            key2node[key] = len(X)
            X.append([x, y, z])
        return key2node[key]

    def section(j):
        f = j / nspan
        c = c_root + (c_tip - c_root) * f
        h = h_root + (h_tip - h_root) * f
        xoff = sweep * span * f
        y = span * f
        return c, h, xoff, y

    conn = []
    comp = []
    names = ["top_skin", "bottom_skin", "front_spar", "rear_spar", "ribs"]

    def add_quad(n0, n1, n2, n3, cid):
        conn.append([n0, n1, n2, n3])
        comp.append(cid)

    # skins: a grid in (chord i, span j)
    def skin(zsign, cid):
        for j in range(nspan):
            c0, h0, x0, y0 = section(j)
            c1, h1, x1, y1 = section(j + 1)
            for i in range(nchord):
                fa, fb = i / nchord, (i + 1) / nchord
                a = node(x0 + (fa - 0.5) * c0, y0, zsign * h0 / 2)
                b = node(x0 + (fb - 0.5) * c0, y0, zsign * h0 / 2)
                d = node(x1 + (fb - 0.5) * c1, y1, zsign * h1 / 2)
                e = node(x1 + (fa - 0.5) * c1, y1, zsign * h1 / 2)
                add_quad(a, b, d, e, cid)

    skin(+1, 0)
    skin(-1, 1)

    # spars: a grid in (span j, height k) at chord fraction 0 / 1
    def spar(cfrac, cid):
        for j in range(nspan):
            c0, h0, x0, y0 = section(j)
            c1, h1, x1, y1 = section(j + 1)
            for k in range(nheight):
                ga, gb = k / nheight - 0.5, (k + 1) / nheight - 0.5
                a = node(x0 + (cfrac - 0.5) * c0, y0, ga * h0)
                b = node(x0 + (cfrac - 0.5) * c0, y0, gb * h0)
                d = node(x1 + (cfrac - 0.5) * c1, y1, gb * h1)
                e = node(x1 + (cfrac - 0.5) * c1, y1, ga * h1)
                add_quad(a, e, d, b, cid)

    spar(0.0, 2)
    spar(1.0, 3)

    # ribs: full cross-section sheets at evenly spaced interior stations
    rib_js = np.linspace(0, nspan, nribs + 2).astype(int)[1:-1]
    for j in rib_js:
        c0, h0, x0, y0 = section(int(j))
        for i in range(nchord):
            fa, fb = i / nchord, (i + 1) / nchord
            for k in range(nheight):
                ga, gb = k / nheight - 0.5, (k + 1) / nheight - 0.5
                a = node(x0 + (fa - 0.5) * c0, y0, ga * h0)
                b = node(x0 + (fb - 0.5) * c0, y0, ga * h0)
                d = node(x0 + (fb - 0.5) * c0, y0, gb * h0)
                e = node(x0 + (fa - 0.5) * c0, y0, gb * h0)
                add_quad(a, b, d, e, 4)

    return (np.array(X), np.array(conn, dtype=np.int32),
            np.array(comp, dtype=np.int32), names)


class Problem:
    """The reference model of one configuration."""

    def __init__(self, model):
        kw = dict(model)
        nspan = kw.get("nspan", 48)
        nribs = kw.get("nribs") or max(3, nspan // 8)
        mesh_kw = {k: kw[k] for k in ("span", "c_root", "c_tip", "h_root",
                                      "h_tip", "sweep") if k in kw}
        X, conn, comp, names = make_wingbox_mesh(
            nspan, kw.get("nchord", 8), kw.get("nheight", 3), nribs=nribs,
            **mesh_kw)
        self.N = kw.get("N", 6)
        self.sigma = float(kw.get("sigma", 0.0) or 0.0)
        self.E, self.nu, self.rho = (kw.get("E", 70e9), kw.get("nu", 0.3),
                                     kw.get("rho", 2700.0))
        self.ndv = len(names)
        self.conn, self.comp = conn.astype(np.int64), comp.astype(np.int64)
        self.Xe = torch.as_tensor(X[self.conn], dtype=torch.float64)
        nnodes = X.shape[0]
        self.n = 6 * nnodes
        self.dofs = (6 * self.conn[:, :, None] + np.arange(6)).reshape(-1, 24)
        self.rows = np.repeat(self.dofs, 24, axis=1).reshape(-1)
        self.cols = np.tile(self.dofs, (1, 24)).reshape(-1)
        root = X[:, 1] <= X[:, 1].min() + 1e-9
        self.free = np.nonzero(np.repeat(~root, 6))[0]
        tip = np.nonzero(X[:, 1] > X[:, 1].max() - 1e-9)[0]
        load = np.zeros(self.n)
        load[6 * tip + 2] = 1.0 / len(tip)
        self.load = load[self.free]

    def _element_mats(self, t):
        return shell_element_matrices(self.Xe, t[self.comp], E=self.E,
                                      nu=self.nu, rho=self.rho)

    def _assemble(self, mats):
        A = sp.csr_matrix((mats.reshape(-1), (self.rows, self.cols)),
                          shape=(self.n, self.n))
        return A[self.free][:, self.free]

    def solve(self, x, dtype=np.float64):
        """(lam, Phi, K, M) of the N lowest modes at thicknesses x; the
        next eigenvalue is kept as ``next_lam``."""
        t = torch.as_tensor(np.asarray(x, dtype=np.float64))
        with torch.no_grad():
            Ke, Me = self._element_mats(t)
        self._t = t
        K = self._assemble(Ke.numpy())
        M = self._assemble(Me.numpy())
        lam, Phi = eig.lowest_pairs(K, M, self.sigma, self.N + 1, dtype)
        self.next_lam = lam[-1]  # the first mode not asked for
        return lam[:-1], Phi[:, :-1], K, M

    def gradient(self, UK, UM, V):
        """d/dx of sum_i UK_i^T K(x) V_i + UM_i^T M(x) V_i at the x of the
        last ``solve``, by autograd of the element bilinear forms."""
        def full(U):
            out = np.zeros((self.n, U.shape[1]))
            out[self.free] = U
            return torch.as_tensor(out[self.dofs])  # (ne, 24, N)

        uk, um, v = full(UK), full(UM), full(V)
        t = self._t.clone().requires_grad_(True)
        Ke, Me = self._element_mats(t)
        s = (torch.einsum("eai,eab,ebi->", uk, Ke, v)
             + torch.einsum("eai,eab,ebi->", um, Me, v))
        (g,) = torch.autograd.grad(s, t)
        return g.numpy()
