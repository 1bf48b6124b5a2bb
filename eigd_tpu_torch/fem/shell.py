"""Flat-shell Q4 element (membrane + Mindlin bending + reduced shear) with
6 DOF a node, batched over elements.

Counterpart of ``eigd_tpu/fem/shell.py``: isotropic shell stiffness and
consistent mass as differentiable functions of per-element thickness, so
the thickness sensitivities of the CRM wingbox come from autograd through
this assembly (the role of TACS ``addMatDVSensInnerProduct`` in the
reference).

Formulation: a local orthonormal frame per element; membrane = plane-stress
Q4; bending = Mindlin plate with 2x2 quadrature; transverse shear with
1-point reduced quadrature (no locking); a small drilling stiffness and
rotary mass on the rotation about the shell normal. The local matrices
are batched einsums over elements, rotated to global coordinates by the
block-diagonal frames as two batched GEMMs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .quad import GAUSS
from .quad import _grads as _grads_local  # JAX's _grads_local, line for line

# Local DOF layout a node: [u, v, w, t1, t2, t3] (t = rotations about the
# local axes); the element vector has 24 entries, node-major, so the DOF d
# of the four nodes sits at columns d::6.
_U, _V, _W, _T1, _T2, _T3 = range(6)


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


@functools.lru_cache(maxsize=None)
def _constants(nu, device, dtype):
    """The plane-stress matrix over E / (1 - nu^2) and the translation
    and rotation masks of a node's DOF, made on ``device`` once: each
    copy from the host waits for the device to finish its queue."""
    f64 = dict(dtype=dtype, device=device)
    return (torch.tensor([[1.0, nu, 0.0], [nu, 1.0, 0.0],
                          [0.0, 0.0, 0.5 * (1.0 - nu)]], **f64),
            torch.tensor([1.0, 1.0, 1.0, 0.0, 0.0, 0.0], **f64),
            torch.tensor([0.0, 0.0, 0.0, 1.0, 1.0, 0.0], **f64))


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

    C0, trans, rot = _constants(nu, Xe.device, Xe.dtype)
    C0 = E / (1.0 - nu**2) * C0
    Gmod = E / (2.0 * (1.0 + nu))

    Kl = Xe.new_zeros((nelems, 24, 24))
    Ml = Xe.new_zeros((nelems, 24, 24))
    area = Xe.new_zeros(nelems)
    eye6 = torch.eye(6, **f64)

    for gx in GAUSS:
        for gy in GAUSS:
            N, Nx, Ny, dJ = _grads_local(xl, yl, gx, gy)
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
    N, Nx, Ny, dJ = _grads_local(xl, yl, 0.0, 0.0)
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


def shell_dof_map(conn):
    """(nelems, 24) global DOF indices, 6 DOF a node (numpy int64)."""
    conn = np.asarray(conn, dtype=np.int64)
    return (6 * conn[:, :, None] + np.arange(6)).reshape(conn.shape[0], 24)
