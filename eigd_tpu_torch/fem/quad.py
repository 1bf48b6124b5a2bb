"""Bilinear quad (Q4) element tables, batched over all elements.

Counterpart of ``eigd_tpu/fem/quad.py`` (the plane-stress tables, the
geometric-stiffness tables of buckling and the scalar tables of the
Helmholtz filter and the thermal model, and the Jacobian determinants
alone). Element DOF ordering is
[ux0, uy0, ux1, uy1, ...]; the plane-stress quadrature-point index is
2*i + j over GAUSS[i], GAUSS[j], the scalar one 2*j + i.
"""

from __future__ import annotations

import functools
import math

import torch

GAUSS = (-1.0 / math.sqrt(3.0), 1.0 / math.sqrt(3.0))


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


@functools.lru_cache(maxsize=None)
def _shape_functions_on(xi, eta, device, dtype):
    """``shape_functions`` on ``device``, copied from the host once: each
    such copy waits for the device to finish its queue."""
    return tuple(v.to(device, dtype) for v in shape_functions(xi, eta))


def _grads(xe, ye, xi, eta):
    """Physical shape-function gradients and detJ at one quadrature point.

    xe, ye: (nelems, 4) element nodal coordinates.
    Returns N (4,), Nx, Ny (nelems, 4), detJ (nelems,).
    """
    N, Nxi, Neta = _shape_functions_on(xi, eta, xe.device, xe.dtype)
    J00 = xe @ Nxi
    J10 = ye @ Nxi
    J01 = xe @ Neta
    J11 = ye @ Neta
    detJ = J00 * J11 - J01 * J10
    Nx = torch.outer(J11 / detJ, Nxi) + torch.outer(-J10 / detJ, Neta)
    Ny = torch.outer(-J01 / detJ, Nxi) + torch.outer(J00 / detJ, Neta)
    return N, Nx, Ny, detJ


def quad_points():
    """The four (xi, eta) Gauss points in reference index order 2*i + j."""
    out = [None] * 4
    for j in range(2):
        for i in range(2):
            out[2 * i + j] = (GAUSS[i], GAUSS[j])
    return out


def plane_stress_tables(X, conn):
    """Quadrature tables for the plane-stress Q4 element.

    X : (nnodes, 2) f64 tensor, conn : (nelems, 4) integer tensor.

    Returns
    -------
    Be : (nq, nelems, 3, 8) strain-displacement matrices
    He : (nq, nelems, 2, 8) displacement interpolation matrices
    detJ : (nq, nelems)
    """
    xe = X[conn, 0]
    ye = X[conn, 1]
    nelems = conn.shape[0]

    Be_list, He_list, dJ_list = [], [], []
    for xi, eta in quad_points():
        N, Nx, Ny, detJ = _grads(xe, ye, xi, eta)
        Be = X.new_zeros((nelems, 3, 8))
        Be[:, 0, 0::2] = Nx
        Be[:, 1, 1::2] = Ny
        Be[:, 2, 0::2] = Ny
        Be[:, 2, 1::2] = Nx
        He = X.new_zeros((nelems, 2, 8))
        He[:, 0, 0::2] = N[None, :]
        He[:, 1, 1::2] = N[None, :]
        Be_list.append(Be)
        He_list.append(He)
        dJ_list.append(detJ)
    return torch.stack(Be_list), torch.stack(He_list), torch.stack(dJ_list)


def stress_stiffness_tables(X, conn):
    """Quadrature tables for the geometric (stress) stiffness of buckling.

    Returns
    -------
    Be : (nq, nelems, 3, 8) strain-displacement matrices
    Te : (nq, nelems, 3, 4, 4) with Te[:, :, 0] = Nx Nx^T, [1] = Ny Ny^T,
         [2] = Nx Ny^T + Ny Nx^T
    detJ : (nq, nelems)
    """
    xe = X[conn, 0]
    ye = X[conn, 1]
    nelems = conn.shape[0]

    Be_list, Te_list, dJ_list = [], [], []
    for xi, eta in quad_points():
        _, Nx, Ny, detJ = _grads(xe, ye, xi, eta)
        Be = X.new_zeros((nelems, 3, 8))
        Be[:, 0, 0::2] = Nx
        Be[:, 1, 1::2] = Ny
        Be[:, 2, 0::2] = Ny
        Be[:, 2, 1::2] = Nx
        Te = torch.stack([
            torch.einsum("ni,nj->nij", Nx, Nx),
            torch.einsum("ni,nj->nij", Ny, Ny),
            torch.einsum("ni,nj->nij", Nx, Ny)
            + torch.einsum("ni,nj->nij", Ny, Nx)], dim=1)
        Be_list.append(Be)
        Te_list.append(Te)
        dJ_list.append(detJ)
    return torch.stack(Be_list), torch.stack(Te_list), torch.stack(dJ_list)


def thermal_tables(X, conn):
    """Quadrature tables for the scalar Q4 element (quadrature-point index
    2*j + i).

    Returns
    -------
    Be : (nq, nelems, 2, 4) gradient matrices
    He : (nq, nelems, 4) interpolation vectors
    detJ : (nq, nelems)
    """
    xe = X[conn, 0]
    ye = X[conn, 1]
    nelems = conn.shape[0]
    Be_list, He_list, dJ_list = [], [], []
    for j in range(2):
        for i in range(2):
            N, Nx, Ny, detJ = _grads(xe, ye, GAUSS[i], GAUSS[j])
            Be_list.append(torch.stack([Nx, Ny], dim=1))
            He_list.append(N[None, :].expand(nelems, 4))
            dJ_list.append(detJ)
    return torch.stack(Be_list), torch.stack(He_list), torch.stack(dJ_list)


def detJ_tables(X, conn):
    """detJ at every quadrature point of ``quad_points()``: (nq, nelems)."""
    xe = X[conn, 0]
    ye = X[conn, 1]
    return torch.stack([_grads(xe, ye, xi, eta)[3]
                        for xi, eta in quad_points()])
