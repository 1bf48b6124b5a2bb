"""Material interpolation, DOF maps, plane-stress assembly and element
densities.

Counterpart of ``eigd_tpu/fem/assembly.py``: the plane-stress stiffness
and mass matrices (including the general per-element ones of a
non-uniform mesh), the geometric (stress) stiffness of buckling
(``:108-128``) and the thermal conduction and capacitance matrices
(``:132-160``). Every function is a plain differentiable tensor
function, so the eigh_gen backward pass chains through it with
``torch.autograd`` (the stress stiffness in both its density and its
displacement argument).
"""

from __future__ import annotations

import torch

from ..ops.operators import ElementOperator


def stiffness_interp(rhoE, ptype="simp", p=3.0, q=5.0, rho0=1e-6):
    """Stiffness interpolation factor."""
    if ptype == "simp":
        return rhoE**p + rho0
    if ptype == "ramp":
        return rhoE / (1.0 + q * (1.0 - rhoE)) + rho0
    raise ValueError(f"Unknown stiffness interpolation {ptype!r}")


def mass_interp(rhoE, ptype="linear", q=5.0, rho0=1e-9, density=1.0,
                simp_c1=6e5, simp_c2=-5e6):
    """Mass interpolation factor; msimp blends a high-order polynomial
    below rho=0.1 to avoid spurious low-density modes."""
    if ptype == "msimp":
        nonlin = simp_c1 * rhoE**6.0 + simp_c2 * rhoE**7.0
        cond = (rhoE > 0.1).to(rhoE.dtype)
        return density * (rhoE * cond + nonlin * (1.0 - cond))
    if ptype == "ramp":
        return density * ((q + 1.0) * rhoE / (1.0 + q * rhoE) + rho0)
    if ptype == "linear":
        return density * rhoE
    raise ValueError(f"Unknown mass interpolation {ptype!r}")


def plane_stress_C0(E=1.0, nu=0.3, dtype=torch.float64, device="cpu"):
    """Plane-stress constitutive matrix."""
    return E / (1.0 - nu**2) * torch.tensor(
        [[1.0, nu, 0.0], [nu, 1.0, 0.0], [0.0, 0.0, 0.5 * (1.0 - nu)]],
        dtype=dtype, device=device)


def element_dof_map(conn):
    """(nelems, 8) global DOF indices in [ux0, uy0, ux1, uy1, ...] order."""
    var = conn.new_zeros((conn.shape[0], 8))
    var[:, 0::2] = 2 * conn
    var[:, 1::2] = 2 * conn + 1
    return var


def stiffness_matrix(rhoE, Be, detJ, dofs, nvars, C0, ptype="simp", p=3.0,
                     q=5.0, rho0=1e-6):
    """K(rhoE) as an ElementOperator:
    Ke = sum_q detJ_q Be_q^T (c(rhoE) C0) Be_q, with Be (nq, nelems, 3, 8)
    and detJ (nq, nelems)."""
    c = stiffness_interp(rhoE, ptype=ptype, p=p, q=q, rho0=rho0)
    CB = torch.einsum("ik,qekl->qeil", C0, Be)  # (nq, ne, 3, 8)
    w = c[None, :] * detJ  # (nq, ne)
    Ke = torch.einsum("qeij,qeil->ejl", Be, CB * w[:, :, None, None])
    return ElementOperator(Ke, dofs, nvars)


def mass_matrix(rhoE, He, detJ, dofs, nvars, ptype="linear", q=5.0,
                rho0=1e-9, density=1.0):
    """M(rhoE) as an ElementOperator: Me = sum_q detJ_q d(rhoE) He_q^T He_q,
    with He (nq, nelems, 2, 8)."""
    dens = mass_interp(rhoE, ptype=ptype, q=q, rho0=rho0, density=density)
    w = dens[None, :] * detJ  # (nq, ne)
    Me = torch.einsum("qeij,qeil->ejl", He, He * w[:, :, None, None])
    return ElementOperator(Me, dofs, nvars)


def stress_stiffness_matrix(rhoE, u, Be, Te, detJ, dofs, conn, nvars, C0,
                            ptype="simp", p=3.0, q=5.0, rho0=1e-9):
    """G(rhoE, u) as an ElementOperator: the element stresses
    s = c(rhoE) C0 Be u_e at each quadrature point, contracted against the
    Te tables into a (4, 4) block that goes on both the x-x and the y-y
    DOFs. u is the full displacement vector (nvars,)."""
    c = stiffness_interp(rhoE, ptype=ptype, p=p, q=q, rho0=rho0)
    ue = u[dofs]  # (nelems, 8)
    s = torch.einsum("e,ik,qekl,el->qei", c, C0, Be, ue)  # (nq, ne, 3)
    G0 = torch.einsum("qe,qei,qeijl->ejl", detJ, s, Te)  # (ne, 4, 4)
    Ge = G0.new_zeros((conn.shape[0], 8, 8))
    Ge[:, 0::2, 0::2] += G0
    Ge[:, 1::2, 1::2] += G0
    return ElementOperator(Ge, dofs, nvars)


def thermal_stiffness_matrix(rhoE, Be, detJ, conn, nnodes, kappa=1.0,
                             beta=0.0, p=3.0):
    """Heat conduction K as an ElementOperator, with
    kappa(rho) = kappa0 ((1 - beta) rho^p + beta); Be (nq, nelems, 2, 4)."""
    k = kappa * ((1.0 - beta) * rhoE**p + beta)
    BtB = torch.einsum("qeij,qeil->qejl", Be, Be)
    Ke = torch.einsum("e,qe,qejl->ejl", k, detJ, BtB)
    return ElementOperator(Ke, conn, nnodes)


def thermal_mass_matrix(rhoE, He, detJ, conn, nnodes, density=1.0,
                        heat_capacity=1.0, beta=0.0):
    """Heat capacitance M as an ElementOperator, with
    c(rho) = c0 rho0 ((1 - beta) rho + beta); He (nq, nelems, 4)."""
    c = heat_capacity * density * ((1.0 - beta) * rhoE + beta)
    HtH = torch.einsum("qei,qej->qeij", He, He)
    Me = torch.einsum("e,qe,qeij->eij", c, detJ, HtH)
    return ElementOperator(Me, conn, nnodes)


def element_density(rho, conn):
    """rhoE = mean of the four nodal densities."""
    return 0.25 * (rho[conn[:, 0]] + rho[conn[:, 1]] + rho[conn[:, 2]]
                   + rho[conn[:, 3]])
