"""Material interpolation, DOF maps and element densities.

Counterpart of ``eigd_tpu/fem/assembly.py:28-64,157``: the pieces of the
assembly that the uniform-grid natural-frequency model uses. Every function
is a plain differentiable tensor function, so the eigh_gen backward pass
chains through it with ``torch.autograd``.
"""

from __future__ import annotations

import torch


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


def element_density(rho, conn):
    """rhoE = mean of the four nodal densities."""
    return 0.25 * (rho[conn[:, 0]] + rho[conn[:, 1]] + rho[conn[:, 2]]
                   + rho[conn[:, 3]])
