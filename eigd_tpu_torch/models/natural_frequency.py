"""Natural-frequency topology analysis on a uniform grid.

Counterpart of ``eigd_tpu/models/natural_frequency.py:28-270,564`` for
``uniform_grid=True`` and ``factor_kind="mg"``: the chain
x -> conv filter -> element densities -> (K, M) grid stencils -> block
shift-invert Lanczos on the multigrid factor -> (lam, Phi) is one
differentiable function whose eigensolve carries the adjoint backward pass
(``ops.autodiff.eigh_gen``). The structure is free-free: the three rigid
modes are deflated out of the Krylov iteration. The three-phase adjoint
protocol, ``MinFreqOpt`` and the direct factors are not ported (ROADMAP
queue 1, items 4 and 9).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..fem import assembly as fem
from ..fem.quad import plane_stress_tables
from ..ops.autodiff import EigProblem, EighGenConfig, eigh_gen
from ..ops.operators import ElementOperator
from ..ops.stencil import GridStencilOperator


class TopologyAnalysis:
    """Plane-stress natural-frequency analysis K(x) phi = lam M(x) phi."""

    def __init__(self, fltr, conn, X, node_sets=None, element_sets=None,
                 E=1.0, nu=0.3, ptype_K="simp", ptype_M="simp", rho0_K=1e-6,
                 rho0_M=1e-9, p=3.0, q=5.0, density=1.0, sigma=-10.0, N=10,
                 m=None, rtol=1e-10, eig_atol=1e-5, adjoint_method="sibk",
                 adjoint_options=None, factor_kind="mg", grid_shape=None,
                 lanczos_tol=None, lanczos_block=1, lanczos_ortho="full",
                 lanczos_check_every=1, uniform_grid=True,
                 factor_options=None, lanczos_polish=0,
                 lanczos_polish_spare=0, lanczos_sweep="exact",
                 kernel_mv="auto", device="cuda"):
        if factor_kind != "mg" or grid_shape is None:
            raise NotImplementedError(
                f"factor_kind={factor_kind!r}: only the multigrid factor on "
                "a grid is ported (ROADMAP queue 1, item 4 lists the dense "
                "and block factors)")
        if not uniform_grid:
            raise NotImplementedError(
                "only the uniform-grid assembly is ported")
        self.device = torch.device(device)
        self.fltr = fltr
        # np.array copies: torch.as_tensor warns on read-only arrays
        self.conn = torch.as_tensor(np.array(conn), dtype=torch.int64,
                                    device=self.device)
        self.X = torch.as_tensor(np.array(X), dtype=torch.float64,
                                 device=self.device)
        self.node_sets = node_sets or {}
        self.element_sets = element_sets or {}
        self.nelems = int(self.conn.shape[0])
        self.nnodes = int(np.asarray(conn).max()) + 1
        self.nvars = 2 * self.nnodes
        self.N = N
        self.sigma = sigma
        self.eig_atol = eig_atol
        adjoint_options = adjoint_options or {}

        if m is None:
            m = max(3 * N + 1, 60)
        if lanczos_block > 1:
            # block Krylov convergence follows the degree m/block, relaxed
            # by spare block columns and polish steps (see the JAX model)
            q_deg = m // lanczos_block
            q_eff = (q_deg + max(0, lanczos_block - N)
                     + int(lanczos_polish or 0))
            if q_eff < 2 * N + 6:
                warnings.warn(
                    f"m={m} with lanczos_block={lanczos_block} gives only "
                    f"q={q_deg} block steps (effective degree {q_eff}) for "
                    f"N={N} modes; expect non-convergence below ~ 2N+6.")
        self.m = m

        self.E = E
        self.nu = nu
        self.ptype_K = ptype_K.lower()
        ptype_M = ptype_M.lower()
        self.ptype_M = "linear" if ptype_M == "simp" else ptype_M
        self.rho0_K = rho0_K
        self.rho0_M = rho0_M
        self.p = p
        self.q = q
        self.density = density

        self.C0 = fem.plane_stress_C0(E, nu, device=self.device)
        self.dofs = fem.element_dof_map(self.conn)
        # uniform grid: every element has the tables of element 0
        Be, He, detJ = plane_stress_tables(self.X, self.conn[:1])
        self.Be, self.He, self.detJ = Be[:, 0], He[:, 0], detJ[:, 0]

        self.cfg = EighGenConfig(
            N=N, m=self.m, sigma=sigma, mode="normal",
            adjoint_method=adjoint_method,
            adjoint_maxiter=adjoint_options.get("maxiter", 60),
            adjoint_rtol=rtol * 1e-2,
            nrestart=adjoint_options.get("nrestart", 2), eig_atol=eig_atol,
            lanczos_tol=lanczos_tol, block=lanczos_block,
            lanczos_ortho=lanczos_ortho,
            lanczos_check_every=lanczos_check_every,
            adjoint_mixed=adjoint_options.get("mixed", False),
            adjoint_ladder=adjoint_options.get("ladder", "approx"),
            polish=lanczos_polish, polish_spare=lanczos_polish_spare,
            lanczos_sweep=lanczos_sweep, kernel_mv=kernel_mv)
        self.grid_shape = tuple(grid_shape)
        mg_opts = dict(factor_options or {})

        def factor_fn(A, B, sig, mode):
            from ..ops.multigrid import GridMGFactor

            return GridMGFactor.build(A.W - sig * B.W, self.grid_shape, 2,
                                      **mg_opts)

        self.problem = EigProblem(assemble=self._assemble,
                                  nullspace=self._nullspace,
                                  factor=factor_fn)
        self.x = 0.95 * torch.ones(self.fltr.num_design_vars,
                                   dtype=torch.float64, device=self.device)

    # ------------------------------------------------------------------
    # Differentiable core
    # ------------------------------------------------------------------

    def element_matrices(self):
        """The reference element stiffness and mass matrices (8, 8)."""
        Ke0 = torch.einsum("qij,ik,qkl,q->jl", self.Be, self.C0, self.Be,
                           self.detJ)
        Me0 = torch.einsum("qij,qil,q->jl", self.He, self.He, self.detJ)
        return Ke0, Me0

    def _assemble(self, rhoE):
        """rhoE -> (K, M) grid stencil operators (differentiable)."""
        Ke0, Me0 = self.element_matrices()
        c = fem.stiffness_interp(rhoE, ptype=self.ptype_K, p=self.p,
                                 q=self.q, rho0=self.rho0_K)
        dens = fem.mass_interp(rhoE, ptype=self.ptype_M, q=self.q,
                               rho0=self.rho0_M, density=self.density)
        K = ElementOperator(c[:, None, None] * Ke0[None], self.dofs,
                            self.nvars)
        M = ElementOperator(dens[:, None, None] * Me0[None], self.dofs,
                            self.nvars)
        K = GridStencilOperator.from_element_operator(K, self.grid_shape,
                                                      ndof=2)
        M = GridStencilOperator.from_element_operator(M, self.grid_shape,
                                                      ndof=2)
        return K, M

    def _nullspace(self, rhoE):
        """Rigid-body modes: two translations + the linearized rotation."""
        del rhoE
        U = torch.zeros((3, self.nvars), dtype=torch.float64,
                        device=self.device)
        U[0, 0::2] = 1.0
        U[1, 1::2] = 1.0
        U[2, 0::2] = -self.X[:, 1]
        U[2, 1::2] = self.X[:, 0]
        return U

    def _solve_fn(self, x):
        """x (design vars) -> (lam, Phi, rho, rhoE); rigid modes deflated."""
        rho = self.fltr.apply(x)
        rhoE = fem.element_density(rho, self.conn)
        lam, Phi = eigh_gen(rhoE, self.problem, self.cfg)
        return lam, Phi, rho, rhoE


def make_model(nx=128, ny=64, Lx=1.0, Ly=1.0, rfact=4.0, N=10, Mx=3, My=3,
               ns=2, device="cuda", **kwargs):
    """Symmetric optimization model factory (the JAX ``make_model``)."""
    from ..fem.filter import NodeFilter
    from ..fem.model import make_grid, make_symmetric_dvmap_with_sets

    mesh = make_grid(nx, ny, Lx, Ly)
    r0 = rfact * (Ly / ny)
    dvmap, ndv, node_sets, element_sets = make_symmetric_dvmap_with_sets(
        mesh, Mx=Mx, My=My, ns=ns, rfact=rfact)
    ftype = kwargs.pop("ftype", "conv")
    fltr = NodeFilter(mesh.conn, mesh.X, r0=r0, dvmap=dvmap,
                      num_design_vars=ndv, ftype=ftype, grid_shape=(nx, ny),
                      projection=kwargs.pop("projection", False),
                      beta=kwargs.pop("b0", 10.0), device=device)
    kwargs.setdefault("grid_shape", (nx, ny))
    kwargs.setdefault("uniform_grid", True)
    return TopologyAnalysis(fltr, mesh.conn, mesh.X, N=N,
                            node_sets=node_sets, element_sets=element_sets,
                            device=device, **kwargs)
