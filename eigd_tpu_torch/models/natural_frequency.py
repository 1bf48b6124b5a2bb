"""Natural-frequency topology analysis.

Counterpart of ``eigd_tpu/models/natural_frequency.py``: the chain
x -> filter -> element densities -> (K, M) -> shift-invert Lanczos ->
(lam, Phi) is one differentiable function whose eigensolve carries the
adjoint backward pass (``ops.autodiff.eigh_gen``). The structure is
free-free: the three rigid modes are deflated out of the Krylov iteration.
The factor is the multigrid one on a grid (``factor_kind="mg"``) or the
dense Cholesky one (``"dense"``); the assembly is the uniform-grid one
(one reference element) or the general per-element one.

The reference's three-phase adjoint protocol (``initialize``,
``initialize_adjoint``, ``finalize_adjoint``) holds the autograd graph of
``_solve_fn(x)`` where JAX holds its ``jax.vjp`` closure, and pulls the
accumulated (lamb, Qb) seeds through it with ``torch.autograd.grad``.
``MinFreqOpt`` is the reference's KS-aggregated minimum frequency with
point masses. The block factors (``factor_kind`` "blocktridiag", "bcr" and
their "_f32" forms, ``block_factor_fn``) are shared with the thermal
model. ``save_state``/``restore_state`` checkpoint the loop's state.
"""

from __future__ import annotations

import time
import warnings
import weakref

import numpy as np
import torch

from ..fem import assembly as fem
from ..fem.quad import plane_stress_tables
from ..ops import adjoint as adj
from ..ops.autodiff import EigProblem, EighGenConfig, _kernel_ops, eigh_gen
from ..ops.factor import make_shift_factor
from ..ops.lanczos import b_orthonormalize_rows, lanczos_solve
from ..ops.operators import ElementOperator
from ..ops.stencil import GridStencilOperator
from ..ops.sync import span


def weakly(method):
    """``method``, called through a weak reference to its object.

    A model's ``EigProblem`` goes into the autograd graph of every solve
    (``EighGen`` keeps it on its ctx), and the model holds the graph of
    its last solve for ``finalize_adjoint``. Strongly bound methods would
    close a cycle through the autograd node, which Python's gc cannot
    see, and the model and its solve would never be freed."""
    ref = weakref.WeakMethod(method)

    def call(*args):
        fn = ref()
        if fn is None:
            raise ReferenceError("the model of this solve has been freed")
        return fn(*args)

    return call


BLOCK_FACTOR_KINDS = ("blocktridiag", "blocktridiag_f32", "bcr", "bcr_f32")


def block_factor_fn(kind, grid_shape, ndof, refine_options=None):
    """The ``EigProblem.factor`` of a block factor kind on a grid: the
    block Cholesky (``blocktridiag``) or cyclic-reduction (``bcr``) factor
    of the shifted element matrices, in f64; or, for the "_f32" kinds,
    built from f32 blocks (the f64 blocks are the peak-memory term at 1M
    DOF) and refined to f64 by a ``RefinedFactor`` (``refine_options``:
    its tol, max_refine) against the shifted f64 stencil, which runs on K2
    when the operators carry the kernels' planes."""
    from ..ops.blockfactor import (BCRFactor, BlockTridiagFactor,
                                   RefinedFactor, grid_block_tridiag)
    from ..ops.stencil import stencil_from_elements

    gnx, gny = grid_shape
    cls_ = BCRFactor if kind.startswith("bcr") else BlockTridiagFactor

    def factor_fn(A, B, sig, mode):
        shifted = A.mats - sig * B.mats
        if not kind.endswith("_f32"):
            return cls_.from_blocks(*grid_block_tridiag(shifted, gnx, gny,
                                                        ndof=ndof))
        inner = cls_.from_blocks(*grid_block_tridiag(
            shifted.to(torch.float32), gnx, gny, ndof=ndof))
        op = GridStencilOperator(shifted, A.dofs, A.n,
                                 stencil_from_elements(shifted, gnx, gny,
                                                       ndof),
                                 grid_shape, ndof)
        if getattr(A, "Wp64", None) is not None:
            op = op.with_kernels()
        return RefinedFactor(inner, op, **(refine_options or {}))

    return factor_fn


class TopologyAnalysis:
    """Plane-stress natural-frequency analysis K(x) phi = lam M(x) phi."""

    def __init__(self, fltr, conn, X, node_sets=None, element_sets=None,
                 E=1.0, nu=0.3, ptype_K="simp", ptype_M="simp", rho0_K=1e-6,
                 rho0_M=1e-9, p=3.0, q=5.0, density=1.0, sigma=-10.0, N=10,
                 m=None, rtol=1e-10, eig_atol=1e-5, adjoint_method="sibk",
                 adjoint_options=None, factor_kind="dense", grid_shape=None,
                 lanczos_tol=None, lanczos_block=1, lanczos_ortho="full",
                 lanczos_check_every=1, uniform_grid=False,
                 factor_options=None, lanczos_polish=0,
                 lanczos_polish_spare=0, lanczos_sweep="exact",
                 kernel_mv="auto", device="cuda"):
        if factor_kind not in ("mg", "dense") + BLOCK_FACTOR_KINDS:
            raise ValueError(f"Unknown factor_kind {factor_kind!r}")
        if factor_kind != "dense" and grid_shape is None:
            raise ValueError(f"factor_kind={factor_kind!r} needs grid_shape")
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
        self.Be, self.He, self.detJ = plane_stress_tables(self.X, self.conn)
        # uniform grid: every element has the tables of element 0
        self._uniform = bool(uniform_grid)
        if self._uniform:
            self.Be = self.Be[:, :1]
            self.He = self.He[:, :1]
            self.detJ = self.detJ[:, :1]

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
        self.grid_shape = (tuple(grid_shape) if grid_shape is not None
                           else None)
        factor_fn = None  # dense: make_shift_factor's Cholesky factor
        if factor_kind == "mg":
            mg_opts = dict(factor_options or {})
            grid = self.grid_shape

            def factor_fn(A, B, sig, mode):
                from ..ops.multigrid import GridMGFactor

                return GridMGFactor.build(A.W - sig * B.W, grid, 2, **mg_opts)
        elif factor_kind in BLOCK_FACTOR_KINDS:
            factor_fn = block_factor_fn(factor_kind, self.grid_shape, 2,
                                        factor_options)

        self.problem = EigProblem(assemble=weakly(self._assemble),
                                  nullspace=weakly(self._nullspace),
                                  factor=factor_fn)
        self.x = 0.95 * torch.ones(self.fltr.num_design_vars,
                                   dtype=torch.float64, device=self.device)
        self.Q = None
        self.lam = None
        self._graph = None
        self.profile = self._init_profile()

    # ------------------------------------------------------------------
    # Differentiable core
    # ------------------------------------------------------------------

    def element_matrices(self):
        """The uniform grid's reference element stiffness and mass matrices
        (8, 8)."""
        Be, He, detJ = self.Be[:, 0], self.He[:, 0], self.detJ[:, 0]
        Ke0 = torch.einsum("qij,ik,qkl,q->jl", Be, self.C0, Be, detJ)
        Me0 = torch.einsum("qij,qil,q->jl", He, He, detJ)
        return Ke0, Me0

    def _assemble(self, rhoE):
        """rhoE -> (K, M) operators (differentiable): grid stencils when
        the mesh is a grid, element operators otherwise."""
        if self._uniform:
            Ke0, Me0 = self.element_matrices()
            c = fem.stiffness_interp(rhoE, ptype=self.ptype_K, p=self.p,
                                     q=self.q, rho0=self.rho0_K)
            dens = fem.mass_interp(rhoE, ptype=self.ptype_M, q=self.q,
                                   rho0=self.rho0_M, density=self.density)
            K = ElementOperator(c[:, None, None] * Ke0[None], self.dofs,
                                self.nvars)
            M = ElementOperator(dens[:, None, None] * Me0[None], self.dofs,
                                self.nvars)
        else:
            K = fem.stiffness_matrix(rhoE, self.Be, self.detJ, self.dofs,
                                     self.nvars, self.C0,
                                     ptype=self.ptype_K, p=self.p, q=self.q,
                                     rho0=self.rho0_K)
            M = fem.mass_matrix(rhoE, self.He, self.detJ, self.dofs,
                                self.nvars, ptype=self.ptype_M, q=self.q,
                                rho0=self.rho0_M, density=self.density)
        if self.grid_shape is not None:
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

    # ------------------------------------------------------------------
    # Three-phase adjoint protocol
    # ------------------------------------------------------------------

    def _elapsed(self, t0):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    @span("eigd.protocol.initialize")
    def initialize(self, store=False):
        """Solve at ``self.x`` and hold the autograd graph of the solve for
        ``finalize_adjoint``; eigenvector signs follow the previous solve.
        The previous graph is released first, so two never coexist."""
        t0 = time.perf_counter()
        self._graph = None
        x = self.x.detach().requires_grad_(True)
        with torch.enable_grad():
            lam, Q, rho, rhoE = self._solve_fn(x)
        self._graph = (x, lam, Q)
        self.lam, Q = lam.detach(), Q.detach()
        self.rho, self.rhoE = rho.detach(), rhoE.detach()
        if self.Q is not None and self.Q.shape == Q.shape:
            # the graph gives Q before the flip: the signs fold into the
            # seeds in finalize_adjoint
            flip = torch.sum(Q * self.Q, dim=0) < 0.0
            self._signs = 1.0 - 2.0 * flip.to(Q.dtype)
            Q = Q * self._signs[None, :]
        else:
            self._signs = torch.ones(Q.shape[1], dtype=Q.dtype,
                                     device=Q.device)
        self.Q = Q
        self.profile["eigenvalue solve time"] = self._elapsed(t0)
        # factor-apply budgets (upper bounds; add_check_adjoint_residual
        # records the counts of a run)
        self.profile["solve preconditioner count (max)"] = (
            self.m if self.cfg.block <= 1
            else -(-self.m // self.cfg.block))
        self.profile["adjoint preconditioner count (max)"] = (
            1 + self.cfg.nrestart * -(-self.cfg.adjoint_maxiter // self.N))
        self.profile["adjoint solution method"] = self.cfg.adjoint_method
        self.profile["natural frequencies"] = torch.sqrt(self.lam).tolist()
        if store:
            self.profile["eigenvalues"] = self.lam.tolist()

    def initialize_adjoint(self):
        self.xb = torch.zeros_like(self.x)
        self.lamb = torch.zeros_like(self.lam)
        self.Qb = torch.zeros_like(self.Q)

    # ------------------------------------------------------------------
    # Checkpoint / warm restart
    # ------------------------------------------------------------------

    def save_state(self, path):
        """Checkpoint the loop's state: the design x and the eigenpairs
        (lam, Q) of the last ``initialize``. Restored in a fresh process,
        the design comes back and Q becomes the previous iterate that the
        next ``initialize`` aligns the eigenvector signs against."""
        from ..utils.checkpoint import save_checkpoint

        return save_checkpoint(path, {"x": self.x, "lam": self.lam,
                                      "Q": self.Q})

    def restore_state(self, path):
        from ..utils.checkpoint import load_checkpoint

        like = {"x": self.x,
                "lam": self.x.new_zeros(self.N),
                "Q": self.x.new_zeros((self.nvars, self.N))}
        state = load_checkpoint(path, like)
        self.x, self.lam, self.Q = state["x"], state["lam"], state["Q"]
        return self

    @span("eigd.protocol.finalize_adjoint")
    def finalize_adjoint(self):
        """xb += the seeds (lamb, Qb) pulled through the graph that
        ``initialize`` holds. The graph is kept until the next
        ``initialize`` (as JAX keeps its ``_vjp`` closure), so any number
        of adjoint passes may follow one solve."""
        t0 = time.perf_counter()
        x, lam, Q = self._graph
        (xb,) = torch.autograd.grad(
            (lam, Q), x, (self.lamb, self.Qb * self._signs[None, :]),
            retain_graph=True)
        self.xb = self.xb + xb
        self.profile["adjoint solution time"] = self._elapsed(t0)

    # ------------------------------------------------------------------
    # Functions of the solution + seed accumulation
    # ------------------------------------------------------------------

    def get_frequencies(self):
        return torch.sqrt(self.lam)

    def add_frequency_derivatives(self, omegab):
        omegab = torch.as_tensor(omegab, dtype=self.lam.dtype,
                                 device=self.device)
        self.lamb = self.lamb + 0.5 * omegab / torch.sqrt(self.lam)

    def _node_set(self, name):
        nodes = torch.as_tensor(np.asarray(self.node_sets[name]),
                                dtype=torch.int64, device=self.device)
        return nodes, 1.0 / len(nodes)

    def get_point_coefficients(self, name):
        """Mean modal displacement coefficients over a node set: x0 (3,)
        and xcoef (3, N)."""
        nodes, weight = self._node_set(name)
        zero = self.X.new_zeros(())
        x0 = torch.stack([weight * torch.sum(self.X[nodes, 0]),
                          weight * torch.sum(self.X[nodes, 1]), zero])
        xcoef = torch.stack([
            weight * torch.sum(self.Q[2 * nodes], dim=0),
            weight * torch.sum(self.Q[2 * nodes + 1], dim=0),
            self.Q.new_zeros(self.Q.shape[1])])
        return x0, xcoef

    def add_point_derivative(self, name, x0b, xcoefb):
        if xcoefb is None:
            return
        nodes, weight = self._node_set(name)
        k = nodes.shape[0]
        self.Qb = self.Qb.index_add(
            0, 2 * nodes, (weight * xcoefb[0])[None, :].expand(k, -1))
        self.Qb = self.Qb.index_add(
            0, 2 * nodes + 1, (weight * xcoefb[1])[None, :].expand(k, -1))

    def eval_area(self):
        return torch.sum(self.detJ * self.rhoE[None, :])

    def eval_area_gradient(self):
        with torch.enable_grad():
            x = self.x.detach().requires_grad_(True)
            rhoE = fem.element_density(self.fltr.apply(x), self.conn)
            (g,) = torch.autograd.grad(
                torch.sum(self.detJ * rhoE[None, :]), x)
        return g

    def add_check_adjoint_residual(self, b_ortho=True):
        """Diagnostics: solve again at the current design (single-vector
        Lanczos with the rigid modes deflated, then LAA + non-mixed SIBK on
        the accumulated Qb) and record each mode's adjoint residual and
        orthogonality, the iteration counts and, for an iterative factor,
        its inner iterations on one probe apply. Returns the residuals."""
        with torch.no_grad():
            rhoE = fem.element_density(self.fltr.apply(self.x), self.conn)
            A, B = _kernel_ops(*self._assemble(rhoE), self.cfg)
            if self.problem.factor is not None:
                factor = self.problem.factor(A, B, self.sigma, "normal")
            else:
                factor = make_shift_factor(A, B, self.sigma)
            deflate = b_orthonormalize_rows(self._nullspace(rhoE), B.mv)
            res = lanczos_solve(A, B, factor, self.sigma, self.cfg.N, self.m,
                                deflate=deflate, seed=self.cfg.seed)
            Phib = self.Qb * self._signs[None, :]
            psi0 = adj.laa(Phib, B, factor, res, b_ortho=True)
            psi, _, info = adj.sibk(
                Phib, A, B, res.lam, res.Phi, psi=psi0, sigma=self.sigma,
                factor=factor, rtol=self.cfg.adjoint_rtol,
                eig_atol=self.eig_atol, maxiter=self.cfg.adjoint_maxiter,
                nrestart=self.cfg.nrestart)
            r, o = adj.eval_adjoint_residual_norm(A, B, res.lam, res.Phi,
                                                  Phib, psi, b_ortho=b_ortho)
            for i, (ri, oi, li) in enumerate(zip(r.tolist(), o.tolist(),
                                                 res.lam.tolist())):
                self.profile[f"adjoint norm[{i:2d}]"] = ri
                self.profile[f"adjoint ortho[{i:2d}]"] = oi
                self.profile[f"adjoint lam[{i:2d}]"] = li
            self.profile["adjoint residuals"] = info["res"].tolist()
            self.profile["adjoint residual history"] = info["hist"].tolist()
            self.profile["adjoint iterations"] = int(info["niter"])
            self.profile["eigensolve iterations"] = int(res.niter)
            self.profile["eigensolve residuals"] = res.eig_res.tolist()
            if hasattr(factor, "mv_info"):
                _, finfo = factor.mv_info(B.mv(res.Phi[:, :1]))
                self.profile["factor apply iterations"] = int(finfo["niter"])
                self.profile["factor apply final res2"] = float(
                    torch.max(finfo["res2"]))
                self.profile["factor apply tol2"] = float(
                    torch.max(finfo["tol2"]))
        return r

    def _init_profile(self):
        return {"nnodes": self.nnodes, "nelems": self.nelems, "N": self.N,
                "E": self.E, "nu": self.nu, "density": self.density,
                "p": self.p, "eig_atol": self.eig_atol, "sigma": self.sigma,
                "m": self.m}


class MinFreqOpt:
    """KS-aggregated minimum natural frequency of the structure with
    parasitic point masses; its seeds come from ``torch.autograd``."""

    def __init__(self, topo: TopologyAnalysis, ks_param=1.0, fixed_mass=1.0):
        self.topo = topo
        self.ks_param = ks_param
        self.fixed_mass = fixed_mass
        self.node_sets = topo.node_sets

    def _eval_min_frequency(self, omega, coefs):
        """KS-min over the node sets' reduced problems: for each set
        K0 = diag(omega^2), M0 = I + fixed_mass c0^T c0, a KS-min over its
        frequencies; then a KS-min over the sets (differentiable)."""
        ks = self.ks_param
        N = omega.shape[0]
        eye = torch.eye(N, dtype=omega.dtype, device=omega.device)
        vals = []
        for name in sorted(coefs):
            c0 = coefs[name]
            L = torch.linalg.cholesky(eye + self.fixed_mass * c0.T @ c0)
            C = torch.linalg.solve_triangular(L, torch.diag(omega**2),
                                              upper=False)
            C = torch.linalg.solve_triangular(L, C.T, upper=False)
            omega0 = torch.sqrt(torch.linalg.eigvalsh(0.5 * (C + C.T)))
            low = torch.min(omega0)
            vals.append(low - torch.log(torch.sum(
                torch.exp(-ks * (omega0 - low)))) / ks)
        vals = torch.stack(vals)
        low = torch.min(vals)
        return low - torch.log(torch.sum(torch.exp(-ks * (vals - low)))) / ks

    @span("eigd.protocol.initialize")
    def initialize(self, store=False):
        self.topo.initialize(store)
        self.omega = self.topo.get_frequencies()
        self.coef = {name: self.topo.get_point_coefficients(name)[1]
                     for name in self.node_sets}
        names = sorted(self.coef)
        with torch.enable_grad():
            om = self.omega.detach().requires_grad_(True)
            cf = {k: self.coef[k].detach().requires_grad_(True)
                  for k in names}
            ks = self._eval_min_frequency(om, cf)
            grads = torch.autograd.grad(ks, [om] + [cf[k] for k in names])
        self.ks_min = ks.detach()
        self.omegab = grads[0]
        self.coefb = dict(zip(names, grads[1:]))

    def initialize_adjoint(self):
        self.topo.initialize_adjoint()

    @span("eigd.protocol.finalize_adjoint")
    def finalize_adjoint(self):
        self.topo.add_frequency_derivatives(self.omegab)
        for name in self.node_sets:
            self.topo.add_point_derivative(name, None, self.coefb[name])
        self.topo.finalize_adjoint()

    def get_min_frequency(self):
        return self.ks_min

    def test_ks_func(self, dh_fd=1e-6, pert=None):
        """The reference's FD check of the KS gradient along ``pert``
        (default: numpy's global uniform draw)."""
        self.initialize(store=True)
        x0 = self.topo.x.clone()

        self.initialize_adjoint()
        self.finalize_adjoint()
        self.topo.add_check_adjoint_residual(b_ortho=True)

        if pert is None:
            pert = np.random.uniform(size=tuple(x0.shape))
        pert = torch.as_tensor(pert, dtype=x0.dtype, device=x0.device)

        data = {"ans": float(pert @ self.topo.xb)}
        data.update({k: v for k, v in self.topo.profile.items()
                     if isinstance(v, (int, float, str))})

        self.topo.x = x0 + dh_fd * pert
        self.initialize()
        ks2 = float(self.get_min_frequency())
        self.topo.x = x0 - dh_fd * pert
        self.initialize()
        ks3 = float(self.get_min_frequency())
        self.topo.x = x0

        data["dh_fd"] = dh_fd
        data["fd"] = (ks2 - ks3) / (2 * dh_fd)
        data["fd_err"] = abs((data["ans"] - data["fd"]) / data["fd"])
        print("%25s  %25s  %25s" % ("Answer", "FD", "FD Rel Error"))
        print("%25.15e  %25.15e  %25.15e" % (data["ans"], data["fd"],
                                             data["fd_err"]))
        return data


def make_model(nx=128, ny=64, Lx=1.0, Ly=1.0, rfact=4.0, N=10, Mx=3, My=3,
               ns=2, device="cuda", **kwargs):
    """Symmetric optimization model factory (the JAX ``make_model``): a
    uniform grid with a ``conv`` filter (``ftype="spatial"`` or
    ``"helmholtz"`` for the general ones) and the dense factor unless
    ``factor_kind`` says otherwise."""
    from ..fem.filter import NodeFilter
    from ..fem.model import make_grid, make_symmetric_dvmap_with_sets

    mesh = make_grid(nx, ny, Lx, Ly)
    r0 = rfact * (Ly / ny)
    dvmap, ndv, node_sets, element_sets = make_symmetric_dvmap_with_sets(
        mesh, Mx=Mx, My=My, ns=ns, rfact=rfact)
    fltr = NodeFilter(mesh.conn, mesh.X, r0=r0, dvmap=dvmap,
                      num_design_vars=ndv, ftype=kwargs.pop("ftype", "conv"),
                      grid_shape=(nx, ny),
                      projection=kwargs.pop("projection", False),
                      beta=kwargs.pop("b0", 10.0), device=device)
    kwargs.setdefault("grid_shape", (nx, ny))
    kwargs.setdefault("uniform_grid", True)
    return TopologyAnalysis(fltr, mesh.conn, mesh.X, N=N,
                            node_sets=node_sets, element_sets=element_sets,
                            device=device, **kwargs)
