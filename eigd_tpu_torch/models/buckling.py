"""Linearized buckling topology analysis.

Counterpart of ``eigd_tpu/models/buckling.py``: a plane-stress column
clamped on one edge, the static preload K(x) u = f, the geometric (stress)
stiffness G(x, u) and the buckling eigenproblem K phi + lam G phi = 0
(lam the load factors), solved in ``mode="buckling"`` with the factor
(K + sigma G)^{-1}; KS aggregates of 1/BLF, eigenvector aggregates and the
KS-of-KS aggregate max. The chain x -> rho -> (K, u, G) -> eigensolve is
one differentiable function whose ``eigh_gen`` parameter is the tuple
(rhoE, u); the path adjoint through the static solve is ``solve_spd``'s
rule, and the dG/du chain is autograd through the stress stiffness.

Two factorization paths:

* dense (factor_kind "cholesky"/"eigh"): matrices reduced to the free DOFs
  with an index gather; the static solve is ``torch.linalg.cholesky`` and
  two triangular solves, which autograd differentiates.
* masked (factor_kind "bcr"/"blocktridiag" and their "_f32" forms):
  full-space grid stencils with the Dirichlet DOFs masked (zero rows and
  columns, a unit diagonal on K), so every matvec is a stencil (K2 on the
  card) and both the static solve and the shift factor are block factors
  of the masked element matrices. The masked subspace is invariant under
  every solver map and the start vector is zero there, so the Krylov
  iteration never leaves the free DOFs.

The three-phase protocol holds the autograd graph of ``_solve_fn(x)``
where JAX holds its ``jax.vjp`` closure, until the next ``initialize``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..fem import assembly as fem
from ..fem.quad import stress_stiffness_tables
from ..ops.autodiff import (EigProblem, EighGenConfig, eigh_gen, kernels_on,
                            solve_spd)
from ..ops.operators import DenseOperator, ElementOperator
from ..ops.stencil import GridStencilOperator
from ..ops.sync import host_bool, host_flags, span
from .natural_frequency import weakly

SCALABLE_KINDS = ("bcr_f32", "bcr", "blocktridiag", "blocktridiag_f32")
# the shift's cut when the shifted factor is found indefinite, and the
# most cuts a solve makes (then the factor's failure is not the shift's);
# the range of sigma / BLF_1 a solve leaves alone, and where the shift
# goes from outside it (examples/buckling.py's 0.8 BLF_1)
SHIFT_BACKOFF = 0.5
SHIFT_CUTS = 30
SHIFT_BAND = (0.6, 0.95)
SHIFT_MARGIN = 0.8


class ShiftAboveFirstLoad(ArithmeticError):
    """K + sigma G is not positive definite: the shift lies above the first
    load factor, where the buckling mode's spectral map does not hold."""


def _held(fac):
    """Whether a block factor of an SPD matrix held (a 0-d bool tensor). A
    block whose Schur complement is not SPD turns NaN (``_cholesky``), and
    every later level depends on it, so the last level's blocks show it."""
    fac = getattr(fac, "inner", fac)  # RefinedFactor's f32 factor
    last = fac.last_Dinv if hasattr(fac, "last_Dinv") else fac.Linv[-1]
    return torch.isfinite(last).all()


def _chol_solve(L, b):
    y = torch.linalg.solve_triangular(L, b[:, None], upper=False)
    return torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]


class BucklingTopologyAnalysis:
    """Plane-stress linearized buckling analysis."""

    def __init__(self, fltr, conn, X, free_dofs, forces, E=1.0, nu=0.3,
                 ptype_K="simp", ptype_G="simp", rho0_K=1e-6, rho0_G=1e-9,
                 p=3.0, q=5.0, sigma=3.0, N=10, m=None, Ntarget=None,
                 solver_type="lanczos", tol=0.0, rtol=1e-10, eig_atol=1e-5,
                 adjoint_method="sibk", adjoint_options=None,
                 deriv_type="tensor", factor_kind="cholesky",
                 grid_shape=None, lanczos_tol=None, lanczos_polish=0,
                 kernel_mv="auto", device="cuda"):
        del solver_type, tol, deriv_type  # JAX's signature; unused there
        self.device = torch.device(device)
        self.fltr = fltr
        conn_np = np.array(conn)
        self.conn = torch.as_tensor(conn_np, dtype=torch.int64,
                                    device=self.device)
        self.X = torch.as_tensor(np.array(X), dtype=torch.float64,
                                 device=self.device)
        self.free = torch.as_tensor(np.array(free_dofs), dtype=torch.int64,
                                    device=self.device)
        self.nelems = int(conn_np.shape[0])
        self.nnodes = int(conn_np.max()) + 1
        self.nvars = 2 * self.nnodes
        self.f = torch.as_tensor(np.array(forces), dtype=torch.float64,
                                 device=self.device)
        if Ntarget is not None:
            N = max(N, Ntarget + 1)  # one extra mode to detect clustering
        self.N = N
        self.Ntarget = Ntarget
        self.sigma = sigma
        self.eig_atol = eig_atol
        self._adjoint_options = adjoint_options or {}
        if m is None:
            m = max(3 * max(N, Ntarget or 0) + 1, 60)
        self.m = m
        self._rtol = rtol
        self._lanczos_tol = lanczos_tol
        self._lanczos_polish = lanczos_polish
        self._adjoint_method = adjoint_method
        self._kernel_mv = kernel_mv

        self.E, self.nu = E, nu
        self.ptype_K = ptype_K.lower()
        self.ptype_G = ptype_G.lower()
        self.rho0_K, self.rho0_G = rho0_K, rho0_G
        self.p, self.q = p, q

        self.C0 = fem.plane_stress_C0(E, nu, device=self.device)
        self.dofs = fem.element_dof_map(self.conn)
        self.Be, self.Te, self.detJ = stress_stiffness_tables(self.X,
                                                              self.conn)

        self.factor_kind = factor_kind
        self.scalable = factor_kind in SCALABLE_KINDS
        if not self.scalable and factor_kind not in ("cholesky", "eigh"):
            raise ValueError(f"Unknown factor_kind {factor_kind!r}")
        self.grid_shape = tuple(grid_shape) if grid_shape is not None else None
        if self.scalable and self.grid_shape is None:
            raise ValueError(f"factor_kind={factor_kind!r} needs grid_shape")

        self.free_mask = torch.zeros(self.nvars, dtype=torch.float64,
                                     device=self.device)
        self.free_mask[self.free] = 1.0
        self.fixed_mask = 1.0 - self.free_mask
        # the solve's graph holds these; bound weakly, the graph that the
        # model holds makes no cycle (natural_frequency.weakly)
        self._op_K_w = weakly(self._op_K)
        self._K_factor_w = weakly(self._K_factor)

        self._build_cfg()

        self.x = 0.5 * torch.ones(self.fltr.num_design_vars,
                                  dtype=torch.float64, device=self.device)
        self.lam = None
        self.Q = None
        self._graph = None
        self.profile = {"nnodes": self.nnodes, "nelems": self.nelems,
                        "N": N, "sigma": sigma, "m": self.m,
                        "factor_kind": factor_kind}

    def _build_cfg(self):
        opts = self._adjoint_options
        self.cfg = EighGenConfig(
            N=self.N, m=self.m, sigma=self.sigma, mode="buckling",
            adjoint_method=self._adjoint_method,
            adjoint_maxiter=opts.get("maxiter", 60),
            adjoint_rtol=self._rtol * 1e-2,
            nrestart=opts.get("nrestart", 2), eig_atol=self.eig_atol,
            factor_kind=(self.factor_kind if not self.scalable
                         else "cholesky"),
            lanczos_tol=self._lanczos_tol, polish=self._lanczos_polish,
            kernel_mv=self._kernel_mv)
        if self.scalable:
            self.problem = EigProblem(assemble=weakly(self._assemble_pencil),
                                      factor=weakly(self._pencil_factor),
                                      v0=weakly(self._v0))
        else:
            self.problem = EigProblem(assemble=weakly(self._assemble_pencil))

    # -- differentiable pieces ---------------------------------------------

    def _mask_mats(self, mats):
        me = self.free_mask[self.dofs]  # (nelems, 8)
        return mats * me[:, :, None] * me[:, None, :]

    def _K_mats(self, rhoE):
        return fem.stiffness_matrix(rhoE, self.Be, self.detJ, self.dofs,
                                    self.nvars, self.C0, ptype=self.ptype_K,
                                    p=self.p, q=self.q, rho0=self.rho0_K)

    def _G_mats(self, rhoE, u_full):
        return fem.stress_stiffness_matrix(
            rhoE, u_full, self.Be, self.Te, self.detJ, self.dofs, self.conn,
            self.nvars, self.C0, ptype=self.ptype_G, p=self.p, q=self.q,
            rho0=self.rho0_G)

    # dense-reduced path -----------------------------------------------------

    def _reduce(self, dense):
        return dense[self.free[:, None], self.free[None, :]]

    def _stiffness_dense_reduced(self, rhoE):
        return self._reduce(self._K_mats(rhoE).to_dense())

    def _stress_stiffness_dense_reduced(self, rhoE, u_full):
        return self._reduce(self._G_mats(rhoE, u_full).to_dense())

    # masked path ------------------------------------------------------------

    def _op_K(self, rhoE):
        """Masked full-space stiffness as a grid stencil with a unit
        diagonal on the fixed DOFs."""
        Km = self._mask_mats(self._K_mats(rhoE).mats)
        return GridStencilOperator.from_element_operator(
            ElementOperator(Km, self.dofs, self.nvars), self.grid_shape,
            ndof=2, extra_diag=self.fixed_mask)

    def _op_G(self, rhoE, u_full):
        G = self._G_mats(rhoE, u_full * self.free_mask)
        Gm = self._mask_mats(G.mats)
        return GridStencilOperator.from_element_operator(
            ElementOperator(Gm, self.dofs, self.nvars), self.grid_shape,
            ndof=2)

    def _structured_factor(self, mats, extra_diag):
        """BCR / block-tridiagonal factor of masked element matrices plus a
        diagonal (a unit one on the fixed DOFs). The f64 BCR applies its
        level-0 couplings through their stencil; the "_f32" kinds refine
        the f32 factor in f64 against the stencil, on K2 on the card."""
        from ..ops.blockfactor import (BCRFactor, BlockTridiagFactor,
                                       RefinedFactor, grid_block_tridiag)

        gnx, gny = self.grid_shape
        b = 2 * (gny + 1)
        blocks = list(grid_block_tridiag(mats, gnx, gny, ndof=2))
        torch.diagonal(blocks[0], dim1=1, dim2=2).add_(
            extra_diag.reshape(gnx + 1, b))
        if self.factor_kind == "blocktridiag":
            return BlockTridiagFactor.from_owned_blocks(blocks)
        op = GridStencilOperator.from_element_operator(
            ElementOperator(mats, self.dofs, self.nvars), self.grid_shape,
            ndof=2, extra_diag=extra_diag)
        if self.factor_kind == "bcr":
            return BCRFactor.from_owned_blocks(blocks, coupling=op)
        cls_ = (BCRFactor if self.factor_kind.startswith("bcr")
                else BlockTridiagFactor)
        blocks[0] = blocks[0].to(torch.float32)
        blocks[1] = blocks[1].to(torch.float32)
        inner = cls_.from_owned_blocks(blocks)
        if kernels_on(self._kernel_mv, self.device):
            op = op.with_kernels()
        return RefinedFactor(inner, op)

    def _K_factor(self, rhoE):
        Km = self._mask_mats(self._K_mats(rhoE).mats)
        return self._structured_factor(Km, self.fixed_mask)

    def _pencil_factor(self, A, B, sig, mode):
        """(K + sigma G)^{-1} for the buckling pencil (A = G, B = K-hat).
        Raises ``ShiftAboveFirstLoad`` where the factor did not hold: the
        design has moved the first load factor below the shift (one host
        decision, ``HOST_SYNCS["buckling_shift"]``)."""
        assert mode == "buckling"
        fac = self._structured_factor(B.mats + sig * A.mats, B.extra_diag)
        if not host_bool(_held(fac), "buckling_shift"):
            raise ShiftAboveFirstLoad(f"K + {sig!r} G is not SPD")
        return fac

    def _v0(self, theta):
        """A uniform start vector on [-1, 1) from a seeded
        ``torch.Generator``, zero on the fixed DOFs (JAX draws its own
        from ``jax.random``: parity tests pass it as ``problem.v0``)."""
        g = torch.Generator().manual_seed(12345)
        v = 2.0 * torch.rand(self.nvars, generator=g,
                             dtype=torch.float64) - 1.0
        return v.to(self.device) * self.free_mask

    # -------------------------------------------------------------------

    def _assemble_pencil(self, theta):
        """eigh_gen parameter: theta = (rhoE, u). Returns (A, B) = (G, K)
        for the buckling pencil (reduced dense or masked full)."""
        rhoE, u = theta
        if self.scalable:
            return self._op_G(rhoE, u), self._op_K(rhoE)
        u_full = u.new_zeros(self.nvars).index_put((self.free,), u)
        Gr = self._stress_stiffness_dense_reduced(rhoE, u_full)
        Kr = self._stiffness_dense_reduced(rhoE)
        return DenseOperator(Gr), DenseOperator(Kr)

    def _static(self, rhoE):
        """The preload: (u, the loads it answers)."""
        if self.scalable:
            fm = self.f * self.free_mask
            return solve_spd(rhoE, fm, self._op_K_w, self._K_factor_w), fm
        L = torch.linalg.cholesky(self._stiffness_dense_reduced(rhoE))
        fr = self.f[self.free]
        return _chol_solve(L, fr), fr

    def _solve_fn(self, x):
        rhoE = fem.element_density(self.fltr.apply(x), self.conn)
        u, f = self._static(rhoE)
        lam, Q = eigh_gen((rhoE, u), self.problem, self.cfg)
        return lam, Q, f @ u

    # -- three-phase protocol ----------------------------------------------

    def _elapsed(self, t0):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    @span("eigd.protocol.initialize")
    def initialize(self, store=False):
        """Solve at ``self.x`` and hold the autograd graph of the solve for
        ``finalize_adjoint``, releasing the previous one first.

        The shift follows the first load factor BLF_1, which a closed
        design loop moves (``_solve_shifted``). The eigenpairs do not
        depend on the shift; ``solve_sigma`` is the held solve's, ``sigma``
        and ``profile["sigma"]`` the next solve's.

        With ``Ntarget`` set, the smallest N >= Ntarget whose load factors
        N and N+1 are distinct is picked, and the solve keeps N + 1 modes
        (the extra one shows the boundary): a window too small to show it
        grows by two and the solve runs again. JAX's rule
        (``eigd_tpu/models/buckling.py:277-291``) sets the window to N
        itself, which then has no mode past the boundary, widens it again,
        and recurses without end; the port keeps the extra mode."""
        t0 = time.perf_counter()
        self._graph = None
        x = self.x.detach().requires_grad_(True)
        lam, Qr, comp = self._solve_shifted(x)
        self._graph = (x, lam, Qr, comp)
        self.lam, self.Qr = lam.detach(), Qr.detach()
        self.compliance_val = comp.detach()
        self.BLF = self.lam
        self.Q = self._full_Q(self.Qr)
        self.profile["eigenvalue solve time"] = self._elapsed(t0)
        if store:
            self.profile["eigenvalues"] = self.BLF.tolist()

        if self.Ntarget is not None:
            lam_np = self.lam.cpu().numpy()
            N = self.Ntarget
            while (N < len(lam_np)
                   and abs(lam_np[N - 1] - lam_np[N]) < self.eig_atol):
                N += 1
            if N >= len(lam_np) and self.N < self.m - 1:
                # the cluster may extend past the solved window: widen
                self.N = min(self.N + 2, self.m - 1)
                self._build_cfg()
                return self.initialize(store=store)
            if N < len(lam_np) and N + 1 != self.N:
                self.N = N + 1
                self._build_cfg()
                return self.initialize(store=store)
        return None

    def _solve_shifted(self, x):
        """``_solve_fn(x)`` at a shift that suits the design's BLF_1.

        On the masked factor kinds a shift found above BLF_1
        (``ShiftAboveFirstLoad``) is cut by ``SHIFT_BACKOFF`` and the solve
        runs again, at most ``SHIFT_CUTS`` times. A solve whose sigma / BLF_1 ends outside
        ``SHIFT_BAND`` moves the shift to ``SHIFT_MARGIN`` BLF_1 (one
        counted host decision a solve, ``HOST_SYNCS["buckling_shift"]``):
        from below the band the solve runs again there, since the
        single-vector Lanczos at a fixed m converges the wanted pairs the
        worse the farther the shift lies below them; from above it the
        next solve takes the new shift."""
        cuts = 0
        while True:
            try:
                with torch.enable_grad():
                    out = self._solve_fn(x)
            except ShiftAboveFirstLoad:
                cuts += 1
                if cuts > SHIFT_CUTS:
                    raise
                self._shift(self.sigma * SHIFT_BACKOFF)
                continue
            self.solve_sigma = self.sigma
            ratio = self.sigma / out[0][0].detach()
            below, above = host_flags(torch.stack(
                [ratio < SHIFT_BAND[0], ratio > SHIFT_BAND[1]]),
                "buckling_shift")
            if below or above:
                self._shift(SHIFT_MARGIN * out[0][0].item())
            if not below:
                return out
            del out  # free this solve's factors before the next one

    def _shift(self, sigma):
        self.sigma = sigma
        self.profile["sigma"] = sigma
        self._build_cfg()

    def initialize_adjoint(self):
        self.xb = torch.zeros_like(self.x)
        self.lamb = torch.zeros_like(self.lam)
        self.Qrb = torch.zeros_like(self.Qr)
        self.complianceb = torch.zeros((), dtype=torch.float64,
                                       device=self.device)

    @span("eigd.protocol.finalize_adjoint")
    def finalize_adjoint(self):
        """xb += the seeds (lamb, Qrb, complianceb) pulled through the
        held graph, which stays for further passes until the next
        ``initialize``."""
        t0 = time.perf_counter()
        x, lam, Qr, comp = self._graph
        (xb,) = torch.autograd.grad(
            (lam, Qr, comp), x, (self.lamb, self.Qrb, self.complianceb),
            retain_graph=True)
        self.xb = self.xb + xb
        self.profile["adjoint solution time"] = self._elapsed(t0)

    # -- functions -----------------------------------------------------------

    def _grad(self, fn, *args):
        """The gradients of the scalar fn(*args) at detached copies."""
        with torch.enable_grad():
            leaves = [a.detach().requires_grad_(True) for a in args]
            return torch.autograd.grad(fn(*leaves), leaves)

    def _nodes(self, node):
        return torch.as_tensor(np.asarray(node), dtype=torch.int64,
                               device=self.device)

    def compliance(self):
        return self.compliance_val

    def compliance_derivative(self):
        """d(f^T u)/dx at ``self.x``, through the static solve only (the
        eigensolve does not enter the compliance)."""
        def comp(x):
            u, f = self._static(fem.element_density(self.fltr.apply(x),
                                                    self.conn))
            return f @ u

        return self._grad(comp, self.x)[0]

    @staticmethod
    def _ks(lam, ks_rho):
        mu = 1.0 / lam
        c = torch.max(mu)
        return c + torch.log(torch.sum(torch.exp(ks_rho * (mu - c)))) / ks_rho

    def eval_ks_buckling(self, ks_rho=160.0):
        return self._ks(self.BLF, ks_rho)

    def add_ks_buckling_derivative(self, ksb, ks_rho=160.0):
        (glam,) = self._grad(lambda lam: self._ks(lam, ks_rho), self.lam)
        self.lamb = self.lamb + ksb * glam

    def eval_ks_buckling_derivative(self, ks_rho=160.0):
        """The total derivative of the KS buckling aggregate."""
        self.initialize_adjoint()
        self.add_ks_buckling_derivative(1.0, ks_rho)
        self.finalize_adjoint()
        return self.xb

    # eigenvector aggregates -------------------------------------------------

    def _full_Q(self, Qr):
        if self.scalable:
            return Qr
        return Qr.new_zeros((self.nvars, Qr.shape[1])).index_put(
            (self.free,), Qr)

    @staticmethod
    def _eta(lam, rho_agg, mode, lam_b=50.0):
        if mode == "exp":
            eta = torch.exp(-rho_agg * (lam - torch.min(lam)))
        else:
            eta = (torch.tanh(rho_agg * (lam - 0.0))
                   - torch.tanh(rho_agg * (lam - lam_b)))
        return eta / torch.sum(eta)

    def _aggregate(self, lam, Qr, rho_agg, node, mode):
        Q = self._full_Q(Qr)
        eta = self._eta(lam, rho_agg, mode)
        return torch.sum(eta * torch.sum(Q[node, :] ** 2, dim=0))

    def _aggregate_max(self, lam, Qr, rho_agg, node):
        """KS-of-KS: per-DOF magnitude h = sum_i eta_i Q[node, i]^2, then
        the KS max over the node set with the same rho."""
        Q = self._full_Q(Qr)
        eta = self._eta(lam, rho_agg, "tanh", lam_b=1000.0)
        h = torch.sum(eta[None, :] * Q[node, :] ** 2, dim=1)
        c = torch.max(h)
        return c + torch.log(torch.sum(torch.exp(rho_agg * (h - c)))) / rho_agg

    def _add_seeds(self, hb, fn, *args):
        glam, gQr = self._grad(lambda lam, Qr: fn(lam, Qr, *args), self.lam,
                               self.Qr)
        self.lamb = self.lamb + hb * glam
        self.Qrb = self.Qrb + hb * gQr

    def get_eigenvector_aggregate(self, rho_agg, node, mode="tanh"):
        return self._aggregate(self.lam, self.Qr, rho_agg, self._nodes(node),
                               mode)

    def add_eigenvector_aggregate_derivative(self, hb, rho_agg, node,
                                             mode="tanh"):
        self._add_seeds(hb, self._aggregate, rho_agg, self._nodes(node), mode)

    def get_eigenvector_aggregate_max(self, rho_agg, node):
        return self._aggregate_max(self.lam, self.Qr, rho_agg,
                                   self._nodes(node))

    def add_eigenvector_aggregate_max_derivative(self, hb, rho_agg, node):
        self._add_seeds(hb, self._aggregate_max, rho_agg, self._nodes(node))

    def _area(self, x):
        rhoE = fem.element_density(self.fltr.apply(x), self.conn)
        return torch.sum(self.detJ * rhoE[None, :])

    def eval_area(self):
        return self._area(self.x)

    def eval_area_gradient(self):
        return self._grad(self._area, self.x)[0]


def first_blf(topo):
    """The first load factor of ``topo`` at its design, from the dense
    pencil reduced to the free DOFs: the pilot that places the shift
    (examples/buckling.py). For small models of any factor kind."""
    with torch.no_grad():
        rhoE = fem.element_density(topo.fltr.apply(topo.x), topo.conn)
        Kr = topo._stiffness_dense_reduced(rhoE)
        ur = torch.linalg.solve(Kr, topo.f[topo.free])
        u_full = ur.new_zeros(topo.nvars).index_put((topo.free,), ur)
        Gr = topo._stress_stiffness_dense_reduced(rhoE, u_full)
        # G phi = mu K phi; the load factors are -1/mu, the first at the
        # smallest mu
        L = torch.linalg.cholesky(Kr)
        C = torch.linalg.solve_triangular(L, Gr, upper=False)
        C = torch.linalg.solve_triangular(L, C.T, upper=False)
        mu = torch.linalg.eigvalsh(0.5 * (C + C.T))
    return float(-1.0 / mu[0])


def load_nodes(mesh, load_frac=0.2):
    """The right-edge nodes of the centred strip that carries the load."""
    ny = mesh.ny
    jmid = range(int(ny * (0.5 - load_frac / 2)),
                 int(ny * (0.5 + load_frac / 2)) + 1)
    return [int(mesh.nodes[-1, j]) for j in jmid]


def make_buckling_model(nx=32, ny=16, Lx=2.0, Ly=1.0, rfact=2.0, N=6,
                        load_frac=0.2, device="cuda", **kwargs):
    """A compressed column: clamped at the left edge, a compressive unit
    load in -x on a centred strip of the right edge, the spatial filter
    and JAX's defaults elsewhere; the masked factor kinds take the grid."""
    from ..fem.filter import NodeFilter
    from ..fem.model import cantilever_bcs, make_grid

    mesh = make_grid(nx, ny, Lx, Ly)
    r0 = rfact * (Ly / ny)
    free = cantilever_bcs(mesh, side="left")
    forces = np.zeros(2 * mesh.nnodes)
    nodes = load_nodes(mesh, load_frac)
    for nd in nodes:
        forces[2 * nd] = -1.0 / len(nodes)

    if str(kwargs.get("factor_kind", "")) in SCALABLE_KINDS:
        kwargs.setdefault("grid_shape", (nx, ny))
    fltr = NodeFilter(mesh.conn, mesh.X, r0=r0, device=device)
    return BucklingTopologyAnalysis(fltr, mesh.conn, mesh.X, free, forces,
                                    N=N, device=device, **kwargs)
