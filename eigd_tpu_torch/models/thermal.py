"""Thermal topology analysis: modal heat conduction and a transient
reduced-order model.

Counterpart of ``eigd_tpu/models/thermal.py``. A scalar field (1 DOF a
node) and the pure-Neumann conduction eigenproblem K(x) phi = lam M(x) phi,
whose mode 0 is the near-zero constant mode, skipped by every objective.
The factor is dense, multigrid on the scalar heat stencil (``"mg"``, K1/K2
at ndof 1 on the card) or one of the block factors (``"blocktridiag"``,
``"bcr"`` and their ``"_f32"`` forms). ``ThermalOpt`` integrates the modal
ODE xi' + lam xi = q(t) with the Crank-Nicolson rule as a Python loop of
small device ops (JAX's ``lax.scan``); its adjoint comes from autograd
through the loop, as JAX's comes from AD through the scan.

The three-phase protocol holds the autograd graph of ``_solve_fn(x)``
where JAX holds its ``jax.vjp`` closure, until the next ``initialize``.
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import numpy as np
import torch

from ..fem import assembly as fem
from ..fem.quad import thermal_tables
from ..ops.autodiff import EigProblem, EighGenConfig, eigh_gen
from ..ops.stencil import GridStencilOperator
from .natural_frequency import BLOCK_FACTOR_KINDS, block_factor_fn, weakly


def mean_vectors(conn, detJ, element_sets, nnodes):
    """The normalized set-average weights of each element set: node n of
    element e gains detJ[q, e] for every quadrature point q. One
    ``np.add.at`` over (element, point, node) in the order of the
    reference's double loop, so the sums are the loop's, bit for bit."""
    out = {}
    for name, elems in element_sets.items():
        elems = np.asarray(elems)
        nq = detJ.shape[0]
        idx = np.broadcast_to(conn[elems][:, None, :],
                              (len(elems), nq, conn.shape[1]))
        vals = np.broadcast_to(detJ[:, elems].T[:, :, None], idx.shape)
        v = np.zeros(nnodes)
        np.add.at(v, idx.reshape(-1), vals.reshape(-1))
        out[name] = v / v.sum()
    return out


class ThermalTopologyAnalysis:
    """Heat-conduction eigenproblem analysis."""

    def __init__(self, fltr, conn, X, node_sets=None, element_sets=None,
                 kappa=1.0, density=1.0, heat_capacity=1.0, rho0=1e-6, p=3,
                 beta=1e-6, sigma=-0.1, N=10, m=None, Ntarget=None,
                 rtol=1e-10, eig_atol=1e-5, adjoint_method="sibk",
                 adjoint_options=None, factor_kind="dense", grid_shape=None,
                 lanczos_tol=None, lanczos_block=1, lanczos_ortho="full",
                 factor_options=None, lanczos_polish=0, kernel_mv="auto",
                 device="cuda"):
        if factor_kind not in ("dense", "mg") + BLOCK_FACTOR_KINDS:
            raise ValueError(f"Unknown factor_kind {factor_kind!r}")
        if factor_kind != "dense" and grid_shape is None:
            raise ValueError(f"factor_kind={factor_kind!r} needs grid_shape")
        self.device = torch.device(device)
        self.fltr = fltr
        conn_np = np.array(conn)
        self.conn = torch.as_tensor(conn_np, dtype=torch.int64,
                                    device=self.device)
        self.X = torch.as_tensor(np.array(X), dtype=torch.float64,
                                 device=self.device)
        self.node_sets = node_sets or {}
        self.element_sets = element_sets or {}
        self.nelems = int(self.conn.shape[0])
        self.nnodes = int(conn_np.max()) + 1
        self.kappa = kappa
        self.density = density
        self.heat_capacity = heat_capacity
        self.rho0 = rho0
        self.p = p
        self.beta = beta
        self.sigma = sigma
        self.Ntarget = Ntarget
        self.eig_atol = eig_atol
        adjoint_options = adjoint_options or {}

        # spare modes, so the host-side Ntarget rule can grow N past a
        # repeated boundary without another eigensolve
        self.Nmax = (Ntarget if Ntarget is not None else N) + 4
        self.N = N if Ntarget is None else Ntarget
        if m is None:
            m = max(3 * self.Nmax + 1, 60)
        self.m = m

        self.Be, self.He, self.detJ = thermal_tables(self.X, self.conn)
        self.cfg = EighGenConfig(
            N=self.Nmax, m=self.m, sigma=sigma, mode="normal",
            adjoint_method=adjoint_method,
            adjoint_maxiter=adjoint_options.get("maxiter", 60),
            adjoint_rtol=rtol * 1e-2,
            nrestart=adjoint_options.get("nrestart", 2), eig_atol=eig_atol,
            lanczos_tol=lanczos_tol, block=lanczos_block,
            lanczos_ortho=lanczos_ortho,
            adjoint_mixed=adjoint_options.get("mixed", False),
            adjoint_ladder=adjoint_options.get("ladder", "approx"),
            polish=lanczos_polish, kernel_mv=kernel_mv)

        self.grid_shape = (tuple(grid_shape) if grid_shape is not None
                           else None)
        factor_fn = None  # dense: make_shift_factor's Cholesky factor
        if factor_kind == "mg":
            mg_opts = dict(factor_options or {})
            grid = self.grid_shape

            def factor_fn(A, B, sig, mode):
                from ..ops.multigrid import GridMGFactor

                return GridMGFactor.build(A.W - sig * B.W, grid, 1, **mg_opts)
        elif factor_kind in BLOCK_FACTOR_KINDS:
            # the refinement keeps its defaults here, as in JAX
            factor_fn = block_factor_fn(factor_kind, self.grid_shape, 1)
        self.problem = EigProblem(assemble=weakly(self._assemble),
                                  factor=factor_fn)

        self.x = 0.95 * torch.ones(self.fltr.num_design_vars,
                                   dtype=torch.float64, device=self.device)
        self.Q = None
        self.lam = None
        self._graph = None
        self.mean_vecs = {
            name: torch.as_tensor(v, device=self.device)
            for name, v in mean_vectors(
                conn_np, self.detJ.cpu().numpy(), self.element_sets,
                self.nnodes).items()}
        self.profile = {"nnodes": self.nnodes, "nelems": self.nelems,
                        "N": self.N, "kappa": kappa, "sigma": sigma,
                        "m": self.m, "eig_atol": eig_atol}

    # -- differentiable core ------------------------------------------------

    def _assemble(self, rhoE):
        K = fem.thermal_stiffness_matrix(rhoE, self.Be, self.detJ, self.conn,
                                         self.nnodes, kappa=self.kappa,
                                         beta=self.beta, p=self.p)
        M = fem.thermal_mass_matrix(rhoE, self.He, self.detJ, self.conn,
                                    self.nnodes, density=self.density,
                                    heat_capacity=self.heat_capacity,
                                    beta=self.beta)
        if self.grid_shape is not None:
            K = GridStencilOperator.from_element_operator(
                K, self.grid_shape, ndof=1)
            M = GridStencilOperator.from_element_operator(
                M, self.grid_shape, ndof=1)
        return K, M

    def _solve_fn(self, x):
        rho = self.fltr.apply(x)
        rhoE = fem.element_density(rho, self.conn)
        return eigh_gen(rhoE, self.problem, self.cfg)

    # -- three-phase protocol ----------------------------------------------

    def _elapsed(self, t0):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    def initialize(self, store=False):
        """Solve at ``self.x`` and hold the autograd graph of the solve for
        ``finalize_adjoint``, releasing the previous one first."""
        t0 = time.perf_counter()
        self._graph = None
        x = self.x.detach().requires_grad_(True)
        with torch.enable_grad():
            lam, Q = self._solve_fn(x)
        self._graph = (x, lam, Q)
        self.lam, self.Q = lam.detach(), Q.detach()
        # Ntarget: grow N past numerically repeated boundaries
        if self.Ntarget is not None:
            lam_np = self.lam.cpu().numpy()
            N = self.Ntarget
            while N < self.Nmax - 1 and abs(
                    lam_np[N - 1] - lam_np[N]) < self.eig_atol:
                N += 1
            self.N = N
        self.profile["eigenvalue solve time"] = self._elapsed(t0)
        if store:
            self.profile["eigenvalues"] = self.lam.tolist()

    def initialize_adjoint(self):
        self.xb = torch.zeros_like(self.x)
        self.lamb = torch.zeros_like(self.lam)
        self.Qb = torch.zeros_like(self.Q)

    def finalize_adjoint(self):
        """xb += the seeds (lamb, Qb) pulled through the held graph, which
        stays for further adjoint passes until the next ``initialize``."""
        t0 = time.perf_counter()
        x, lam, Q = self._graph
        (xb,) = torch.autograd.grad((lam, Q), x, (self.lamb, self.Qb),
                                    retain_graph=True)
        self.xb = self.xb + xb
        self.profile["adjoint solution time"] = self._elapsed(t0)

    # -- mean-temperature coefficient vectors ---------------------------------

    def get_mean_coefficients(self):
        return {name: self.Q.T @ v for name, v in self.mean_vecs.items()}

    def add_mean_derivatives(self, coefb):
        for name, v in self.mean_vecs.items():
            self.Qb = self.Qb + torch.outer(v, coefb[name])

    # -- objective functions (mode 0 skipped) --------------------------------

    def _mode_mask(self):
        mask = torch.zeros(self.Nmax, dtype=torch.float64,
                           device=self.device)
        mask[1:self.N] = 1.0
        return mask

    def _nodes(self, node):
        return torch.as_tensor(np.asarray(node), dtype=torch.int64,
                               device=self.device)

    def get_thermal_compliance(self, vec):
        vals = self.Q.T @ vec
        return torch.sum(self._mode_mask() * vals**2 / self.lam)

    def add_thermal_compliance_derivative(self, compb, vec):
        mask = self._mode_mask()
        vals = self.Q.T @ vec
        self.Qb = self.Qb + compb * 2.0 * mask[None, :] * torch.outer(
            vec, vals / self.lam)
        self.lamb = self.lamb - compb * mask * vals**2 / self.lam**2

    def _eta(self, lam, rho_agg, lam_b):
        a = torch.tanh(rho_agg * (lam - 0.0))
        b = torch.tanh(rho_agg * (lam - lam_b))
        eta = self._mode_mask() * (a - b)
        return eta / torch.sum(eta)

    def _aggregate(self, lam, Q, rho_agg, node):
        eta = self._eta(lam, rho_agg, 50.0)
        return torch.sum(eta * torch.sum(Q[node, :] ** 2, dim=0))

    def _aggregate_max(self, lam, Q, rho_agg, node):
        eta = self._eta(lam, rho_agg, 1000.0)
        return self.KSmax(torch.sum(eta[None, :] * Q[node, :] ** 2, dim=1),
                          rho_agg)

    def _add_seeds(self, hb, fn, *args):
        """lamb, Qb += hb * the gradient of fn(lam, Q, *args), by autograd
        on detached copies (JAX's ``jax.grad``)."""
        with torch.enable_grad():
            lam = self.lam.detach().requires_grad_(True)
            Q = self.Q.detach().requires_grad_(True)
            glam, gQ = torch.autograd.grad(fn(lam, Q, *args), (lam, Q))
        self.lamb = self.lamb + hb * glam
        self.Qb = self.Qb + hb * gQ

    def get_eigenvector_aggregate(self, rho_agg, node):
        return self._aggregate(self.lam, self.Q, rho_agg, self._nodes(node))

    def add_eigenvector_aggregate_derivative(self, hb, rho_agg, node):
        self._add_seeds(hb, self._aggregate, rho_agg, self._nodes(node))

    @staticmethod
    def KSmax(q, ks_rho):
        c = torch.max(q)
        return c + torch.log(torch.sum(torch.exp(ks_rho * (q - c)))) / ks_rho

    def get_eigenvector_aggregate_max(self, rho_agg, node):
        return self._aggregate_max(self.lam, self.Q, rho_agg,
                                   self._nodes(node))

    def add_eigenvector_aggregate_max_derivative(self, hb, rho_agg, node):
        self._add_seeds(hb, self._aggregate_max, rho_agg, self._nodes(node))

    def _area(self, x):
        rhoE = fem.element_density(self.fltr.apply(x), self.conn)
        return torch.sum(self.detJ * rhoE[None, :])

    def eval_area(self):
        return self._area(self.x)

    def eval_area_gradient(self):
        with torch.enable_grad():
            x = self.x.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(self._area(x), x)
        return g


class ThermalOpt:
    """Transient reduced-order thermal problem: project the heat loads onto
    the modes, integrate the diagonal modal ODE with Crank-Nicolson, and
    take KS maxima of set-averaged temperatures over time. A heat function
    is a callable on a tensor of times (``torch.sin`` where JAX's tests
    write ``jnp.sin``). The reverse sweep is autograd through the loop."""

    def __init__(self, topo: ThermalTopologyAnalysis,
                 heat_func: Dict[str, Dict[str, Callable]],
                 compliance_func=None, nsteps=100, tfinal=1.0):
        self.topo = topo
        self.heat_func = heat_func
        self.cases = sorted(heat_func)
        self.nsteps = nsteps
        self.tfinal = tfinal
        self.t = torch.as_tensor(np.linspace(0.0, tfinal, nsteps + 1),
                                 device=topo.device)
        self.dt = tfinal / nsteps

        self.vec = torch.ones(topo.nnodes, dtype=torch.float64,
                              device=topo.device)
        if compliance_func is not None:
            for key, val in compliance_func.items():
                if key in topo.mean_vecs:
                    self.vec = self.vec + val[0] * topo.mean_vecs[key]

    # -- differentiable transient core -------------------------------------

    def _solve_forward(self, case_name, lam, coef):
        """Integrate xi' + lam xi = q(t) by the midpoint rule; returns xi
        (N, nsteps+1)."""
        beta = 1.0 / self.dt
        J = beta + 0.5 * lam
        tmid = 0.5 * (self.t[1:] + self.t[:-1])
        # load coefficients at each midpoint: sum over sets coef * heat(t)
        q = lam.new_zeros((self.nsteps, lam.shape[0]))
        for name, func in self.heat_func[case_name].items():
            if name in coef:
                vals = torch.broadcast_to(
                    torch.as_tensor(func(tmid), dtype=lam.dtype,
                                    device=lam.device), tmid.shape)
                q = q + vals[:, None] * coef[name][None, :]
        # Crank-Nicolson: (beta + lam/2) xi_k = (beta - lam/2) xi_{k-1} + q_k
        xi = [torch.zeros_like(lam)]
        for k in range(self.nsteps):
            xi.append(((beta - 0.5 * lam) * xi[-1] + q[k]) / J)
        return torch.stack(xi, dim=1)

    def _eval_ks_function(self, rho_ks, xi, coef):
        """KS max of the set-averaged temperatures over time and sets."""
        T = torch.cat([coef[name] @ xi[:, 1:self.nsteps]
                       for name in sorted(coef)])
        Tmax = torch.max(T)
        return Tmax + torch.log(torch.sum(torch.exp(rho_ks * (T - Tmax)))
                                ) / rho_ks

    def _ks_from_eig(self, lam, Q, rho_ks):
        coef = {name: Q.T @ v for name, v in self.topo.mean_vecs.items()}
        return {case: self._eval_ks_function(
            rho_ks, self._solve_forward(case, lam, coef), coef)
            for case in self.cases}

    # -- the reference's API -------------------------------------------------

    def initialize(self, store=False):
        self.topo.initialize(store)
        self.lam = self.topo.lam
        self.coef = self.topo.get_mean_coefficients()
        self.xi = {c: self._solve_forward(c, self.lam, self.coef)
                   for c in self.cases}

    def initialize_adjoint(self):
        self.topo.initialize_adjoint()

    def eval_ks_functions(self, rho_ks):
        return {c: self._eval_ks_function(rho_ks, self.xi[c], self.coef)
                for c in self.cases}

    def add_ks_derivative(self, rho_ks, ksb):
        """Accumulate the (lamb, Qb) seeds of sum_case ksb[case] * KS_case
        by autograd through the transient loop."""
        topo = self.topo

        def total(lam, Q):
            ks = self._ks_from_eig(lam, Q, rho_ks)
            return sum(ksb[c] * ks[c] for c in self.cases)

        topo._add_seeds(1.0, total)

    def finalize_adjoint(self):
        self.topo.finalize_adjoint()

    def get_thermal_compliance(self):
        return self.topo.get_thermal_compliance(self.vec)

    def add_thermal_compliance_derivative(self, scale=1.0):
        return self.topo.add_thermal_compliance_derivative(scale, self.vec)

    def test_ks_func(self, rho_ks=10.0, dh_fd=1e-6, ksb=None, pert=None):
        """The reference's central-difference check of the KS gradient
        along ``pert`` (default: numpy's global uniform draw, as the
        reference's; the tests pass the reference's ``pert``)."""
        self.initialize(store=True)
        x0 = self.topo.x.clone()

        if ksb is None:
            r = np.random.default_rng(0)
            ksb = {c: float(r.uniform()) for c in self.cases}

        self.initialize_adjoint()
        self.add_ks_derivative(rho_ks, ksb)
        self.finalize_adjoint()

        if pert is None:
            pert = np.random.uniform(size=tuple(x0.shape))
        pert = torch.as_tensor(pert, dtype=x0.dtype, device=x0.device)
        data = {"ans": float(pert @ self.topo.xb)}

        def total_at(x):
            self.topo.x = x
            self.initialize()
            ks_v = self.eval_ks_functions(rho_ks)
            return sum(ksb[c] * float(ks_v[c]) for c in self.cases)

        f_p = total_at(x0 + dh_fd * pert)
        f_m = total_at(x0 - dh_fd * pert)
        self.topo.x = x0
        data["cd"] = (f_p - f_m) / (2 * dh_fd)
        data["cd_err"] = abs((data["ans"] - data["cd"]) / data["cd"])
        print("%25s  %25s  %25s" % ("Answer", "CD", "CD Rel Error"))
        print("%25.15e  %25.15e  %25.15e" % (data["ans"], data["cd"],
                                             data["cd_err"]))
        return data


def make_model(nx=32, ny=32, Lx=1.0, Ly=1.0, rfact=4.0, device="cuda",
               **kwargs):
    """Thermal model factory (JAX's ``make_model``): a grid, the spatial
    filter, the "center" element set and JAX's defaults elsewhere."""
    from ..fem.filter import NodeFilter
    from ..fem.model import make_grid

    mesh = make_grid(nx, ny, Lx, Ly)
    r0 = rfact * (Ly / ny)
    eset = (np.arange(nx // 2, 3 * nx // 4)[None, :]
            + nx * np.arange(ny // 2, 3 * ny // 4)[:, None]).reshape(-1)
    element_sets = {"center": eset.astype(np.int32)}

    kwargs.setdefault("grid_shape", (nx, ny))
    fltr = NodeFilter(mesh.conn, mesh.X, r0=r0, device=device)
    return ThermalTopologyAnalysis(fltr, mesh.conn, mesh.X,
                                   element_sets=element_sets, device=device,
                                   **kwargs)


def symmetric_dvmap(nx):
    """The 8-fold symmetric design-variable map of an nx x nx grid's nodes
    and its number of design variables."""
    dvmap = -np.ones((nx + 1, nx + 1), dtype=np.int64)
    index = 0
    for i in range(nx // 2, nx + 1):
        for j in range(nx // 2, i + 1):
            for a, b in ((i, j), (j, i), (nx - i, j), (j, nx - i),
                         (i, nx - j), (nx - j, i), (nx - i, nx - j),
                         (nx - j, nx - i)):
                dvmap[a, b] = index
            index += 1
    return dvmap.reshape(-1), index


def make_opt_model(nx=64, Lx=1.0, rfact=4.0, epsilon=0.0, element_sets=None,
                   device="cuda", **kwargs):
    """Square-domain model with the 8-fold symmetric dvmap and an epsilon
    domain asymmetry (the repeated-eigenvalue sweep). The named element
    sets ("center", "corner0".."corner3") gain their blocks of elements;
    the caller's dict is not changed."""
    from ..fem.filter import NodeFilter
    from ..fem.model import make_grid

    mesh = make_grid(nx, nx, Lx, Lx + epsilon)
    r0 = rfact * (Lx / nx)

    def block(istart, jstart, size):
        return [i + nx * j for j in range(jstart, jstart + size)
                for i in range(istart, istart + size)]

    element_sets = dict(element_sets or {})
    if "center" in element_sets:
        element_sets["center"] = np.array(
            list(element_sets["center"])
            + block(2 * nx // 5, 2 * nx // 5, 3 * nx // 5 - 2 * nx // 5),
            dtype=np.int32)
    for k in range(4):
        key = f"corner{k}"
        if key in element_sets:
            element_sets[key] = np.array(
                list(element_sets[key])
                + block((3 * nx // 5) * (k % 2), (3 * nx // 5) * (k // 2),
                        2 * nx // 5), dtype=np.int32)

    dvmap, ndv = symmetric_dvmap(nx)
    fltr = NodeFilter(mesh.conn, mesh.X, r0=r0, dvmap=dvmap,
                      num_design_vars=ndv,
                      projection=kwargs.pop("projection", False),
                      beta=kwargs.pop("b0", 10.0), device=device)
    return ThermalTopologyAnalysis(fltr, mesh.conn, mesh.X,
                                   element_sets=element_sets, device=device,
                                   **kwargs)
