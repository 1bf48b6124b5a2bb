"""DOF-dimension sharding of the eigensolve/adjoint pipeline.

Counterpart of ``eigd_tpu/parallel/sharded.py`` on ``torch.distributed``:

* long vectors (Lanczos basis, adjoint blocks, displacement fields) are
  sharded over the grid's node lines: rank r owns lines [r*L, (r+1)*L);
* the element-operator matvec exchanges one halo line with the right
  neighbour (two ``ppermute``s of line_dofs words a matvec);
* every solver inner product is an all-reduced contraction (the ``axis``
  threaded through ``ops.lanczos``, ``ops.adjoint`` and ``ops.autodiff``);
* the shift-invert factor is CG on the sharded shifted operator with the
  rank-local block-tridiagonal Cholesky as preconditioner (one-level
  additive Schwarz), the line-sharded multigrid factor
  (``mgshard.ShardedGridMGFactor``), or for the CRM wingbox the exact
  station Schur factor (``StationSchurFactor``);
* the (m, m) Rayleigh-Ritz problem and all (N, N) algebra stay
  replicated.

Where JAX runs one ``shard_map`` program over a mesh, every rank here runs
the same Python: the builders take the rank's ``collective.Axis`` and
return an objective of the replicated design vector whose value is
replicated on every rank. Its gradient by ``backward()`` is whole and
equal on every rank: the replicated element array enters the solve through
``collective.shard`` (its backward all-reduces), sums leave through
``psum`` (its backward is the identity), and the halo exchanges inside the
assembly differentiate through ``ppermute``'s inverse. Scatters use
``operators.scatter_rows``, so CUDA runs sum in one order every time.

The start vectors: JAX draws ``v0`` as one uniform local vector, the same
on every device (``jax.random.uniform(PRNGKey(12345), (n_local,))``); the
builders here draw it from a ``torch.Generator`` seeded 12345, or take
``v0_local`` (JAX's, as numpy) for parity runs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.collective import (all_gather, col_sums, ppermute, psum, pvary,
                              shard)
from ..ops.operators import scatter_rows
from .grid import (GridPartition, element_gather_index, local_dof_map,
                   make_partition, pad_line_mask)


def pad_elements(arrays, n_shards, axis=0):
    """Pad the element axis to a multiple of n_shards (zero padding; padded
    elements have zero matrices so they contribute nothing)."""
    out = []
    for a in arrays:
        pad = (-a.shape[axis]) % n_shards
        if pad:
            shape = list(a.shape)
            shape[axis] = pad
            a = torch.cat([a, a.new_zeros(shape)], dim=axis)
        out.append(a)
    return out


def sharded_element_matvec(axis, mats, dofs, nvars):
    """Element-sharded matvec closure for unstructured problems:
    x (replicated) -> A x (replicated).

    mats (nelems, d, d) and dofs (nelems, d) are the padded element arrays
    (``pad_elements``); each rank takes its contiguous share, scatters
    locally and one psum of the O(n) result reduces (the general fallback;
    the grid path reduces this to O(line) halo exchanges). The gradients
    of x and mats are whole on every rank.
    """
    per = mats.shape[0] // axis.size
    mats_l = shard(mats, axis, per)
    dofs_l = dofs[axis.rank * per:(axis.rank + 1) * per].long()

    def mv(x):
        xe = pvary(x, axis)[dofs_l]
        ye = torch.einsum("eij,ej->ei", mats_l, xe)
        y = scatter_rows(ye.reshape(-1), dofs_l.reshape(-1), nvars)
        return psum(y, axis)

    return mv


# ---------------------------------------------------------------------------
# Halo-exchange grid operator
# ---------------------------------------------------------------------------


class GridHaloOperator:
    """Matrix-free FE operator on a line-partitioned grid, the rank's view.

    mats : (elems_local, d, d) element matrices of the rank's element
        columns (padded columns have zero matrices).
    dofs : (elems_local, d) local extended DOF indices
        (``grid.local_dof_map``), the same on every rank.
    part : the GridPartition. axis : the shard axis.

    mv(x_local) is the rank's shard of the global matvec: one halo receive
    (the right neighbour's first line) and one boundary send-back.
    """

    def __init__(self, mats, dofs, part: GridPartition, axis):
        self.mats = mats
        self.dofs = dofs
        self.part = part
        self.axis = axis

    @property
    def shape(self):
        n = self.part.n_local
        return (n, n)

    @property
    def dtype(self):
        return self.mats.dtype

    @property
    def device(self):
        return self.mats.device

    def mv(self, x):
        part = self.part
        b = part.line_dofs
        squeeze = x.ndim == 1
        if squeeze:
            x = x[:, None]
        x = x.to(torch.promote_types(self.mats.dtype, x.dtype))
        k = x.shape[1]
        nd = part.ndev
        if nd > 1:  # receive from the right neighbour: d+1 -> d
            halo = ppermute(x[:b], self.axis,
                            [(d + 1, d) for d in range(nd - 1)])
        else:
            halo = x.new_zeros((b, k))
        x_ext = torch.cat([x, halo])  # L+1 lines
        ye = torch.bmm(self.mats.to(x.dtype), x_ext[self.dofs])
        y_ext = scatter_rows(ye.reshape(-1, k), self.dofs.reshape(-1),
                             (part.L + 1) * b)
        if nd > 1:  # boundary contributions to the right neighbour
            recv = ppermute(y_ext[part.L * b:], self.axis,
                            [(d, d + 1) for d in range(nd - 1)])
        else:
            recv = x.new_zeros((b, k))
        y = torch.cat([y_ext[:b] + recv, y_ext[b:part.L * b]])
        return y[:, 0] if squeeze else y

    def __call__(self, x):
        return self.mv(x)


def _block_scatter(vals, blk, wi, wj, nblk, b):
    """(nblk, b, b) blocks with out[blk, wi, wj] += vals (sorted sums on
    CUDA, ``scatter_rows``)."""
    flat = (blk * b + wi) * b + wj
    return scatter_rows(vals.reshape(-1), flat.reshape(-1),
                        nblk * b * b).reshape(nblk, b, b)


def _unit_diag_fix(D):
    """Unit diagonal on empty (masked / padded) DOFs so Cholesky exists."""
    diag = torch.diagonal(D, dim1=-2, dim2=-1)
    return D + torch.diag_embed((diag == 0.0).to(D.dtype))


def local_line_blocks(mats, dofs, part: GridPartition):
    """The rank's block-tridiagonal blocks of its own lines: (L, b, b)
    diagonal blocks D and (L-1, b, b) sub-diagonal blocks
    E = A[line c+1, line c], the couplings to the halo line dropped
    (one-level additive Schwarz). Zero diagonal entries (padded lines or
    columns) become 1, so the local Cholesky exists."""
    L, b = part.L, part.line_dofs
    li = dofs // b  # (ne, d) line of each element dof (0..L)
    wi = dofs % b
    lii, lij = li[:, :, None], li[:, None, :]
    wii, wij = wi[:, :, None].expand(mats.shape), wi[:, None, :].expand(
        mats.shape)
    same = lii == lij
    lower = lii == lij + 1
    own = lii < L
    d_idx = torch.where(same & own, lii, L).expand(mats.shape)
    D = _block_scatter(torch.where(same & own, mats, 0.0), d_idx, wii, wij,
                       L + 1, b)[:L]
    e_idx = torch.where(lower & own, lij, L).expand(mats.shape)
    E = _block_scatter(torch.where(lower & own, mats, 0.0), e_idx, wii, wij,
                       L + 1, b)[:max(L - 1, 0)]
    return _unit_diag_fix(D), E


class SchwarzPCGFactor:
    """Shift-invert factor of the sharded path: CG on the (SPD) sharded
    shifted operator, preconditioned by the rank-local block-tridiagonal
    Cholesky (one-level additive Schwarz): no exchange per preconditioner
    apply, one halo exchange and two all-reduces per CG iteration. The
    loop decision reads all-reduced residuals (one host decision an
    iteration, ``sync.HOST_SYNCS["schwarz_pcg"]``)."""

    def __init__(self, op: GridHaloOperator, btf, maxiter=100, tol=1e-13,
                 axis=None):
        self.op = op
        self.btf = btf
        self.maxiter = maxiter
        self.tol = tol
        self.axis = axis

    @classmethod
    def build(cls, shifted_mats, dofs, part, axis, maxiter=100, tol=1e-13):
        from ..ops.blockfactor import BlockTridiagFactor

        op = GridHaloOperator(shifted_mats, dofs, part, axis)
        D, E = local_line_blocks(shifted_mats, dofs, part)
        return cls(op, BlockTridiagFactor.from_blocks(D, E), maxiter=maxiter,
                   tol=tol, axis=axis)

    @property
    def shape(self):
        return self.op.shape

    @property
    def dtype(self):
        return self.op.dtype

    def mv(self, bvec):
        x, _ = self.mv_info(bvec)
        return x

    def mv_info(self, bvec):
        """Like ``mv``, with the convergence info: niter, per-column final
        squared residuals and the squared tolerance (an unconverged
        maxiter exit stays visible)."""
        from ..ops.blockfactor import blocked_pcg

        squeeze = bvec.ndim == 1
        if squeeze:
            bvec = bvec[:, None]
        sums = col_sums(self.axis)
        tol2 = (self.tol ** 2) * torch.clamp(sums((bvec, bvec))[0],
                                             min=1e-300)
        x, r2, k = blocked_pcg(torch.zeros_like(bvec), bvec, self.op.mv,
                               self.btf.mv, tol2, self.maxiter, "schwarz_pcg",
                               sums=sums)
        if squeeze:
            x = x[:, 0]
        return x, {"niter": k, "res2": r2, "tol2": tol2}

    def __call__(self, x):
        return self.mv(x)


def _sharded_mg_factor(shifted_mats, part, axis, shard_levels, rtol=1e-11):
    """The rank's element matrices of the shifted operator -> the
    line-sharded multigrid factor. The element block is (L columns x ny
    rows) in column-major slot order; stencil_from_elements wants
    e = i + nx*j."""
    from ..ops.stencil import stencil_from_elements
    from .mgshard import ShardedGridMGFactor

    ny, L = part.ny, part.L
    d4 = shifted_mats.shape[1]
    em = shifted_mats.reshape(L, ny, d4, d4).transpose(0, 1).reshape(
        ny * L, d4, d4)
    Wl = stencil_from_elements(em, L, ny, part.ndof)  # (L+1, ny+1, ...)
    W_local = Wl[:L]
    if part.ndev > 1:
        # the couplings onto the right neighbour's first line from this
        # rank's elements ship right once
        recv = ppermute(Wl[L:], axis,
                        [(d, d + 1) for d in range(part.ndev - 1)])
        W_local = torch.cat([W_local[:1] + recv, W_local[1:]])
    return ShardedGridMGFactor.build(W_local, part, axis,
                                     shard_levels=shard_levels, rtol=rtol)


# ---------------------------------------------------------------------------
# Shared set-up of the grid families
# ---------------------------------------------------------------------------


class _GridShard:
    """The rank's share of a line-partitioned grid family: the partition,
    the local DOF map, the gather into padded column-major element slots,
    the rank's pad mask and its slice of element tables."""

    def __init__(self, axis, nx, ny, ndof, multiple=1):
        self.axis = axis
        self.dev = axis.device
        self.part = part = make_partition(nx, ny, axis.size, ndof=ndof,
                                          multiple=multiple)
        gidx = element_gather_index(part)
        self.gsafe = torch.as_tensor(np.maximum(gidx, 0), dtype=torch.int64,
                                     device=self.dev)
        self.real = torch.as_tensor((gidx >= 0).astype(np.float64),
                                    device=self.dev)
        self.dofs = torch.as_tensor(local_dof_map(part), dtype=torch.int64,
                                    device=self.dev)
        self.mask = torch.as_tensor(pad_line_mask(part)[axis.rank],
                                    device=self.dev)
        lo = axis.rank * part.elems_local
        self.slots = slice(lo, lo + part.elems_local)
        idx = torch.arange(part.n_local, device=self.dev)
        self.line = (axis.rank * part.L + idx // part.line_dofs).to(
            torch.float64)
        self.within = idx % part.line_dofs

    def local_table(self, arr):
        """The rank's padded slots of an element table (nq, nelems, ...)
        -> (nq, elems_local, ...), zero on padded slots."""
        g, r = self.gsafe[self.slots], self.real[self.slots]
        return arr[:, g] * r.reshape((1, -1) + (1,) * (arr.ndim - 2))

    def local_elements(self, rhoE):
        """The replicated element vector -> the rank's padded slots, by
        ``shard`` (the gradient all-reduces)."""
        return shard(rhoE[self.gsafe] * self.real, self.axis,
                     self.part.elems_local)

    def weight(self):
        """The device-count-independent physical weight of the aggregates:
        mask * sin(0.37 line + 0.11 within)."""
        return self.mask * torch.sin(0.37 * self.line
                                     + 0.11 * self.within.to(torch.float64))

    def start(self, v0_local, mask):
        """v0: JAX's raw uniform local draw (numpy) or the port's own, times
        ``mask``."""
        if v0_local is None:
            g = torch.Generator().manual_seed(12345)
            v = 2.0 * torch.rand(self.part.n_local, generator=g,
                                 dtype=torch.float64) - 1.0
        else:
            v = torch.as_tensor(np.asarray(v0_local), dtype=torch.float64)
        v = v.to(self.dev) * mask
        return lambda theta: v

    def factor(self, kind, cg_maxiter, shard_levels):
        """factor(A, B, sigma, mode) of A - sigma B, normal mode."""
        def factor_fn(A, B, sig, mode):
            assert mode == "normal"
            shifted = A.mats - sig * B.mats
            if kind == "mg":
                return _sharded_mg_factor(shifted, self.part, self.axis,
                                          shard_levels)
            return SchwarzPCGFactor.build(shifted, self.dofs, self.part,
                                          self.axis, maxiter=cg_maxiter)

        return factor_fn


# ---------------------------------------------------------------------------
# Sharded natural-frequency objective + train step
# ---------------------------------------------------------------------------


def make_sharded_objective(axis, nx, ny, Lx=2.0, Ly=1.0, N=2, m=24,
                           sigma=-10.0, adjoint_maxiter=16, nrestart=2,
                           cg_maxiter=60, qweight=1e-3, factor="schwarz",
                           adjoint_method="sibk", shard_levels=2,
                           lanczos_block=1, polish=0, v0_local=None):
    """(objective(x), fltr, axis, part) for the free-free plane-stress
    natural-frequency problem with the solve sharded over node lines.

    The rigid-body triple is deflated out of the Krylov iteration, built on
    each rank from the physical grid coordinates. factor="schwarz": CG with
    the rank-local block-tridiagonal Cholesky preconditioner; factor="mg":
    the line-sharded multigrid factor (pair it with adjoint_method="pcpg"
    for the V-cycle-preconditioned adjoint). The objective is
    -sum sqrt(lam) + qweight * sum (w Q)^2 with a weight of the physical
    DOF only, so its value does not depend on the rank count.
    """
    from ..fem import assembly as fem
    from ..fem.filter import NodeFilter
    from ..fem.model import make_grid
    from ..fem.quad import plane_stress_tables
    from ..ops.autodiff import EigProblem, EighGenConfig, eigh_gen

    gs = _GridShard(axis, nx, ny, 2,
                    multiple=(1 << shard_levels) if factor == "mg" else 1)
    part, dev = gs.part, gs.dev
    grid = make_grid(nx, ny, Lx, Ly)
    fltr = NodeFilter(grid.conn, grid.X, r0=2.0 * (Ly / ny), device=dev)
    conn = torch.as_tensor(grid.conn, dtype=torch.int64, device=dev)
    X = torch.as_tensor(grid.X, dtype=torch.float64, device=dev)
    C0 = fem.plane_stress_C0(device=dev)
    Be, He, detJ = plane_stress_tables(X, conn)
    Be_l, He_l, dJ_l = (gs.local_table(t) for t in (Be, He, detJ))
    n_ext = (part.L + 1) * part.line_dofs

    def assemble(rhoE_l):
        K = fem.stiffness_matrix(rhoE_l, Be_l, dJ_l, gs.dofs, n_ext, C0)
        M = fem.mass_matrix(rhoE_l, He_l, dJ_l, gs.dofs, n_ext)
        return (GridHaloOperator(K.mats, gs.dofs, part, axis),
                GridHaloOperator(M.mats, gs.dofs, part, axis))

    comp = gs.within % 2
    xc = gs.line * (Lx / nx)
    yc = (gs.within // 2).to(torch.float64) * (Ly / ny)
    rigid = torch.stack([(comp == 0).to(torch.float64) * gs.mask,
                         (comp == 1).to(torch.float64) * gs.mask,
                         torch.where(comp == 0, -yc, xc) * gs.mask])

    problem = EigProblem(assemble=assemble,
                         factor=gs.factor(factor, cg_maxiter, shard_levels),
                         v0=gs.start(v0_local, gs.mask),
                         nullspace=lambda theta: rigid)
    cfg = EighGenConfig(N=N, m=m, sigma=sigma, adjoint_method=adjoint_method,
                        adjoint_maxiter=adjoint_maxiter, nrestart=nrestart,
                        axis=axis, block=lanczos_block, polish=polish,
                        adjoint_mixed=(adjoint_method == "pcpg"
                                       and factor == "mg"))
    w = gs.weight()

    def theta(x):
        return gs.local_elements(fem.element_density(fltr.apply(x), conn))

    def objective(x):
        lam, Q = eigh_gen(theta(x), problem, cfg)
        qagg = psum(torch.sum((w[:, None] * Q) ** 2), axis)
        return -torch.sum(torch.sqrt(lam)) + qweight * qagg

    # the solve's pieces, for checks of its operators and factor
    objective.theta, objective.problem, objective.cfg = theta, problem, cfg
    return objective, fltr, axis, part


def sharded_train_step(axis, nx, ny, **kwargs):
    """One objective + gradient + design update step on the sharded solve
    from x0 = 0.95; returns (x1, value) as JAX's does, and the gradient,
    all replicated."""
    objective, fltr, _, _ = make_sharded_objective(axis, nx, ny, **kwargs)
    x0 = torch.full((fltr.num_design_vars,), 0.95, dtype=torch.float64,
                    device=axis.device, requires_grad=True)
    val = objective(x0)
    (g,) = torch.autograd.grad(val, x0)
    return (x0 - 0.05 * g).detach(), val.detach(), g


# ---------------------------------------------------------------------------
# Sharded thermal objective (ndof = 1)
# ---------------------------------------------------------------------------


def make_sharded_thermal_objective(axis, nx, ny, Lx=1.0, Ly=1.0, N=4, m=48,
                                   sigma=-0.1, adjoint_maxiter=24,
                                   nrestart=2, cg_maxiter=300, qweight=1e-3,
                                   factor="schwarz", shard_levels=2,
                                   kappa=1.0, beta=1e-6, p=3.0, polish=0,
                                   v0_local=None):
    """Sharded scalar heat-conduction eigenproblem objective: the same
    line partition and halo machinery with ndof = 1. The pure-Neumann
    pencil's near-zero constant mode is mode 0, solved (not deflated), and
    every aggregate skips it."""
    from ..fem import assembly as fem
    from ..fem.filter import NodeFilter
    from ..fem.model import make_grid
    from ..fem.quad import thermal_tables
    from ..ops.autodiff import EigProblem, EighGenConfig, eigh_gen

    gs = _GridShard(axis, nx, ny, 1,
                    multiple=(1 << shard_levels) if factor == "mg" else 1)
    part, dev = gs.part, gs.dev
    grid = make_grid(nx, ny, Lx, Ly)
    fltr = NodeFilter(grid.conn, grid.X, r0=2.0 * (Ly / ny), device=dev)
    conn = torch.as_tensor(grid.conn, dtype=torch.int64, device=dev)
    X = torch.as_tensor(grid.X, dtype=torch.float64, device=dev)
    Be, He, detJ = thermal_tables(X, conn)
    Be_l, He_l, dJ_l = (gs.local_table(t) for t in (Be, He, detJ))
    BtB = torch.einsum("qeij,qeil->qejl", Be_l, Be_l)
    HtH = torch.einsum("qei,qej->qeij", He_l, He_l)

    def assemble(rhoE_l):
        kcoef = kappa * ((1.0 - beta) * rhoE_l ** p + beta)
        Ke = torch.einsum("e,qe,qejl->ejl", kcoef, dJ_l, BtB)
        ccoef = (1.0 - beta) * rhoE_l + beta
        Me = torch.einsum("e,qe,qeij->eij", ccoef, dJ_l, HtH)
        return (GridHaloOperator(Ke, gs.dofs, part, axis),
                GridHaloOperator(Me, gs.dofs, part, axis))

    problem = EigProblem(assemble=assemble,
                         factor=gs.factor(factor, cg_maxiter, shard_levels),
                         v0=gs.start(v0_local, gs.mask))
    cfg = EighGenConfig(N=N, m=m, sigma=sigma, adjoint_method="sibk",
                        adjoint_maxiter=adjoint_maxiter, nrestart=nrestart,
                        axis=axis, polish=polish)
    w = gs.weight()

    def objective(x):
        rhoE = fem.element_density(fltr.apply(x), conn)
        lam, Q = eigh_gen(gs.local_elements(rhoE), problem, cfg)
        f_q = psum(w @ Q, axis)  # (N,) phi_i . f
        comp_ = torch.sum(f_q[1:] ** 2 / lam[1:])
        qagg = psum(torch.sum((w[:, None] * Q[:, 1:]) ** 2), axis)
        return comp_ + torch.sum(torch.sqrt(lam[1:])) + qweight * qagg

    return objective, fltr, axis, part


# ---------------------------------------------------------------------------
# Sharded buckling objective (masked Dirichlet pencil)
# ---------------------------------------------------------------------------


class DiagHaloOperator:
    """GridHaloOperator plus a local diagonal term (the unit diagonal on
    masked Dirichlet DOFs, the sharded mirror of
    ``GridStencilOperator.extra_diag``)."""

    def __init__(self, op: GridHaloOperator, diag):
        self.op = op
        self.diag = diag

    @property
    def shape(self):
        return self.op.shape

    @property
    def dtype(self):
        return self.op.dtype

    @property
    def device(self):
        return self.op.device

    @property
    def mats(self):
        return self.op.mats

    def mv(self, x):
        y = self.op.mv(x)
        if x.ndim == 2:
            return y + self.diag[:, None] * x
        return y + self.diag * x

    def __call__(self, x):
        return self.mv(x)


def make_sharded_buckling_objective(axis, nx, ny, Lx=2.0, Ly=1.0, N=3, m=40,
                                    sigma=3.0, adjoint_maxiter=24,
                                    nrestart=2, cg_maxiter=400, qweight=1e-3,
                                    ks_rho=160.0, load_frac=0.2, p=3.0,
                                    q=5.0, polish=0, v0_local=None):
    """Sharded linearized-buckling objective: Dirichlet DOFs masked
    (zeroed rows and columns plus a unit diagonal), the static preload
    K u = f solved through the sharded Schwarz-PCG factor under
    ``solve_spd``, the stress stiffness G(rho, u) assembled from
    halo-exchanged displacements, and the pencil G phi = mu K phi solved in
    buckling mode with the factor of K + sigma G.

    Objective = KS(1/BLF) + qweight * eigenvector aggregate + 0.1 *
    compliance.
    """
    from ..fem import assembly as fem
    from ..fem.filter import NodeFilter
    from ..fem.model import make_grid
    from ..fem.quad import stress_stiffness_tables
    from ..ops.autodiff import EigProblem, EighGenConfig, eigh_gen, solve_spd

    gs = _GridShard(axis, nx, ny, 2)
    part, dev = gs.part, gs.dev
    grid = make_grid(nx, ny, Lx, Ly)
    fltr = NodeFilter(grid.conn, grid.X, r0=2.0 * (Ly / ny), device=dev)
    conn = torch.as_tensor(grid.conn, dtype=torch.int64, device=dev)
    X = torch.as_tensor(grid.X, dtype=torch.float64, device=dev)
    C0 = fem.plane_stress_C0(device=dev)
    Be, Te, detJ = stress_stiffness_tables(X, conn)
    Be_l, Te_l, dJ_l = (gs.local_table(t) for t in (Be, Te, detJ))

    # Dirichlet mask and load, line-partitioned on the host
    b = part.line_dofs
    n_ext = (part.L + 1) * b
    lo = axis.rank * part.n_local
    masks = pad_line_mask(part).reshape(-1)
    free = np.ones(part.n_padded)
    free[:b] = 0.0  # clamp the left edge (line 0)
    free = free * masks
    forces = np.zeros(part.n_padded)
    jmid = range(int(ny * (0.5 - load_frac / 2)),
                 int(ny * (0.5 + load_frac / 2)) + 1)
    for j in jmid:  # right-edge nodes: global line nx, row j
        forces[nx * b + 2 * j] = -1.0 / len(jmid)
    fm_l = torch.as_tensor(free[lo:lo + part.n_local], device=dev)
    fixed_l = gs.mask * (1.0 - fm_l)
    fm_load = torch.as_tensor(forces[lo:lo + part.n_local], device=dev) * fm_l

    perm_fwd = [(d + 1, d) for d in range(part.ndev - 1)]

    def halo_right(u):
        if part.ndev == 1:
            return u.new_zeros((b,))
        return ppermute(u[:b], axis, perm_fwd)

    me = torch.cat([fm_l, halo_right(fm_l)])[gs.dofs]
    mm = me[:, :, None] * me[:, None, :]

    def K_mats(rhoE_l):
        K = fem.stiffness_matrix(rhoE_l, Be_l, dJ_l, gs.dofs, n_ext, C0, p=p,
                                 q=q)
        return K.mats * mm

    def G_mats(rhoE_l, u_l):
        uf = u_l * fm_l
        ue = torch.cat([uf, halo_right(uf)])[gs.dofs]
        c = fem.stiffness_interp(rhoE_l, p=p, q=q, rho0=1e-9)
        s = torch.einsum("e,ik,qekl,el->qei", c, C0, Be_l, ue)
        G0 = torch.einsum("qe,qei,qeijl->ejl", dJ_l, s, Te_l)
        Ge = G0.new_zeros((G0.shape[0], 8, 8))
        Ge[:, 0::2, 0::2] += G0
        Ge[:, 1::2, 1::2] += G0
        return Ge * mm

    def K_op(rhoE_l):
        return DiagHaloOperator(
            GridHaloOperator(K_mats(rhoE_l), gs.dofs, part, axis), fixed_l)

    def K_factor(rhoE_l):
        return SchwarzPCGFactor.build(K_mats(rhoE_l), gs.dofs, part, axis,
                                      maxiter=cg_maxiter)

    def assemble(th2):
        rhoE_l, u = th2
        K = K_op(rhoE_l)
        G = DiagHaloOperator(
            GridHaloOperator(G_mats(rhoE_l, u), gs.dofs, part, axis),
            0.0 * fixed_l)
        return G, K

    def factor_fn(A, B, sig, mode):
        assert mode == "buckling"
        return SchwarzPCGFactor.build(B.mats + sig * A.mats, gs.dofs, part,
                                      axis, maxiter=cg_maxiter)

    problem = EigProblem(assemble=assemble, factor=factor_fn,
                         v0=gs.start(v0_local, fm_l))
    cfg = EighGenConfig(N=N, m=m, sigma=sigma, mode="buckling",
                        adjoint_method="sibk",
                        adjoint_maxiter=adjoint_maxiter, nrestart=nrestart,
                        axis=axis, polish=polish)
    w = gs.weight()

    def objective(x):
        rhoE = fem.element_density(fltr.apply(x), conn)
        rhoE_l = gs.local_elements(rhoE)
        u = solve_spd(rhoE_l, fm_load, K_op, K_factor)
        compliance = psum(fm_load @ u, axis)
        lam, Q = eigh_gen((rhoE_l, u), problem, cfg)
        mu = 1.0 / lam
        c = torch.max(mu)
        ks = c + torch.log(torch.sum(torch.exp(ks_rho * (mu - c)))) / ks_rho
        qagg = psum(torch.sum((w[:, None] * Q) ** 2), axis)
        return ks + qweight * qagg + 0.1 * compliance

    return objective, fltr, axis, part


# ---------------------------------------------------------------------------
# Sharded CRM wingbox objective (station-partitioned)
# ---------------------------------------------------------------------------


def local_station_chain(mats, dofs, part: GridPartition):
    """The rank's full station-chain blocks including the right interface:
    (L+1, b, b) diagonal blocks D (D[L] = this rank's element contributions
    to the neighbour's first station) and (L, b, b) sub-diagonal blocks E
    with E[i] = A[station i+1, station i]. Nothing is dropped: these are
    the exact subdomain matrices, so sum_d A_d = A."""
    L, b = part.L, part.line_dofs
    li = dofs // b
    wi = dofs % b
    lii, lij = li[:, :, None], li[:, None, :]
    wii, wij = wi[:, :, None].expand(mats.shape), wi[:, None, :].expand(
        mats.shape)
    same = lii == lij
    lower = lii == lij + 1
    D = _block_scatter(torch.where(same, mats, 0.0),
                       torch.where(same, lii, L + 1).expand(mats.shape),
                       wii, wij, L + 2, b)[:L + 1]
    E = _block_scatter(torch.where(lower, mats, 0.0),
                       torch.where(lower, lij, L).expand(mats.shape),
                       wii, wij, L + 1, b)[:L]
    return D, E


class StationSchurFactor:
    """Exact distributed direct solve of a station-block-tridiagonal SPD
    matrix partitioned over the ranks (substructuring):

    * build: each rank Cholesky-factors its interior station chain
      (stations rL+1 .. rL+L-1, coupled only to its own elements), forms
      the 2b x 2b Schur complement onto its two interface stations (rL and
      (r+1)L), and one all_gather assembles the replicated (ndev+1)-station
      reduced block-tridiagonal system;
    * apply: one local interior solve, one all_gather of the (2, b, k)
      interface right-hand-side shares, one replicated reduced solve, one
      local back-substitution.

    The apply is exact whatever the conditioning (the shell matrix's
    bending/membrane spread defeats one-level Schwarz-PCG).
    """

    def __init__(self, Tint, W0, W1, E0, Elast, red, part, axis):
        self.Tint = Tint  # interior-chain factor (None when L == 1)
        self.W0 = W0  # (n_int, b) = Tint^-1 (e_1 (x) E0)
        self.W1 = W1  # (n_int, b) = Tint^-1 (e_last (x) Elast^T)
        self.E0 = E0  # (b, b) A[first interior, I_r]
        self.Elast = Elast  # (b, b) A[I_{r+1}, last interior]
        self.red = red  # replicated reduced interface factor
        self.part = part
        self.axis = axis

    @classmethod
    def build(cls, mats, dofs, part: GridPartition, axis):
        from ..ops.blockfactor import BlockTridiagFactor

        L, b = part.L, part.line_dofs
        D, E = local_station_chain(mats, dofs, part)
        if L > 1:
            Tint = BlockTridiagFactor.from_blocks(_unit_diag_fix(D[1:L]),
                                                  E[1:L - 1])
            E0, Elast = E[0], E[L - 1]
            n_int = (L - 1) * b
            R0 = D.new_zeros((n_int, b))
            R0[:b] = E0
            R1 = D.new_zeros((n_int, b))
            R1[-b:] = Elast.T
            W0 = Tint.mv(R0)
            W1 = Tint.mv(R1)
            S00 = D[0] - E0.T @ W0[:b]
            S10 = -Elast @ W0[-b:]
            S11 = D[L] - Elast @ W1[-b:]
        else:
            Tint = W0 = W1 = None
            E0 = Elast = E[0]
            S00, S10, S11 = D[0], E[0], D[1]
        Sg = all_gather(torch.stack([S00, S10, S11])[None], axis)
        ndev = part.ndev
        Dr = D.new_zeros((ndev + 1, b, b))
        Dr[:-1] += Sg[:, 0]
        Dr[1:] += Sg[:, 2]
        red = BlockTridiagFactor.from_blocks(_unit_diag_fix(Dr), Sg[:, 1])
        return cls(Tint, W0, W1, E0, Elast, red, part, axis)

    @property
    def shape(self):
        n = self.part.n_local
        return (n, n)

    @property
    def dtype(self):
        return self.E0.dtype

    def mv(self, r):
        part, axis = self.part, self.axis
        L, b, ndev = part.L, part.line_dofs, part.ndev
        squeeze = r.ndim == 1
        if squeeze:
            r = r[:, None]
        k = r.shape[1]
        rb = r.reshape(L, b, k)
        r_I = rb[0]
        if L > 1:
            y = self.Tint.mv(rb[1:].reshape((L - 1) * b, k))
            sh0 = r_I - self.E0.T @ y[:b]
            sh1 = -self.Elast @ y[-b:]
        else:
            y = None
            sh0, sh1 = r_I, torch.zeros_like(r_I)
        g = all_gather(torch.stack([sh0, sh1])[None], axis)  # (ndev,2,b,k)
        rhs = r.new_zeros((ndev + 1, b, k))
        rhs[:-1] += g[:, 0]
        rhs[1:] += g[:, 1]
        xI = self.red.mv(rhs.reshape(-1, k)).reshape(ndev + 1, b, k)
        xI_own = xI[axis.rank]
        if L > 1:
            x_int = y - self.W0 @ xI_own - self.W1 @ xI[axis.rank + 1]
            x = torch.cat([xI_own[None], x_int.reshape(L - 1, b, k)])
        else:
            x = xI_own[None]
        x = x.reshape(L * b, k)
        return x[:, 0] if squeeze else x

    def __call__(self, x):
        return self.mv(x)


# the unit dummy quad of padded element slots: an all-zero element makes
# shell_element_matrices produce NaN frames, and the zero mask cannot
# cancel a NaN (0 * nan = nan)
_UNIT_QUAD = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [1.0, 1.0, 0.0],
                       [0.0, 1.0, 0.0]])


def station_buckets(crm, ndev):
    """The CRM's elements bucketed by owning rank (host side): (part,
    Xe_cm, comp_cm, dofs_cm, me_cm), each element array padded to ndev *
    Emax slots (unit dummy quads, component 0, zero DOF mask), dofs_cm
    local to the owning rank's extended station chain."""
    nb, b = crm.nb, crm.b
    part = make_partition(nx=nb - 1, ny=crm.b_nodes - 1, ndev=ndev, ndof=6)
    assert part.line_dofs == b, (part.line_dofs, b)
    L = part.L
    dofs_g = crm.dofs.cpu().numpy()
    st_e = dofs_g.min(axis=1) // b
    assert np.all(dofs_g.max(axis=1) // b <= st_e + 1), \
        "element spans more than two stations"
    dev_e = st_e // L
    Emax = max(int(np.bincount(dev_e, minlength=ndev).max()), 1)
    Xe_all = crm.X.cpu().numpy()[crm.conn.cpu().numpy()]
    comp_all = crm.comp.cpu().numpy()
    fm_g = crm.free_mask.cpu().numpy()

    Xe_cm = np.broadcast_to(_UNIT_QUAD, (ndev * Emax, 4, 3)).copy()
    comp_cm = np.zeros(ndev * Emax, dtype=np.int64)
    dofs_cm = np.zeros((ndev * Emax, 24), dtype=np.int64)
    me_cm = np.zeros((ndev * Emax, 24))
    fill = np.zeros(ndev, dtype=np.int64)
    for e in range(dofs_g.shape[0]):
        d = int(dev_e[e])
        s = d * Emax + int(fill[d])
        fill[d] += 1
        Xe_cm[s] = Xe_all[e]
        comp_cm[s] = comp_all[e]
        dofs_cm[s] = dofs_g[e] - d * L * b
        me_cm[s] = fm_g[dofs_g[e]]
    assert dofs_cm.min() >= 0 and dofs_cm.max() < (L + 1) * b
    return part, Xe_cm, comp_cm, dofs_cm, me_cm


def make_sharded_crm_objective(axis, nspan=8, nchord=4, nheight=2, N=4, m=40,
                               adjoint_maxiter=24, nrestart=2,
                               cg_maxiter=300, crm_kwargs=None,
                               v0_local=None):
    """Station-sharded wingbox modal-compliance objective.

    The CRM's padded DOF layout is station-major and every shell element
    couples adjacent span stations only: the node-line structure of
    ``grid.GridPartition`` with line_dofs = b. Rank r owns stations
    [r*L, (r+1)*L) and the elements whose lowest station falls there; a
    matvec needs one halo station. The factor is the exact
    ``StationSchurFactor``.

    Returns (objective(tcomp) -> modal compliance, crm, axis, part); the
    objective matches the serial ``CRM.get_modal_compliance`` with the tip
    load. ``cg_maxiter`` is JAX's argument (its factor takes none). The
    forward runs the CRM's Ritz polish steps (``crm_kwargs``'
    ``lanczos_polish``, by default the CRM's own: 0 below 60,000 padded
    DOF, as in JAX's objective, and 3 above).
    """
    from ..fem.shell import shell_element_matrices
    from ..models.crm import CRM
    from ..ops.autodiff import EigProblem, EighGenConfig, eigh_gen

    del cg_maxiter
    dev = axis.device
    crm = CRM(nspan=nspan, nchord=nchord, nheight=nheight, N=N, m=m,
              device=dev, **(crm_kwargs or {}))
    part, Xe_cm, comp_cm, dofs_cm, me_cm = station_buckets(crm, axis.size)
    Emax = comp_cm.shape[0] // axis.size
    fm_g = crm.free_mask.cpu().numpy()

    def local(v):  # station-partitioned slice of a global padded vector
        full = np.zeros(part.n_padded)
        full[:v.shape[0]] = v
        lo = axis.rank * part.n_local
        return torch.as_tensor(full[lo:lo + part.n_local], device=dev)

    fm_l = local(fm_g)
    f_l = local(crm.tip_load().cpu().numpy())
    sl = slice(axis.rank * Emax, (axis.rank + 1) * Emax)
    Xe_l = torch.as_tensor(Xe_cm[sl], device=dev)
    me_l = torch.as_tensor(me_cm[sl], device=dev)
    dofs_l = torch.as_tensor(dofs_cm[sl], device=dev)
    comp_cm = torch.as_tensor(comp_cm, device=dev)
    mm = me_l[:, :, None] * me_l[:, None, :]

    def assemble(t_l):
        Ke, Me = shell_element_matrices(Xe_l, t_l, E=crm.E, nu=crm.nu,
                                        rho=crm.rho)
        return (GridHaloOperator(Ke * mm, dofs_l, part, axis),
                GridHaloOperator(Me * mm, dofs_l, part, axis))

    def factor_fn(A, B, sig, mode):
        assert mode == "normal"
        return StationSchurFactor.build(A.mats - sig * B.mats, dofs_l, part,
                                        axis)

    if v0_local is None:
        g = torch.Generator().manual_seed(12345)
        v0 = 2.0 * torch.rand(part.n_local, generator=g,
                              dtype=torch.float64) - 1.0
    else:
        v0 = torch.as_tensor(np.asarray(v0_local), dtype=torch.float64)
    v0 = v0.to(dev) * fm_l
    problem = EigProblem(assemble=assemble, factor=factor_fn,
                         v0=lambda te: v0)
    cfg = EighGenConfig(N=N, m=m, sigma=0.0,
                        adjoint_method=crm.cfg.adjoint_method,
                        adjoint_maxiter=adjoint_maxiter, nrestart=nrestart,
                        eig_atol=crm.cfg.eig_atol, axis=axis,
                        polish=crm.cfg.polish)

    def objective(tcomp):
        t_l = shard(tcomp[comp_cm], axis, Emax)
        lam, Q = eigh_gen(t_l, problem, cfg)
        vals = psum(f_l @ Q, axis)  # (N,) modal load participation
        return torch.sum(vals ** 2 / lam)

    return objective, crm, axis, part
