"""Rank functions of the sharded solve, for ``launch.run``.

Each is called as ``fn(axis, ...)`` on every rank and returns what rank
0's caller needs (numpy arrays and floats; replicated values are the same
on every rank). They live in the package so that a spawned rank can
import them: the tests, ``chip_smoke.py`` and ``graft_entry`` launch them.

* ``collectives`` - psum, ppermute, all_gather and shard on the axis, with
  their backward passes and ppermute's forward-mode rule;
* ``ops`` - the sharded operators and factors applied to given global
  inputs, the results gathered back to the global layout;
  ``stencil_gradient`` - the sharded stencil matvec's gradient;
* ``placement`` - the device and backend a rank was given;
* ``objective`` / ``families`` - a sharded objective's value and gradient
  at a design point, with central differences along a direction.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops import collective as col
from ..ops import sync


def _sync(axis):
    if axis.device.type == "cuda":
        torch.cuda.synchronize(axis.device)


def collectives(axis, staged=False):
    """Each collective and its derivatives on a small seeded input; returns
    what rank 0 and the others saw, for the caller to hold against the
    definitions. ``staged=True`` runs them as a staged axis does (gloo
    with CUDA tensors: ppermute through host buffers), on any device."""
    axis.staged = axis.staged or staged
    r, n = axis.rank, axis.size
    dev = axis.device
    x = torch.arange(6, dtype=torch.float64, device=dev) + 10.0 * r
    out = {"rank": r, "size": n, "backend": axis.backend,
           "staged": axis.staged}

    xs = x.clone().requires_grad_(True)
    s = col.psum(xs, axis)
    (gs,) = torch.autograd.grad(torch.sum(s * s), xs)
    out["psum"], out["psum_grad"] = s.detach(), gs

    perm = [(d, (d + 1) % n) for d in range(n)]
    xp = x.clone().requires_grad_(True)
    y = col.ppermute(xp, axis, perm)
    wgt = torch.arange(1.0, 7.0, dtype=torch.float64, device=dev) * (r + 1)
    (gp,) = torch.autograd.grad(torch.sum(wgt * y), xp)
    out["ppermute"], out["ppermute_grad"] = y.detach(), gp
    part = [(d, d + 1) for d in range(n - 1)]
    out["ppermute_open"] = col.ppermute(x, axis, part)
    _, tan = torch.func.jvp(lambda v: col.ppermute(v, axis, perm), (x,),
                            (2.0 * x,))
    out["ppermute_jvp"] = tan

    # two exchanges in one batch: x forward around the ring, 2x backward
    back = [(d, (d - 1) % n) for d in range(n)]
    xm = x.clone().requires_grad_(True)
    a, b = col.ppermute_multi([(xm, perm), (2.0 * xm, back)], axis)
    (gm,) = torch.autograd.grad(torch.sum(wgt * (a + b)), xm)
    out["ppermute_multi"], out["ppermute_multi_grad"] = (
        torch.stack([a, b]).detach(), gm)
    _, tan = torch.func.jvp(lambda v: torch.stack(col.ppermute_multi(
        [(v, perm), (v, back)], axis)), (x,), (2.0 * x,))
    out["ppermute_multi_jvp"] = tan

    # pvary: a replicated input read with rank-dependent weights
    xr = torch.arange(6, dtype=torch.float64, device=dev).requires_grad_(True)
    (gv,) = torch.autograd.grad(
        col.psum(torch.sum(wgt * col.pvary(xr, axis)), axis), xr)
    out["pvary_grad"] = gv

    xg = x[:2].clone().requires_grad_(True)
    g = col.all_gather(xg, axis)
    (gg,) = torch.autograd.grad(torch.sum(g * g), xg)
    out["all_gather"], out["all_gather_grad"] = g.detach(), gg

    full = torch.arange(3 * n, dtype=torch.float64,
                        device=dev).requires_grad_(True)
    sh = col.shard(full, axis, 3)
    val = col.psum(torch.sum(sh ** 2), axis) * (1.0 + full[0])
    (gf,) = torch.autograd.grad(val, full)
    out["shard"], out["shard_grad"], out["shard_value"] = (
        sh.detach(), gf, val.detach())
    return out


def placement(axis):
    """Where the launcher put this rank: its device, backend, rank and
    world size, and a psum of ones over the group."""
    one = torch.ones((), dtype=torch.float64, device=axis.device)
    return {"device": str(axis.device), "backend": axis.backend,
            "rank": axis.rank, "size": axis.size,
            "psum": float(col.psum(one, axis))}


def stencil_gradient(axis, W_rep, x, w, part):
    """psum(<w, sharded_stencil_matvec(W_rep, x)>) on the line partition
    ``part`` (x and w: the rank's lines) and its gradient in the
    replicated stencil and in x: (value, grad W_rep, grad x)."""
    from .mgshard import sharded_stencil_matvec

    W = W_rep.detach().clone().requires_grad_(True)
    xr = x.detach().clone().requires_grad_(True)
    y = sharded_stencil_matvec(W, xr, part.L, part.nlines, part.ny,
                               part.ndof, axis)
    val = col.psum(torch.sum(w * y), axis)
    gW, gx = torch.autograd.grad(val, (W, xr))
    return val.detach(), gW, gx


def _spmd_inputs(inputs, axis):
    dev = axis.device
    return {k: (torch.as_tensor(v, device=dev) if isinstance(v, np.ndarray)
                else v) for k, v in inputs.items()}


def ops(axis, inputs):
    """The sharded operators on global inputs.

    inputs (numpy arrays and GridPartitions of axis.size ranks): ``part``
    with ``mats_cm`` (its padded column-major element matrices),
    ``shifted_cm`` (those of an SPD shifted operator), ``dofs_l`` (the
    local DOF map) and ``xp`` (an (n_padded, k) padded block);
    ``mg_part`` with ``W_rep`` (its line-padded stencil), ``xmg`` (a
    padded fine block), ``wmg`` (a padded weight block of xmg's shape)
    and ``xmg_c`` (a coarse one); ``crm_part`` with
    ``crm_mats_cm``, ``crm_dofs_cm`` (``sharded.station_buckets``' slots)
    and ``crm_x``; ``R``, a tall block whose rows the ranks share; and
    ``emv_mats``, ``emv_dofs``, ``emv_n``, ``emv_x``, ``emv_w``, an
    unstructured element operator, a vector and a weight. Returns each
    result gathered to the global (padded) layout, and the replicated ones
    as they are; for the stencil and the element matvec also the
    gradients of the weighted sum of the product in the operator and in
    the vector.
    """
    from .mgshard import (ShardedGridMGFactor, sharded_prolong,
                          sharded_restrict, sharded_stencil_matvec)
    from .sharded import (GridHaloOperator, SchwarzPCGFactor,
                          StationSchurFactor, pad_elements,
                          sharded_element_matvec)

    t = _spmd_inputs(inputs, axis)
    r = axis.rank
    out = {}

    def rows(a, n_local):
        return a[r * n_local:(r + 1) * n_local]

    def gather(y):
        return col.all_gather(y, axis)

    part = t["part"]
    el = part.elems_local
    x_l = rows(t["xp"], part.n_local)
    op = GridHaloOperator(rows(t["mats_cm"], el), t["dofs_l"], part, axis)
    out["halo_mv"] = gather(op.mv(x_l))
    out["halo_mv_vec"] = gather(op.mv(x_l[:, 0]))
    fac = SchwarzPCGFactor.build(rows(t["shifted_cm"], el), t["dofs_l"],
                                 part, axis, maxiter=200, tol=1e-13)
    out["schwarz_mv"] = gather(fac.mv(x_l[:, 0]))

    mp = t["mg_part"]
    L, ny, nd = mp.L, mp.ny, mp.ndof
    xm = rows(t["xmg"], mp.n_local)
    out["stencil_mv"] = gather(sharded_stencil_matvec(
        t["W_rep"], xm, L, mp.nlines, ny, nd, axis))
    _, gW, gx = stencil_gradient(axis, t["W_rep"], xm,
                                 rows(t["wmg"], mp.n_local), mp)
    out["stencil_mv_grad_W"], out["stencil_mv_grad_x"] = gW, gather(gx)
    out["restrict"] = gather(sharded_restrict(xm, L, ny, nd, axis))
    nc = (L // 2) * (ny // 2 + 1) * nd
    xc = rows(t["xmg_c"], nc)
    out["prolong"] = gather(sharded_prolong(xc, L // 2, ny // 2, nd, axis,
                                            mp.nlines))
    mg = ShardedGridMGFactor.build(rows(t["W_rep"], L), mp, axis,
                                   shard_levels=2)
    out["mg_mv"] = gather(mg.mv(xm[:, 0]))

    cp = t["crm_part"]
    Emax = t["crm_dofs_cm"].shape[0] // axis.size
    ss = StationSchurFactor.build(rows(t["crm_mats_cm"], Emax),
                                  rows(t["crm_dofs_cm"], Emax), cp, axis)
    out["station_mv"] = gather(ss.mv(rows(t["crm_x"], cp.n_local)))

    Rl = rows(t["R"], t["R"].shape[0] // axis.size)
    Q, Rr = col.qr_tall(Rl, axis)
    out["qr_Q"], out["qr_R"] = gather(Q), Rr

    mats, dofs = pad_elements([t["emv_mats"], t["emv_dofs"]], axis.size)
    mats = mats.clone().requires_grad_(True)
    x = t["emv_x"].clone().requires_grad_(True)
    y = sharded_element_matvec(axis, mats, dofs, int(t["emv_n"]))(x)
    gx, gm = torch.autograd.grad(torch.sum(t["emv_w"] * y), (x, mats))
    out["element_mv"] = y.detach()
    out["element_mv_grad_x"], out["element_mv_grad_mats"] = gx, gm
    return out


def build(axis, family, kwargs):
    """(objective, x0 default) of a sharded family: "nf", "thermal",
    "buckling" or "crm"."""
    from . import sharded as sh

    makers = {"nf": sh.make_sharded_objective,
              "thermal": sh.make_sharded_thermal_objective,
              "buckling": sh.make_sharded_buckling_objective,
              "crm": sh.make_sharded_crm_objective}
    obj, model, _, part = makers[family](axis, **kwargs)
    if family == "crm":
        x0 = model.x
    else:
        nv = model.num_design_vars
        base = 0.6 if family == "buckling" else 0.8
        amp = 0.05 if family == "buckling" else 0.1
        x0 = base + amp * torch.sin(torch.arange(
            nv, dtype=torch.float64, device=axis.device))
    return obj, x0, part


def objective(axis, family, kwargs, x0=None, pert=None, h=None,
              richardson=False):
    """Value and gradient of a sharded family's objective at x0 (default:
    the tests' design point), timed; with ``pert`` and ``h`` also the
    central difference of the value along pert (``richardson``: the
    Richardson-4 combination of steps h and 2h)."""
    from ..ops import cuda_stencil as cs

    obj, x_def, part = build(axis, family, kwargs)
    x = (x_def if x0 is None else torch.as_tensor(
        np.asarray(x0), dtype=torch.float64, device=axis.device))
    sync.clear()
    k1, k2 = cs.K1_LAUNCHES, cs.K2_LAUNCHES
    xv = x.detach().clone().requires_grad_(True)
    _sync(axis)
    t0 = time.perf_counter()
    val = obj(xv)
    _sync(axis)
    t1 = time.perf_counter()
    (g,) = torch.autograd.grad(val, xv)
    _sync(axis)
    t2 = time.perf_counter()
    out = {"value": float(val.detach()), "grad": g, "x0": x.detach(),
           "value_s": t1 - t0, "grad_s": t2 - t1,
           "host_syncs": dict(sync.HOST_SYNCS),
           "loop_exits": dict(sync.LOOP_EXITS),
           "launches": {"K1": cs.K1_LAUNCHES - k1, "K2": cs.K2_LAUNCHES - k2},
           "n_padded": part.n_padded, "ranks": axis.size,
           "backend": axis.backend, "staged": axis.staged}
    if pert is not None:
        p = torch.as_tensor(np.asarray(pert), dtype=torch.float64,
                            device=axis.device)
        with torch.no_grad():
            def f(s):
                return float(obj(x + s * p))

            if richardson:
                d1 = (f(h) - f(-h)) / (2 * h)
                d2 = (f(2 * h) - f(-2 * h)) / (4 * h)
                out["fd"] = (4.0 * d1 - d2) / 3.0
            else:
                out["fd"] = (f(h) - f(-h)) / (2 * h)
        out["directional"] = float(p @ g)
    return out


def families(axis, specs):
    """``objective`` for each (family, kwargs, options) of ``specs`` in
    one launch; the list of results."""
    return [objective(axis, fam, kw, **opts) for fam, kw, opts in specs]


def serial_nf_objective(nx, ny, N, m, device="cuda"):
    """The serial twin of ``sharded.make_sharded_objective`` at its
    defaults (sigma -10, qweight 1e-3; the reference of
    tests/test_sharding.py's ``_serial_objective``): element operators on
    the whole grid, the f64 cyclic-reduction factor of the line blocks,
    the rigid modes deflated, SIBK, and the same objective. Returns
    (objective, fltr)."""
    from ..fem import assembly as fem
    from ..fem.filter import NodeFilter
    from ..fem.model import make_grid
    from ..fem.quad import plane_stress_tables
    from ..ops.autodiff import EigProblem, EighGenConfig, eigh_gen
    from ..ops.blockfactor import BCRFactor, grid_block_tridiag

    grid = make_grid(nx, ny, 2.0, 1.0)
    fltr = NodeFilter(grid.conn, grid.X, r0=2.0 / ny, device=device)
    conn = torch.as_tensor(grid.conn, dtype=torch.int64, device=device)
    X = torch.as_tensor(grid.X, dtype=torch.float64, device=device)
    C0 = fem.plane_stress_C0(device=device)
    dofs = fem.element_dof_map(conn)
    Be, He, detJ = plane_stress_tables(X, conn)
    nvars = 2 * grid.nnodes
    sigma, qweight = -10.0, 1e-3

    def assemble(rhoE):
        return (fem.stiffness_matrix(rhoE, Be, detJ, dofs, nvars, C0),
                fem.mass_matrix(rhoE, He, detJ, dofs, nvars))

    def factor_fn(A, B, sig, mode):
        return BCRFactor.from_blocks(*grid_block_tridiag(
            A.mats - sig * B.mats, nx, ny, ndof=2))

    rigid = torch.zeros((3, nvars), dtype=torch.float64, device=device)
    rigid[0, 0::2] = 1.0
    rigid[1, 1::2] = 1.0
    rigid[2, 0::2] = -X[:, 1]
    rigid[2, 1::2] = X[:, 0]
    problem = EigProblem(assemble=assemble, factor=factor_fn,
                         nullspace=lambda th: rigid)
    cfg = EighGenConfig(N=N, m=m, sigma=sigma, adjoint_method="sibk",
                        adjoint_maxiter=40, nrestart=2)
    idx = torch.arange(nvars, device=device)
    line = (idx // (2 * (ny + 1))).to(torch.float64)
    within = (idx % (2 * (ny + 1))).to(torch.float64)
    w = torch.sin(0.37 * line + 0.11 * within)

    def objective(x):
        lam, Q = eigh_gen(fem.element_density(fltr.apply(x), conn), problem,
                          cfg)
        return (-torch.sum(torch.sqrt(lam))
                + qweight * torch.sum((w[:, None] * Q) ** 2))

    return objective, fltr
