"""Parity of the port's multigrid factor with eigd_tpu's, on a 32x16 grid.

The hierarchy build is compared level by level. The V-cycle and the solves
run on JAX's built factor state carried across with
``interop.mg_factor_from_numpy``: the Chebyshev bounds come from a 12-step
power iteration from a random start, which JAX draws from ``PRNGKey(7)``
and the port from a ``torch.Generator``, so bit-level parity of a build is
not expected there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigd_tpu.fem import assembly as jfem
from eigd_tpu.fem.model import make_grid
from eigd_tpu.fem.quad import plane_stress_tables
from eigd_tpu.ops.multigrid import GridMGFactor as JFactor
from eigd_tpu.ops.multigrid import stencil_to_dense as j_to_dense
from eigd_tpu.ops.stencil import stencil_from_elements
from eigd_tpu_torch.interop import mg_factor_from_numpy
from eigd_tpu_torch.ops import multigrid as tmg
from eigd_tpu_torch.ops import sync

torch.set_num_threads(1)
NX, NY = 32, 16


@pytest.fixture(scope="module")
def problem():
    """Shifted plane-stress stencil K - sigma M (sigma = -1, as the bench),
    its dense matrix, and JAX's factor built from it."""
    m = make_grid(NX, NY, 2.0, 1.0)
    conn = jnp.asarray(m.conn)
    Be, He, detJ = plane_stress_tables(jnp.asarray(m.X), conn)
    dofs = jfem.element_dof_map(conn)
    rhoE = jnp.asarray(np.random.default_rng(0).uniform(0.3, 1.0, m.nelems))
    K = jfem.stiffness_matrix(rhoE, Be, detJ, dofs, 2 * m.nnodes,
                              jfem.plane_stress_C0())
    M = jfem.mass_matrix(rhoE, He, detJ, dofs, 2 * m.nnodes)
    W = stencil_from_elements(K.mats + 1.0 * M.mats, NX, NY, 2)
    dense = np.asarray(j_to_dense(W, NX, NY, 2))
    jfac = JFactor.build(W, (NX, NY), 2, min_coarse=64, rtol=1e-12)
    return np.array(W), dense, jfac


def carried(jfac, **kw):
    return mg_factor_from_numpy(
        [np.asarray(w) for w in jfac.Ws], [np.asarray(d) for d in jfac.dinvs],
        [float(v) for v in jfac.lmaxs], np.asarray(jfac.coarse_inv),
        np.asarray(jfac.W64), jfac.shapes, 2, device="cpu", rtol=jfac.rtol,
        **kw)


def test_build_levels_match(problem):
    """Level stencils and Jacobi inverses to f32 rounding (1e-6 of the
    level's max), lambda_max to 5% (different random power-iteration
    starts), and the dense coarse inverse inverts the coarse operator."""
    W, dense, jfac = problem
    tfac = tmg.GridMGFactor.build(torch.as_tensor(W), (NX, NY), 2,
                                  min_coarse=64, rtol=1e-12)
    assert tfac.shapes == jfac.shapes and len(tfac.shapes) >= 3
    for wt, wj in zip(tfac.Ws, jfac.Ws):
        wj = np.asarray(wj)
        assert wt.dtype == torch.float32
        assert np.abs(wt.numpy() - wj).max() <= 1e-6 * np.abs(wj).max()
    for dt, dj in zip(tfac.dinvs, jfac.dinvs):
        dj = np.asarray(dj)
        assert np.abs(dt.numpy() - dj).max() <= 1e-6 * np.abs(dj).max()
    for lt, lj in zip(tfac.lmaxs, jfac.lmaxs):
        assert abs(lt - float(lj)) <= 5e-2 * float(lj)
    Ac = tmg.stencil_to_dense(tfac.Ws[-1], *tfac.shapes[-1], 2)
    np.testing.assert_allclose(
        Ac.numpy(), np.asarray(j_to_dense(jfac.Ws[-1], *jfac.shapes[-1], 2)),
        rtol=0, atol=1e-6 * float(Ac.abs().max()))
    eye = (tfac.coarse_inv.double() @ Ac.double()).numpy()
    assert np.abs(eye - np.eye(eye.shape[0])).max() < 1e-3


@pytest.mark.parametrize("vcycle", ["plain", "kernel"])
def test_vcycle_on_carried_factor(problem, vcycle):
    """One f32 V-cycle of the port (plain vector layout, or the kernel
    variant's plane layout on the K1 twin) against JAX's on the same
    factor state: f32 rounding, 1e-5 of max|ref|."""
    W, dense, jfac = problem
    tfac = carried(jfac, vcycle=vcycle)
    assert tfac.vcycle == vcycle
    b = np.random.default_rng(1).standard_normal((dense.shape[0], 3))
    ref = np.asarray(jfac.precond_mv(jnp.asarray(b)))
    got = tfac.precond_mv(torch.as_tensor(b)).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("vcycle", ["plain", "kernel"])
def test_mv_at_rtol(problem, vcycle):
    """The f64 PCG solve reaches its rtol (1e-12) against the dense matrix
    and agrees with JAX's solve to 1e-10 of max|x| (both solve to rtol; the
    gap is rtol times the operator's conditioning)."""
    W, dense, jfac = problem
    tfac = carried(jfac, vcycle=vcycle)
    b = np.random.default_rng(2).standard_normal((dense.shape[0], 2))
    x, info = tfac.mv_info(torch.as_tensor(b))
    x = x.numpy()
    r = b - dense @ x
    assert (np.linalg.norm(r, axis=0)
            <= 1e-12 * np.linalg.norm(b, axis=0) * 1.01).all()
    assert info["niter"] < tfac.maxiter
    xj = np.asarray(jfac.mv(jnp.asarray(b)))
    assert np.abs(x - xj).max() <= 1e-10 * np.abs(xj).max()


@pytest.mark.parametrize("vcycle", ["plain", "kernel"])
def test_approx_mv_contraction(problem, vcycle):
    """The f32 approx solve contracts the residual as JAX's does: both
    reach approx_rtol (1e-5, within 2x for f32 rounding of the residual
    recurrence), and the sweep channel at rtol 0, run to the f32 floor,
    lands no higher."""
    W, dense, jfac = problem
    tfac = carried(jfac, vcycle=vcycle, approx_rtol=1e-5, approx_maxiter=18,
                   sweep_rtol=0.0, sweep_maxiter=24)
    b = np.random.default_rng(4).standard_normal((dense.shape[0], 3))
    bn = np.linalg.norm(b, axis=0)
    x = tfac.approx_mv(torch.as_tensor(b))
    assert x.dtype == torch.float32
    ct = np.linalg.norm(b - dense @ x.double().numpy(), axis=0) / bn
    xj = np.asarray(jfac.approx_mv(jnp.asarray(b)), dtype=np.float64)
    cj = np.linalg.norm(b - dense @ xj, axis=0) / bn
    assert (ct < 2e-5).all() and (cj < 2e-5).all()
    xs = tfac.sweep_mv(torch.as_tensor(b)).double().numpy()
    cs = np.linalg.norm(b - dense @ xs, axis=0) / bn
    assert cs.max() <= ct.max()


@pytest.mark.parametrize("planes", [False, True])
def test_transfers_match(planes):
    """Bilinear prolongation and full-weighting restriction (vector and
    plane layouts) against eigd_tpu's, and their adjointness: 1e-14."""
    from eigd_tpu.ops import multigrid as jmg

    nxc, nyc, nd, k = 6, 4, 2, 3
    rng = np.random.default_rng(5)
    xc = rng.standard_normal(((nxc + 1) * (nyc + 1) * nd, k))
    yf = rng.standard_normal(((2 * nxc + 1) * (2 * nyc + 1) * nd, k))
    if planes:
        xc = xc.reshape(nxc + 1, nyc + 1, nd, k).transpose(2, 3, 0, 1).copy()
        yf = yf.reshape(2 * nxc + 1, 2 * nyc + 1, nd, k).transpose(
            2, 3, 0, 1).copy()
        jp, jr = jmg.prolong_planes, jmg.restrict_planes
        tp, tr = tmg.prolong_planes, tmg.restrict_planes
        args = (nxc, nyc)
    else:
        jp, jr, tp, tr = jmg.prolong, jmg.restrict, tmg.prolong, tmg.restrict
        args = (nxc, nyc, nd)
    pf = tp(torch.as_tensor(xc), *args).numpy()
    rc = tr(torch.as_tensor(yf), *args).numpy()
    np.testing.assert_allclose(pf, np.asarray(jp(jnp.asarray(xc), *args)),
                               rtol=0, atol=1e-14)
    np.testing.assert_allclose(rc, np.asarray(jr(jnp.asarray(yf), *args)),
                               rtol=0, atol=1e-14)
    assert abs(np.sum(pf * yf) - np.sum(xc * rc)) <= 1e-12 * abs(
        np.sum(pf * yf))


def test_f32_factor_solve(problem):
    """A factor built from an f32 stencil (no f64 outer residual) solves in
    f32 to its floor-clamped rtol (1e-6) on both V-cycle variants; measured
    in f64, the residual of the f32 solution lands at 2.3e-6, the f32
    precision of x times the conditioning, so the bound is 1e-5."""
    W, dense, jfac = problem
    b = np.random.default_rng(6).standard_normal((dense.shape[0], 2))
    for vcycle in ("plain", "kernel"):
        fac = tmg.GridMGFactor.build(torch.as_tensor(W, dtype=torch.float32),
                                     (NX, NY), 2, min_coarse=64, rtol=1e-12,
                                     vcycle=vcycle)
        assert fac.W64 is None and fac.dtype == torch.float32
        x, info = fac.mv_info(torch.as_tensor(b))
        assert x.dtype == torch.float32 and info["niter"] < fac.maxiter
        r = b - dense @ x.double().numpy()
        assert (np.linalg.norm(r, axis=0)
                <= 1e-5 * np.linalg.norm(b, axis=0)).all()


# The flexible PCG loops as they stood before ``flexible_pcg`` replaced
# them (``GridMGFactor._pcg`` and ``_pcg_planes``), kept as oracles: the
# one loop must return their x, residuals, step count and exit bitwise.

def _oracle_exit(fac, r2, tol2, bad):
    unconverged, fresh = torch.stack(
        [torch.any(r2 > tol2), bad < fac.stag_bad]).tolist()
    if unconverged and fresh:
        return None
    return "stagnated" if unconverged else "converged"


def _oracle_pcg(fac, bb, matvec, rtol, maxiter, x0=None):
    dtype = bb.dtype

    def M(r):
        z = fac._apply_vcycle32(r).to(dtype)
        rz = torch.sum(r * z, dim=0)
        ok = rz > 0.0
        return (torch.where(ok[None, :], z, r),
                torch.where(ok, rz, torch.sum(r * r, dim=0)))

    b2 = torch.sum(bb * bb, dim=0)
    tol2 = (rtol * rtol) * torch.clamp(b2, min=1e-300)
    x = M(bb)[0] if x0 is None else x0.to(dtype)
    r = bb - matvec(x)
    z, rz = M(r)
    p = z
    r2 = torch.sum(r * r, dim=0)
    best = torch.sum(r2)
    bad = torch.zeros((), dtype=torch.int64, device=bb.device)
    k = 0
    while k < maxiter:
        why = _oracle_exit(fac, r2, tol2, bad)
        if why:
            break
        Ap = matvec(p)
        pAp = torch.sum(p * Ap, dim=0)
        active = (r2 > tol2).to(dtype)
        pos = pAp > 0
        alpha = torch.where(pos, rz / torch.where(pos, pAp, 1.0),
                            0.0) * active
        x = x + p * alpha[None, :]
        r_new = r - Ap * alpha[None, :]
        z, rz_new = M(r_new)
        rz_flex = rz_new - torch.sum(r * z, dim=0)
        nz = rz != 0.0
        beta = torch.where(nz, rz_flex / torch.where(nz, rz, 1.0), 0.0)
        p = z + p * beta[None, :]
        r2 = torch.sum(r_new * r_new, dim=0)
        improving = torch.sum(r2) < 0.9 * best
        bad = torch.where(improving, 0, bad + 1)
        best = torch.minimum(best, torch.sum(r2))
        r, rz = r_new, rz_new
        k += 1
    else:
        why = "maxiter"
    return x, k, r2, why


def _oracle_pcg_planes(fac, bb, rtol, maxiter):
    from eigd_tpu_torch.ops import cuda_stencil

    nx, ny = fac.shapes[0]
    nd = fac.ndof
    bq = cuda_stencil.to_planes(bb, nx, ny, nd)

    def mv(xq):
        return cuda_stencil.matvec_planes(fac.Wps[0], xq, nx, ny, nd)

    def col_sum(pq, qq):
        return torch.sum(pq * qq, dim=(0, 2, 3))

    def M(rq):
        zq = fac._vcycle_planes(0, rq)
        rz = col_sum(rq, zq)
        ok = rz > 0.0
        return (torch.where(ok[None, :, None, None], zq, rq),
                torch.where(ok, rz, col_sum(rq, rq)))

    b2 = col_sum(bq, bq)
    tol2 = (rtol * rtol) * torch.clamp(b2, min=1e-300)
    x, _ = M(bq)
    r = bq - mv(x)
    z, rz = M(r)
    p = z
    r2 = col_sum(r, r)
    best = torch.sum(r2)
    bad = torch.zeros((), dtype=torch.int64, device=bb.device)
    k = 0
    while k < maxiter:
        why = _oracle_exit(fac, r2, tol2, bad)
        if why:
            break
        Ap = mv(p)
        pAp = col_sum(p, Ap)
        active = (r2 > tol2).to(torch.float32)
        pos = pAp > 0
        alpha = torch.where(pos, rz / torch.where(pos, pAp, 1.0),
                            0.0) * active
        x = x + p * alpha[None, :, None, None]
        r_new = r - Ap * alpha[None, :, None, None]
        z, rz_new = M(r_new)
        rz_flex = rz_new - col_sum(r, z)
        nz = rz != 0.0
        beta = torch.where(nz, rz_flex / torch.where(nz, rz, 1.0), 0.0)
        p = z + p * beta[None, :, None, None]
        r2 = col_sum(r_new, r_new)
        improving = torch.sum(r2) < 0.9 * best
        bad = torch.where(improving, 0, bad + 1)
        best = torch.minimum(best, torch.sum(r2))
        r, rz = r_new, rz_new
        k += 1
    else:
        why = "maxiter"
    return cuda_stencil.from_planes(x, nx, ny, nd), k, r2, why


# (maxiter, the factor's lambda_max scale) of each exit: Chebyshev smoothers
# tuned to 0.6 of lambda_max amplify the top of the spectrum, and the
# V-cycle stops being a convergent preconditioner
EXITS = {"converged": (60, 1.0), "stagnated": (60, 0.6),
         "maxiter": (3, 1.0)}


def _count_guard(fac, name):
    """Wrap the factor's V-cycle entry ``name`` (r last among its
    arguments) so that it counts the columns whose r.z is not positive,
    the columns where the loop's descent guard takes r for z."""
    inner = getattr(fac, name)
    fired = [0]

    def wrapped(*args):
        r = args[-1]
        z = inner(*args)
        dims = tuple(d for d in range(r.ndim) if d != 1)
        fired[0] += int((torch.sum(r * z.to(r.dtype), dim=dims) <= 0).sum())
        return z

    setattr(fac, name, wrapped)
    return fired


@pytest.fixture(scope="module")
def built_factor(problem):
    """The port's factor of ``problem``'s stencil, its lambda_max estimates
    drawn from a seeded generator."""
    return tmg.GridMGFactor.build(torch.as_tensor(problem[0]), (NX, NY), 2,
                                  min_coarse=64,
                                  generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("variant,vcycle", [
    ("f64", "plain"), ("f64", "kernel"), ("f64_x0", "plain"),
    ("f64_x0", "kernel"), ("f32", "plain"), ("f32", "kernel"),
    ("f32_planes", "kernel")])
@pytest.mark.parametrize("exit_", list(EXITS))
def test_flexible_pcg_bitwise_as_the_loops_it_replaced(problem, built_factor,
                                                       variant, vcycle, exit_):
    """``flexible_pcg`` through the factor's vector entry point (f64, f64
    warm-started, f32) and its plane entry point (f32 planes, kernel
    variant) against the loops it replaced: x and the final squared
    residuals bitwise, the same step count, the same exit, counted once at
    the loop's site. The stagnating V-cycle trips the descent guard, and
    only it: the guard's counted firings are held to that."""
    W, dense, _ = problem
    maxiter, scale = EXITS[exit_]
    f = built_factor
    fac = tmg.GridMGFactor(f.Ws, f.dinvs, [scale * v for v in f.lmaxs],
                           f.coarse_inv, f.W64, f.shapes, 2, vcycle=vcycle)
    fired = _count_guard(fac, "_vcycle_planes" if variant == "f32_planes"
                         else "_apply_vcycle32")
    rt64, rt32 = 1e-10, 1e-5
    b = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (dense.shape[0], 3)))
    sync.clear()
    if variant == "f32_planes":
        b = b.float()
        x, info = fac._pcg32(b, rt32, maxiter)
        fired_port = fired[0]
        ref = _oracle_pcg_planes(fac, b, rt32, maxiter)
        site = "pcg_f32_planes"
    elif variant == "f32":
        b = b.float()
        x, info = fac._pcg(b, fac._matvec32, rt32, maxiter)
        fired_port = fired[0]
        ref = _oracle_pcg(fac, b, fac._matvec32, rt32, maxiter)
        site = "pcg_f32"
    else:
        x0 = 0.5 * b if variant == "f64_x0" else None
        x, info = fac._pcg(b, fac._matvec64, rt64, maxiter, x0=x0)
        fired_port = fired[0]
        ref = _oracle_pcg(fac, b, fac._matvec64, rt64, maxiter, x0=x0)
        site = "pcg_f64"
    xr, kr, r2r, why = ref
    assert why == exit_
    assert torch.equal(x, xr) and torch.equal(info["res2"], r2r)
    assert info["niter"] == kr
    assert dict(sync.LOOP_EXITS) == {f"{site}.{why}": 1}
    assert sync.LOOP_STEPS[site] == kr
    assert sync.HOST_SYNCS[site] == kr + (why != "maxiter")
    assert (fired_port > 0) == (exit_ == "stagnated")
