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
