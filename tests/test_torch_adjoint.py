"""Parity of the port's adjoint solvers with eigd_tpu's.

Both sides start from the same forward solve: JAX's block-Lanczos result
on a 16x8 plane-stress pencil and its multigrid factor, carried across as
numpy arrays. The mixed-ladder SIBK must solve the adjoint equations to a
residual of 1e-9 relative, as tests/test_adjoint.py requires of eigd_tpu.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigd_tpu.fem import assembly as jfem
from eigd_tpu.fem.model import make_grid
from eigd_tpu.fem.quad import plane_stress_tables
from eigd_tpu.ops import adjoint as jadj
from eigd_tpu.ops.lanczos import b_orthonormalize_rows as j_bortho
from eigd_tpu.ops.lanczos import block_lanczos_solve as j_solve
from eigd_tpu.ops.multigrid import GridMGFactor as JFactor
from eigd_tpu.ops.operators import ElementOperator as JElementOperator
from eigd_tpu.ops.stencil import GridStencilOperator as JGrid
from eigd_tpu_torch.interop import (mg_factor_from_numpy,
                                    stencil_operator_from_numpy)
from eigd_tpu_torch.ops import adjoint as tadj
from eigd_tpu_torch.ops.lanczos import LanczosResult

torch.set_num_threads(1)
NX, NY, N, P, SIGMA = 16, 8, 4, 4, -1.0


def t(a):
    return None if a is None else torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def solved():
    m = make_grid(NX, NY, 2.0, 1.0)
    conn = jnp.asarray(m.conn)
    Be, He, detJ = plane_stress_tables(jnp.asarray(m.X), conn)
    dofs = jfem.element_dof_map(conn)
    rhoE = jnp.asarray(np.random.default_rng(0).uniform(0.3, 1.0, m.nelems))
    n = 2 * m.nnodes
    K = jfem.stiffness_matrix(rhoE, Be, detJ, dofs, n, jfem.plane_stress_C0())
    M = jfem.mass_matrix(rhoE, He, detJ, dofs, n)
    Aj, Bj = (JGrid.from_element_operator(JElementOperator(E.mats, dofs, n),
                                          (NX, NY), 2) for E in (K, M))
    fj = JFactor.build(Aj.W - SIGMA * Bj.W, (NX, NY), 2, min_coarse=64,
                       approx_rtol=1e-5, approx_maxiter=18)
    U0 = np.zeros((3, n))
    U0[0, 0::2] = 1.0
    U0[1, 1::2] = 1.0
    U0[2, 0::2] = -m.X[:, 1]
    U0[2, 1::2] = m.X[:, 0]
    v0 = np.random.default_rng(5).uniform(-1.0, 1.0, (n, P))
    rj = j_solve(Aj, Bj, fj, SIGMA, N, 64, P, v0=jnp.asarray(v0),
                 deflate=j_bortho(jnp.asarray(U0), Bj.mv), ortho="local",
                 polish=1)
    At, Bt = (stencil_operator_from_numpy(np.asarray(o.W), None, None, n,
                                          (NX, NY), 2, device="cpu")
              for o in (Aj, Bj))
    ft = mg_factor_from_numpy(
        [np.asarray(w) for w in fj.Ws], [np.asarray(d) for d in fj.dinvs],
        [float(v) for v in fj.lmaxs], np.asarray(fj.coarse_inv),
        np.asarray(fj.W64), fj.shapes, 2, device="cpu", approx_rtol=1e-5,
        approx_maxiter=18)
    rt = LanczosResult(**{f: t(getattr(rj, f)) for f in (
        "lam", "Phi", "V", "BV", "alpha", "beta", "H", "theta", "Y", "order",
        "lam_all", "eig_res", "sigma")}, niter=int(rj.niter))
    Phib = np.random.default_rng(1).standard_normal((n, N))
    return (Aj, Bj, fj, rj), (At, Bt, ft, rt), Phib


@pytest.mark.parametrize("approx", [False, True])
def test_laa_matches(solved, approx):
    """LAA guess on the same Lanczos state: the accurate apply (rtol 1e-13)
    agrees to 1e-9 of max|psi|; the f32 approx apply to 1e-4 (approx_rtol
    1e-5 solves whose f32 rounding differs between XLA and torch)."""
    (Aj, Bj, fj, rj), (At, Bt, ft, rt), Phib = solved
    pj = np.asarray(jadj.laa(jnp.asarray(Phib), Bj, fj, rj, b_ortho=True,
                             approx=approx))
    pt = tadj.laa(t(Phib), Bt, ft, rt, b_ortho=True, approx=approx).numpy()
    tol = 1e-4 if approx else 1e-9
    assert np.abs(pt - pj).max() <= tol * np.abs(pj).max()


def _sibk_both(solved, ladder):
    (Aj, Bj, fj, rj), (At, Bt, ft, rt), Phib = solved
    kw = dict(sigma=SIGMA, rtol=1e-11, maxiter=30, nrestart=8, mixed=True,
              ladder=ladder)
    psi0 = jadj.laa(jnp.asarray(Phib), Bj, fj, rj, b_ortho=True)
    pj, dj, ij = jadj.sibk(jnp.asarray(Phib), Aj, Bj, rj.lam, rj.Phi,
                           psi=psi0, factor=fj, **kw)
    pt, dt, it = tadj.sibk(t(Phib), At, Bt, rt.lam, rt.Phi, psi=t(psi0),
                           factor=ft, **kw)
    return (np.asarray(pj), dj, ij), (pt, dt, it)


def test_sibk_mixed_solves_adjoint(solved):
    """Mixed approx-ladder SIBK (the bench's): the port's adjoint residual
    is at most 1e-9 of ||Phib||, and psi agrees with JAX's to 1e-9 of
    max|psi| (both meet rtol 1e-11 on the true f64 residual; measured
    1.3e-12 apart)."""
    (At, Bt, ft, rt), Phib = solved[1], solved[2]
    (pj, dj, ij), (pt, dt, it) = _sibk_both(solved, "approx")
    scale = float(np.sqrt(np.max(np.sum(Phib**2, axis=0))))
    r, _ = tadj.eval_adjoint_residual_norm(At, Bt, rt.lam, rt.Phi, t(Phib),
                                           pt, b_ortho=True)
    assert float(r.max()) / scale <= 1e-9
    assert float(it["res"].max()) <= 1e-9
    assert np.abs(pt.numpy() - pj).max() <= 1e-9 * np.abs(pj).max()
    np.testing.assert_array_equal(dt.Xi.numpy(), np.asarray(dj.Xi))


def test_sibk_precond_ladder_matches(solved):
    """Mixed precond ladder (one raw V-cycle per step): on this pencil both
    packages stop on the round-stagnation gate at the same residual (about
    2e-3 of ||Phib||, to 1e-5 of it: measured 1.2e-6); psi agrees to 1e-6
    of max|psi| (measured 9e-8: the f32 V-cycle rounding of an unconverged
    iterate)."""
    (pj, dj, ij), (pt, dt, it) = _sibk_both(solved, "precond")
    rj_, rt_ = np.asarray(ij["res"]), it["res"].numpy()
    assert np.abs(rt_ - rj_).max() <= 1e-5 * np.abs(rj_).max()
    assert np.abs(pt.numpy() - pj).max() <= 1e-6 * np.abs(pj).max()


@pytest.mark.parametrize("gap", [1.0, 1e-7, 0.0])
def test_corrections_and_weights_match(gap):
    """Repeated-eigenvalue corrections and total-derivative weights on
    random data, distinct and (near-)repeated pairs: 1e-12 relative."""
    rng = np.random.default_rng(2)
    n = 40
    lam = np.array([1.0, 1.0 + gap, 2.5])
    Phi, Phib, psi = (rng.standard_normal((n, 3)) for _ in range(3))
    lamb = rng.standard_normal(3)
    pj, cj = jadj.generate_adjoint_correction(
        jnp.asarray(lam), jnp.asarray(Phi), jnp.asarray(psi),
        Phib=jnp.asarray(Phib))
    pt, ct = tadj.generate_adjoint_correction(t(lam), t(Phi), t(psi),
                                              Phib=t(Phib))
    for a, b in ((pt, pj), (ct.Xi, cj.Xi), (ct.Eta, cj.Eta)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-12 * max(np.abs(b).max(),
                                                          1.0)
    wj = jadj.total_derivative_weights(jnp.asarray(lam), jnp.asarray(Phi),
                                       jnp.asarray(lamb), jnp.asarray(Phib),
                                       pj, adj_corr_data=cj)
    wt = tadj.total_derivative_weights(t(lam), t(Phi), t(lamb), t(Phib), pt,
                                       adj_corr_data=ct)
    for a, b in zip(wt, wj):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-12 * np.abs(b).max()
    assert tadj.are_eigenvalues_repeated(t(lam)) == bool(
        jadj.are_eigenvalues_repeated(jnp.asarray(lam)))


def test_lstsq_and_true_resnorm_match(solved):
    """The shifted least-squares helper (random data) and the SIBK restart
    residual norms (same psi) against eigd_tpu: 1e-12 relative."""
    (Aj, Bj, fj, rj), (At, Bt, ft, rt), Phib = solved
    rng = np.random.default_rng(6)
    H0, r = rng.standard_normal((12, 8)), rng.standard_normal(12)
    yj, nj = jadj._solve_shifted_lstsq(0.3, jnp.asarray(H0), jnp.asarray(r))
    yt, nt = tadj._solve_shifted_lstsq(0.3, t(H0), t(r))
    assert np.abs(yt.numpy() - np.asarray(yj)).max() <= 1e-12 * np.abs(
        np.asarray(yj)).max()
    assert abs(float(nt) - float(nj)) <= 1e-12 * abs(float(nj))
    psi = rng.standard_normal(Phib.shape)
    ref = np.asarray(jadj.sibk_true_resnorm(jnp.asarray(Phib), Aj, Bj,
                                            rj.lam, rj.Phi,
                                            jnp.asarray(psi)))
    got = tadj.sibk_true_resnorm(t(Phib), At, Bt, rt.lam, rt.Phi,
                                 t(psi)).numpy()
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


# ---------------------------------------------------------------------------
# DL: the reverse sweep through the single-vector chain
# ---------------------------------------------------------------------------


def _make_pencil(n, seed):
    """The pencil of tests/test_adjoint.py: eigenvalues 1..10^1.5 then
    100-300, congruent to a B near the identity."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    w = np.concatenate([np.arange(1.0, 11.0) ** 1.5,
                        np.linspace(100.0, 300.0, n - 10)])
    Bm = rng.standard_normal((n, n)) * 0.05
    Bm = Bm @ Bm.T + np.eye(n)
    L = np.linalg.cholesky(Bm)
    A = L @ (Q @ np.diag(w) @ Q.T) @ L.T
    return 0.5 * (A + A.T), Bm


def test_dl_gradient_matches_jax_on_the_pencil():
    """eigh_gen with adjoint_method="dl" on the pencil of
    tests/test_adjoint.py (n 80, N 4, m 40, where the wanted modes just
    converge), x entering A0 + diag x and B0 + 0.02 diag x, both packages
    from one start vector: the gradient of sum(log lam) + sum(Phi[:7]^2)
    against jax.grad through JAX's dl at 1e-10 of max|g|."""
    from eigd_tpu.ops.autodiff import EigProblem as JProblem
    from eigd_tpu.ops.autodiff import EighGenConfig as JConfig
    from eigd_tpu.ops.autodiff import eigh_gen as j_eigh_gen
    from eigd_tpu.ops.operators import DenseOperator as JDense
    from eigd_tpu_torch.ops.autodiff import EigProblem, EighGenConfig, eigh_gen
    from eigd_tpu_torch.ops.operators import DenseOperator

    n = 80
    A0, B0 = _make_pencil(n, 3)
    v0 = np.random.default_rng(4).uniform(-1.0, 1.0, n)
    x0 = 0.05 * np.random.default_rng(4).standard_normal(n)
    kw = dict(N=4, m=40, sigma=0.0, adjoint_method="dl")

    jp = JProblem(assemble=lambda x: (JDense(jnp.asarray(A0) + jnp.diag(x)),
                                      JDense(jnp.asarray(B0)
                                             + 0.02 * jnp.diag(x))),
                  v0=lambda x: jnp.asarray(v0))

    def fj(x):
        lam, Phi = j_eigh_gen(x, jp, JConfig(**kw))
        return jnp.sum(jnp.log(lam)) + jnp.sum(Phi[:7] ** 2)

    g_j = np.asarray(jax.grad(fj)(jnp.asarray(x0)))

    At, Bt = torch.as_tensor(A0), torch.as_tensor(B0)
    tp = EigProblem(assemble=lambda x: (DenseOperator(At + torch.diag(x)),
                                        DenseOperator(Bt
                                                      + 0.02 * torch.diag(x))),
                    v0=lambda x: torch.as_tensor(v0))
    x = torch.as_tensor(x0).requires_grad_(True)
    lam, Phi = eigh_gen(x, tp, EighGenConfig(**kw))
    (torch.sum(torch.log(lam)) + torch.sum(Phi[:7] ** 2)).backward()
    assert np.abs(x.grad.numpy() - g_j).max() <= 1e-10 * np.abs(g_j).max()


def test_dl_gradient_matches_jax_on_the_thermal_model():
    """The thermal 24x24 dense model (N 4: Nmax 8, m 60, single vector,
    no deflation, the chain where JAX's dl is right), both packages from
    one start vector: the gradient of sum(lam) + sum(Q[:20]^2) through dl
    against jax.grad through JAX's at 1e-10 of max|g|, and the port's dl
    against its own SIBK at 1e-8."""
    from eigd_tpu.models import thermal as jth
    from eigd_tpu_torch.interop import thermal_from_numpy

    jt = jth.make_model(24, 24, N=4, adjoint_method="dl")
    f = jt.fltr
    tt = thermal_from_numpy(
        np.asarray(jt.x), np.asarray(jt.X), np.asarray(jt.conn),
        jt.element_sets, (np.asarray(f.idx), np.asarray(f.wts)),
        jt.grid_shape, f.r0,
        device="cpu", N=4, adjoint_method="dl")
    v0 = np.random.default_rng(3).uniform(-1.0, 1.0, jt.nnodes)
    jt.problem = dataclasses.replace(jt.problem,
                                     v0=lambda th: jnp.asarray(v0))
    tt.problem = dataclasses.replace(tt.problem,
                                     v0=lambda th: torch.as_tensor(v0))

    def fj(x):
        lam, Q = jt._solve_fn(x)[:2]
        return jnp.sum(lam) + jnp.sum(Q[:20] ** 2)

    g_j = np.asarray(jax.grad(fj)(jt.x))
    grads = {}
    for method in ("dl", "sibk"):
        tt.cfg = dataclasses.replace(tt.cfg, adjoint_method=method)
        x = tt.x.clone().requires_grad_(True)
        lam, Q = tt._solve_fn(x)
        (torch.sum(lam) + torch.sum(Q[:20] ** 2)).backward()
        grads[method] = x.grad.numpy()
    scale = np.abs(g_j).max()
    assert np.abs(grads["dl"] - g_j).max() <= 1e-10 * scale
    assert np.abs(grads["dl"] - grads["sibk"]).max() <= 1e-8 * scale


def _first_blf_sigma():
    from eigd_tpu_torch.models.buckling import first_blf, make_buckling_model

    return 0.8 * first_blf(make_buckling_model(nx=16, ny=8, N=4, sigma=1.0,
                                               device="cpu"))


@pytest.mark.parametrize("chain", ["deflated", "buckling", "block"])
def test_dl_refuses_what_the_reference_gets_wrong(chain):
    """adjoint_method="dl" raises ValueError naming the restriction on the
    deflated natural-frequency chain (16x8, N 3, m 40, single vector) and
    on the buckling chain (16x8, N 4, sigma 0.8 BLF_1), where JAX's dl
    returns gradients off by 2.8e7 and 5.6e49 (ROADMAP, faults of the
    reference), and, as JAX does, on a block solve."""
    from eigd_tpu_torch.models.buckling import make_buckling_model
    from eigd_tpu_torch.models.natural_frequency import make_model

    if chain == "buckling":
        topo = make_buckling_model(nx=16, ny=8, N=4, sigma=_first_blf_sigma(),
                                   adjoint_method="dl", device="cpu")
        match = "buckling"
    else:
        block = 1 if chain == "deflated" else 4
        topo = make_model(nx=16, ny=8, Lx=2.0, rfact=2.0, N=3,
                          m=40 if block == 1 else 48,
                          lanczos_block=block,
                          adjoint_method="dl", device="cpu")
        match = "deflated" if chain == "deflated" else "single-vector"
    x = topo.x.clone().requires_grad_(True)
    lam, Q = topo._solve_fn(x)[:2]
    with pytest.raises(ValueError, match=match):
        (torch.sum(lam) + torch.sum(Q[:20] ** 2)).backward()
