"""Parity of the port's buckling family with eigd_tpu's, on the CPU.

Each module of the slice against its JAX function on the same numpy
inputs (x64): the geometric-stiffness tables and matrix, the cantilever
boundary, the stencil's extra diagonal, the buckling shift factor, the
spectral map and both Lanczos solvers in buckling mode (fixed trip, one
start vector), the adjoint solvers and weights, the tangent against the
directional oracle, ``solve_spd``'s reverse and forward rules, and the
whole ``BucklingTopologyAnalysis`` at 14x7 on the dense, ``bcr_f32`` and
``bcr`` paths (load factors, compliance and xb of the KS, aggregate and
aggregate-max seeds), with the repeated-load-factor correction. Each JAX
model is solved once, in a module-scoped fixture; the port gets its state
through ``interop.buckling_from_numpy``, JAX's start vector included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from eigd_tpu.fem import assembly as jfem
from eigd_tpu.fem import model as jmodel
from eigd_tpu.fem import quad as jquad
from eigd_tpu.models import buckling as jbk
from eigd_tpu.ops import adjoint as jadj
from eigd_tpu.ops import autodiff as jad
from eigd_tpu.ops import factor as jfac
from eigd_tpu.ops import lanczos as jlz
from eigd_tpu.ops.operators import DenseOperator as JDense
from eigd_tpu.ops.operators import ElementOperator as JElement
from eigd_tpu.ops.stencil import GridStencilOperator as JGrid
from eigd_tpu_torch.fem import assembly as tfem
from eigd_tpu_torch.fem import model as tmodel
from eigd_tpu_torch.fem import quad as tquad
from eigd_tpu_torch.interop import buckling_from_numpy
from eigd_tpu_torch.models import buckling as tbk
from eigd_tpu_torch.ops import adjoint as tadj
from eigd_tpu_torch.ops import autodiff as tad
from eigd_tpu_torch.ops import factor as tfac
from eigd_tpu_torch.ops import lanczos as tlz
from eigd_tpu_torch.ops.operators import DenseOperator, ElementOperator
from eigd_tpu_torch.ops.stencil import GridStencilOperator

torch.set_num_threads(1)
NX, NY, N = 14, 7, 4
NODE = [11, 29]  # the aggregate's DOFs (tests/test_buckling.py)
NODE3 = [11, 29, 47]


def t(a):
    return None if a is None else torch.as_tensor(np.array(a))


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def align(P, ref):
    """P's columns with the signs of ref's."""
    return P * np.where(np.sum(P * ref, axis=0) < 0.0, -1.0, 1.0)


def j_start(n, seed=12345):
    """JAX's default Lanczos start vector."""
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (n,),
                                         dtype=jnp.float64, minval=-1.0,
                                         maxval=1.0))


def mesh_state(nx=6, ny=4, seed=0):
    """A grid with perturbed interior nodes (a general quad mesh), its
    element densities and a displacement field."""
    m = jmodel.make_grid(nx, ny, 2.0, 1.0)
    rng = np.random.default_rng(seed)
    X = m.X + 0.05 * rng.uniform(-1.0, 1.0, m.X.shape) / nx
    rhoE = rng.uniform(0.3, 1.0, m.nelems)
    u = rng.standard_normal(2 * m.nnodes)
    return m, X, rhoE, u


# ---------------------------------------------------------------------------
# fem: tables, stress stiffness, boundary
# ---------------------------------------------------------------------------


def test_stress_stiffness_tables_match_jax():
    """Be, Te and detJ on a perturbed mesh: 1e-13 relative."""
    m, X, _, _ = mesh_state()
    ref = jquad.stress_stiffness_tables(jnp.asarray(X), jnp.asarray(m.conn))
    got = tquad.stress_stiffness_tables(t(X), t(m.conn).long())
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        assert rel(a.numpy(), b) <= 1e-13


@pytest.mark.parametrize("ptype", ["simp", "ramp"])
def test_stress_stiffness_matrix_matches_jax(ptype):
    """G(rhoE, u)'s element matrices, and the gradients of a bilinear form
    of it in rhoE and in u (the dG/du chain): 1e-13 relative."""
    m, X, rhoE, u = mesh_state(seed=1)
    conn = jnp.asarray(m.conn)
    Be, Te, detJ = jquad.stress_stiffness_tables(jnp.asarray(X), conn)
    dofs = jfem.element_dof_map(conn)
    n = 2 * m.nnodes
    C0 = jfem.plane_stress_C0()
    w, v = np.random.default_rng(2).standard_normal((2, n))

    def jform(r, uu):
        G = jfem.stress_stiffness_matrix(r, uu, Be, Te, detJ, dofs, conn, n,
                                         C0, ptype=ptype)
        return jnp.asarray(w) @ G.mv(jnp.asarray(v)), G.mats

    (_, mats_j), (gr_j, gu_j) = (
        jform(jnp.asarray(rhoE), jnp.asarray(u)),
        jax.grad(lambda r, uu: jform(r, uu)[0], argnums=(0, 1))(
            jnp.asarray(rhoE), jnp.asarray(u)))

    tc = t(m.conn).long()
    tBe, tTe, tdJ = tquad.stress_stiffness_tables(t(X), tc)
    tdofs = tfem.element_dof_map(tc)
    r = t(rhoE).requires_grad_(True)
    uu = t(u).requires_grad_(True)
    G = tfem.stress_stiffness_matrix(r, uu, tBe, tTe, tdJ, tdofs, tc, n,
                                     tfem.plane_stress_C0(), ptype=ptype)
    assert rel(G.mats.detach().numpy(), mats_j) <= 1e-13
    gr, gu = torch.autograd.grad(t(w) @ G.mv(t(v)), (r, uu))
    assert rel(gr.numpy(), gr_j) <= 1e-13
    assert rel(gu.numpy(), gu_j) <= 1e-13


@pytest.mark.parametrize("side", ["left", "right", "bottom", "top"])
def test_cantilever_bcs_match_jax(side):
    mj = jmodel.make_grid(9, 5, 2.0, 1.0)
    mt = tmodel.make_grid(9, 5, 2.0, 1.0)
    got = tmodel.cantilever_bcs(mt, side=side)
    np.testing.assert_array_equal(got, jmodel.cantilever_bcs(mj, side=side))
    assert got.dtype == np.int32
    with pytest.raises(ValueError):
        tmodel.cantilever_bcs(mt, side="middle")


# ---------------------------------------------------------------------------
# ops: stencil extra diagonal, factor, spectral map, Lanczos
# ---------------------------------------------------------------------------


def test_extra_diag_stencil_matches_jax():
    """GridStencilOperator with the unit diagonal of the clamped DOFs
    folded into W: W, mv (vector and block), to_dense against JAX's at
    1e-13, and ``with_kernels`` keeps mats and extra_diag (K2's twin on
    the CPU)."""
    nx, ny = 8, 4
    m = jmodel.make_grid(nx, ny, 2.0, 1.0)
    rhoE = np.random.default_rng(3).uniform(0.3, 1.0, m.nelems)
    conn = jnp.asarray(m.conn)
    Be, He, detJ = jquad.plane_stress_tables(jnp.asarray(m.X), conn)
    dofs = jfem.element_dof_map(conn)
    n = 2 * m.nnodes
    mats = np.asarray(jfem.stiffness_matrix(jnp.asarray(rhoE), Be, detJ,
                                            dofs, n,
                                            jfem.plane_stress_C0()).mats)
    fixed = np.zeros(n)
    fixed[np.setdiff1d(np.arange(n), jmodel.cantilever_bcs(m))] = 1.0
    opj = JGrid.from_element_operator(
        JElement(jnp.asarray(mats), dofs, n), (nx, ny), ndof=2,
        extra_diag=jnp.asarray(fixed))
    opt = GridStencilOperator.from_element_operator(
        ElementOperator(t(mats), t(np.asarray(dofs)).long(), n), (nx, ny),
        ndof=2, extra_diag=t(fixed))
    x = np.random.default_rng(4).standard_normal((n, 3))
    assert rel(opt.W.numpy(), opj.W) <= 1e-13
    assert rel(opt.to_dense().numpy(), opj.to_dense()) <= 1e-13
    for xx in (x, x[:, 0]):
        assert rel(opt.mv(t(xx)).numpy(), opj.mv(jnp.asarray(xx))) <= 1e-13
    fast = opt.with_kernels()
    assert fast.mats is opt.mats and fast.extra_diag is opt.extra_diag
    assert fast.Wp64 is not None
    assert rel(fast.mv(t(x)).numpy(), opj.mv(jnp.asarray(x))) <= 1e-13
    assert rel(fast.to_dense().numpy(), opj.to_dense()) <= 1e-13


def buckling_pencil(n=90, seed=7):
    """The (G, K) pencil of tests/test_lanczos.py: K SPD, G negative
    definite, so every load factor -1/mu is positive."""
    rng = np.random.default_rng(seed)
    K = rng.standard_normal((n, n))
    K = K @ K.T + n * np.eye(n)
    G = rng.standard_normal((n, n))
    G = -(G @ G.T) - 0.5 * np.eye(n)
    mu = scipy.linalg.eigh(G, K, eigvals_only=True)
    return G, K, -1.0 / np.sort(mu)


@pytest.mark.parametrize("kind,tol", [("cholesky", 1e-12), ("eigh", 1e-12),
                                      ("cg", 1e-10)])
def test_buckling_shift_factor_matches_jax(kind, tol):
    """(K + sigma G)^{-1} of make_shift_factor(mode="buckling"), applied to
    a block and a vector."""
    G, K, lam = buckling_pencil(60, seed=1)
    kw = {"maxiter": 40} if kind == "cg" else {}
    sigma = 0.9 * lam[0]
    fj = jfac.make_shift_factor(jnp.asarray(G), jnp.asarray(K), sigma,
                                mode="buckling", kind=kind, **kw)
    ft = tfac.make_shift_factor(t(G), DenseOperator(t(K)), sigma,
                                mode="buckling", kind=kind, **kw)
    X = np.random.default_rng(2).standard_normal((60, 3))
    for x in (X, X[:, 0]):
        assert rel(ft.mv(t(x)).numpy(), fj.mv(jnp.asarray(x))) <= tol
    with pytest.raises(ValueError):
        tfac.make_shift_factor(t(G), t(K), sigma, mode="cayley")


def test_map_ritz_values_buckling_matches_jax():
    theta = np.array([3.0, 1.2, 0.4, -0.7, 1.05, 8.0])
    for mode in ("normal", "buckling"):
        lj, oj = jlz.map_ritz_values(jnp.asarray(theta), 0.004, mode)
        lt, ot = tlz.map_ritz_values(t(theta), 0.004, mode)
        assert rel(lt.numpy(), lj) <= 1e-15
        np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))


@pytest.mark.parametrize("solver", ["single", "single-tol", "block",
                                    "block-polish"])
def test_lanczos_buckling_matches_jax(solver):
    """Buckling-mode Lanczos on the (G, K) pencil from one start vector:
    the single-vector solver (m 60; with tol set it still runs all m
    steps, as JAX's) and the block one (p 3, m 60, full ortho; the guarded
    selection of an adaptive run; one Ritz polish). lam against JAX's and
    the dense load factors, Phi up to sign: 1e-10."""
    G, K, lam_ref = buckling_pencil()
    n = G.shape[0]
    sigma = 0.9 * lam_ref[0]
    fj = jfac.make_shift_factor(jnp.asarray(G), jnp.asarray(K), sigma,
                                mode="buckling")
    ft = tfac.make_shift_factor(t(G), t(K), sigma, mode="buckling")
    Aj, Bj = JDense(jnp.asarray(G)), JDense(jnp.asarray(K))
    At, Bt = DenseOperator(t(G)), DenseOperator(t(K))
    if solver.startswith("single"):
        tol = 1e-10 if solver == "single-tol" else None
        v0 = j_start(n)
        rj = jlz.lanczos_solve(Aj, Bj, fj, sigma, N, 60, mode="buckling",
                               v0=jnp.asarray(v0), tol=tol)
        rt = tlz.lanczos_solve(At, Bt, ft, sigma, N, 60, mode="buckling",
                               v0=t(v0), tol=tol)
        assert rt.niter == 60
    else:
        v0 = np.random.default_rng(3).uniform(-1.0, 1.0, (n, 3))
        kw = dict(mode="buckling", tol=1e-12, polish=int(solver ==
                                                         "block-polish"))
        rj = jlz.block_lanczos_solve(Aj, Bj, fj, sigma, N, 60, 3,
                                     v0=jnp.asarray(v0), **kw)
        rt = tlz.block_lanczos_solve(At, Bt, ft, sigma, N, 60, 3, v0=t(v0),
                                     **kw)
    assert rel(rt.lam.numpy(), rj.lam) <= 1e-10
    assert rel(rt.lam.numpy(), lam_ref[:N]) <= 1e-10
    Pj = np.asarray(rj.Phi)
    assert rel(align(rt.Phi.numpy(), Pj), Pj) <= 1e-10
    resid = K @ rt.Phi.numpy() + (G @ rt.Phi.numpy()) * rt.lam.numpy()
    assert np.linalg.norm(resid, axis=0).max() <= 1e-9 * np.linalg.norm(K)


# ---------------------------------------------------------------------------
# adjoint solvers and weights in buckling mode
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def solved():
    """JAX's single-vector buckling solve of the (G, K) pencil (n 90,
    N 4), carried into the port's LanczosResult; a seed block Phib."""
    G, K, lam_ref = buckling_pencil()
    sigma = 0.9 * lam_ref[0]
    fj = jfac.make_shift_factor(jnp.asarray(G), jnp.asarray(K), sigma,
                                mode="buckling")
    Aj, Bj = JDense(jnp.asarray(G)), JDense(jnp.asarray(K))
    rj = jlz.lanczos_solve(Aj, Bj, fj, sigma, N, 60, mode="buckling",
                           v0=jnp.asarray(j_start(G.shape[0])))
    rt = tlz.LanczosResult(**{f: t(getattr(rj, f)) for f in (
        "lam", "Phi", "V", "BV", "alpha", "beta", "H", "theta", "Y", "order",
        "lam_all", "eig_res", "sigma")}, niter=int(rj.niter))
    ft = tfac.make_shift_factor(t(G), t(K), sigma, mode="buckling")
    Phib = np.random.default_rng(1).standard_normal((G.shape[0], N))
    return ((Aj, Bj, fj, rj), (DenseOperator(t(G)), DenseOperator(t(K)),
                               ft, rt), Phib, sigma)


@pytest.mark.parametrize("method", ["laa", "sibk", "pcpg", "pgmres"])
def test_adjoint_solvers_buckling_match_jax(solved, method):
    """Each adjoint method in buckling mode from the same LAA guess: psi
    and the correction against JAX's at 1e-9 of max|psi|; the exact
    methods solve (K + lam_i G) psi_i = -proj(Phib_i) to 1e-9 of ||Phib||
    (eval_adjoint_residual_norm, against JAX's at 1e-9)."""
    (Aj, Bj, fj, rj), (At, Bt, ft, rt), Phib, sigma = solved
    psi0j = jadj.laa(jnp.asarray(Phib), Bj, fj, rj, b_ortho=True,
                     mode="buckling")
    psi0t = tadj.laa(t(Phib), Bt, ft, rt, b_ortho=True, mode="buckling")
    assert rel(psi0t.numpy(), psi0j) <= 1e-9
    kw = dict(mode="buckling", rtol=1e-13, maxiter=60)
    if method == "laa":
        pj, dj = jadj.generate_adjoint_correction(
            rj.lam, rj.Phi, psi0j, Phib=jnp.asarray(Phib), mode="buckling")
        pt, dt = tadj.generate_adjoint_correction(
            rt.lam, rt.Phi, psi0t, Phib=t(Phib), mode="buckling")
    else:
        fn_j, fn_t = getattr(jadj, method), getattr(tadj, method)
        extra = dict(sigma=sigma, nrestart=3) if method == "sibk" else {}
        pj, dj, _ = fn_j(jnp.asarray(Phib), Aj, Bj, rj.lam, rj.Phi,
                         psi=psi0j, factor=fj, **kw, **extra)
        pt, dt, _ = fn_t(t(Phib), At, Bt, rt.lam, rt.Phi, psi=psi0t,
                         factor=ft, **kw, **extra)
    assert rel(pt.numpy(), pj) <= 1e-9
    for a, b in ((dt.Xi, dj.Xi), (dt.Eta, dj.Eta)):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-9
    rt_, ot = tadj.eval_adjoint_residual_norm(At, Bt, rt.lam, rt.Phi,
                                              t(Phib), pt, mode="buckling",
                                              b_ortho=True)
    rj_, oj = jadj.eval_adjoint_residual_norm(Aj, Bj, rj.lam, rj.Phi,
                                              jnp.asarray(Phib), pj,
                                              mode="buckling", b_ortho=True)
    scale = float(np.sqrt(np.max(np.sum(Phib**2, axis=0))))
    assert np.abs(rt_.numpy() - np.asarray(rj_)).max() <= 1e-9 * scale
    if method != "laa":
        assert float(rt_.max()) <= 1e-9 * scale


@pytest.mark.parametrize("gap", [1.0, 1e-7])
def test_buckling_corrections_and_weights_match_jax(gap):
    """The buckling corrections (G scaled by diag(lam)), the weight
    blocks and add_eig_total_derivative's plus sign on random data,
    distinct and near-repeated pairs: 1e-12 relative."""
    rng = np.random.default_rng(2)
    n = 40
    lam = np.array([0.5, 0.5 + gap, 2.5])
    Phi, Phib, psi = (rng.standard_normal((n, 3)) for _ in range(3))
    lamb = rng.standard_normal(3)
    pj, cj = jadj.generate_adjoint_correction(
        jnp.asarray(lam), jnp.asarray(Phi), jnp.asarray(psi),
        Phib=jnp.asarray(Phib), mode="buckling")
    pt, ct = tadj.generate_adjoint_correction(t(lam), t(Phi), t(psi),
                                              Phib=t(Phib), mode="buckling")
    for a, b in ((pt, pj), (ct.Xi, cj.Xi), (ct.Eta, cj.Eta)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-12 * max(np.abs(b).max(),
                                                          1.0)
    args_j = (jnp.asarray(lam), jnp.asarray(Phi), jnp.asarray(lamb),
              jnp.asarray(Phib), pj)
    args_t = (t(lam), t(Phi), t(lamb), t(Phib), pt)
    wj = jadj.total_derivative_weights(*args_j, adj_corr_data=cj,
                                       mode="buckling")
    wt = tadj.total_derivative_weights(*args_t, adj_corr_data=ct,
                                       mode="buckling")
    for a, b in zip(wt, wj):
        assert rel(a.numpy(), b) <= 1e-12
    D = rng.standard_normal((n, n))

    def dAdx(W, V):
        return jnp.sum(W * (jnp.asarray(D) @ V))

    def tdAdx(W, V):
        return torch.sum(W * (t(D) @ V))

    gj = jadj.add_eig_total_derivative(*args_j, dAdx, dAdx, 0.0,
                                       adj_corr_data=cj, mode="buckling")
    gt = tadj.add_eig_total_derivative(*args_t, tdAdx, tdAdx, 0.0,
                                       adj_corr_data=ct, mode="buckling")
    assert abs(float(gt) - float(gj)) <= 1e-12 * abs(float(gj))


# ---------------------------------------------------------------------------
# autodiff: dense entry point, oracles, tangent, solve_spd
# ---------------------------------------------------------------------------


def test_buckling_oracles_match_jax():
    """eigh_gen_oracle and eigh_gen_directional_oracle in buckling mode
    against JAX's: 1e-10 (vectors up to sign)."""
    G, K, _ = buckling_pencil(36, seed=17)
    rng = np.random.default_rng(5)
    dG = rng.standard_normal(G.shape) * 0.1
    dG = 0.5 * (dG + dG.T)
    dK = rng.standard_normal(K.shape)
    dK = 0.5 * (dK + dK.T)
    wj, pj = jad.eigh_gen_oracle(jnp.asarray(G), jnp.asarray(K), 3,
                                 mode="buckling")
    wt, pt = tad.eigh_gen_oracle(t(G), t(K), 3, mode="buckling")
    assert rel(wt.numpy(), wj) <= 1e-10
    assert rel(align(pt.numpy(), np.asarray(pj)), pj) <= 1e-10
    ref = jad.eigh_gen_directional_oracle(G, K, dG, dK, 3, mode="buckling")
    got = tad.eigh_gen_directional_oracle(t(G), t(K), t(dG), t(dK), 3,
                                          mode="buckling")
    sign = np.sign(np.sum(got[1].numpy() * ref[1], axis=0))
    assert rel(got[0].numpy(), ref[0]) <= 1e-10
    assert rel(got[2].numpy(), ref[2]) <= 1e-10
    assert rel(got[3].numpy() * sign, ref[3]) <= 1e-9


def test_eigh_gen_dense_buckling_gradient_matches_jax():
    """eigh_gen_dense in buckling mode (sibk): the gradient of the load
    factors and an eigenvector term through (G + diag x, K + 0.1 diag x)
    against JAX's at 1e-8 and the port's oracle at 1e-8."""
    G, K, lam = buckling_pencil(40, seed=11)
    cfg_kw = dict(N=3, m=39, sigma=0.9 * lam[0], mode="buckling",
                  adjoint_method="sibk", adjoint_maxiter=39)
    x0 = 0.01 * np.random.default_rng(4).standard_normal(40)

    def jf(x):
        lam_, Phi = jad.eigh_gen_dense(jnp.asarray(G) + jnp.diag(x),
                                       jnp.asarray(K) + 0.1 * jnp.diag(x),
                                       jad.EighGenConfig(**cfg_kw))
        return jnp.sum(lam_) + jnp.sum(Phi[:5] ** 2)

    gj = np.asarray(jax.grad(jf)(jnp.asarray(x0)))

    def grad(fn):
        x = t(x0).requires_grad_(True)
        lam_, Phi = fn(t(G) + torch.diag(x), t(K) + 0.1 * torch.diag(x))
        (torch.sum(lam_) + torch.sum(Phi[:5] ** 2)).backward()
        return x.grad.numpy()

    gt = grad(lambda A, B: tad.eigh_gen_dense(A, B,
                                              tad.EighGenConfig(**cfg_kw)))

    def oracle(A, B):
        mu, Phi = tad.eigh_gen_oracle(A, B, 3, mode="buckling")
        return -1.0 / mu, Phi

    assert rel(gt, gj) <= 1e-8
    assert rel(gt, grad(oracle)) <= 1e-8


def test_repeated_blf_correction():
    """tests/test_buckling.py:232-274 in the port: a buckling pencil with
    a numerically repeated pair (split 1e-6 < eig_atol); the gradient of a
    subspace-invariant objective through the Xi/Eta correction against a
    central difference (1e-6) and against JAX's gradient (1e-8)."""
    n, N_ = 40, 4
    rng = np.random.default_rng(5)
    QQ, _ = np.linalg.qr(rng.standard_normal((n, n)))
    mu = -1.0 / np.concatenate([
        [2.0], [3.0, 3.0 + 1e-6], [4.0], np.linspace(8.0, 60.0, n - 4)])
    w = rng.uniform(1.0, 2.0, n)
    K0 = QQ @ np.diag(w) @ QQ.T
    Ks = scipy.linalg.sqrtm(K0).real
    G0 = Ks @ np.diag(mu) @ Ks
    S = rng.standard_normal((n, n)) * 0.05
    S = S + S.T
    v = rng.uniform(size=n)
    kw = dict(N=N_, m=39, sigma=1.8, mode="buckling", adjoint_method="sibk",
              adjoint_maxiter=39, factor_kind="eigh", eig_atol=1e-4)

    def jf(s):
        lam, Phi = jad.eigh_gen_dense(jnp.asarray(G0) + s * jnp.asarray(S),
                                      jnp.asarray(K0),
                                      jad.EighGenConfig(**kw))
        v_ = jnp.asarray(v)
        return jnp.sum(lam) + (v_ @ Phi[:, 1]) ** 2 + (v_ @ Phi[:, 2]) ** 2

    gj = float(jax.grad(jf)(0.0))

    def tf(s):
        lam, Phi = tad.eigh_gen_dense(t(G0) + s * t(S), t(K0),
                                      tad.EighGenConfig(**kw))
        return torch.sum(lam) + (t(v) @ Phi[:, 1]) ** 2 + (
            t(v) @ Phi[:, 2]) ** 2

    s = torch.zeros((), dtype=torch.float64, requires_grad=True)
    tf(s).backward()
    g = float(s.grad)
    h = 1e-5
    with torch.no_grad():
        fd = (float(tf(torch.tensor(h, dtype=torch.float64)))
              - float(tf(torch.tensor(-h, dtype=torch.float64)))) / (2 * h)
    assert abs(g - fd) <= 1e-6 * abs(fd)
    assert abs(g - gj) <= 1e-8 * abs(gj)


def test_tangent_buckling_matches_directional_oracle():
    """tests/test_autodiff_jvp.py:137-172 in the port: the buckling
    tangent of eigh_gen (sibk) on a dense (G, K) pencil against the
    port's and JAX's directional oracles (lam 1e-9, dlam 1e-7, dPhi 1e-7
    absolute)."""
    rng = np.random.default_rng(17)
    n, N_ = 36, 3
    S = rng.standard_normal((n, n))
    K0 = S @ S.T + n * np.eye(n)
    T = rng.standard_normal((n, n)) * 0.3
    G0 = -(T @ T.T + 0.5 * np.eye(n))
    dK = rng.standard_normal((n, n))
    dK = 0.5 * (dK + dK.T)
    dG = rng.standard_normal((n, n)) * 0.1
    dG = 0.5 * (dG + dG.T)
    lam_o, Phi_o, dlam_o, dPhi_o = jad.eigh_gen_directional_oracle(
        G0, K0, dG, dK, N_, eig_atol=1e-5, mode="buckling")
    _, Phi_t, dlam_t, dPhi_t = (a.numpy() for a in
                                tad.eigh_gen_directional_oracle(
                                    t(G0), t(K0), t(dG), t(dK), N_,
                                    eig_atol=1e-5, mode="buckling"))
    sign_t = np.sign(np.sum(Phi_t * Phi_o, axis=0))
    np.testing.assert_allclose(dlam_t, dlam_o, rtol=1e-10)
    np.testing.assert_allclose(dPhi_t * sign_t[None, :], dPhi_o, atol=1e-10)
    problem = tad.EigProblem(assemble=lambda th: (
        DenseOperator(t(G0) + th * t(dG)), DenseOperator(t(K0) + th * t(dK))))
    cfg = tad.EighGenConfig(N=N_, m=36, sigma=0.5 * float(lam_o[0]),
                            mode="buckling", adjoint_method="sibk",
                            adjoint_maxiter=60, nrestart=3, eig_atol=1e-5)
    lam, Phi, dlam, dPhi = (a.numpy() for a in tad.eigh_gen_tangent(
        torch.tensor(0.0, dtype=torch.float64),
        torch.tensor(1.0, dtype=torch.float64), problem, cfg))
    sign = np.sign(np.sum(Phi * Phi_o, axis=0))
    np.testing.assert_allclose(lam, lam_o, rtol=1e-9)
    np.testing.assert_allclose(dlam, dlam_o, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(dPhi * sign[None, :], dPhi_o, atol=1e-7)


def test_solve_spd_rules_match_jax():
    """solve_spd on a dense SPD K(theta) = K0 + diag(theta^2) with its
    Cholesky factor: the reverse rule (autograd, theta_bar and f_bar)
    against JAX's solve_spd vjp, the forward rule (torch.func.jvp, in
    theta and in f) against JAX's solve_spd_fwdmode jvp, and the two
    against each other: 1e-12 relative (tests/test_autodiff_jvp.py:207-230
    holds JAX's pair at 1e-9; the masked stencil chain runs in
    test_model_matches_jax and test_masked_chain_jvp_matches_vjp)."""
    rng = np.random.default_rng(8)
    n = 30
    S = rng.standard_normal((n, n))
    K0 = S @ S.T + n * np.eye(n)
    th0, dth, f, w = rng.uniform(0.5, 1.5, n), *rng.standard_normal((3, n))

    def j_op(th):
        return JDense(jnp.asarray(K0) + jnp.diag(th**2))

    def j_fac(th):
        return jfac.CholeskyFactor.from_matrix(j_op(th).mat)

    def t_op(th):
        return DenseOperator(t(K0) + torch.diag(th**2))

    def t_fac(th):
        return tfac.CholeskyFactor.from_matrix(t_op(th).mat)

    gj = jax.grad(lambda th, ff: jnp.asarray(w) @ jad.solve_spd(
        th, ff, j_op, j_fac), argnums=(0, 1))(jnp.asarray(th0),
                                              jnp.asarray(f))
    _, duj = jax.jvp(lambda th, ff: jad.solve_spd_fwdmode(th, ff, j_op,
                                                          j_fac),
                     (jnp.asarray(th0), jnp.asarray(f)),
                     (jnp.asarray(dth), jnp.asarray(w)))
    th = t(th0).requires_grad_(True)
    ff = t(f).requires_grad_(True)
    gt = torch.autograd.grad(t(w) @ tad.solve_spd(th, ff, t_op, t_fac),
                             (th, ff))
    _, du = torch.func.jvp(lambda a, b: tad.solve_spd(a, b, t_op, t_fac),
                           (t(th0), t(f)), (t(dth), t(w)))
    for a, b in zip(gt, gj):
        assert rel(a.numpy(), b) <= 1e-12
    assert rel(du.numpy(), duj) <= 1e-12
    ans_vjp = float(gt[0] @ t(dth) + gt[1] @ t(w))
    assert abs(ans_vjp - float(t(w) @ du)) <= 1e-12 * abs(ans_vjp)


def test_masked_chain_jvp_matches_vjp(sigma0):
    """Forward mode through the whole masked chain (staged_jvp over
    x -> (rhoE, u = solve_spd) -> eigh_gen -> KS + aggregate) against the
    reverse-mode gradient, 14x7 on bcr: 1e-9 (the JAX package holds its
    dense chain to 1e-9, tests/test_autodiff_jvp.py:174-205)."""
    tt = tbk.make_buckling_model(nx=NX, ny=NY, N=N, sigma=sigma0,
                                 factor_kind="bcr", device="cpu")
    node = tt._nodes(NODE)

    def pre(x):
        rhoE = tfem.element_density(tt.fltr.apply(x), tt.conn)
        return rhoE, tt._static(rhoE)[0]

    def tail(lam, Q):
        return tt._ks(lam, 100.0) + tt._aggregate(lam, Q, 1.0, node, "tanh")

    x = tt.x.clone().requires_grad_(True)
    lam, Q, _ = tt._solve_fn(x)
    tail(lam, Q).backward()
    p = t(np.random.default_rng(9).uniform(size=x.shape))
    ans = float(p @ x.grad)
    _, dv = tad.staged_jvp(pre, tail, tt.problem, tt.cfg)(tt.x, p)
    assert abs(ans - float(dv)) <= 1e-9 * abs(ans)


# ---------------------------------------------------------------------------
# the model at 14x7
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sigma0():
    """0.9 BLF_1 of the dense 14x7 pencil, from the port's pilot."""
    tt = tbk.make_buckling_model(nx=NX, ny=NY, N=N, sigma=1.0, device="cpu")
    return 0.9 * tbk.first_blf(tt)


KINDS = ("cholesky", "bcr_f32", "bcr")


def _j_start_vector(jt):
    if jt.scalable:
        return np.asarray(jt._v0(None))
    return j_start(int(jt.free.shape[0]))


def _port(jt, **config):
    """The port's analysis on JAX's state and start vector."""
    return buckling_from_numpy(
        np.asarray(jt.x), np.asarray(jt.X), np.asarray(jt.conn),
        np.asarray(jt.free), np.asarray(jt.f),
        (np.asarray(jt.fltr.idx), np.asarray(jt.fltr.wts)), jt.fltr.r0,
        v0=_j_start_vector(jt), device="cpu", N=jt.N, sigma=jt.sigma,
        factor_kind=jt.factor_kind, grid_shape=jt.grid_shape, **config)


def _passes(topo, wrap):
    """One initialize, then the three passes of one solve: KS (rho 100)
    plus the eigenvector aggregate (rho 1), the aggregate max (rho 20),
    and the compliance derivative. Returns the values and the xbs."""
    topo.initialize()
    vals = [float(topo.eval_ks_buckling(100.0)),
            float(topo.get_eigenvector_aggregate(1.0, wrap(NODE))),
            float(topo.get_eigenvector_aggregate_max(20.0, wrap(NODE3))),
            float(topo.compliance()), float(topo.eval_area())]
    topo.initialize_adjoint()
    topo.add_ks_buckling_derivative(1.0, 100.0)
    topo.add_eigenvector_aggregate_derivative(1.0, 1.0, wrap(NODE))
    topo.finalize_adjoint()
    xbs = [np.array(topo.xb)]
    topo.initialize_adjoint()
    topo.add_eigenvector_aggregate_max_derivative(1.0, 20.0, wrap(NODE3))
    topo.finalize_adjoint()
    xbs += [np.array(topo.xb), np.array(topo.compliance_derivative()),
            np.array(topo.eval_area_gradient())]
    return np.array(topo.BLF), vals, xbs


@pytest.fixture(scope="module")
def analyses(sigma0):
    out = {}
    for kind in KINDS:
        jt = jbk.make_buckling_model(nx=NX, ny=NY, N=N, sigma=sigma0,
                                     factor_kind=kind)
        out[kind] = (jt, _passes(jt, jnp.asarray))
    return out


def test_pilot_matches_jax(sigma0):
    """first_blf's shift against tests/test_buckling.py's _pick_sigma."""
    from tests.test_buckling import _pick_sigma

    assert abs(sigma0 - _pick_sigma()) <= 1e-10 * sigma0


@pytest.mark.parametrize("kind", KINDS)
def test_model_matches_jax(analyses, kind):
    """BLFs, the KS, aggregate, aggregate-max, compliance and area values,
    and xb of each pass (KS + aggregate; aggregate max on the same solve;
    the compliance derivative; the area gradient) against JAX's: 1e-8
    relative."""
    jt, (blf_j, vals_j, xbs_j) = analyses[kind]
    blf, vals, xbs = _passes(_port(jt), lambda a: a)
    assert rel(blf, blf_j) <= 1e-8
    assert rel(vals, vals_j) <= 1e-8
    for a, b in zip(xbs, xbs_j):
        assert rel(a, b) <= 1e-8


def test_dense_and_masked_paths_agree(analyses):
    """The masked stencil path (bcr) reproduces the dense-reduced path:
    BLFs 1e-8, compliance 1e-10 absolute (tests/test_buckling.py:138-146),
    and the xb of every pass 1e-8."""
    blf_d, vals_d, xbs_d = analyses["cholesky"][1]
    blf, vals, xbs = analyses["bcr"][1]
    assert rel(blf, blf_d) <= 1e-8
    assert abs(vals[3] - vals_d[3]) <= 1e-10
    for a, b in zip(xbs, xbs_d):
        assert rel(a, b) <= 1e-8


def test_port_start_vector_and_ntarget(analyses, sigma0):
    """The port's own start vector is uniform on [-1, 1) and zero on the
    clamped DOFs. With Ntarget 3 the model keeps Ntarget + 1 modes (the
    extra one shows the boundary; no cluster here) and solves to the load
    factors of JAX's N 4 model (1e-8); JAX's own Ntarget rule recurses
    without end on this model (the port's ``initialize`` says why)."""
    tt = tbk.make_buckling_model(nx=NX, ny=NY, N=N, sigma=sigma0,
                                 factor_kind="bcr", device="cpu")
    v = tt._v0(None).numpy()
    fixed = tt.fixed_mask.numpy() == 1.0
    assert np.all(v[fixed] == 0.0) and np.all(np.abs(v) <= 1.0)
    assert np.all(v[~fixed] != 0.0)
    jt, (blf_j, _, _) = analyses["cholesky"]
    tt = _port(jt, Ntarget=3)
    tt.initialize()
    assert tt.N == 4
    assert rel(tt.BLF.numpy(), blf_j) <= 1e-8


@pytest.mark.parametrize("kind", ["bcr", "bcr_f32", "blocktridiag"])
@pytest.mark.parametrize("ratio", [1.5, 3.5, 0.3, 0.98])
def test_shift_follows_the_first_load(analyses, kind, ratio):
    """A shift above the first load factor (K + sigma G indefinite: the
    masked block factor does not hold) is cut by SHIFT_BACKOFF until it
    lies below it, and the solve runs again; a solve whose shift ends
    outside SHIFT_BAND of BLF_1 moves it to SHIFT_MARGIN BLF_1, and runs
    again from below the band (0.3 BLF_1), not from above it (0.98).
    Either way the load factors and the xb of every pass are JAX's at
    sigma0 (1e-8), with one ``buckling_shift`` decision a pencil factor
    built and one a solve."""
    from eigd_tpu_torch.ops import sync

    blf_j, _, xbs_j = analyses["cholesky"][1]
    blf1 = float(blf_j[0])
    tt = tbk.make_buckling_model(nx=NX, ny=NY, N=N, sigma=ratio * blf1,
                                 factor_kind=kind, device="cpu")
    sync.clear()
    blf, _, xbs = _passes(tt, lambda a: a)
    cuts = max(0, int(np.ceil(np.log(ratio) / np.log(1 / tbk.SHIFT_BACKOFF))))
    shifts = sync.HOST_SYNCS["buckling_shift"]
    sync.clear()
    assert shifts == cuts + (4 if ratio < tbk.SHIFT_BAND[0] else 2)
    if ratio < 1.0:
        assert tt.sigma == pytest.approx(tbk.SHIFT_MARGIN * blf1, rel=1e-8)
    else:
        assert tt.sigma == ratio * blf1 * tbk.SHIFT_BACKOFF**cuts
    assert tt.profile["sigma"] == tt.sigma
    assert rel(blf, blf_j) <= 1e-8
    for a, b in zip(xbs, xbs_j):
        assert rel(a, b) <= 1e-8


def test_shift_cuts_end_where_the_factor_never_holds():
    """A design whose factors never hold (a NaN density) raises
    ShiftAboveFirstLoad after SHIFT_CUTS cuts, and does not loop."""
    tt = tbk.make_buckling_model(nx=NX, ny=NY, N=N, sigma=1.0,
                                 factor_kind="bcr", device="cpu")
    tt.x = tt.x.clone()
    tt.x[3] = float("nan")
    with pytest.raises(tbk.ShiftAboveFirstLoad):
        tt.initialize()
    assert tt.sigma == tbk.SHIFT_BACKOFF**tbk.SHIFT_CUTS
