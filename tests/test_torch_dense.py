"""Parity of the port's dense path with eigd_tpu's, on the CPU.

Operators, the shift-invert factors, the single-vector Lanczos solver, the
pcpg/pgmres adjoint solvers and the dense entry point ``eigh_gen_dense``
with its oracles. The same numpy inputs (the pencil of
tests/test_adjoint.py: n 80, a Cholesky-congruent B) go through the JAX
function (x64 on the CPU) and its counterpart in the port. Where a result
depends on the Lanczos start vector, both sides get the same one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from eigd_tpu.ops import adjoint as jadj
from eigd_tpu.ops import autodiff as jad
from eigd_tpu.ops import factor as jfac
from eigd_tpu.ops.lanczos import lanczos_solve as j_lanczos
from eigd_tpu.ops.operators import DenseOperator as JDense
from eigd_tpu_torch.ops import adjoint as tadj
from eigd_tpu_torch.ops import autodiff as tad
from eigd_tpu_torch.ops import factor as tfac
from eigd_tpu_torch.ops import sync
from eigd_tpu_torch.ops.lanczos import b_orthonormalize_rows, lanczos_solve
from eigd_tpu_torch.ops.operators import (DenseOperator, DiagonalOperator,
                                          as_operator)

torch.set_num_threads(1)
N_MODES = 4


def t(a):
    return torch.as_tensor(np.array(a))


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def make_pencil(n, seed=0, low=None):
    """tests/test_adjoint.py's pencil, as numpy arrays."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    if low is None:
        low = np.arange(1.0, 11.0) ** 1.5
    w = np.concatenate([low, np.linspace(100.0, 300.0, n - len(low))])
    A = Q @ np.diag(w) @ Q.T
    Bm = rng.standard_normal((n, n)) * 0.05
    Bm = Bm @ Bm.T + np.eye(n)
    L = np.linalg.cholesky(Bm)
    A = L @ A @ L.T
    return 0.5 * (A + A.T), Bm


def j_start(n, seed=12345):
    """JAX's default Lanczos start vector, which the port cannot draw."""
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (n,),
                                         dtype=jnp.float64, minval=-1.0,
                                         maxval=1.0))


@pytest.fixture(scope="module")
def pencil():
    return make_pencil(80, seed=3)


def test_operators_and_as_operator(pencil):
    A, _ = pencil
    d = np.random.default_rng(0).uniform(1.0, 2.0, 80)
    X = np.random.default_rng(1).standard_normal((80, 3))
    assert isinstance(as_operator(t(A)), DenseOperator)
    assert isinstance(as_operator(t(d)), DiagonalOperator)
    op = DenseOperator(t(A))
    assert as_operator(op) is op
    assert rel(as_operator(t(d)).mv(t(X)).numpy(), d[:, None] * X) < 1e-15
    assert rel(as_operator(t(d)).to_dense().numpy(), np.diag(d)) == 0.0
    assert rel(op.mv(t(X[:, 0])).numpy(), A @ X[:, 0]) < 1e-13


@pytest.mark.parametrize("kind,tol", [("cholesky", 1e-12), ("eigh", 1e-12),
                                      ("cg", 1e-10)])
def test_factor_matches_jax(kind, tol):
    """make_shift_factor's mv on an SPD pencil (n 60), a vector and a
    block, in the normal mode (A + 0.5 B) and the buckling mode
    (B + 0.5 A); CG with the same maxiter."""
    A, B = make_pencil(60, seed=1)
    kw = {"maxiter": 40} if kind == "cg" else {}
    fj = jfac.make_shift_factor(jnp.asarray(A), jnp.asarray(B), -0.5,
                                kind=kind, **kw)
    ft = tfac.make_shift_factor(t(A), DenseOperator(t(B)), -0.5, kind=kind,
                                **kw)
    X = np.random.default_rng(2).standard_normal((60, 3))
    for x in (X, X[:, 0]):
        assert rel(ft.mv(t(x)).numpy(), fj.mv(jnp.asarray(x))) <= tol
    if kind == "cholesky":
        assert bool(ft.ok()) and bool(fj.ok())
        bad = np.diag(np.r_[1.0, -1.0, np.ones(58)])
        assert not bool(tfac.CholeskyFactor.from_matrix(t(bad)).ok())
        assert not bool(jfac.CholeskyFactor.from_matrix(
            jnp.asarray(bad)).ok())
    fj = jfac.make_shift_factor(jnp.asarray(A), jnp.asarray(B), 0.5,
                                mode="buckling", kind=kind, **kw)
    ft = tfac.make_shift_factor(t(A), DenseOperator(t(B)), 0.5,
                                mode="buckling", kind=kind, **kw)
    for x in (X, X[:, 0]):
        assert rel(ft.mv(t(x)).numpy(), fj.mv(jnp.asarray(x))) <= tol


def align(P, ref):
    """P's columns with the signs of ref's."""
    return P * np.where(np.sum(P * ref, axis=0) < 0.0, -1.0, 1.0)


@pytest.mark.parametrize("deflated,tol", [(False, None), (False, 1e-10),
                                          (True, None), (True, 1e-10)])
def test_lanczos_solve_matches_jax(pencil, deflated, tol):
    """Single-vector Lanczos (m 55, check every 8) from the same v0, with
    and without the two lowest modes deflated and the adaptive exit: the
    same niter, lam and Phi up to sign to 1e-10."""
    A, B = pencil
    v0 = j_start(80)
    deflate_j = deflate_t = None
    if deflated:
        _, V = scipy.linalg.eigh(A, B)
        U0 = V[:, :2].T
        from eigd_tpu.ops.lanczos import b_orthonormalize_rows as j_bortho

        deflate_j = j_bortho(jnp.asarray(U0), JDense(jnp.asarray(B)).mv)
        deflate_t = b_orthonormalize_rows(t(U0), DenseOperator(t(B)).mv)
    fj = jfac.make_shift_factor(jnp.asarray(A), jnp.asarray(B), 0.0)
    ft = tfac.make_shift_factor(t(A), t(B), 0.0)
    rj = j_lanczos(JDense(jnp.asarray(A)), JDense(jnp.asarray(B)), fj, 0.0,
                   N_MODES, 55, v0=jnp.asarray(v0), deflate=deflate_j,
                   tol=tol)
    sync.clear()
    rt = lanczos_solve(t(A), t(B), ft, 0.0, N_MODES, 55, v0=t(v0),
                       deflate=deflate_t, tol=tol)
    assert rt.niter == int(rj.niter)
    if tol is not None:
        assert rt.niter < 55
        assert sync.HOST_SYNCS["lanczos1_exit"] > 0
        assert sync.LOOP_EXITS["lanczos1_exit.converged"] == 1
    assert rel(rt.lam.numpy(), rj.lam) <= 1e-10
    Pj = np.asarray(rj.Phi)
    assert rel(align(rt.Phi.numpy(), Pj), Pj) <= 1e-10
    if not deflated and tol is None:
        # the tridiagonal reduced problem, on JAX's coefficients
        from eigd_tpu.ops.lanczos import solve_reduced_problem as j_reduced

        from eigd_tpu_torch.ops.lanczos import solve_reduced_problem

        tj = j_reduced(rj.alpha, rj.beta, 0.0, "normal")
        tt = solve_reduced_problem(t(rj.alpha), t(rj.beta), 0.0, "normal")
        assert rel(tt[0].numpy(), tj[0]) <= 1e-12
        np.testing.assert_array_equal(tt[3].numpy(), np.asarray(tj[3]))


def _objective(fn, A0, B0, x, lib):
    lam, Phi = fn(A0 + lib.diag(x), B0 + 0.02 * lib.diag(x))
    return lib.sum(lib.log(lam)) + lib.sum(Phi[:7, :] ** 2)


def _torch_grad(fn, A0, B0, x0):
    x = t(x0).requires_grad_(True)
    _objective(fn, t(A0), t(B0), x, torch).backward()
    return x.grad.numpy()


@pytest.mark.parametrize("method", ["sibk", "laa", "pcpg", "pgmres"])
def test_dense_gradient_matches_jax(pencil, method):
    """The tests/test_adjoint.py objective (n 80, N 4, m 55) through JAX's
    eigh_gen_dense and the port's dense path from JAX's start vector (an
    EigProblem of DenseOperators with no factor: make_shift_factor and the
    single-vector solver, as in eigh_gen_dense), to 1e-8 for every method.
    The port's own eigh_gen_dense starts from its torch.Generator: the
    converged methods hold against jax.grad and the torch oracle at
    1e-8 all the same."""
    A0, B0 = pencil
    x0 = 0.05 * np.random.default_rng(4).standard_normal(80)
    cfg_kw = dict(N=N_MODES, m=55, sigma=0.0, adjoint_method=method,
                  adjoint_maxiter=60)
    jcfg = jad.EighGenConfig(**cfg_kw)
    gj = np.asarray(jax.grad(lambda x: _objective(
        lambda A, B: jad.eigh_gen_dense(A, B, jcfg), jnp.asarray(A0),
        jnp.asarray(B0), x, jnp))(jnp.asarray(x0)))

    tcfg = tad.EighGenConfig(**cfg_kw)
    v0 = t(j_start(80))
    At0, Bt0 = t(A0), t(B0)
    problem = tad.EigProblem(
        assemble=lambda th: (DenseOperator(At0 + torch.diag(th)),
                             DenseOperator(Bt0 + 0.02 * torch.diag(th))),
        v0=lambda th: v0)
    x = t(x0).requires_grad_(True)
    lam, Phi = tad.eigh_gen(x, problem, tcfg)
    (torch.sum(torch.log(lam)) + torch.sum(Phi[:7, :] ** 2)).backward()
    assert rel(x.grad.numpy(), gj) <= 1e-8

    if method != "laa":
        gt = _torch_grad(lambda A, B: tad.eigh_gen_dense(A, B, tcfg), A0, B0,
                         x0)
        go = _torch_grad(lambda A, B: tad.eigh_gen_oracle(A, B, N_MODES), A0,
                         B0, x0)
        assert rel(gt, gj) <= 1e-8
        assert rel(gt, go) <= 1e-8


def test_oracles_match_jax(pencil):
    """eigh_gen_oracle (values and gradient) and the directional oracle
    against JAX's, eigenvectors up to sign: 1e-10."""
    A0, B0 = pencil
    x0 = 0.05 * np.random.default_rng(4).standard_normal(80)
    wj, pj = jad.eigh_gen_oracle(jnp.asarray(A0), jnp.asarray(B0), N_MODES)
    wt, pt = tad.eigh_gen_oracle(t(A0), t(B0), N_MODES)
    assert rel(wt.numpy(), wj) <= 1e-10
    assert rel(align(pt.numpy(), np.asarray(pj)), pj) <= 1e-10
    gj = np.asarray(jax.grad(lambda x: _objective(
        lambda A, B: jad.eigh_gen_oracle(A, B, N_MODES), jnp.asarray(A0),
        jnp.asarray(B0), x, jnp))(jnp.asarray(x0)))
    gt = _torch_grad(lambda A, B: tad.eigh_gen_oracle(A, B, N_MODES), A0, B0,
                     x0)
    assert rel(gt, gj) <= 1e-10

    rng = np.random.default_rng(5)
    dA = rng.standard_normal((80, 80))
    dA = dA + dA.T
    dB = 0.02 * np.diag(rng.standard_normal(80))
    lj, Pj, dlj, dPj = jad.eigh_gen_directional_oracle(A0, B0, dA, dB,
                                                       N_MODES)
    lt, Pt, dlt, dPt = tad.eigh_gen_directional_oracle(
        t(A0), t(B0), t(dA), t(dB), N_MODES)
    s = np.where(np.sum(Pt.numpy() * Pj, axis=0) < 0.0, -1.0, 1.0)
    assert rel(lt.numpy(), lj) <= 1e-10
    assert rel(dlt.numpy(), dlj) <= 1e-10
    assert rel(dPt.numpy() * s, dPj) <= 1e-10


@pytest.fixture(scope="module")
def solved(pencil):
    """One forward solve on each side (shift -1) from the same start
    vector, on the pencil with its two lowest modes moved to eigenvalue 0
    (a null space, as the rigid modes of the models) and deflated: pcpg
    resolves them explicitly."""
    A, B = pencil
    mu, V = scipy.linalg.eigh(A, B)
    BV = B @ V[:, :2]
    A = A - BV @ np.diag(mu[:2]) @ BV.T
    A = 0.5 * (A + A.T)
    U0 = V[:, :2].T
    from eigd_tpu.ops.lanczos import b_orthonormalize_rows as j_bortho

    Bj = JDense(jnp.asarray(B))
    dj = j_bortho(jnp.asarray(U0), Bj.mv)
    dt = b_orthonormalize_rows(t(U0), DenseOperator(t(B)).mv)
    fj = jfac.make_shift_factor(jnp.asarray(A), jnp.asarray(B), -1.0)
    ft = tfac.make_shift_factor(t(A), t(B), -1.0)
    v0 = j_start(80)
    rj = j_lanczos(JDense(jnp.asarray(A)), Bj, fj, -1.0, N_MODES, 55,
                   v0=jnp.asarray(v0), deflate=dj)
    rt = lanczos_solve(t(A), t(B), ft, -1.0, N_MODES, 55, v0=t(v0),
                       deflate=dt)
    Phib = np.random.default_rng(1).standard_normal((80, N_MODES))
    return (A, B, Phib), (fj, rj, dj), (ft, rt, dt)


def test_pcpg_pgmres_and_total_derivative_match_jax(solved):
    """pcpg with the deflated modes resolved explicitly, pgmres, and
    add_eig_total_derivative on the same forward solve: psi and the
    derivative to 1e-9, the adjoint residual under 1e-8 of ||Phib||."""
    (A, B, Phib), (fj, rj, dj), (ft, rt, dt) = solved
    Aj, Bj = jnp.asarray(A), jnp.asarray(B)
    psi0j = jadj.laa(jnp.asarray(Phib), JDense(Bj), fj, rj, b_ortho=True)
    psi0t = tadj.laa(t(Phib), t(B), ft, rt, b_ortho=True)
    assert rel(psi0t.numpy(), psi0j) <= 1e-9
    kw = dict(rtol=1e-12, maxiter=60)
    sync.clear()
    outs = {
        "pcpg": (jadj.pcpg(jnp.asarray(Phib), Aj, Bj, rj.lam, rj.Phi,
                           psi=psi0j, factor=fj, deflate=dj, **kw),
                 tadj.pcpg(t(Phib), t(A), t(B), rt.lam, rt.Phi, psi=psi0t,
                           factor=ft, deflate=dt, **kw)),
        "pgmres": (jadj.pgmres(jnp.asarray(Phib), Aj, Bj, rj.lam, rj.Phi,
                               psi=psi0j, factor=fj, **kw),
                   tadj.pgmres(t(Phib), t(A), t(B), rt.lam, rt.Phi,
                               psi=psi0t, factor=ft, **kw)),
    }
    assert sync.HOST_SYNCS["pcpg"] > 0 and sync.HOST_SYNCS["pgmres"] > 0
    scale = np.sqrt(np.max(np.sum(Phib**2, axis=0)))
    lamb = np.random.default_rng(2).standard_normal(N_MODES)

    def dAdx(W, V):  # d/dx of diag(x): sum_i w_i * v_i elementwise
        return (W * V).sum(1)

    for name, ((pj, cj, ij), (pt, ct, it)) in outs.items():
        assert rel(pt.numpy(), pj) <= 1e-9, name
        assert int(it["niter"]) == int(ij["niter"]), name
        r, _ = tadj.eval_adjoint_residual_norm(t(A), t(B), rt.lam, rt.Phi,
                                               t(Phib), pt, b_ortho=True)
        assert float(r.max()) / scale <= 1e-8, name
        gj = jadj.add_eig_total_derivative(
            rj.lam, rj.Phi, jnp.asarray(lamb), jnp.asarray(Phib), pj, dAdx,
            dAdx, jnp.zeros(80), adj_corr_data=cj)
        gt = tadj.add_eig_total_derivative(
            rt.lam, rt.Phi, t(lamb), t(Phib), pt, dAdx, dAdx,
            torch.zeros(80, dtype=torch.float64), adj_corr_data=ct)
        assert rel(gt.numpy(), gj) <= 1e-9, name
