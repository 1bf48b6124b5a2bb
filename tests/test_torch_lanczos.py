"""Parity of the port's block shift-invert Lanczos with eigd_tpu's.

Both solve the same plane-stress pencil on a 16x8 grid, with the rigid
modes deflated, from the same numpy (n, p) start block, each on its own
multigrid factor. With the exact sweep every factor apply is solved to
rtol 1e-13, so both sides build the same Krylov space up to rounding: the
eigenvalues agree to 1e-10 relative and the eigenvector subspaces to
angles of at most 1e-8 (Phi may differ by column signs, which angles do
not see).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigd_tpu.fem import assembly as jfem
from eigd_tpu.fem.model import make_grid
from eigd_tpu.fem.quad import plane_stress_tables
from eigd_tpu.ops.lanczos import b_orthonormalize_rows as j_bortho
from eigd_tpu.ops.lanczos import block_lanczos_solve as j_solve
from eigd_tpu.ops.multigrid import GridMGFactor as JFactor
from eigd_tpu.ops.operators import ElementOperator as JElementOperator
from eigd_tpu.ops.stencil import GridStencilOperator as JGrid
from eigd_tpu_torch.interop import stencil_operator_from_numpy
from eigd_tpu_torch.ops.lanczos import b_orthonormalize_rows as t_bortho
from eigd_tpu_torch.ops.lanczos import block_lanczos_solve as t_solve
from eigd_tpu_torch.ops.multigrid import GridMGFactor as TFactor

torch.set_num_threads(1)
NX, NY, N, P, SIGMA = 16, 8, 4, 4, -1.0


def subspace_angle(A, B):
    """Largest principal angle between the column spaces of A and B, by
    its sine ||(I - Qa Qa^T) Qb||_2 (accurate for small angles, where the
    arccos of the cosines floors near 1e-8)."""
    qa, _ = np.linalg.qr(A)
    qb, _ = np.linalg.qr(B)
    sin = np.linalg.norm(qb - qa @ (qa.T @ qb), 2)
    return float(np.arcsin(min(sin, 1.0)))


@pytest.fixture(scope="module")
def pencil():
    m = make_grid(NX, NY, 2.0, 1.0)
    conn = jnp.asarray(m.conn)
    Be, He, detJ = plane_stress_tables(jnp.asarray(m.X), conn)
    dofs = jfem.element_dof_map(conn)
    rhoE = jnp.asarray(np.random.default_rng(0).uniform(0.3, 1.0, m.nelems))
    n = 2 * m.nnodes
    K = jfem.stiffness_matrix(rhoE, Be, detJ, dofs, n, jfem.plane_stress_C0())
    M = jfem.mass_matrix(rhoE, He, detJ, dofs, n)
    ops = [JGrid.from_element_operator(JElementOperator(E.mats, dofs, n),
                                       (NX, NY), 2) for E in (K, M)]
    U0 = np.zeros((3, n))
    U0[0, 0::2] = 1.0
    U0[1, 1::2] = 1.0
    U0[2, 0::2] = -m.X[:, 1]
    U0[2, 1::2] = m.X[:, 0]
    v0 = np.random.default_rng(5).uniform(-1.0, 1.0, (n, P))
    return ops, U0, v0


@pytest.mark.parametrize("ortho", ["local", "full"])
def test_block_lanczos_matches(pencil, ortho):
    (Aj, Bj), U0, v0 = pencil
    kw = dict(mode="normal", ortho=ortho, polish=1, sweep="exact")
    fj = JFactor.build(Aj.W - SIGMA * Bj.W, (NX, NY), 2, min_coarse=64)
    rj = j_solve(Aj, Bj, fj, SIGMA, N, 64, P, v0=jnp.asarray(v0),
                 deflate=j_bortho(jnp.asarray(U0), Bj.mv), **kw)

    At, Bt = (stencil_operator_from_numpy(np.asarray(o.W), None, None, o.n,
                                          (NX, NY), 2, device="cpu")
              for o in (Aj, Bj))
    ft = TFactor.build(At.W - SIGMA * Bt.W, (NX, NY), 2, min_coarse=64)
    rt = t_solve(At, Bt, ft, SIGMA, N, 64, P, v0=torch.as_tensor(v0),
                 deflate=t_bortho(torch.as_tensor(U0), Bt.mv), **kw)

    lam_j, lam_t = np.asarray(rj.lam), rt.lam.numpy()
    assert np.abs(lam_t - lam_j).max() <= 1e-10 * np.abs(lam_j).max()
    Phi_j, Phi_t = np.asarray(rj.Phi), rt.Phi.numpy()
    assert subspace_angle(Phi_t, Phi_j) <= 1e-8
    # column by column, up to sign (the spectrum is simple here)
    for i in range(N):
        c = abs(Phi_t[:, i] @ Phi_j[:, i]) / (
            np.linalg.norm(Phi_t[:, i]) * np.linalg.norm(Phi_j[:, i]))
        assert 1.0 - c <= 1e-12
    assert rt.niter == int(rj.niter)
    np.testing.assert_allclose(rt.eig_res_measured.numpy(),
                               np.asarray(rj.eig_res_measured), rtol=0,
                               atol=1e-9 * np.abs(lam_j).max())


def test_full_rayleigh_ritz_matches():
    """Rayleigh-Ritz on a measured projected operator: Ritz values and the
    mapped eigenvalues at 1e-13, sort order equal, vectors up to sign."""
    from eigd_tpu.ops.lanczos import full_rayleigh_ritz as j_rr
    from eigd_tpu_torch.ops.lanczos import full_rayleigh_ritz as t_rr

    rng = np.random.default_rng(3)
    BV, W = rng.standard_normal((8, 50)), rng.standard_normal((8, 50))
    tj, Yj, lj, oj = (np.asarray(a) for a in j_rr(jnp.asarray(BV),
                                                   jnp.asarray(W), -1.0,
                                                   "normal"))
    tt, Yt, lt, ot = (a.numpy() for a in t_rr(torch.as_tensor(BV),
                                              torch.as_tensor(W), -1.0,
                                              "normal"))
    assert np.abs(tt - tj).max() <= 1e-13 * np.abs(tj).max()
    assert np.abs(lt - lj).max() <= 1e-13 * np.abs(lj).max()
    np.testing.assert_array_equal(ot, oj)
    assert np.abs(np.abs(Yt.T @ Yj) - np.eye(8)).max() <= 1e-12


# ---------------------------------------------------------------------------
# BasicLanczos, the Cayley map and the measured residual
# ---------------------------------------------------------------------------


def make_spd_pencil(n, seed=0):
    """The pencil of tests/test_lanczos.py: eigenvalues 1..100 then
    200-500, congruent to a B near the identity."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    w = np.concatenate([np.arange(1.0, 11.0) ** 2,
                        np.linspace(200.0, 500.0, n - 10)])
    Bm = rng.standard_normal((n, n)) * 0.05
    Bm = Bm @ Bm.T + np.eye(n)
    L = np.linalg.cholesky(Bm)
    A = L @ (Q @ np.diag(w) @ Q.T) @ L.T
    return 0.5 * (A + A.T), Bm


def jax_v0(n, seed=12345):
    """JAX's default start vector (jax.random, f64)."""
    import jax

    return np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (n,),
                                         dtype=jnp.float64, minval=-1.0,
                                         maxval=1.0))


def _both(A, B, sigma=0.0, mode="normal", **kw):
    """JAX's BasicLanczos and the port's (from JAX's start vector), each
    solved on the dense pencil (A, B)."""
    from eigd_tpu import BasicLanczos as JBasic
    from eigd_tpu import make_shift_factor as j_factor
    from eigd_tpu_torch import BasicLanczos as TBasic
    from eigd_tpu_torch import make_shift_factor as t_factor

    fmode = "normal" if mode == "cayley" else mode
    sj = JBasic(mode=mode, **kw)
    sj.solve(jnp.asarray(A), jnp.asarray(B),
             j_factor(jnp.asarray(A), jnp.asarray(B), sigma, mode=fmode),
             sigma)
    At, Bt = torch.as_tensor(A), torch.as_tensor(B)
    st = TBasic(mode=mode, v0=torch.tensor(jax_v0(A.shape[0])), **kw)
    st.solve(At, Bt, t_factor(At, Bt, sigma, mode=fmode), sigma)
    return sj, st


def test_basic_lanczos_solve_matches_jax():
    """solve on the 80-DOF pencil (N 5, m 50): lam against JAX's at
    1e-10, eigenvectors up to sign at 1e-9, converged (fail False), the
    same step count."""
    import scipy.linalg

    A, B = make_spd_pencil(80, seed=8)
    sj, st = _both(A, B, N=5, m=50)
    lam_ref = scipy.linalg.eigh(A, B, eigvals_only=True)[:5]
    assert np.abs(st.lam0.numpy() - np.asarray(sj.lam0)).max() <= (
        1e-10 * lam_ref.max())
    Pj, Pt = np.asarray(sj.Phi), st.Phi.numpy()
    assert np.abs(np.abs(Pt) - np.abs(Pj)).max() <= 1e-9 * np.abs(Pj).max()
    assert not st.fail and st.niter == sj.niter == 50


def test_basic_lanczos_ntarget_grows_past_a_repeated_pair():
    """Ntarget 3 with eigenvalues 3 and 4 repeated (n 50, m 40): N grows to
    4 in both packages, and Phi widens from the stored basis."""
    n = 50
    rng = np.random.default_rng(9)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    w = np.arange(1.0, n + 1.0)
    w[2] = w[3]
    sj, st = _both(Q @ np.diag(w) @ Q.T, np.eye(n), Ntarget=3, m=40)
    assert st.N == sj.N == 4
    assert st.Phi.shape == (n, 4)
    assert np.abs(st.lam0.numpy() - np.asarray(sj.lam0)).max() <= 1e-10 * 4


def test_basic_lanczos_warns_on_non_convergence():
    """A starved budget (m 10, N 8, a clustered spectrum) is surfaced: the
    warning, fail, and eig_res above tol, as in JAX."""
    n = 60
    rng = np.random.default_rng(4)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = Q @ np.diag(np.linspace(1.0, 2.0, n)) @ Q.T
    with pytest.warns(UserWarning, match="did not converge"):
        _, st = _both(A, np.eye(n), N=8, m=10, tol=1e-14)
    assert st.fail and np.any(st.eig_res > 1e-14)


def test_cayley_map_matches_dense():
    """BasicLanczos(mode="cayley") at n 50 (sigma 0.5; A's eigenvalues
    1..80): lam against scipy's eigh at rtol 1e-9 and against JAX's, and
    the adjoint dispatch refuses the map."""
    import scipy.linalg

    n = 50
    rng = np.random.default_rng(3)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = Q @ np.diag(np.linspace(1.0, 80.0, n)) @ Q.T
    Bm = rng.standard_normal((n, n)) * 0.1
    B = np.eye(n) + Bm @ Bm.T
    sj, st = _both(A, B, sigma=0.5, mode="cayley", N=5, m=40)
    lam_ref = scipy.linalg.eigh(A, B, eigvals_only=True)[:5]
    np.testing.assert_allclose(st.lam0.numpy(), lam_ref, rtol=1e-9)
    np.testing.assert_allclose(st.lam0.numpy(), np.asarray(sj.lam0),
                               rtol=1e-12)
    with pytest.raises(ValueError, match="cayley"):
        st.solve_adjoint(torch.zeros((n, 5), dtype=torch.float64))


@pytest.mark.parametrize("method", ["laa", "sibk", "pcpg", "pgmres", "dl"])
def test_basic_lanczos_adjoint_methods_match_jax(method):
    """solve_adjoint by each method on the pencil of tests/test_adjoint.py
    (n 70, N 3, m 50), then add_total_derivative with dA/dx = dB/dx = I
    probes: the port's total derivative against JAX's (same method, same
    start vector) at 1e-8 of its largest entry, and the adjoint residual
    of the exact methods at 1e-8 relative. dl is held as
    tests/test_adjoint.py holds JAX's on this chain, which runs past
    convergence (m 50 for N 3, where the reverse sweep amplifies
    rounding): the total derivative at 1e-4 (against JAX's and against
    the port's sibk) and the residual at 5e-2."""
    from test_torch_adjoint import _make_pencil

    A, B = _make_pencil(70, 5)
    sj, st = _both(A, B, N=3, m=50)
    rng = np.random.default_rng(6)
    Phib_j = rng.standard_normal((70, 3))
    lamb = rng.standard_normal(3)
    # the same objective on the port's eigenvectors, whose column signs
    # are eigh's own
    Phib = Phib_j * np.sign(np.sum(st.Phi.numpy() * np.asarray(sj.Phi), 0))
    kw = {} if method in ("laa", "dl") else {"rtol": 1e-13}
    pj, dj = sj.solve_adjoint(jnp.asarray(Phib_j), method=method, **kw)
    pt, dt = st.solve_adjoint(torch.as_tensor(Phib), method=method, **kw)
    gj = np.asarray(sj.add_total_derivative(
        jnp.asarray(lamb), jnp.asarray(Phib_j), pj,
        lambda W, V: jnp.sum(W * V, axis=1),
        lambda W, V: jnp.sum(W * V, axis=1), jnp.zeros(70),
        adj_corr_data=dj))
    gt = st.add_total_derivative(
        torch.as_tensor(lamb), torch.as_tensor(Phib), pt,
        lambda W, V: torch.sum(W * V, dim=1),
        lambda W, V: torch.sum(W * V, dim=1), torch.zeros(70,
                                                          dtype=torch.float64),
        adj_corr_data=dt).numpy()
    tol = 1e-4 if method == "dl" else 1e-8
    assert np.abs(gt - gj).max() <= tol * np.abs(gj).max()
    if method == "dl":
        ps, ds = st.solve_adjoint(torch.as_tensor(Phib), rtol=1e-13)
        gs = st.add_total_derivative(
            torch.as_tensor(lamb), torch.as_tensor(Phib), ps,
            lambda W, V: torch.sum(W * V, dim=1),
            lambda W, V: torch.sum(W * V, dim=1),
            torch.zeros(70, dtype=torch.float64), adj_corr_data=ds).numpy()
        assert np.abs(gt - gs).max() <= 1e-4 * np.abs(gs).max()
    if method != "laa":
        r, _ = st.eval_adjoint_residual_norm(torch.as_tensor(Phib), pt,
                                             b_ortho=True)
        scale = np.sqrt(np.max(np.sum(Phib**2, axis=0)))
        assert float(r.max()) <= (5e-2 if method == "dl" else 1e-8) * scale


class _InexactFactor:
    """Exact mv; approx_mv = the exact apply plus a fixed symmetric
    perturbation E (a linear, preconditioner-quality solve), as in
    tests/test_lanczos.py's TestMeasuredResidual."""

    def __init__(self, exact, E, wrap):
        self.exact, self.E, self.wrap = exact, wrap(E), wrap

    def mv(self, x):
        return self.exact.mv(x)

    def approx_mv(self, x):
        return self.exact.mv(x) + self.E @ x


def test_measure_eig_res_matches_jax():
    """measure_res on the block solver (n 96, N 4, m 64, p 4, local ortho,
    the approx sweep, polish 0) from one start block: the coupling bound
    understates the true residual, eig_res_measured equals JAX's at 1e-10
    relative and an independent ||A Phi - B Phi lam|| at 1e-10, and the
    flag moves neither lam nor Phi (bitwise)."""
    from eigd_tpu.ops.factor import make_shift_factor as j_factor
    from eigd_tpu_torch.ops.factor import make_shift_factor as t_factor

    n = 96
    rng = np.random.default_rng(0)
    Qm, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = Qm @ np.diag(np.concatenate([np.linspace(1.0, 6.0, 8),
                                     np.linspace(40.0, 200.0, n - 8)])) @ Qm.T
    E = rng.standard_normal((n, n)) * 1e-4
    E = 0.5 * (E + E.T)
    v0 = np.random.default_rng(1).uniform(-1.0, 1.0, (n, 4))
    kw = dict(N=4, m=64, p=4, ortho="local", sweep="approx", polish=0)
    fj = _InexactFactor(j_factor(jnp.asarray(A), jnp.eye(n), -1.0), E,
                        jnp.asarray)
    rj = j_solve(jnp.asarray(A), jnp.eye(n), fj, -1.0, v0=jnp.asarray(v0),
                 measure_res=True, **kw)
    At = torch.as_tensor(A)
    Bt = torch.eye(n, dtype=torch.float64)
    ft = _InexactFactor(t_factor(At, Bt, -1.0), E, torch.as_tensor)
    rt = t_solve(At, Bt, ft, -1.0, v0=torch.as_tensor(v0), measure_res=True,
                 **kw)
    r0 = t_solve(At, Bt, ft, -1.0, v0=torch.as_tensor(v0), **kw)
    measured, bound = rt.eig_res_measured.numpy(), rt.eig_res.numpy()
    assert bound.max() < 1e-6 and measured.max() > 50 * bound.max()
    np.testing.assert_allclose(measured, np.asarray(rj.eig_res_measured),
                               rtol=1e-10)
    direct = np.linalg.norm(A @ rt.Phi.numpy() - rt.Phi.numpy()
                            * rt.lam.numpy()[None, :], axis=0)
    np.testing.assert_allclose(measured, direct, rtol=1e-10)
    assert r0.eig_res_measured is None
    assert torch.equal(rt.lam, r0.lam) and torch.equal(rt.Phi, r0.Phi)


def test_measure_eig_res_through_eigh_gen():
    """EighGenConfig.measure_eig_res reaches the block solve of eigh_gen:
    the kept forward's eig_res_measured is the pencil residual of lam and
    Phi (1e-10 relative), and lam and Phi equal those without the flag."""
    from eigd_tpu_torch.ops.autodiff import (EigProblem, EighGenConfig,
                                             eigh_gen, kept_forward)
    from eigd_tpu_torch.ops.operators import DenseOperator

    A, B = make_spd_pencil(60, seed=2)
    At, Bt = torch.as_tensor(A), torch.as_tensor(B)
    v0 = torch.as_tensor(np.random.default_rng(2).uniform(-1, 1, (60, 4)))
    prob = EigProblem(assemble=lambda x: (DenseOperator(At * x),
                                          DenseOperator(Bt)),
                      v0=lambda x: v0)
    x = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    out = {}
    for flag in (True, False):
        cfg = EighGenConfig(N=4, m=40, block=4, measure_eig_res=flag)
        lam, Phi = eigh_gen(x, prob, cfg)
        out[flag] = (lam.detach(), Phi.detach(),
                     kept_forward(lam)[2].eig_res_measured)
    lam, Phi, measured = out[True]
    direct = torch.linalg.norm(At @ Phi - (Bt @ Phi) * lam[None, :], dim=0)
    np.testing.assert_allclose(measured.numpy(), direct.numpy(), rtol=1e-10)
    assert out[False][2] is None
    assert torch.equal(lam, out[False][0]) and torch.equal(Phi, out[False][1])
