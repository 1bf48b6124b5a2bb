"""Parity of the port's thick-restart Lanczos (``thick_restart_solve``,
``IRAM``) with eigd_tpu's, on the dense pencils of tests/test_lanczos.py
(``TestThickRestartIRAM``), at that test's tolerances. Both packages start
from JAX's default start vector (the port takes it as ``v0``); the
restarts keep the k best Ritz directions under the mode's own order, so
the same cycles run on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from eigd_tpu.ops.factor import make_shift_factor as j_factor
from eigd_tpu.ops.operators import DenseOperator as JDense
from eigd_tpu.ops.restart import IRAM as JIRAM
from eigd_tpu.ops.restart import thick_restart_solve as j_restart
from eigd_tpu_torch import IRAM, thick_restart_solve
from eigd_tpu_torch.ops.factor import make_shift_factor as t_factor
from eigd_tpu_torch.ops.operators import DenseOperator
from test_torch_lanczos import jax_v0, make_spd_pencil

torch.set_num_threads(1)


def _iram_pair(A, B, **kw):
    """JAX's IRAM and the port's (from JAX's start vector), each solved on
    the dense pencil at sigma 0."""
    sj = JIRAM(**kw)
    sj.solve(jnp.asarray(A), jnp.asarray(B),
             j_factor(jnp.asarray(A), jnp.asarray(B), 0.0), 0.0)
    At, Bt = torch.as_tensor(A), torch.as_tensor(B)
    st = IRAM(v0=torch.tensor(jax_v0(A.shape[0])), **kw)
    st.solve(At, Bt, t_factor(At, Bt, 0.0), 0.0)
    return sj, st


def test_restarted_matches_dense():
    """m 22 with restarts (n 150, N 5, ncycle 6): lam against scipy's at
    rtol 1e-9 and JAX's at 1e-12, eig_res under 1e-7, the same steps."""
    A, B = make_spd_pencil(150, seed=11)
    sj, st = _iram_pair(A, B, N=5, m=22, ncycle=6)
    lam_ref = scipy.linalg.eigh(A, B, eigvals_only=True)[:5]
    np.testing.assert_allclose(st.lam0.numpy(), lam_ref, rtol=1e-9)
    np.testing.assert_allclose(st.lam0.numpy(), np.asarray(sj.lam0),
                               rtol=1e-12)
    assert float(st.eig_res.max()) < 1e-7
    assert st.niter == sj.niter


def test_restarted_adjoint_residual():
    """The SIBK adjoint on the restarted subspace (n 120, N 4, m 20):
    residual under 1e-8 relative, and the total derivative with identity
    probes against JAX's at 1e-8."""
    A, B = make_spd_pencil(120, seed=12)
    sj, st = _iram_pair(A, B, N=4, m=20, ncycle=6)
    Phib_j = np.random.default_rng(13).standard_normal((120, 4))
    Phib = Phib_j * np.sign(np.sum(st.Phi.numpy() * np.asarray(sj.Phi), 0))
    lamb = np.random.default_rng(14).standard_normal(4)
    pj, dj = sj.solve_adjoint(jnp.asarray(Phib_j), method="sibk", rtol=1e-12)
    pt, dt = st.solve_adjoint(torch.as_tensor(Phib), method="sibk",
                              rtol=1e-12)
    res, _ = st.eval_adjoint_residual_norm(torch.as_tensor(Phib), pt,
                                           b_ortho=True)
    scale = np.sqrt(np.max(np.sum(Phib**2, axis=0)))
    assert float(res.max()) / scale < 1e-8
    gj = np.asarray(sj.add_total_derivative(
        jnp.asarray(lamb), jnp.asarray(Phib_j), pj,
        lambda W, V: jnp.sum(W * V, axis=1), None, jnp.zeros(120),
        adj_corr_data=dj))
    gt = st.add_total_derivative(
        torch.as_tensor(lamb), torch.as_tensor(Phib), pt,
        lambda W, V: torch.sum(W * V, dim=1), None,
        torch.zeros(120, dtype=torch.float64), adj_corr_data=dt).numpy()
    assert np.abs(gt - gj).max() <= 1e-8 * np.abs(gj).max()


def test_dl_rejected():
    """The compressed basis is no Krylov chain: IRAM refuses dl."""
    A, B = make_spd_pencil(60, seed=14)
    At, Bt = torch.as_tensor(A), torch.as_tensor(B)
    st = IRAM(N=3, m=20, ncycle=3)
    st.solve(At, Bt, t_factor(At, Bt, 0.0), 0.0)
    with pytest.raises(ValueError, match="unrestarted"):
        st.solve_adjoint(torch.zeros((60, 3), dtype=torch.float64),
                         method="dl")


def test_adaptive_cycle_count():
    """The measured-residual exit (n 120, N 4, m 30, ncycle 40) ends in
    the same cycle as JAX's, well inside the budget, with eig_res under
    1e-9 and lam at rtol 1e-9 of scipy's."""
    A, B = make_spd_pencil(120, seed=21)
    sj, st = _iram_pair(A, B, N=4, m=30, ncycle=40)
    assert st.niter == sj.niter < 30 + 39 * (30 - 8)
    assert float(st.eig_res.max()) < 1e-9
    lam_ref = scipy.linalg.eigh(A, B, eigvals_only=True)[:4]
    np.testing.assert_allclose(st.lam0.numpy(), lam_ref, rtol=1e-9)


def _both_restart(A, B, sigma, N, m, ncycle, mode, tol):
    v0 = jax_v0(A.shape[0])
    fmode = dict(mode=mode)
    rj = j_restart(JDense(jnp.asarray(A)), JDense(jnp.asarray(B)),
                   j_factor(jnp.asarray(A), jnp.asarray(B), sigma, **fmode),
                   sigma, N, m=m, ncycle=ncycle, mode=mode, tol=tol,
                   v0=jnp.asarray(v0))
    At, Bt = torch.as_tensor(A), torch.as_tensor(B)
    rt = thick_restart_solve(DenseOperator(At), DenseOperator(Bt),
                             t_factor(At, Bt, sigma, **fmode), sigma, N,
                             m=m, ncycle=ncycle, mode=mode, tol=tol,
                             v0=torch.tensor(v0))
    return rj, rt


def test_buckling_restart_retention():
    """Buckling mode (n 90, N 3, m 24, ncycle 12, tol 1e-13): the restarts
    keep the wanted load factors (the -1/lam order), which match the dense
    oracle at rtol 1e-8 and JAX's at 1e-12, in as many steps."""
    n = 90
    rng = np.random.default_rng(22)
    K = rng.standard_normal((n, n))
    K = K @ K.T + n * np.eye(n)
    G = rng.standard_normal((n, n))
    G = -(G @ G.T) - 0.5 * np.eye(n)
    mu = scipy.linalg.eigh(G, K, eigvals_only=True)
    lam_want = (-1.0 / np.sort(mu))[:3]
    rj, rt = _both_restart(G, K, 0.9 * lam_want[0], 3, 24, 12, "buckling",
                           1e-13)
    np.testing.assert_allclose(rt.lam.numpy(), lam_want, rtol=1e-8)
    np.testing.assert_allclose(rt.lam.numpy(), np.asarray(rj.lam),
                               rtol=1e-12)
    assert rt.niter == int(rj.niter)


def test_breakdown_guard_invariant_subspace():
    """A spectrum of 5 distinct values (n 40): the Krylov space breaks down
    after ~5 steps; the guard leaves zero vectors, and every returned pair
    is a converged eigenpair of {1..5} (eig_res under 1e-9, within 1e-8 of
    an eigenvalue), finite, as in JAX."""
    n = 40
    rng = np.random.default_rng(23)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    w = np.repeat(np.arange(1.0, 6.0), 8)
    rj, rt = _both_restart(Q @ np.diag(w) @ Q.T, np.eye(n), 0.0, 3, 16, 4,
                           "normal", 1e-12)
    lam = rt.lam.numpy()
    assert np.all(np.isfinite(lam)) and np.all(np.isfinite(rt.Phi.numpy()))
    assert float(rt.eig_res.max()) < 1e-9
    assert np.min(np.abs(lam[:, None] - np.arange(1.0, 6.0)[None, :]),
                  axis=1).max() < 1e-8
    np.testing.assert_allclose(lam, np.asarray(rj.lam), rtol=1e-10)
