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
