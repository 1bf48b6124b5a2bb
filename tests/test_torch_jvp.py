"""Forward mode: the port's eigh_gen_tangent and staged_jvp, on the CPU.

(a) ``eigh_gen_tangent`` against eigd_tpu's at the 12x6 parity
configuration of tests/test_torch_natural_frequency.py, from the same
start block and the same dtheta, with the kernel path (twins on the CPU)
and the plain path; (b) the port's ``staged_jvp`` against its own
reverse-mode gradient along the same direction, the jvp-vs-vjp oracle of
the 1M-DOF problem (tests/test_autodiff_jvp.py holds eigd_tpu to the same
check).

Bounds. "exact" solves every factor apply and the tangent's projected
systems to rtol 1e-13 / 1e-12, so the packages agree to f64 rounding:
measured dlam 2.6e-14 and dPhi 7.2e-14 against bounds 1e-10 and 1e-8.
"approx" drives the sweep and the mixed ladder with f32 solves whose
rounding differs between XLA:CPU and torch (test_torch_natural_frequency
.py, bounds 1e-8 on lam and 5e-6 on the gradient): measured dlam 9.9e-7
and dPhi 1.9e-6, bound 5e-6 on both. jvp-vs-vjp within the port shares
the primal solve: measured 3.8e-14 (exact) and 1.7e-10 (approx), bound
1e-9.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigd_tpu.fem import assembly as jfem
from eigd_tpu.models.natural_frequency import make_model as j_make_model
from eigd_tpu.ops.autodiff import EigProblem as j_problem
from eigd_tpu.ops.autodiff import EighGenConfig as j_config
from eigd_tpu.ops.autodiff import eigh_gen_tangent as j_tangent
from eigd_tpu.ops.operators import DenseOperator as JDense
from eigd_tpu_torch.fem import assembly as tfem
from eigd_tpu_torch.models.natural_frequency import make_model as t_make_model
from eigd_tpu_torch.ops import sync
from eigd_tpu_torch.ops.autodiff import EigProblem as t_problem
from eigd_tpu_torch.ops.autodiff import EighGenConfig as t_config
from eigd_tpu_torch.ops.autodiff import eigh_gen_tangent, staged_jvp
from eigd_tpu_torch.ops.operators import DenseOperator

torch.set_num_threads(1)
KW = dict(nx=12, ny=6, N=2, m=32, Lx=2.0, Ly=1.0, rfact=2.0, factor_kind="mg",
          lanczos_block=4, lanczos_ortho="local", lanczos_tol=1e-11,
          lanczos_polish=1)
MIXED = {"mixed": True, "ladder": "approx", "maxiter": 30, "nrestart": 8}
V0 = np.random.default_rng(11).uniform(-1.0, 1.0, (2 * 13 * 7, 4))
DTHETA = np.random.default_rng(3).uniform(-1.0, 1.0, 72)


def config(sweep):
    kw = dict(KW, lanczos_sweep=sweep)
    if sweep == "approx":
        kw["adjoint_options"] = MIXED
    return kw


def t_model(sweep, kernel_mv="on"):
    topo = t_make_model(kernel_mv=kernel_mv, device="cpu",
                        factor_options={"min_coarse": 64,
                                        "vcycle": "kernel" if kernel_mv == "on"
                                        else "plain"}, **config(sweep))
    topo.problem = dataclasses.replace(topo.problem,
                                       v0=lambda th: torch.as_tensor(V0))
    return topo


def t_pre(topo):
    return lambda x: tfem.element_density(topo.fltr.apply(x), topo.conn)


def t_tail(lam, Q):
    eta = torch.exp(-2.0 * (lam - lam[0]))
    return torch.sum(torch.sqrt(lam)) + torch.sum(eta[None, :] * Q[:8] ** 2)


@pytest.mark.parametrize("sweep,tol_dlam,tol_dphi",
                         [("exact", 1e-10, 1e-8), ("approx", 5e-6, 5e-6)])
def test_tangent_matches_jax(sweep, tol_dlam, tol_dphi):
    jt = j_make_model(pallas_mv="off", factor_options={"min_coarse": 64},
                      **config(sweep))
    jt.problem = dataclasses.replace(jt.problem,
                                     v0=lambda th: jnp.asarray(V0))
    th = jfem.element_density(jt.fltr.apply(jnp.asarray(jt.x)), jt.conn)
    _, Phi, dlam, dPhi = map(np.asarray, j_tangent(
        th, jnp.asarray(DTHETA), jt.problem, jt.cfg))
    for kernel_mv in ("on", "off"):
        topo = t_model(sweep, kernel_mv)
        out = eigh_gen_tangent(t_pre(topo)(topo.x), torch.as_tensor(DTHETA),
                               topo.problem, topo.cfg)
        _, tPhi, tdlam, tdPhi = (t.numpy() for t in out)
        sign = np.sign(np.sum(tPhi * Phi, axis=0))  # eigenvector signs
        assert np.abs(tdlam - dlam).max() <= tol_dlam * np.abs(dlam).max()
        assert (np.abs(tdPhi * sign - dPhi).max()
                <= tol_dphi * np.abs(dPhi).max())


@pytest.mark.parametrize("sweep", ["exact", "approx"])
def test_staged_jvp_matches_reverse_mode(sweep):
    topo = t_model(sweep)
    x = topo.x.clone().requires_grad_(True)
    lam, Q, _, _ = topo._solve_fn(x)
    value = t_tail(lam, Q)
    value.backward()
    p = torch.as_tensor(np.random.default_rng(7).uniform(size=x.shape))
    ans = float(p @ x.grad)
    sync.clear()
    v, dv = staged_jvp(t_pre(topo), t_tail, topo.problem, topo.cfg)(topo.x, p)
    assert float(v) == value.item()  # one primal solve in both modes
    assert abs(ans - float(dv)) <= 1e-9 * abs(float(dv))
    # the forward's one adaptive-exit sweep and the tangent's solves were
    # counted
    assert (sync.LOOP_EXITS["lanczos_exit.converged"]
            + sync.LOOP_EXITS["lanczos_exit.last_block"]) == 1
    assert sync.LOOP_STEPS["lanczos_exit"] > 0
    assert sync.HOST_SYNCS["sibk_round"] > 0


def test_tangent_is_normal_mode_only():
    """The tangent outside the normal mode: in buckling mode, on a dense
    (G, K) pencil along (dG, dK) from one start vector, lam, dlam and dPhi
    (up to sign) against eigd_tpu's eigh_gen_tangent at 1e-9 of each
    (tests/test_torch_buckling.py holds both to the directional oracle); a
    mode with no tangent rule raises."""
    rng = np.random.default_rng(17)
    n = 36
    S = rng.standard_normal((n, n))
    K0 = S @ S.T + n * np.eye(n)
    T = rng.standard_normal((n, n)) * 0.3
    G0 = -(T @ T.T + 0.5 * np.eye(n))
    dK, dG = rng.standard_normal((2, n, n))
    dK, dG = 0.5 * (dK + dK.T), 0.05 * (dG + dG.T)
    v0 = rng.uniform(-1.0, 1.0, n)
    kw = dict(N=3, m=36, sigma=0.05, mode="buckling", adjoint_method="sibk",
              adjoint_maxiter=60, nrestart=3)
    jprob = j_problem(lambda th: (JDense(jnp.asarray(G0) + th * dG),
                                  JDense(jnp.asarray(K0) + th * dK)),
                      v0=lambda th: jnp.asarray(v0))
    ref = [np.asarray(a) for a in j_tangent(
        jnp.asarray(0.0), jnp.asarray(1.0), jprob, j_config(**kw))]
    tG0, tK0, tdG, tdK = (torch.as_tensor(a) for a in (G0, K0, dG, dK))
    tprob = dataclasses.replace(
        t_problem(lambda th: (DenseOperator(tG0 + th * tdG),
                              DenseOperator(tK0 + th * tdK))),
        v0=lambda th: torch.as_tensor(v0))
    cfg = t_config(**kw)
    got = [a.numpy() for a in eigh_gen_tangent(
        torch.tensor(0.0, dtype=torch.float64),
        torch.tensor(1.0, dtype=torch.float64), tprob, cfg)]
    sign = np.sign(np.sum(got[1] * ref[1], axis=0))
    for a, b in ((got[0], ref[0]), (got[2], ref[2]),
                 (got[3] * sign, ref[3])):
        assert np.abs(a - b).max() <= 1e-9 * np.abs(b).max()
    with pytest.raises(NotImplementedError):
        eigh_gen_tangent(torch.tensor(0.0, dtype=torch.float64),
                         torch.tensor(1.0, dtype=torch.float64), tprob,
                         dataclasses.replace(cfg, mode="cayley"))
