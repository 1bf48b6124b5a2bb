"""Parity of the port's thermal family (``eigd_tpu_torch.models.thermal``)
with eigd_tpu's, on the CPU: ``ThermalTopologyAnalysis`` on the dense,
multigrid and f32 cyclic-reduction factors, the compliance and aggregate
seeds through several adjoint passes on one solve, ``ThermalOpt``'s
transient KS and its FD check, the 8-fold dvmap and the set-average
vectors of ``make_opt_model``, the repeated-eigenvalue sweep and the
forward-mode thermal chain. Both packages get the same numpy state (the
filter through ``interop.thermal_from_numpy``) and the same Lanczos start
vector (``EigProblem.v0``); each JAX reference is computed once, in a
module-scoped fixture.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigd_tpu.fem import assembly as jfem
from eigd_tpu.models import thermal as jth
from eigd_tpu.ops.autodiff import eigh_gen_fwdmode
from eigd_tpu_torch.fem import assembly as tfem
from eigd_tpu_torch.interop import thermal_from_numpy
from eigd_tpu_torch.models import thermal as tth
from eigd_tpu_torch.ops.autodiff import staged_jvp

torch.set_num_threads(1)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _v0(n):
    return np.random.default_rng(3).uniform(-1.0, 1.0, n)


def _pair(jt, device="cpu", **config):
    """The port's analysis on JAX's state (design, mesh, element sets,
    filter ELL, dvmap), both started from one numpy vector."""
    f = jt.fltr
    dv = None if f.dvmap is None else np.asarray(f.dvmap)
    tt = thermal_from_numpy(
        np.asarray(jt.x), np.asarray(jt.X), np.asarray(jt.conn),
        jt.element_sets, (np.asarray(f.idx), np.asarray(f.wts)),
        jt.grid_shape, f.r0, device=device, dvmap=dv,
        num_design_vars=f.num_design_vars if dv is not None else None,
        **config)
    v0 = _v0(jt.nnodes)
    jt.problem = dataclasses.replace(jt.problem,
                                     v0=lambda th: jnp.asarray(v0))
    tt.problem = dataclasses.replace(tt.problem,
                                     v0=lambda th: torch.as_tensor(v0))
    return tt


KINDS = ("dense", "mg", "bcr_f32")
NODE = [5, 20, 33]


def _seeds(topo, wrap):
    """The three seeds of a pass: thermal compliance on the center set's
    vector, the eigenvector aggregate (rho 3) and its KS max (rho 3)."""
    vec = topo.mean_vecs["center"]
    return (lambda: topo.add_thermal_compliance_derivative(1.0, vec),
            lambda: topo.add_eigenvector_aggregate_derivative(
                1.0, 3.0, wrap(NODE)),
            lambda: topo.add_eigenvector_aggregate_max_derivative(
                1.0, 3.0, wrap(NODE)))


def _passes(topo, wrap):
    """One initialize, then one adjoint pass per seed; returns xb of each
    pass and the objective values."""
    topo.initialize()
    out = []
    for seed in _seeds(topo, wrap):
        topo.initialize_adjoint()
        seed()
        topo.finalize_adjoint()
        out.append(np.array(topo.xb))
    vals = (float(topo.get_thermal_compliance(topo.mean_vecs["center"])),
            float(topo.get_eigenvector_aggregate(3.0, wrap(NODE))),
            float(topo.get_eigenvector_aggregate_max(3.0, wrap(NODE))))
    return out, vals


@pytest.fixture(scope="module")
def analyses():
    """For each factor kind on the 12x12 model (Ly 1.15, N 6): JAX's
    model, its lam and Q, its xb of each seed's pass and the values."""
    out = {}
    for kind in KINDS:
        jt = jth.make_model(nx=12, ny=12, Ly=1.15, N=6, factor_kind=kind)
        tt = _pair(jt, N=6, factor_kind=kind)
        xbs, vals = _passes(jt, jnp.asarray)
        out[kind] = (jt, tt, np.asarray(jt.lam), np.asarray(jt.Q), xbs, vals)
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_eigenpairs_match_jax(analyses, kind):
    """lam and |Q| against JAX at 1e-9; mode 0 is the constant mode."""
    _, tt, lam_j, Q_j, _, _ = analyses[kind]
    tt.initialize()
    assert rel(tt.lam.numpy(), lam_j) < 1e-9
    assert rel(np.abs(tt.Q.numpy()), np.abs(Q_j)) < 1e-9
    assert abs(float(tt.lam[0])) < 1e-6 and float(tt.lam[1]) > 0.1


@pytest.mark.parametrize("kind", KINDS)
def test_seed_passes_match_jax(analyses, kind):
    """The compliance, aggregate and aggregate-max seeds, each in its own
    adjoint pass on one initialize: every xb against JAX's at 1e-8 of
    max|xb|, and the three objective values at 1e-10."""
    _, tt, _, _, xbs_j, vals_j = analyses[kind]
    xbs, vals = _passes(tt, lambda a: a)
    for xb, xb_j in zip(xbs, xbs_j):
        assert rel(xb, xb_j) < 1e-8
    assert rel(vals, vals_j) < 1e-10


def test_mean_vectors_match_the_loop():
    """make_opt_model's set-average vectors (center and the four corners)
    against JAX's double loop, to 1e-15, and the 8-fold dvmap equal to
    JAX's."""
    sets = lambda: {"center": [], "corner0": [], "corner1": [],  # noqa: E731
                    "corner2": [], "corner3": []}
    jt = jth.make_opt_model(nx=10, element_sets=sets(), N=5)
    tt = tth.make_opt_model(nx=10, element_sets=sets(), N=5, device="cpu")
    assert sorted(tt.mean_vecs) == sorted(jt.mean_vecs)
    for name, v in jt.mean_vecs.items():
        assert rel(tt.mean_vecs[name].numpy(), v) <= 1e-15
        assert np.array_equal(np.asarray(tt.element_sets[name]),
                              np.asarray(jt.element_sets[name]))
    assert np.array_equal(tt.fltr.dvmap.numpy(), np.asarray(jt.fltr.dvmap))
    assert tt.fltr.num_design_vars == jt.fltr.num_design_vars


def _heat(xp):
    return {"case": {"center": lambda t: 1.0 + 0.5 * xp.sin(4.0 * t)}}


@pytest.fixture(scope="module")
def transient():
    """JAX's ThermalOpt on tests/test_thermal.py's 10x10 case (Ly 1.2,
    N 5, 40 steps to t 2): the KS value, xb of the KS seeds and the
    direction JAX's test_ks_func draws."""
    np.random.seed(0)
    jt = jth.make_model(nx=10, ny=10, Ly=1.2, N=5)
    tt = _pair(jt, N=5)
    pert = np.random.uniform(size=np.asarray(jt.x).shape)
    opt = jth.ThermalOpt(jt, _heat(jnp), nsteps=40, tfinal=2.0)
    opt.initialize()
    ks = float(opt.eval_ks_functions(10.0)["case"])
    ksb = {"case": float(np.random.default_rng(0).uniform())}
    opt.initialize_adjoint()
    opt.add_ks_derivative(10.0, ksb)
    opt.finalize_adjoint()
    return tt, pert, ks, np.asarray(jt.xb)


def test_thermal_opt_matches_jax(transient):
    """ThermalOpt: the KS value at 1e-10 and xb at 1e-8 against JAX's,
    then test_ks_func along JAX's direction at JAX's bound, cd_err < 1e-6.
    """
    tt, pert, ks_j, xb_j = transient
    opt = tth.ThermalOpt(tt, _heat(torch), nsteps=40, tfinal=2.0)
    opt.initialize()
    assert abs(float(opt.eval_ks_functions(10.0)["case"]) - ks_j) <= (
        1e-10 * abs(ks_j))
    data = opt.test_ks_func(rho_ks=10.0, dh_fd=1e-6, pert=pert)
    assert rel(tt.xb.numpy(), xb_j) < 1e-8
    assert data["cd_err"] < 1e-6, data


@pytest.mark.parametrize("epsilon", [0.1, 1e-8])
def test_repeated_eig_sweep_matches_jax(epsilon):
    """The domain-asymmetry sweep of tests/test_thermal.py (10x10 square
    model, N = Ntarget = 5, aggregate on nodes 7 and 31, rho 2): the
    Ntarget rule picks JAX's N, and xb matches JAX's at 5e-7, the bound
    of the JAX test's oracle."""
    jt = jth.make_opt_model(nx=10, epsilon=epsilon, N=5, Ntarget=5)
    tt = _pair(jt, N=5, Ntarget=5)
    for topo, wrap in ((jt, jnp.asarray), (tt, torch.as_tensor)):
        topo.initialize()
        topo.initialize_adjoint()
        topo.add_eigenvector_aggregate_derivative(1.0, 2.0, wrap([7, 31]))
        topo.finalize_adjoint()
    assert tt.N == jt.N
    assert rel(tt.xb.numpy(), np.asarray(jt.xb)) < 5e-7


def test_thermal_chain_forward_mode():
    """The thermal chain of tests/test_autodiff_jvp.py (10x10, Ly 1.15,
    N 4; tail sum f_q^2/lam + sum sqrt(lam) with mode 0 skipped): the
    port's vjp against its staged_jvp at 1e-10, and both against JAX's
    jax.jvp through eigh_gen_fwdmode at 1e-9."""
    jt = jth.make_model(nx=10, ny=10, Ly=1.15, N=4)
    tt = _pair(jt, N=4)
    w = np.sin(0.37 * np.arange(jt.nnodes))
    pert = np.random.default_rng(5).uniform(size=np.asarray(jt.x).shape)

    def tail(lam, Q, xp, wv):
        f_q = wv @ Q
        return xp.sum((f_q[1:] ** 2) / lam[1:]) + xp.sum(xp.sqrt(lam[1:]))

    def j_obj(x):
        rhoE = jfem.element_density(jt.fltr.apply(x), jt.conn)
        lam, Q = eigh_gen_fwdmode(rhoE, jt.problem, jt.cfg)
        return tail(lam, Q, jnp, jnp.asarray(w))

    _, dv_j = jax.jvp(j_obj, (jnp.asarray(jt.x),), (jnp.asarray(pert),))
    dv_j = float(dv_j)

    def pre(x):
        return tfem.element_density(tt.fltr.apply(x), tt.conn)

    def t_tail(lam, Q):
        return tail(lam, Q, torch, torch.as_tensor(w))

    x = tt.x.clone().requires_grad_(True)
    t_tail(*tt._solve_fn(x)).backward()
    ans = float(torch.as_tensor(pert) @ x.grad)
    _, dv = staged_jvp(pre, t_tail, tt.problem, tt.cfg)(
        tt.x, torch.as_tensor(pert))
    assert abs(ans - float(dv)) <= 1e-10 * abs(ans)
    assert abs(ans - dv_j) <= 1e-9 * abs(dv_j)
    assert abs(float(dv) - dv_j) <= 1e-9 * abs(dv_j)
