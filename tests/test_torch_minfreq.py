"""Parity of the port's natural-frequency protocol with eigd_tpu's, on the
CPU: the general assembly, the spatial and Helmholtz filters, the dense
and multigrid ``TopologyAnalysis`` under the three-phase adjoint protocol,
``MinFreqOpt`` and ``add_check_adjoint_residual``, and ``interop``'s
filter carry-over. The same numpy inputs go through the JAX function (x64
on the CPU) and its counterpart in the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigd_tpu.fem import assembly as jfem
from eigd_tpu.fem import model as jmodel
from eigd_tpu.fem.filter import NodeFilter as JNodeFilter
from eigd_tpu.fem.quad import plane_stress_tables as j_tables
from eigd_tpu.models.natural_frequency import MinFreqOpt as JMinFreqOpt
from eigd_tpu.models.natural_frequency import make_model as j_make_model
from eigd_tpu.ops.operators import ElementOperator as JElementOperator
from eigd_tpu.ops.stencil import GridStencilOperator as JGrid
from eigd_tpu_torch.fem import assembly as tfem
from eigd_tpu_torch.fem.filter import NodeFilter as TNodeFilter
from eigd_tpu_torch.fem.quad import plane_stress_tables as t_tables
from eigd_tpu_torch.interop import filter_from_numpy
from eigd_tpu_torch.models.natural_frequency import MinFreqOpt as TMinFreqOpt
from eigd_tpu_torch.models.natural_frequency import make_model as t_make_model
from eigd_tpu_torch.ops.stencil import GridStencilOperator as TGrid

torch.set_num_threads(1)
TOL = 1e-13


def t(a):
    return torch.as_tensor(np.array(a))


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def test_general_assembly_and_to_dense():
    """stiffness_matrix / mass_matrix on a perturbed (non-uniform) 6x4
    mesh, and the dense forms of the element and grid operators: 1e-13."""
    m = jmodel.make_grid(6, 4, 2.0, 1.0)
    rng = np.random.default_rng(0)
    X = m.X + rng.uniform(-0.08, 0.08, m.X.shape)
    conn = jnp.asarray(m.conn)
    Bj, Hj, dJj = j_tables(jnp.asarray(X), conn)
    Bt, Ht, dJt = t_tables(t(X), t(m.conn).long())
    dofs = jfem.element_dof_map(conn)
    n = 2 * m.nnodes
    rhoE = rng.uniform(0.3, 1.0, m.nelems)
    Kj = jfem.stiffness_matrix(jnp.asarray(rhoE), Bj, dJj, dofs, n,
                               jfem.plane_stress_C0(), p=3.0)
    Mj = jfem.mass_matrix(jnp.asarray(rhoE), Hj, dJj, dofs, n,
                          ptype="msimp")
    dofs_t = t(dofs).long()
    Kt = tfem.stiffness_matrix(t(rhoE), Bt, dJt, dofs_t, n,
                               tfem.plane_stress_C0(), p=3.0)
    Mt = tfem.mass_matrix(t(rhoE), Ht, dJt, dofs_t, n, ptype="msimp")
    for a, b in ((Kt, Kj), (Mt, Mj)):
        assert rel(a.mats.numpy(), b.mats) < TOL
        assert rel(a.to_dense().numpy(), b.to_dense()) < TOL
        g = TGrid.from_element_operator(a, (6, 4), 2)
        gj = JGrid.from_element_operator(JElementOperator(b.mats, dofs, n),
                                         (6, 4), 2)
        assert rel(g.to_dense().numpy(), gj.to_dense()) < TOL
        x = rng.standard_normal(n)
        assert rel(g.mv(t(x)).numpy(), a.to_dense().numpy() @ x) < TOL


@pytest.mark.parametrize("ftype,projection", [("spatial", False),
                                              ("spatial", True),
                                              ("helmholtz", False),
                                              ("helmholtz", True)])
def test_filter_apply_and_gradient(ftype, projection):
    """Spatial and Helmholtz filters with a symmetric dvmap (frozen -1
    entries): apply and apply_gradient against JAX's, each package
    building its own state, then the port's filter on JAX's state
    (interop.filter_from_numpy): 1e-13."""
    nx, ny = 12, 6
    m = jmodel.make_grid(nx, ny, 2.0, 1.0)
    dvmap, ndv, _, _ = jmodel.make_symmetric_dvmap_with_sets(m, rfact=2.0)
    kw = dict(r0=2.0 * (1.0 / ny), ftype=ftype, dvmap=dvmap,
              num_design_vars=ndv, projection=projection, beta=8.0)
    jf = JNodeFilter(m.conn, m.X, **kw)
    tf = TNodeFilter(m.conn, m.X, device="cpu", **kw)
    if ftype == "spatial":
        state = (np.asarray(jf.idx), np.asarray(jf.wts))
    else:
        state = (np.asarray(jf._chol.mat), np.asarray(jf._Bmat))
        assert rel(tf._Bmat.numpy(), state[1]) < TOL
        assert rel(tf._chol.mat.numpy(), state[0]) < TOL
    tc = filter_from_numpy(m.conn, m.X, kw["r0"], ftype, state, dvmap=dvmap,
                           num_design_vars=ndv, device="cpu",
                           projection=projection, beta=8.0)
    rng = np.random.default_rng(5)
    x = rng.uniform(0.2, 1.0, ndv)
    g = rng.standard_normal(m.nnodes)
    rho_j, vjp = jax.vjp(jf.apply, jnp.asarray(x))
    (gx_j,) = vjp(jnp.asarray(g))
    for f in (tf, tc):
        assert rel(f.apply(t(x)).numpy(), rho_j) < TOL
        assert rel(f.apply_gradient(t(g), x=t(x)).numpy(), gx_j) < TOL


# the multigrid model of tests/test_torch_natural_frequency.py (block 4,
# local ortho, 12x6) at m = 48 and no adaptive exit, where the forward
# converges (its FD test); both packages start from one numpy block
MG = dict(factor_kind="mg", lanczos_block=4, lanczos_ortho="local",
          lanczos_polish=1, m=48, factor_options={"min_coarse": 64})
V0 = np.random.default_rng(11).uniform(-1.0, 1.0, (2 * 13 * 7, 4))
MODELS = {"dense": dict(N=4), "mg": dict(N=2, **MG)}


def _models(kind):
    kw = dict(nx=12, ny=6, Lx=2.0, Ly=1.0, rfact=2.0, **MODELS[kind])
    jt = j_make_model(pallas_mv="off", **kw)
    tt = t_make_model(device="cpu", **kw)
    if kind == "mg":
        jt.problem = dataclasses.replace(jt.problem,
                                         v0=lambda th: jnp.asarray(V0))
        tt.problem = dataclasses.replace(tt.problem,
                                         v0=lambda th: torch.as_tensor(V0))
    return jt, tt


def _protocol(opt):
    opt.initialize()
    opt.initialize_adjoint()
    opt.finalize_adjoint()
    return opt


@pytest.mark.parametrize("kind", list(MODELS))
def test_minfreq_protocol_matches_jax(kind):
    """MinFreqOpt's initialize / initialize_adjoint / finalize_adjoint on
    the dense model and the multigrid one: lam to 1e-10, the KS value to
    1e-12 and xb to 1e-8 of max|xb|. On the dense model, the port's
    add_check_adjoint_residual (single-vector Lanczos on the model's
    factor, LAA + SIBK) then solves the adjoint equations of the
    accumulated seeds to 1e-9 of ||Qb||, at the same eigenvalues (on the
    multigrid factor chip_smoke's [minfreq] runs it, at 263k DOF), and
    the model's general assembly (uniform_grid=False) gives the uniform
    one's operators on this grid to 1e-13."""
    jt, tt = _models(kind)
    jo, to = _protocol(JMinFreqOpt(jt)), _protocol(TMinFreqOpt(tt))
    assert rel(tt.lam.numpy(), jt.lam) <= 1e-10
    assert abs(float(to.get_min_frequency()) - float(
        jo.get_min_frequency())) <= 1e-12 * abs(float(jo.get_min_frequency()))
    assert rel(tt.xb.numpy(), jt.xb) <= 1e-8
    if kind == "dense":
        r = tt.add_check_adjoint_residual()
        scale = float(torch.sqrt(torch.max(torch.sum(tt.Qb**2, dim=0))))
        assert float(r.max()) <= 1e-9 * scale
        lam_check = [tt.profile[f"adjoint lam[{i:2d}]"] for i in range(tt.N)]
        assert rel(lam_check, jt.lam) <= 1e-10
        tg = t_make_model(nx=12, ny=6, Lx=2.0, Ly=1.0, rfact=2.0,
                          uniform_grid=False, device="cpu", **MODELS[kind])
        for a, b in zip(tg._assemble(tt.rhoE), tt._assemble(tt.rhoE)):
            assert rel(a.W.numpy(), b.W.numpy()) < TOL


def test_ks_func_fd():
    """The reference's FD check of the KS gradient on the dense 12x6 model,
    at JAX's bound of 1e-6, with the area and its gradient."""
    np.random.seed(0)
    topo = t_make_model(nx=12, ny=6, Lx=2.0, Ly=1.0, N=4, rfact=2.0,
                        device="cpu")
    data = TMinFreqOpt(topo).test_ks_func(dh_fd=1e-6)
    assert data["fd_err"] < 1e-6, data
    g = topo.eval_area_gradient()
    p = torch.as_tensor(np.random.default_rng(1).uniform(size=g.shape))
    h = 1e-6
    x0 = topo.x

    def area(x):
        topo.x = x
        topo.initialize()
        return float(topo.eval_area())

    fd = (area(x0 + h * p) - area(x0 - h * p)) / (2 * h)
    topo.x = x0
    assert abs(float(p @ g) - fd) <= 1e-7 * abs(fd)


@pytest.mark.parametrize("use", ["value_and_grad", "protocol"])
def test_solve_state_is_freed_with_the_model(use):
    """After a value and gradient (or a finalized protocol) the model, and
    with it the solve that eigh_gen keeps for its backward pass, is
    collected once dropped: the Function's outputs do not close a cycle
    through its autograd node."""
    import gc
    import weakref

    def run():
        topo = t_make_model(nx=12, ny=6, Lx=2.0, Ly=1.0, N=2, rfact=2.0,
                            device="cpu")
        if use == "protocol":
            _protocol(TMinFreqOpt(topo))
        else:
            x = topo.x.clone().requires_grad_(True)
            lam, Q, _, _ = topo._solve_fn(x)
            (lam.sum() + (Q**2).sum()).backward()
        return weakref.ref(topo)

    ref = run()
    gc.collect()
    assert ref() is None


def test_second_adjoint_pass_on_one_solve():
    """Two adjoint passes on one initialize (the seeds of omega_1, then of
    omega_2) on the dense 12x6 model: each xb against JAX's at 1e-8 of
    max|xb|. The held graph outlives the first finalize_adjoint, as JAX's
    vjp closure does; the second pass once raised TypeError."""
    jt, tt = _models("dense")
    for topo in (jt, tt):
        topo.initialize()
    xbs = []
    for i in range(2):
        e = np.eye(4)[i]
        for topo, wrap in ((jt, jnp.asarray), (tt, t)):
            topo.initialize_adjoint()
            topo.add_frequency_derivatives(wrap(e))
            topo.finalize_adjoint()
        assert rel(tt.xb.numpy(), jt.xb) <= 1e-8
        xbs.append(np.asarray(jt.xb))
    assert abs(np.linalg.norm(xbs[1]) - 0.5507) < 1e-4
    assert rel(xbs[0], xbs[1]) > 1e-2  # the passes differ
