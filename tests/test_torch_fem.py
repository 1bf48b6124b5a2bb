"""Parity of the port's FEM front end with eigd_tpu's, on the CPU.

The same numpy inputs go through the JAX function and its eigd_tpu_torch
counterpart. Tolerance 1e-13 relative: both sides evaluate the same f64
formulas, so they differ only by summation order (a few ulps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigd_tpu.fem import assembly as jfem
from eigd_tpu.fem import model as jmodel
from eigd_tpu.fem.filter import NodeFilter as JNodeFilter
from eigd_tpu.fem.quad import plane_stress_tables as j_tables
from eigd_tpu_torch.fem import assembly as tfem
from eigd_tpu_torch.fem import model as tmodel
from eigd_tpu_torch.fem.filter import NodeFilter as TNodeFilter
from eigd_tpu_torch.fem.quad import plane_stress_tables as t_tables

torch.set_num_threads(1)
TOL = 1e-13


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def mesh(nx=10, ny=6):
    return jmodel.make_grid(nx, ny, 2.0, 1.0)


def test_grid_and_dvmap_match():
    jm, tm = jmodel.make_grid(12, 8, 2.0, 1.0), tmodel.make_grid(12, 8, 2.0,
                                                                 1.0)
    np.testing.assert_array_equal(jm.conn, tm.conn)
    np.testing.assert_array_equal(jm.X, tm.X)
    np.testing.assert_array_equal(jm.nodes, tm.nodes)
    jd = jmodel.make_symmetric_dvmap_with_sets(jm, rfact=2.0)
    td = tmodel.make_symmetric_dvmap_with_sets(tm, rfact=2.0)
    np.testing.assert_array_equal(jd[0], td[0])
    assert jd[1] == td[1]
    assert sorted(jd[2]) == sorted(td[2])
    for name in jd[2]:
        np.testing.assert_array_equal(jd[2][name], td[2][name])
        np.testing.assert_array_equal(jd[3][name], td[3][name])


def test_plane_stress_tables():
    m = mesh()
    rng = np.random.default_rng(0)
    X = m.X + 0.05 * rng.standard_normal(m.X.shape)  # distorted quads
    jt = j_tables(jnp.asarray(X), jnp.asarray(m.conn))
    tt = t_tables(torch.as_tensor(X),
                  torch.as_tensor(m.conn, dtype=torch.int64))
    for a, b in zip(tt, jt):
        assert tuple(a.shape) == tuple(b.shape)
        assert rel(a.numpy(), b) < TOL


@pytest.mark.parametrize("ptype", ["simp", "ramp"])
def test_stiffness_interp(ptype):
    r = np.random.default_rng(1).uniform(0.01, 1.0, 50)
    assert rel(tfem.stiffness_interp(torch.as_tensor(r), ptype).numpy(),
               jfem.stiffness_interp(jnp.asarray(r), ptype)) < TOL


@pytest.mark.parametrize("ptype", ["linear", "ramp", "msimp"])
def test_mass_interp(ptype):
    r = np.random.default_rng(2).uniform(0.01, 1.0, 50)
    assert rel(tfem.mass_interp(torch.as_tensor(r), ptype).numpy(),
               jfem.mass_interp(jnp.asarray(r), ptype)) < TOL


def test_element_matrices():
    """The uniform-grid K and M element matrices c(rhoE) Ke0 / d(rhoE) Me0
    of the port against eigd_tpu's general stiffness/mass assembly."""
    from eigd_tpu_torch.models.natural_frequency import make_model

    nx, ny = 8, 4
    topo = make_model(nx=nx, ny=ny, Lx=2.0, Ly=1.0, rfact=2.0, N=2, m=32,
                      factor_kind="mg", lanczos_block=4, device="cpu")
    m = jmodel.make_grid(nx, ny, 2.0, 1.0)
    conn = jnp.asarray(m.conn)
    Be, He, detJ = j_tables(jnp.asarray(m.X), conn)
    dofs = jfem.element_dof_map(conn)
    rhoE = np.random.default_rng(3).uniform(0.3, 1.0, m.nelems)
    Kj = jfem.stiffness_matrix(jnp.asarray(rhoE), Be, detJ, dofs,
                               2 * m.nnodes, jfem.plane_stress_C0())
    Mj = jfem.mass_matrix(jnp.asarray(rhoE), He, detJ, dofs, 2 * m.nnodes)
    Kt, Mt = topo._assemble(torch.as_tensor(rhoE))
    assert rel(Kt.mats.numpy(), Kj.mats) < TOL
    assert rel(Mt.mats.numpy(), Mj.mats) < TOL
    np.testing.assert_array_equal(Kt.dofs.numpy(), np.asarray(dofs))
    np.testing.assert_array_equal(
        tfem.element_dof_map(torch.as_tensor(m.conn)).numpy(),
        np.asarray(dofs))


def test_element_density():
    m = mesh()
    rho = np.random.default_rng(4).uniform(size=m.nnodes)
    assert rel(tfem.element_density(torch.as_tensor(rho),
                                    torch.as_tensor(m.conn)).numpy(),
               jfem.element_density(jnp.asarray(rho),
                                    jnp.asarray(m.conn))) < TOL


@pytest.mark.parametrize("projection", [False, True])
def test_conv_filter_apply_and_gradient(projection):
    """Conv filter with a symmetric dvmap (frozen -1 entries): apply and
    the transpose (jax.vjp vs torch.autograd) at 1e-13."""
    nx, ny = 16, 8
    m = jmodel.make_grid(nx, ny, 2.0, 1.0)
    dvmap, ndv, _, _ = jmodel.make_symmetric_dvmap_with_sets(m, rfact=2.0)
    kw = dict(r0=2.0 * (1.0 / ny), ftype="conv", dvmap=dvmap,
              num_design_vars=ndv, grid_shape=(nx, ny),
              projection=projection, beta=8.0)
    jf = JNodeFilter(m.conn, m.X, **kw)
    tf = TNodeFilter(m.conn, m.X, device="cpu", **kw)
    assert rel(tf._kernel.numpy(), jf._kernel) < TOL
    rng = np.random.default_rng(5)
    x = rng.uniform(0.2, 1.0, ndv)
    g = rng.standard_normal(m.nnodes)
    rho_j, vjp = jax.vjp(jf.apply, jnp.asarray(x))
    (gx_j,) = vjp(jnp.asarray(g))
    xt = torch.as_tensor(x).requires_grad_(True)
    rho_t = tf.apply(xt)
    (gx_t,) = torch.autograd.grad(rho_t, xt, torch.as_tensor(g))
    assert rel(rho_t.detach().numpy(), rho_j) < TOL
    assert rel(gx_t.numpy(), gx_j) < TOL
