"""The port's sharded natural-frequency objective against JAX's.

On 4 gloo ranks (``parallel.launch``) at 10x4, N 2, m 32 with JAX's start
vector, the port's ``make_sharded_objective`` matches JAX's
``value_and_grad`` on 4 of conftest's 8 virtual devices (value rel 1e-8,
gradient max-scaled 1e-6) and its gradient matches a central difference
(1e-6). The gradient is the same at world 1, 2 and 4 (1e-6). The
line-sharded multigrid factor at world 4 (16x8, the pcpg adjoint on the
V-cycle) agrees with the Schwarz-PCG factor and with a central
difference. Each launch has its own deadline.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from eigd_tpu.parallel.sharded import make_sharded_objective
from eigd_tpu_torch.parallel import launch, runs
from eigd_tpu_torch.parallel.grid import make_partition

NX, NY, N, M = 10, 4, 2, 32
KW = dict(nx=NX, ny=NY, N=N, m=M, cg_maxiter=200, adjoint_maxiter=30)
DEADLINE = 150.0


def _x0(nv):
    return 0.8 + 0.1 * np.sin(np.arange(nv, dtype=np.float64))


def _pert(nv):
    return np.random.default_rng(7).uniform(size=nv)


def _jax_v0(ndev):
    n_local = make_partition(NX, NY, ndev, ndof=2).n_local
    return np.asarray(jax.random.uniform(
        jax.random.PRNGKey(12345), (n_local,), dtype=jnp.float64,
        minval=-1.0, maxval=1.0))


@pytest.fixture(scope="module")
def jax_ref():
    mesh = Mesh(np.array(jax.devices()[:4]), ("grid",))
    obj, fltr, _, _ = make_sharded_objective(4, NX, NY, N=N, m=M,
                                             cg_maxiter=200, mesh=mesh,
                                             adjoint_maxiter=30)
    x0 = jnp.asarray(_x0(fltr.num_design_vars))
    with mesh:
        v, g = jax.jit(jax.value_and_grad(obj))(x0)
    return float(v), np.asarray(g)


@pytest.fixture(scope="module")
def world():
    """World 1, 2 and 4 runs from JAX's start vector; world 4 with the
    central difference."""
    nv = (NX + 1) * (NY + 1)
    out = {}
    for n in (1, 2, 4):
        kw = dict(KW, v0_local=_jax_v0(n))
        opts = (None, _pert(nv), 1e-6) if n == 4 else ()
        out[n] = launch.run(runs.objective, n, args=("nf", kw) + opts,
                            device="cpu", timeout=DEADLINE)
    return out


def test_value_matches_jax(jax_ref, world):
    v_j, _ = jax_ref
    for res in world[4]:
        assert abs(res["value"] - v_j) / abs(v_j) < 1e-8


def test_gradient_matches_jax(jax_ref, world):
    _, g_j = jax_ref
    scale = np.abs(g_j).max()
    np.testing.assert_allclose(world[4][0]["grad"] / scale, g_j / scale,
                               atol=1e-6)


def test_gradient_matches_central_difference(world):
    r = world[4][0]
    assert abs(r["directional"] - r["fd"]) / abs(r["fd"]) < 1e-6


def test_gradient_equal_on_every_rank(world):
    for n in (2, 4):
        for res in world[n][1:]:
            np.testing.assert_array_equal(res["grad"], world[n][0]["grad"])
            assert res["value"] == world[n][0]["value"]


@pytest.mark.parametrize("n", [1, 2])
def test_gradient_independent_of_world(world, n):
    g4 = world[4][0]["grad"]
    scale = np.abs(g4).max()
    np.testing.assert_allclose(world[n][0]["grad"] / scale, g4 / scale,
                               atol=1e-6)
    assert abs(world[n][0]["value"] - world[4][0]["value"]) < 1e-8 * abs(
        world[4][0]["value"])


MG = dict(nx=16, ny=8, N=2, m=40, adjoint_maxiter=200)


@pytest.fixture(scope="module")
def mg_runs():
    nv = 17 * 9
    mg = launch.run(runs.objective, 4,
                    args=("nf", dict(MG, factor="mg", adjoint_method="pcpg"),
                          None, _pert(nv), 1e-6), device="cpu",
                    timeout=DEADLINE)[0]
    schwarz = launch.run(runs.objective, 4,
                         args=("nf", dict(MG, cg_maxiter=300)),
                         device="cpu", timeout=DEADLINE)[0]
    return mg, schwarz


def test_mg_factor_matches_schwarz(mg_runs):
    mg, sw = mg_runs
    assert abs(mg["value"] - sw["value"]) / abs(sw["value"]) < 1e-8
    scale = np.abs(sw["grad"]).max()
    np.testing.assert_allclose(mg["grad"] / scale, sw["grad"] / scale,
                               atol=1e-6)


def test_mg_factor_central_difference(mg_runs):
    mg, _ = mg_runs
    assert abs(mg["directional"] - mg["fd"]) / abs(mg["fd"]) < 1e-6
