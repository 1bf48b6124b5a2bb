"""The port's sharded thermal, buckling and CRM objectives against JAX's.

One launch of 4 gloo ranks runs the three families from JAX's start
vectors (``parallel.runs.families``): each value matches JAX's sharded
objective on 4 of conftest's 8 virtual devices (rel 1e-8) and each
gradient a central difference (1e-6; CRM 1e-5, JAX's bars).

The buckling family runs at 12x4, not at tests/test_sharding.py's 8x4:
at 8x4 on 4 ranks the one-level Schwarz preconditioner of the static
solve K u = f meets a floating subdomain (rank 2's lines 6-8 carry no
clamp and no halo line), its local Cholesky fails, and JAX's objective
returns NaN there (the port's stops in eigh). At 12x4 every rank's local
block is definite, in both packages.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from eigd_tpu.parallel import sharded as jsh
from eigd_tpu_torch.parallel import launch, runs

NDEV = 4
THERMAL = dict(nx=8, ny=4, N=2, m=24, cg_maxiter=300, adjoint_maxiter=30)
BUCKLING = dict(nx=12, ny=4, N=1, m=20, sigma=0.008, adjoint_maxiter=25,
                ks_rho=160.0, load_frac=0.3)
CRM = dict(nspan=6, nchord=3, nheight=1, N=2, m=32)


def _v0(n_local):
    return np.asarray(jax.random.uniform(
        jax.random.PRNGKey(12345), (n_local,), dtype=jnp.float64,
        minval=-1.0, maxval=1.0))


def _x0(nv, base, amp):
    return base + amp * np.sin(np.arange(nv, dtype=np.float64))


@pytest.fixture(scope="module")
def results():
    mesh = Mesh(np.array(jax.devices()[:NDEV]), ("grid",))
    ref, specs = {}, []
    for fam, kw, maker in (
            ("thermal", THERMAL, jsh.make_sharded_thermal_objective),
            ("buckling", BUCKLING, jsh.make_sharded_buckling_objective),
            ("crm", CRM, jsh.make_sharded_crm_objective)):
        obj, model, _, part = maker(NDEV, mesh=mesh, **kw)
        if fam == "crm":
            x0 = np.asarray(model.x)
        elif fam == "buckling":
            x0 = _x0(model.num_design_vars, 0.6, 0.05)
        else:
            x0 = _x0(model.num_design_vars, 0.8, 0.1)
        with mesh:
            ref[fam] = float(jax.jit(obj)(jnp.asarray(x0)))
        pert = np.random.default_rng(7).uniform(size=x0.shape)
        specs.append((fam, dict(kw, v0_local=_v0(part.n_local)),
                      dict(x0=x0, pert=pert, h=1e-6)))
    port = launch.run(runs.families, NDEV, args=(specs,), device="cpu",
                      timeout=240.0)
    return ref, port


@pytest.mark.parametrize("i,fam", [(0, "thermal"), (1, "buckling"),
                                   (2, "crm")])
def test_value_matches_jax(results, i, fam):
    ref, port = results
    assert np.isfinite(ref[fam])
    for rank in port:
        assert abs(rank[i]["value"] - ref[fam]) / abs(ref[fam]) < 1e-8


@pytest.mark.parametrize("i,fam,bar", [(0, "thermal", 1e-6),
                                       (1, "buckling", 1e-6),
                                       (2, "crm", 1e-5)])
def test_gradient_central_difference(results, i, fam, bar):
    r = results[1][0][i]
    assert abs(r["directional"] - r["fd"]) / abs(r["fd"]) < bar


@pytest.mark.parametrize("i", [0, 1, 2])
def test_gradient_equal_on_every_rank(results, i):
    port = results[1]
    for rank in port[1:]:
        np.testing.assert_array_equal(rank[i]["grad"], port[0][i]["grad"])
