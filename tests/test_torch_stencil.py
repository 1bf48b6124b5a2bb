"""Parity of the port's stencil operators and kernel twins with eigd_tpu's.

JAX's Pallas kernels run in interpret mode here, as tests/test_pallas_stencil
runs them. The CUDA kernels themselves run only on a card
(tests/test_torch_cuda.py); on the CPU the kernel wrappers must route to
their plain twins.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigd_tpu.fem import assembly as jfem
from eigd_tpu.fem.model import make_grid
from eigd_tpu.fem.quad import (plane_stress_tables, thermal_tables)
from eigd_tpu.ops import pallas_stencil as jps
from eigd_tpu.ops.stencil import stencil_from_elements as j_from_elements
from eigd_tpu.ops.stencil import stencil_matvec as j_matvec
from eigd_tpu_torch.ops import cuda_stencil as cs
from eigd_tpu_torch.ops.stencil import GridStencilOperator
from eigd_tpu_torch.ops.stencil import stencil_from_elements as t_from_elements
from eigd_tpu_torch.ops.stencil import stencil_matvec as t_matvec

torch.set_num_threads(1)


def element_mats(nx, ny, ndof, seed=0):
    """Random-density element matrices: plane stress (ndof 2) or thermal
    conduction (ndof 1), from eigd_tpu's assembly."""
    m = make_grid(nx, ny, 2.0, 1.0)
    conn = jnp.asarray(m.conn)
    X = jnp.asarray(m.X)
    rhoE = jnp.asarray(np.random.default_rng(seed).uniform(0.3, 1.0,
                                                           m.nelems))
    if ndof == 2:
        Be, He, detJ = plane_stress_tables(X, conn)
        dofs = jfem.element_dof_map(conn)
        K = jfem.stiffness_matrix(rhoE, Be, detJ, dofs, 2 * m.nnodes,
                                  jfem.plane_stress_C0())
    else:
        Bt, Ht, detJ = thermal_tables(X, conn)
        K = jfem.thermal_stiffness_matrix(rhoE, Bt, detJ, conn, m.nnodes)
    return np.array(K.mats), np.array(K.dofs), K.n


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("ndof", [1, 2])
def test_stencil_from_elements_and_matvec_f64(ndof):
    """f64 at 1e-13: the same slice-adds and multiply-adds on both sides."""
    nx, ny = 16, 8
    mats, _, n = element_mats(nx, ny, ndof)
    Wj = j_from_elements(jnp.asarray(mats), nx, ny, ndof)
    Wt = t_from_elements(torch.as_tensor(mats), nx, ny, ndof)
    assert rel(Wt.numpy(), Wj) < 1e-13
    x = np.random.default_rng(1).standard_normal((n, 3))
    assert rel(t_matvec(Wt, torch.as_tensor(x), nx, ny, ndof).numpy(),
               j_matvec(Wj, jnp.asarray(x), nx, ny, ndof)) < 1e-13
    # (n,) squeeze path
    assert rel(t_matvec(Wt, torch.as_tensor(x[:, 0]), nx, ny, ndof).numpy(),
               j_matvec(Wj, jnp.asarray(x[:, 0]), nx, ny, ndof)) < 1e-13


@pytest.mark.parametrize("ndof", [1, 2])
def test_stencil_csr_matches_jax_matvec(ndof):
    """The CSR form of the stencil (the SpMM library yardstick of K1/K2
    in chip_smoke.py) against eigd_tpu's stencil matvec: f64 at 1e-13,
    9*ndof nonzeros per interior row."""
    from eigd_tpu_torch.diag.common import stencil_csr

    nx, ny = 16, 8
    mats, _, n = element_mats(nx, ny, ndof)
    Wj = j_from_elements(jnp.asarray(mats), nx, ny, ndof)
    A = stencil_csr(torch.as_tensor(np.asarray(Wj)), nx, ny, ndof)
    nodes = (nx + 1) * (ny + 1)
    edge = 2 * (nx + 1) + 2 * (ny + 1) - 4
    assert A.values().numel() <= 9 * ndof * ndof * nodes
    assert A.values().numel() >= 9 * ndof * ndof * (nodes - edge)
    x = np.random.default_rng(2).standard_normal((n, 3))
    assert rel(torch.sparse.mm(A, torch.as_tensor(x)).numpy(),
               j_matvec(Wj, jnp.asarray(x), nx, ny, ndof)) < 1e-13


def test_stencil_matvec_f32():
    """f32 at 1e-5 * max|ref|: f32 rounding of both sides."""
    nx, ny = 16, 8
    mats, _, n = element_mats(nx, ny, 2)
    W = np.asarray(j_from_elements(jnp.asarray(mats), nx, ny, 2),
                   dtype=np.float32)
    x = np.random.default_rng(2).standard_normal((n, 4)).astype(np.float32)
    ref = np.asarray(j_matvec(jnp.asarray(W), jnp.asarray(x), nx, ny, 2))
    got = t_matvec(torch.as_tensor(W), torch.as_tensor(x), nx, ny, 2)
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() < 1e-5 * np.abs(ref).max()


def test_stencil_from_elements_gradient():
    """The assembly is differentiable: torch.autograd's transpose of
    stencil_from_elements + stencil_matvec against jax.vjp."""
    import jax

    nx, ny = 8, 4
    mats, _, n = element_mats(nx, ny, 2)
    rng = np.random.default_rng(3)
    x, g = rng.standard_normal((n, 2)), rng.standard_normal((n, 2))

    def jf(em):
        return j_matvec(j_from_elements(em, nx, ny, 2), jnp.asarray(x), nx,
                        ny, 2)

    _, vjp = jax.vjp(jf, jnp.asarray(mats))
    (gj,) = vjp(jnp.asarray(g))
    em = torch.as_tensor(mats).requires_grad_(True)
    y = t_matvec(t_from_elements(em, nx, ny, 2), torch.as_tensor(x), nx, ny,
                 2)
    (gt,) = torch.autograd.grad(y, em, torch.as_tensor(g))
    assert rel(gt.numpy(), gj) < 1e-13


@pytest.mark.parametrize("nx,ny", [(16, 8), (33, 17)])
@pytest.mark.parametrize("ndof", [1, 2])
@pytest.mark.parametrize("k", [1, 8])
def test_kernel_twins_match_pallas_interpret(nx, ny, ndof, k):
    """K1's twin against JAX's f32 Pallas kernel and K2's twin against the
    double-float Pallas kernel, both interpreted. K1: 1e-5 * max|ref| (f32
    rounding). K2: 1e-11 * 18 max|x| max|W|, the backward-error bound of
    JAX's double-float kernel (tests/test_pallas_stencil.py); the port's
    twin is exact f64."""
    mats, _, n = element_mats(nx, ny, ndof, seed=k)
    Wj = j_from_elements(jnp.asarray(mats), nx, ny, ndof)
    W = torch.as_tensor(np.array(Wj))
    x = np.random.default_rng(7).standard_normal((n, k))

    # K1: f32 plane layout
    x32 = x.astype(np.float32)
    ref32 = np.asarray(jps.pallas_stencil_matvec(
        jps.stencil_planes(Wj, ndof), jnp.asarray(x32), nx, ny, ndof, TX=8,
        interpret=True))
    Wp = cs.stencil_planes(W, ndof)
    np.testing.assert_array_equal(Wp.numpy(),
                                  np.asarray(jps.stencil_planes(Wj, ndof)))
    xq = cs.to_planes(torch.as_tensor(x32), nx, ny, ndof)
    np.testing.assert_array_equal(
        xq.numpy(), np.asarray(jps.to_planes(jnp.asarray(x32), nx, ny, ndof)))
    got32 = cs.from_planes(cs.matvec_planes_ref(Wp, xq, nx, ny, ndof), nx,
                           ny, ndof)
    assert np.abs(got32.numpy() - ref32).max() < 1e-5 * np.abs(ref32).max()

    # K2: f64 vector layout
    ref64 = np.asarray(jps.dd_stencil_matvec(
        jps.stencil_planes_dd(Wj, ndof), jnp.asarray(x), nx, ny, ndof,
        interpret=True))
    Wp64 = cs.stencil_planes(W, ndof, torch.float64)
    got64 = cs.stencil_matvec64(Wp64, torch.as_tensor(x), nx, ny, ndof)
    scale = 18 * np.abs(x).max() * np.abs(np.asarray(Wj)).max()
    assert np.abs(got64.numpy() - ref64).max() < 1e-11 * scale


def test_operator_cpu_dispatch_goes_to_twins():
    """with_kernels(): f64 inputs take K2's path and f32 inputs K1's; on
    CPU tensors both are the plain twins, and no kernel is launched."""
    nx, ny = 16, 8
    mats, dofs, n = element_mats(nx, ny, 2)
    W = t_from_elements(torch.as_tensor(mats), nx, ny, 2)
    op = GridStencilOperator(torch.as_tensor(mats), torch.as_tensor(dofs), n,
                             W, (nx, ny), 2)
    fast = op.with_kernels()
    assert fast.Wp64 is not None and fast.Wp32 is not None
    k1, k2 = cs.K1_LAUNCHES, cs.K2_LAUNCHES
    x = torch.as_tensor(np.random.default_rng(9).standard_normal((n, 6)))
    ref = t_matvec(W, x, nx, ny, 2)
    assert rel(fast.mv(x).numpy(), ref.numpy()) < 1e-14
    assert rel(fast.mv(x[:, 0]).numpy(), ref[:, 0].numpy()) < 1e-14
    x32 = x.to(torch.float32)
    twin = cs.from_planes(cs.matvec_planes_ref(
        fast.Wp32, cs.to_planes(x32, nx, ny, 2), nx, ny, 2), nx, ny, 2)
    got32 = fast.mv(x32)
    assert got32.dtype == torch.float32
    assert torch.equal(got32, twin)
    assert rel(got32.numpy(), ref.numpy()) < 1e-5
    # the plain operator keeps the plain matvec
    assert torch.equal(op.mv(x), ref)
    assert (cs.K1_LAUNCHES, cs.K2_LAUNCHES) == (k1, k2)


def test_kernel_wrappers_refuse_bad_input():
    """A CUDA-bound call is checked before any launch: an unsupported
    device raises instead of falling back to a twin."""
    W = torch.zeros((3, 3, 3, 3, 2, 2))
    Wp = cs.stencil_planes(W, 2)
    x = torch.zeros((2, 1, 3, 3), device="meta")
    with pytest.raises(ValueError):
        cs.matvec_planes(Wp, x, 2, 2, 2)


def test_element_operator_matvec():
    """ElementOperator.mv (gather, bmm, index_add) against eigd_tpu's
    (gather, einsum, segment_sum): f64 at 1e-13."""
    from eigd_tpu.ops.operators import ElementOperator as JElementOperator
    from eigd_tpu_torch.ops.operators import ElementOperator

    mats, dofs, n = element_mats(10, 6, 2)
    x = np.random.default_rng(4).standard_normal((n, 3))
    ref = np.asarray(JElementOperator(jnp.asarray(mats), jnp.asarray(dofs),
                                      n).mv(jnp.asarray(x)))
    op = ElementOperator(torch.as_tensor(mats),
                         torch.as_tensor(dofs, dtype=torch.int64), n)
    assert rel(op.mv(torch.as_tensor(x)).numpy(), ref) < 1e-13
    assert rel(op.mv(torch.as_tensor(x[:, 1])).numpy(), ref[:, 1]) < 1e-13


@pytest.mark.parametrize("nx,ny,levels", [(512, 256, 4), (1024, 512, 5)])
def test_launch_plan_covers_every_node_and_column_once(nx, ny, levels):
    """The stencil kernel's launch plan at every multigrid level of the
    263k and 1M paths (eigd_tpu_torch/diag/configs.py), ndof 1 and 2, f32
    and f64, with and without staged y, k 1 to 17: its node tiles, column
    groups and chunks cover every node and column exactly once with no
    empty block, and one block's shared memory stays within the budget of
    two blocks an SM (half the card's 227 KB a block)."""
    TX, TY = cs.TILE
    for lvl in range(levels):
        X, Y = (nx >> lvl) + 1, (ny >> lvl) + 1
        for nd, itemsize, staged, k in itertools.product(
                (1, 2), (4, 8), (True, False), range(1, 18)):
            plan = cs.launch_plan(X, Y, nd, k, itemsize, staged)
            tiles, groups = plan.grid
            ti, tj = -(-X // TX), -(-Y // TY)
            assert tiles == ti * tj
            # tile t covers rows [t // tj * TX, +TX) and columns
            # [t % tj * TY, +TY) of the grid, clipped at its edge
            rows, cols, ks = np.zeros(X, int), np.zeros(Y, int), np.zeros(
                k, int)
            for t in range(ti):
                assert t * TX < X
                rows[t * TX:(t + 1) * TX] += 1
            for t in range(tj):
                assert t * TY < Y
                cols[t * TY:(t + 1) * TY] += 1
            cpg, kc = plan.cols_per_group, plan.cols_per_chunk
            assert 1 <= kc <= cpg
            for grp in range(groups):
                assert grp * cpg < k
                for c0 in range(grp * cpg, min(k, (grp + 1) * cpg), kc):
                    ks[c0:min(c0 + kc, (grp + 1) * cpg)] += 1
            assert (rows == 1).all() and (cols == 1).all()
            assert (ks == 1).all()
            assert plan.shared_bytes <= cs.SHARED_BUDGET <= 232448 // 2
            # a grid of few tiles splits its columns to fill the card, as
            # far as its k allows
            assert tiles * groups >= min(cs.FILL_BLOCKS, tiles * k)
            if staged and tiles >= cs.FILL_BLOCKS:
                # the vector layout takes a block's columns in one chunk
                assert kc == cpg == k
