"""Parity of the port's block factors (``eigd_tpu_torch.ops.blockfactor``)
with eigd_tpu's, on the CPU: the block extraction of a grid and of DOF
groups, the block-tridiagonal and cyclic-reduction factors in f64 and in
f32 store, the refined and the PCG factors, and ``TopologyAnalysis`` on
each block ``factor_kind``. The same numpy inputs go through the JAX
function (x64 on the CPU) and its counterpart in the port; each JAX
reference is computed once, in a module-scoped fixture.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigd_tpu.fem import assembly as jfem
from eigd_tpu.fem.model import make_grid
from eigd_tpu.fem.quad import plane_stress_tables, thermal_tables
from eigd_tpu.models.natural_frequency import make_model as j_make_model
from eigd_tpu.ops import blockfactor as jbf
from eigd_tpu.ops.operators import DenseOperator as JDense
from eigd_tpu.ops.operators import ElementOperator as JElementOperator
from eigd_tpu.ops.stencil import GridStencilOperator as JGrid
from eigd_tpu_torch.models.natural_frequency import make_model as t_make_model
from eigd_tpu_torch.ops import blockfactor as tbf
from eigd_tpu_torch.ops import sync
from eigd_tpu_torch.ops.operators import DenseOperator as TDense
from eigd_tpu_torch.ops.operators import ElementOperator as TElementOperator
from eigd_tpu_torch.ops.stencil import GridStencilOperator as TGrid

torch.set_num_threads(1)


def t(a):
    return torch.as_tensor(np.array(a))


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _plane(nx, ny):
    """The shifted plane-stress element matrices of tests/test_blockfactor
    .py (random densities, sigma = -10) on an nx x ny grid, with the dense
    matrix and the DOF map."""
    mesh = make_grid(nx, ny, 2.0, 1.0)
    conn, X = jnp.asarray(mesh.conn), jnp.asarray(mesh.X)
    Be, He, detJ = plane_stress_tables(X, conn)
    dofs = jfem.element_dof_map(conn)
    rhoE = jnp.asarray(np.random.default_rng(0).uniform(0.3, 1.0,
                                                        mesh.nelems))
    n = 2 * mesh.nnodes
    K = jfem.stiffness_matrix(rhoE, Be, detJ, dofs, n, jfem.plane_stress_C0())
    M = jfem.mass_matrix(rhoE, He, detJ, dofs, n)
    shifted = np.asarray(K.mats + 10.0 * M.mats)
    return shifted, np.asarray(dofs), n


def _thermal(nx, ny):
    """The shifted (sigma = -0.1) scalar heat element matrices on an
    nx x ny grid with random densities."""
    mesh = make_grid(nx, ny, 1.0, 1.15)
    conn, X = jnp.asarray(mesh.conn), jnp.asarray(mesh.X)
    Be, He, detJ = thermal_tables(X, conn)
    rhoE = jnp.asarray(np.random.default_rng(1).uniform(0.3, 1.0,
                                                        mesh.nelems))
    K = jfem.thermal_stiffness_matrix(rhoE, Be, detJ, conn, mesh.nnodes,
                                      beta=1e-6)
    M = jfem.thermal_mass_matrix(rhoE, He, detJ, conn, mesh.nnodes,
                                 beta=1e-6)
    return np.asarray(K.mats + 0.1 * M.mats), np.asarray(conn), mesh.nnodes


# (nx, ny, ndof): the JAX test's 10x6 plane-stress grid (11 lines), a 9x6
# one (10 lines: the even case of cyclic reduction) and an 8x8 heat grid
GRIDS = {"plane10x6": (10, 6, 2), "plane9x6": (9, 6, 2),
         "thermal8x8": (8, 8, 1)}


@pytest.fixture(scope="module")
def grids():
    """For each grid: the shifted element matrices, DOF map, n, JAX's D/E
    and the dense matrix."""
    out = {}
    for name, (nx, ny, nd) in GRIDS.items():
        mats, dofs, n = _plane(nx, ny) if nd == 2 else _thermal(nx, ny)
        D, E = jbf.grid_block_tridiag(jnp.asarray(mats), nx, ny, ndof=nd)
        dense = np.asarray(JElementOperator(jnp.asarray(mats),
                                            jnp.asarray(dofs), n).to_dense())
        out[name] = dict(mats=mats, dofs=dofs, n=n, D=np.asarray(D),
                         E=np.asarray(E), dense=dense)
    return out


@pytest.mark.parametrize("name", list(GRIDS))
def test_grid_block_tridiag_matches_jax(grids, name):
    """D and E against JAX's at 1e-13 relative (the scatter order differs
    from XLA's, so the sums differ in the last bits), and against the
    dense matrix's blocks."""
    g = grids[name]
    nx, ny, nd = GRIDS[name]
    D, E = tbf.grid_block_tridiag(t(g["mats"]), nx, ny, ndof=nd)
    assert rel(D.numpy(), g["D"]) < 1e-13
    assert rel(E.numpy(), g["E"]) < 1e-13
    b = nd * (ny + 1)
    dense = g["dense"]
    for i in range(nx):
        assert rel(E[i].numpy(), dense[(i + 1) * b:(i + 2) * b,
                                      i * b:(i + 1) * b]) < 1e-13
    assert rel(D[nx].numpy(), dense[nx * b:, nx * b:]) < 1e-13


def test_block_tridiag_from_dof_groups_matches_jax(grids):
    """The 10x6 grid's element matrices with each line padded by 3 unused
    DOFs (dof = line * (b + 3) + offset): D and E against JAX's, exactly
    up to the scatter's rounding (1e-13), including the unit diagonal on
    the padding, and the line blocks of grid_block_tridiag."""
    g = grids["plane10x6"]
    b = 2 * 7
    bp = b + 3
    dofs = (g["dofs"] // b) * bp + g["dofs"] % b
    nb = 11
    Dj, Ej = jbf.block_tridiag_from_dof_groups(
        jnp.asarray(g["mats"]), jnp.asarray(dofs), None, nb, bp)
    D, E = tbf.block_tridiag_from_dof_groups(t(g["mats"]), t(dofs), None,
                                             nb, bp)
    assert D.shape == (nb, bp, bp) and E.shape == (nb - 1, bp, bp)
    assert rel(D.numpy(), Dj) < 1e-13
    assert rel(E.numpy(), Ej) < 1e-13
    assert np.all(np.diagonal(D.numpy()[:, b:, b:], axis1=1, axis2=2) == 1.0)
    assert rel(D.numpy()[:, :b, :b], g["D"]) < 1e-13
    assert rel(E.numpy()[:, :b, :b], g["E"]) < 1e-13


def _summed_dof_groups(mats, dofs, nb, b):
    """block_tridiag_from_dof_groups with the unit diagonal added as a
    dense diag_embed, a second copy of D (the form it replaced)."""
    gi, wi = dofs // b, dofs % b
    same = gi[:, :, None] == gi[:, None, :]
    lower = gi[:, :, None] == gi[:, None, :] + 1
    rows, cols = wi[:, :, None], wi[:, None, :]
    zero = mats.new_zeros(())
    D = mats.new_zeros((nb + 1, b, b))
    D.index_put_((torch.where(same, gi[:, :, None], nb), rows, cols),
                 torch.where(same, mats, zero), accumulate=True)
    E = mats.new_zeros((nb + 1, b, b))
    E.index_put_((torch.where(lower, gi[:, None, :], nb), rows, cols),
                 torch.where(lower, mats, zero), accumulate=True)
    D, E = D[:nb], E[:nb - 1]
    fix = (torch.diagonal(D, dim1=1, dim2=2) == 0.0).to(mats.dtype)
    return D + torch.diag_embed(fix), E


def test_dof_groups_unit_diagonal_in_place(grids):
    """The padded 10x6 grid of the test above: the unit diagonal added in
    place gives the diag_embed form's D and E, equal up to the sign of a
    zero (torch.equal), with the padding's diagonal at 1."""
    g = grids["plane10x6"]
    b, bp, nb = 14, 17, 11
    dofs = t((g["dofs"] // b) * bp + g["dofs"] % b)
    D, E = tbf.block_tridiag_from_dof_groups(t(g["mats"]), dofs, None, nb,
                                             bp)
    Dr, Er = _summed_dof_groups(t(g["mats"]), dofs, nb, bp)
    assert torch.equal(D, Dr) and torch.equal(E, Er)
    assert bool((torch.diagonal(D, dim1=1, dim2=2)[:, b:] == 1.0).all())


def _plain_bcr(D, E, store_dtype=None, jitter=0.0):
    """BCRFactor's build as one loop over levels that leaves every level's
    blocks to the end, the form the owned build replaced: (levels,
    last_Dinv)."""
    b = D.shape[1]
    if store_dtype is not None:
        D = D.to(store_dtype)
        E = E.to(store_dtype)
    levels = []
    Dc, Ec = D, E
    while Dc.shape[0] > 1:
        nb_c = Dc.shape[0]
        n_odd = nb_c // 2
        n_even = nb_c - n_odd
        Dinv = tbf.BCRFactor._inv_spd(Dc[1::2], jitter)
        E_left = Ec[0::2][:n_odd]
        E_right = Ec[1::2]
        if E_right.shape[0] < n_odd:
            E_right = torch.cat([E_right, E_right.new_zeros(
                (n_odd - E_right.shape[0], b, b))])
        HL = Dinv @ E_left
        HR = Dinv @ E_right.mT
        Dn = Dc[0::2].clone()
        n_l = min(n_odd, n_even - 1)
        Dn[1:1 + n_l] -= (HR.mT @ E_right.mT)[:n_l]
        Dn[:n_odd] -= HL.mT @ E_left
        n_enew = n_even - 1
        En = (HR[:n_enew].mT @ E_left[:n_enew]).neg_()
        levels.append((Dinv, HL, HR))
        Dc, Ec = Dn, En
    return levels, tbf.BCRFactor._inv_spd(Dc, jitter)


def _bits(x):
    return x.view(torch.int64 if x.element_size() == 8 else torch.int32)


def _spd_chain(nb, b=6):
    """Blocks of a random block-diagonally dominant SPD chain."""
    g = torch.Generator().manual_seed(nb)
    R = torch.randn((nb, b, b), generator=g, dtype=torch.float64)
    D = R @ R.mT / b + 3.0 * torch.eye(b, dtype=torch.float64)
    E = 0.1 * torch.randn((nb - 1, b, b), generator=g, dtype=torch.float64)
    return D, E


@pytest.mark.parametrize("jitter", [0.0, 1e-6])
@pytest.mark.parametrize("store", [None, torch.float32])
@pytest.mark.parametrize("nb", [2, 3, 8, 9, 17])
def test_bcr_owned_build_is_the_plain_loop_bitwise(nb, store, jitter):
    """BCRFactor.from_owned_blocks, which frees each level's blocks as it
    goes, stores the plain loop's Dinv/HL/HR and last_Dinv bit for bit,
    over odd and even counts (the even ones pad E_right); it empties the
    list it is given, and from_blocks leaves the caller's blocks as they
    were."""
    D, E = _spd_chain(nb)
    levels, last = _plain_bcr(D, E, store, jitter)
    blocks = [D.clone(), E.clone()]
    owned = tbf.BCRFactor.from_owned_blocks(blocks, store_dtype=store,
                                            jitter=jitter)
    assert blocks == []
    D0, E0 = D.clone(), E.clone()
    held = tbf.BCRFactor.from_blocks(D, E, store_dtype=store, jitter=jitter)
    assert torch.equal(_bits(D), _bits(D0))
    assert torch.equal(_bits(E), _bits(E0))
    for f in (owned, held):
        assert len(f.levels) == len(levels)
        for got, ref in zip(f.levels, levels):
            for x, y in zip(got, ref):
                assert x.dtype == y.dtype and x.shape == y.shape
                assert torch.equal(_bits(x), _bits(y))
        assert torch.equal(_bits(f.last_Dinv), _bits(last))
        assert not torch.isnan(f.last_Dinv).any()


def test_bcr_owned_build_peak_memory():
    """The assembly and owned build of a 65-block chain of b 48 in f64,
    under torch.profiler's memory records: the running total of new
    allocations peaks at level 0's schedule, the assembly's two buffers of
    nb + 1 blocks, the next level's n_even diagonal blocks, and the
    Cholesky factor of the n_odd odd blocks with its inverse, within 5%.
    The form it replaced, the blocks held through every level and the
    unit diagonal added as a dense diag_embed, peaks 1.6 times higher."""
    from torch.profiler import ProfilerActivity, profile

    nb, b = 65, 48
    n_odd, n_even = nb // 2, nb - nb // 2
    g = torch.Generator().manual_seed(0)
    # one 4-DOF element per pair of neighbouring groups
    off = torch.randint(0, b, (nb - 1, 4), generator=g)
    dofs = (torch.arange(nb - 1)[:, None] + torch.tensor([0, 0, 1, 1])) * b
    dofs = dofs + off
    R = torch.rand((nb - 1, 4, 4), generator=g, dtype=torch.float64)
    mats = R @ R.mT + torch.eye(4, dtype=torch.float64)
    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        f = tbf.BCRFactor.from_owned_blocks(list(
            tbf.block_tridiag_from_dof_groups(mats, dofs, None, nb, b)))
    records = sorted((e for e in prof.profiler.kineto_results.events()
                      if e.name() == "[memory]"), key=lambda e: e.start_ns())
    total = peak = 0
    for e in records:
        total += e.nbytes()
        peak = max(peak, total)
    block = b * b * 8
    lean = (2 * (nb + 1) + n_even + 2 * n_odd) * block
    assert total == f.nbytes
    assert peak <= 1.05 * lean, (peak / block, lean / block)
    # no operator: every level stores Dinv, HL and HR of its odd lines
    assert f.coupling is None
    for lv in f.levels:
        assert len(lv) == 3 and all(x is not None for x in lv)
        assert len({x.shape for x in lv}) == 1


@functools.lru_cache(maxsize=None)
def _coupled_case(kind, nx, ny):
    """(mats, extra_diag, stencil operator) of an nx x ny plane-stress
    grid: "shifted", the unmasked K + 10 M of ``_plane``; "pencil", the
    buckling column's masked K-hat + sigma G at its start design with the
    unit diagonal on the clamped DOFs, sigma 0.8 of its first load
    factor."""
    from eigd_tpu_torch.fem import assembly as tfem
    from eigd_tpu_torch.models.buckling import first_blf, make_buckling_model

    if kind == "shifted":
        mats, dofs, n = _plane(nx, ny)
        mats, dofs, extra = t(mats), t(dofs), None
    else:
        topo = make_buckling_model(nx=nx, ny=ny, N=2, factor_kind="bcr",
                                   device="cpu")
        sigma = 0.8 * first_blf(topo)
        rhoE = tfem.element_density(topo.fltr.apply(topo.x), topo.conn)
        K = topo._op_K(rhoE)
        u = torch.linalg.solve(K.to_dense(), topo.f * topo.free_mask)
        G = topo._op_G(rhoE, u)
        mats = K.mats + sigma * G.mats
        dofs, n, extra = topo.dofs, topo.nvars, topo.fixed_mask
    op = TGrid.from_element_operator(TElementOperator(mats, dofs, n),
                                     (nx, ny), ndof=2, extra_diag=extra)
    return mats, extra, op


def _grid_blocks(mats, extra, nx, ny):
    D, E = tbf.grid_block_tridiag(mats, nx, ny, ndof=2)
    if extra is not None:
        torch.diagonal(D, dim1=1, dim2=2).add_(extra.reshape(nx + 1, -1))
    return D, E


@pytest.mark.parametrize("k", [1, 6])
@pytest.mark.parametrize("nx, ny", [(8, 4), (16, 8), (17, 9)])
@pytest.mark.parametrize("kind", ["shifted", "pencil"])
def test_bcr_stencil_coupling_matches_the_stored_one(kind, nx, ny, k):
    """A BCR factor given its matrix's stencil (``coupling``) against the
    plain one, f64, over grids whose line counts are odd and even at some
    level: the applies agree to 1e-10 and each one's residual is within
    10x of the plain one's; Dinv of every level, HL and HR of levels 1 on
    and last_Dinv are the plain build's bits; level 0 holds neither HL nor
    HR; ``nbytes`` is the stored blocks plus the stencil's planes."""
    mats, extra, op = _coupled_case(kind, nx, ny)
    D, E = _grid_blocks(mats, extra, nx, ny)
    plain = tbf.BCRFactor.from_blocks(D, E)
    coupled = tbf.BCRFactor.from_owned_blocks([D.clone(), E.clone()],
                                              coupling=op)
    assert plain.coupling is None and coupled.coupling is not None
    assert len(coupled.levels) == len(plain.levels) >= 4
    Dinv, HL, HR = coupled.levels[0]
    assert HL is None and HR is None
    assert torch.equal(_bits(Dinv), _bits(plain.levels[0][0]))
    for got, ref in zip(coupled.levels[1:], plain.levels[1:]):
        for x, y in zip(got, ref):
            assert torch.equal(_bits(x), _bits(y))
    assert torch.equal(_bits(coupled.last_Dinv), _bits(plain.last_Dinv))

    stored = sum(x.numel() * 8 for lv in coupled.levels for x in lv
                 if x is not None) + coupled.last_Dinv.numel() * 8
    planes = coupled.coupling.Wp64
    assert planes.shape == (36, nx + 1, ny + 1) and planes.is_contiguous()
    assert coupled.coupling.Wp32 is None and coupled.coupling.mats is None
    assert coupled.nbytes == stored + planes.numel() * 8
    assert plain.nbytes - coupled.nbytes == sum(
        x.numel() * 8 for x in plain.levels[0][1:]) - planes.numel() * 8

    A = op.to_dense()
    x = torch.randn((op.n, k), generator=torch.Generator().manual_seed(k),
                    dtype=torch.float64)
    y_plain, y = plain.mv(x), coupled.mv(x)
    assert rel(y, y_plain) < 1e-10
    res = [float(torch.linalg.norm(A @ v - x) / torch.linalg.norm(x))
           for v in (y_plain, y)]
    assert res[1] <= 10.0 * res[0], res


def test_bcr_stencil_coupling_under_autograd_and_forward_mode():
    """Where autograd or ``torch.func`` tracks the right-hand side (the
    static solve's jvp rule applies the factor to a tangent), the coupled
    apply still goes through the operator's ``mv`` (K2 on the card), and
    hands it only untracked tensors: torch.func.jvp, a backward pass and
    a jvp of a grad give the factor's own applies."""
    mats, extra, op = _coupled_case("pencil", 8, 4)
    D, E = _grid_blocks(mats, extra, 8, 4)
    f = tbf.BCRFactor.from_owned_blocks([D, E], coupling=op)
    gen = torch.Generator().manual_seed(5)
    x, dx, yb = (torch.randn((op.n, 2), generator=gen, dtype=torch.float64)
                 for _ in range(3))
    y, dy, xb = f.mv(x), f.mv(dx), f.mv(yb)  # the factor is symmetric

    mv, seen = f.coupling.mv, []

    def watched(v):
        assert not (torch.is_grad_enabled() and v.requires_grad)
        assert not torch._C._functorch.is_functorch_wrapped_tensor(v)
        seen.append(v.shape)
        return mv(v)

    f.coupling.mv = watched
    got_y, got_dy = torch.func.jvp(f.mv, (x,), (dx,))
    assert rel(got_y, y) < 1e-14 and rel(got_dy, dy) < 1e-14
    assert len(seen) == 4  # two calls each for the value and the tangent
    xl = x.clone().requires_grad_(True)
    with torch.enable_grad():
        (got_xb,) = torch.autograd.grad(f.mv(xl), xl, yb)
    assert rel(got_xb, xb) < 1e-12
    assert len(seen) == 8

    # d/dv <yb, F v^2> = 2 v (F yb); its tangent along dx is 2 dx (F yb)
    def h(v):
        return torch.sum(yb * f.mv(v * v))

    grad, hess_dx = torch.func.jvp(torch.func.grad(h), (x,), (dx,))
    assert rel(grad, 2.0 * x * xb) < 1e-12
    assert rel(hess_dx, 2.0 * dx * xb) < 1e-12
    assert len(seen) > 8


def test_bcr_stencil_coupled_build_peak_memory():
    """The assembly and coupled build of a 65-line grid (b 48, f64, the
    shifted plane stress) under torch.profiler's memory records, the
    stencil made before: the running total peaks at level 0 within 5% of
    D + E and two n_odd temporaries, one plain factor's worth, and what
    stays allocated is ``nbytes`` (the stored blocks and the stencil's
    planes)."""
    from torch.profiler import ProfilerActivity, profile

    nx, ny = 64, 23
    mats, extra, op = _coupled_case("shifted", nx, ny)
    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        f = tbf.BCRFactor.from_owned_blocks(
            list(_grid_blocks(mats, extra, nx, ny)), coupling=op)
    records = sorted((e for e in prof.profiler.kineto_results.events()
                      if e.name() == "[memory]"), key=lambda e: e.start_ns())
    total = peak = 0
    for e in records:
        total += e.nbytes()
        peak = max(peak, total)
    nb, b = f.nb, f.b
    block = b * b * 8
    lean = (nb + (nb - 1) + 2 * (nb // 2)) * block
    assert f.levels[0][1] is None
    assert total == f.nbytes
    assert peak <= 1.05 * lean, (peak / block, lean / block)


FACTORS = [("tridiag", None), ("tridiag", "f32"), ("bcr", None),
           ("bcr", "f32")]


def _jax_factor(kind, store, D, E):
    sd = jnp.float32 if store else None
    if kind == "tridiag":
        return jbf.BlockTridiagFactor.from_blocks(D, E, store_dtype=sd)
    return jbf.BCRFactor.from_blocks(D, E, store_dtype=sd)


@jax.jit
def _jax_applies(D, E, x, X3):
    """JAX's applies of every factor of FACTORS to x and X3, in one
    compiled program a grid."""
    return [(f.mv(x), f.mv(X3)) for f in
            (_jax_factor(kind, store, D, E) for kind, store in FACTORS)]


@pytest.fixture(scope="module")
def applies(grids):
    """JAX's applies of each factor to a vector and a 3-column block, on
    every grid."""
    out = {}
    rng = np.random.default_rng(1)
    for name, g in grids.items():
        x = rng.standard_normal(g["n"])
        X3 = rng.standard_normal((g["n"], 3))
        ys = _jax_applies(jnp.asarray(g["D"]), jnp.asarray(g["E"]),
                          jnp.asarray(x), jnp.asarray(X3))
        for (kind, store), (y, Y) in zip(FACTORS, ys):
            out[name, kind, store] = (x, X3, np.asarray(y), np.asarray(Y))
    return out


@pytest.mark.parametrize("kind,store", FACTORS)
@pytest.mark.parametrize("name", list(GRIDS))
def test_factor_apply_matches_jax(grids, applies, name, kind, store):
    """BlockTridiagFactor and BCRFactor applies (vector and 3-column
    block) against JAX's and the dense solve. f64: the JAX test's bound
    1e-9 of max|ref| against the solve, 1e-12 against JAX. f32 store:
    against JAX's f32 apply at 1e-4 (f32 rounding, amplified by the
    blocks' condition and taken in another order), and against the solve
    at 1e-3 (the f32 factor's own error, which RefinedFactor removes)."""
    g = grids[name]
    D, E = t(g["D"]), t(g["E"])
    sd = torch.float32 if store else None
    f = (tbf.BlockTridiagFactor.from_blocks(D, E, store_dtype=sd)
         if kind == "tridiag" else
         tbf.BCRFactor.from_blocks(D, E, store_dtype=sd))
    x, X3, yj, Yj = applies[name, kind, store]
    tol_jax, tol_solve = (1e-4, 1e-3) if store else (1e-12, 1e-9)
    for xin, ref_j in ((x, yj), (X3, Yj)):
        y = f.mv(t(xin)).double().numpy()
        assert y.shape == ref_j.shape
        assert rel(y, ref_j) < tol_jax
        assert rel(y, np.linalg.solve(g["dense"], xin)) < tol_solve


@pytest.mark.parametrize("name", list(GRIDS))
def test_refined_factor_matches_jax(grids, name):
    """RefinedFactor (the f32 cyclic-reduction factor refined against the
    f64 stencil) against JAX's: the solution at 1e-10 and the same number
    of refinement passes. JAX's count is the least max_refine whose
    result is that of the full loop, bit for bit."""
    g = grids[name]
    nx, ny, nd = GRIDS[name]
    x = np.random.default_rng(2).standard_normal((g["n"], 2))
    mj = jnp.asarray(g["mats"])
    from eigd_tpu.ops.stencil import stencil_from_elements as j_stencil

    opj = JGrid(mj, jnp.asarray(g["dofs"]), g["n"],
                j_stencil(mj, nx, ny, nd), (nx, ny), nd)
    Dj, Ej = jbf.grid_block_tridiag(mj.astype(jnp.float32), nx, ny, nd)
    inner_j = jbf.BCRFactor.from_blocks(Dj, Ej)

    class Counted:
        """JAX's operator, counting its applies as the loop runs them
        (one a refinement pass)."""
        shape = opj.shape
        n = 0

        def mv(self, v):
            jax.debug.callback(self.tick)
            return opj.mv(v)

        def tick(self):
            Counted.n += 1

    yj = np.asarray(jbf.RefinedFactor(inner_j, Counted()).mv(jnp.asarray(x)))
    passes_j = Counted.n

    mt = t(g["mats"])
    from eigd_tpu_torch.ops.stencil import stencil_from_elements

    opt = TGrid(mt, t(g["dofs"]), g["n"],
                stencil_from_elements(mt, nx, ny, nd), (nx, ny), nd)
    inner_t = tbf.BCRFactor.from_blocks(*tbf.grid_block_tridiag(
        mt.float(), nx, ny, nd))
    sync.clear()
    y = tbf.RefinedFactor(inner_t, opt).mv(t(x)).numpy()
    assert rel(y, yj) < 1e-10
    assert rel(y, np.linalg.solve(g["dense"], x)) < 1e-10
    assert sync.LOOP_STEPS["refine"] == passes_j
    # one host read a pass after the first, and one more for the exit
    # unless the pass cap ended the loop
    capped = sync.LOOP_EXITS["refine.maxiter"]
    assert sync.HOST_SYNCS["refine"] == passes_j - capped
    approx = tbf.RefinedFactor(inner_t, opt).approx_mv(t(x).float())
    assert approx.dtype == torch.float32


def _pcg_problem(scale_hi):
    """tests/test_blockfactor.py's synthetic block-tridiagonal SPD system
    with a DOF-scale disparity."""
    rng = np.random.default_rng(3)
    nb, b = 12, 16
    n = nb * b
    D = np.zeros((nb, b, b))
    E = rng.standard_normal((nb - 1, b, b)) * 0.1
    for i in range(nb):
        Q = rng.standard_normal((b, b)) * 0.1
        D[i] = np.eye(b) * 4.0 + Q @ Q.T
    s = np.ones(n)
    s[::2] = np.sqrt(scale_hi)
    S = s.reshape(nb, b)
    D = D * S[:, :, None] * S[:, None, :]
    E = E * S[1:, :, None] * S[:-1, None, :]
    dense = np.zeros((n, n))
    for i in range(nb):
        dense[i * b:(i + 1) * b, i * b:(i + 1) * b] = D[i]
    for i in range(nb - 1):
        dense[(i + 1) * b:(i + 2) * b, i * b:(i + 1) * b] = E[i]
        dense[i * b:(i + 1) * b, (i + 1) * b:(i + 2) * b] = E[i].T
    return nb, b, D, E, dense


def _pcg_case(case):
    """(inner blocks D, E, jitter, dense, s, mask, rhs) of the two
    TestPCGFactor cases."""
    if case == "converges_where_f32_breaks":
        nb, b, D, E, dense = _pcg_problem(1e8)
        s = 1.0 / np.sqrt(np.diag(dense))
        sb = s.reshape(nb, b)
        D2 = D * sb[:, :, None] * sb[:, None, :]
        E2 = E * sb[1:, :, None] * sb[:-1, None, :]
        x = np.random.default_rng(0).standard_normal((nb * b, 3))
        return D2, E2, 1e-4, dense, s, None, x
    nb, b, D, E, dense = _pcg_problem(1e4)
    n = nb * b
    mask = np.ones(n)
    mask[:b // 2] = 0.0
    dense_m = dense * mask[:, None] * mask[None, :]
    Dm = dense_m.reshape(nb, b, nb, b)
    D2 = np.stack([Dm[i, :, i, :] for i in range(nb)])
    E2 = np.stack([Dm[i + 1, :, i, :] for i in range(nb - 1)])
    for i in range(nb):
        dzero = np.diag(D2[i]) == 0.0
        D2[i][np.diag_indices(b)] += dzero.astype(float)
    diag = np.where(np.diag(dense_m) <= 0, 1.0, np.diag(dense_m))
    s = 1.0 / np.sqrt(diag)
    sb = s.reshape(nb, b)
    D2 = D2 * sb[:, :, None] * sb[:, None, :]
    E2 = E2 * sb[1:, :, None] * sb[:-1, None, :]
    x = np.random.default_rng(1).standard_normal(n)
    return D2, E2, 1e-5, dense_m, s, mask, x


@pytest.mark.parametrize("case", ["converges_where_f32_breaks",
                                  "mask_identity_completion"])
def test_pcg_factor_matches_jax(case):
    """Both TestPCGFactor cases: the port's solution against JAX's (1e-9
    of max|ref|: both stop at tol 1e-12 of the residual) and the dense
    solve (the JAX test's 1e-8), the iteration counts within 1, JAX's
    residual bound 1e-11, and identity on the masked DOFs."""
    D2, E2, jitter, dense, s, mask, x = _pcg_case(case)
    inner_j = jbf.BCRFactor.from_blocks(jnp.asarray(D2, jnp.float32),
                                        jnp.asarray(E2, jnp.float32),
                                        jitter=jitter)
    fj = jbf.PCGFactor(inner_j, JDense(jnp.asarray(dense)), jnp.asarray(s),
                       mask=None if mask is None else jnp.asarray(mask),
                       tol=1e-12, maxiter=300)
    yj, info_j = fj.mv_info(jnp.asarray(x))
    inner_t = tbf.BCRFactor.from_blocks(t(D2).float(), t(E2).float(),
                                        jitter=jitter)
    ft = tbf.PCGFactor(inner_t, TDense(t(dense)), t(s),
                       mask=None if mask is None else t(mask), tol=1e-12,
                       maxiter=300)
    y, info = ft.mv_info(t(x))
    y = y.numpy()
    assert np.all(np.isfinite(y))
    assert rel(y, yj) < 1e-9
    assert abs(info["niter"] - int(info_j["niter"])) <= 1
    assert np.all(info["res"].numpy() < 1e-11)
    free = np.ones(len(s), bool) if mask is None else mask > 0
    ref = np.linalg.solve(dense[np.ix_(free, free)], x[free])
    assert rel(y[free], ref) < 1e-8
    if mask is not None:
        np.testing.assert_allclose(y[~free], x[~free], rtol=1e-10)


def test_pcg_factor_approx_and_warm_channels(grids):
    """PCGFactor on the 10x6 grid's element operator (the CRM layout): the
    f32 approximate channel (``_pcg32``: f32 element matvec, jittered f32
    cyclic reduction of the equilibrated blocks) against JAX's at 1e-4
    (f32 state, iteration count within 1 of JAX's by its own gate), the
    raw preconditioner apply against JAX's at 1e-5 (one f32 apply) and
    the warm-started accurate solve against the dense solve at 1e-9."""
    g = grids["plane10x6"]
    s = 1.0 / np.sqrt(np.diag(g["dense"]))
    sb = s.reshape(11, 14)
    D2 = g["D"] * sb[:, :, None] * sb[:, None, :]
    E2 = g["E"] * sb[1:, :, None] * sb[:-1, None, :]
    x = np.random.default_rng(4).standard_normal((g["n"], 2))
    x0 = 0.9 * np.linalg.solve(g["dense"], x)
    fj = jbf.PCGFactor(
        jbf.BCRFactor.from_blocks(jnp.asarray(D2, jnp.float32),
                                  jnp.asarray(E2, jnp.float32), jitter=1e-5),
        JElementOperator(jnp.asarray(g["mats"]), jnp.asarray(g["dofs"]),
                         g["n"]), jnp.asarray(s))
    ft = tbf.PCGFactor(
        tbf.BCRFactor.from_blocks(t(D2).float(), t(E2).float(), jitter=1e-5),
        TElementOperator(t(g["mats"]), t(g["dofs"]), g["n"]), t(s))
    sync.clear()
    a = ft.approx_mv(t(x)).double().numpy()
    assert rel(a, np.asarray(fj.approx_mv(jnp.asarray(x)))) < 1e-4
    assert sync.LOOP_STEPS["pcg_factor_f32"] <= ft.approx_maxiter
    p = ft.precond_mv(t(x[:, 0])).numpy()
    assert rel(p, np.asarray(fj.precond_mv(jnp.asarray(x[:, 0])))) < 1e-5
    w = ft.mv_warm(t(x), t(x0)).numpy()
    assert rel(w, np.linalg.solve(g["dense"], x)) < 1e-9
    assert rel(w, np.asarray(fj.mv_warm(jnp.asarray(x),
                                        jnp.asarray(x0)))) < 1e-9


# TopologyAnalysis on each block factor kind at 16x8 (N = 4, m = 60
# single-vector Lanczos), both packages from one numpy start vector
KINDS = ("blocktridiag", "blocktridiag_f32", "bcr", "bcr_f32")
NF = dict(nx=16, ny=8, Lx=2.0, Ly=1.0, rfact=2.0, N=4)
V0 = np.random.default_rng(11).uniform(-1.0, 1.0, 2 * 17 * 9)


def _tail(lam, Q, xp):
    eta = xp.exp(-(lam - lam[0]))
    return xp.sum(xp.sqrt(lam)) + xp.sum(eta[None, :] * Q[:9, :] ** 2)


@pytest.fixture(scope="module")
def nf_reference():
    """JAX's lam and gradient of the tail on each block kind."""
    out = {}
    for kind in KINDS:
        jt = j_make_model(factor_kind=kind, pallas_mv="off", **NF)
        jt.problem = dataclasses.replace(jt.problem,
                                         v0=lambda th: jnp.asarray(V0))

        def obj(x, jt=jt):
            lam, Q, _, _ = jt._solve_fn(x)
            return _tail(lam, Q, jnp), lam

        (val, lam), g = jax.jit(jax.value_and_grad(obj, has_aux=True))(
            jnp.asarray(jt.x))
        out[kind] = (np.asarray(lam), float(val), np.asarray(g))
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_topology_analysis_block_kinds_match_jax(nf_reference, kind):
    """TopologyAnalysis(factor_kind=kind) on the 16x8 model: lam against
    JAX at 1e-9, the tail's value at 1e-10 and its gradient at 1e-7 of
    max|g|."""
    lam_j, val_j, g_j = nf_reference[kind]
    tt = t_make_model(factor_kind=kind, device="cpu", **NF)
    tt.problem = dataclasses.replace(tt.problem,
                                     v0=lambda th: torch.as_tensor(V0))
    x = tt.x.clone().requires_grad_(True)
    lam, Q, _, _ = tt._solve_fn(x)
    v = _tail(lam, Q, torch)
    v.backward()
    assert rel(lam.detach().numpy(), lam_j) < 1e-9
    assert abs(float(v.detach()) - val_j) <= 1e-10 * abs(val_j)
    assert rel(x.grad.numpy(), g_j) < 1e-7


def _oracle_loop(y, r, opmv, pre, tol2, maxiter, site, steps):
    """``PCGFactor._loop`` as it stood before ``blocked_pcg`` replaced it,
    kept as the oracle; appends its step count to ``steps``."""
    z = pre(r)
    rz = torch.sum(r * z, dim=0)
    p = z
    r2 = torch.sum(r * r, dim=0)
    k = 0
    while k < maxiter:
        if not torch.any(r2 > tol2)[None].tolist()[0]:
            break
        active = r2 > tol2
        Ap = opmv(p)
        pAp = torch.sum(p * Ap, dim=0)
        alpha = torch.where(active, rz / torch.where(pAp == 0.0, 1.0,
                                                     pAp), 0.0)
        y = y + alpha[None, :] * p
        r = r - alpha[None, :] * Ap
        r2 = torch.sum(r * r, dim=0)
        z = pre(r)
        rzn = torch.sum(r * z, dim=0)
        beta = torch.where(active, rzn / torch.where(rz == 0.0, 1.0, rz),
                           0.0)
        p = z + beta[None, :] * p
        rz = rzn
        k += 1
    steps.append(k)
    return y, r2, k


@pytest.mark.parametrize("channel", ["f64", "f64_x0", "f32"])
@pytest.mark.parametrize("exit_", ["converged", "maxiter"])
def test_blocked_pcg_bitwise_as_the_loop_it_replaced(grids, monkeypatch,
                                                     channel, exit_):
    """PCGFactor on the 10x6 grid's element operator (f64, warm-started
    f64, the f32 element channel), its loop ``blocked_pcg`` against the
    loop it replaced run through the same entry point: the solution and
    the residuals bitwise, the same step count, the same exit. The zero
    column is frozen from the start."""
    g = grids["plane10x6"]
    s = 1.0 / np.sqrt(np.diag(g["dense"]))
    sb = s.reshape(11, 14)
    D2 = g["D"] * sb[:, :, None] * sb[:, None, :]
    E2 = g["E"] * sb[1:, :, None] * sb[:-1, None, :]
    ft = tbf.PCGFactor(
        tbf.BCRFactor.from_blocks(t(D2).float(), t(E2).float(), jitter=1e-5),
        TElementOperator(t(g["mats"]), t(g["dofs"]), g["n"]), t(s))
    x = np.random.default_rng(5).standard_normal((g["n"], 3))
    x[:, 2] = 0.0
    x = t(x)
    x0 = 0.5 * x if channel == "f64_x0" else None
    tol = 1e-5 if channel == "f32" else 1e-12
    maxiter = 1 if exit_ == "maxiter" else 300
    site = "pcg_factor_f32" if channel == "f32" else "pcg_factor"

    def solve():
        if channel == "f32":
            return ft._pcg32(x, tol, maxiter), None
        return ft._pcg(x, tol, maxiter, x0=x0)

    sync.clear()
    y, info = solve()
    assert dict(sync.LOOP_EXITS) == {f"{site}.{exit_}": 1}
    steps = []
    monkeypatch.setattr(tbf, "blocked_pcg",
                        functools.partial(_oracle_loop, steps=steps))
    y_ref, info_ref = solve()
    assert torch.equal(y, y_ref)
    assert steps == [sync.LOOP_STEPS[site]]
    assert (steps[0] == maxiter) == (exit_ == "maxiter")
    if info is not None:
        assert torch.equal(info["res"], info_ref["res"])
        assert info["niter"] == info_ref["niter"]
