"""The port's sharded layer against eigd_tpu/parallel on the CPU.

The partition maps equal JAX's integer for integer; the collectives and
their derivatives hold on 4 gloo ranks; and each sharded operator and
factor, applied on 4 gloo ranks (one launch, ``parallel.runs.ops``),
matches JAX's under ``shard_map`` on 4 of conftest's 8 virtual devices
on the same inputs. Every multi-rank launch has its own deadline.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from eigd_tpu.fem import assembly as jfem
from eigd_tpu.fem.model import make_grid
from eigd_tpu.fem.quad import plane_stress_tables
from eigd_tpu.fem.shell import shell_element_matrices
from eigd_tpu.ops.collective import qr_tall as j_qr_tall
from eigd_tpu.ops.operators import ElementOperator
from eigd_tpu.ops.stencil import stencil_from_elements
from eigd_tpu.parallel import grid as jgrid
from eigd_tpu.parallel import mgshard as jmg
from eigd_tpu.parallel import sharded as jsh
from eigd_tpu_torch import interop
from eigd_tpu_torch.models.crm import CRM
from eigd_tpu_torch.ops import sync
from eigd_tpu_torch.parallel import grid as tgrid
from eigd_tpu_torch.parallel import launch, runs
from eigd_tpu_torch.parallel.sharded import station_buckets

NDEV = 4
DEADLINE = 180.0


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:NDEV]), ("grid",))


@pytest.mark.parametrize("nx,ny,ndev,ndof,multiple", [
    (13, 5, 4, 2, 1), (10, 4, 4, 2, 1), (8, 4, 8, 1, 1), (16, 8, 4, 2, 4),
    (512, 256, 1, 2, 4), (255, 17, 3, 6, 1)])
def test_partition_maps_equal_jax(nx, ny, ndev, ndof, multiple):
    tp = tgrid.make_partition(nx, ny, ndev, ndof=ndof, multiple=multiple)
    jp = jgrid.make_partition(nx, ny, ndev, ndof=ndof, multiple=multiple)
    for f in ("nx", "ny", "ndof", "ndev", "L", "line_dofs", "nlines",
              "n_local", "n_padded", "n", "elems_local", "elems_padded"):
        assert getattr(tp, f) == getattr(jp, f), f
    np.testing.assert_array_equal(tgrid.element_gather_index(tp),
                                  jgrid.element_gather_index(jp))
    np.testing.assert_array_equal(tgrid.local_dof_map(tp),
                                  jgrid.local_dof_map(jp))
    np.testing.assert_array_equal(tgrid.pad_line_mask(tp),
                                  jgrid.pad_line_mask(jp))


def _jax_to_padded(x, part):
    """tests/test_sharding.py's layout loop."""
    out = np.zeros((part.n_padded,) + x.shape[1:], dtype=x.dtype)
    b = part.line_dofs
    for line in range(part.nlines):
        d, lo = divmod(line, part.L)
        out[d * part.n_local + lo * b: d * part.n_local + (lo + 1) * b] = \
            x[line * b: (line + 1) * b]
    return out


@pytest.mark.parametrize("shape", [(13, 5, 4), (16, 8, 3)])
def test_padded_layout(shape):
    part = tgrid.make_partition(*shape)
    x = np.random.default_rng(0).standard_normal((part.n, 2))
    np.testing.assert_array_equal(interop.to_padded(x, part),
                                  _jax_to_padded(x, part))
    np.testing.assert_array_equal(
        interop.from_padded(interop.to_padded(torch.as_tensor(x), part),
                            part).numpy(), x)


# ---------------------------------------------------------------------------
# Collectives and their derivatives on 4 gloo ranks
# ---------------------------------------------------------------------------


def test_launcher_defaults_to_the_card(monkeypatch):
    """run and local_axis default to device "cuda"; where CUDA is absent
    (made so here), each raises the "pass device='cpu'" error before a
    rank is spawned or a process group started."""
    import inspect
    import multiprocessing

    import torch.distributed as dist

    for fn in (launch.run, launch.local_axis):
        assert inspect.signature(fn).parameters["device"].default == "cuda"

    def no_spawn(*a, **k):
        raise AssertionError("a rank was spawned")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(multiprocessing, "get_context", no_spawn)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        launch.run(runs.placement, 1)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        with launch.local_axis():
            pass
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def coll():
    return launch.run(runs.collectives, NDEV, device="cpu",
                      timeout=DEADLINE)


def _x(r):
    return np.arange(6.0) + 10.0 * r


def test_collective_ranks(coll):
    assert [c["rank"] for c in coll] == list(range(NDEV))
    assert all(c["backend"] == "gloo" and not c["staged"] for c in coll)


def test_psum_and_backward(coll):
    total = sum(_x(r) for r in range(NDEV))
    for c in coll:
        np.testing.assert_array_equal(c["psum"], total)
        # the identity backward: d sum(s^2)/dx_r = 2 s, not 2 n s
        np.testing.assert_array_equal(c["psum_grad"], 2.0 * total)


def test_ppermute_and_backward(coll):
    w = np.arange(1.0, 7.0)
    for r, c in enumerate(coll):
        np.testing.assert_array_equal(c["ppermute"], _x((r - 1) % NDEV))
        # x_r went to rank r+1, whose weight is (r + 2) w
        np.testing.assert_array_equal(c["ppermute_grad"],
                                      w * ((r + 1) % NDEV + 1))
        np.testing.assert_array_equal(c["ppermute_jvp"],
                                      2.0 * _x((r - 1) % NDEV))


def test_ppermute_open_chain_gets_zeros(coll):
    np.testing.assert_array_equal(coll[0]["ppermute_open"], np.zeros(6))
    for r in range(1, NDEV):
        np.testing.assert_array_equal(coll[r]["ppermute_open"], _x(r - 1))


def test_ppermute_multi_and_derivatives(coll):
    """Two exchanges in one batch: x_r to rank r+1 and 2 x_r to rank r-1;
    the backward sends each cotangent back, the jvp sends the tangents on."""
    w = np.arange(1.0, 7.0)
    for r, c in enumerate(coll):
        np.testing.assert_array_equal(
            c["ppermute_multi"],
            np.stack([_x((r - 1) % NDEV), 2.0 * _x((r + 1) % NDEV)]))
        np.testing.assert_array_equal(
            c["ppermute_multi_grad"],
            w * ((r + 1) % NDEV + 1) + 2.0 * w * ((r - 1) % NDEV + 1))
        np.testing.assert_array_equal(
            c["ppermute_multi_jvp"],
            np.stack([2.0 * _x((r - 1) % NDEV), 2.0 * _x((r + 1) % NDEV)]))


def test_pvary_backward_is_whole(coll):
    # d/dx psum(<(r+1) w, x>) = sum_r (r+1) w on every rank
    w = np.arange(1.0, 7.0)
    for c in coll:
        np.testing.assert_array_equal(c["pvary_grad"],
                                      w * NDEV * (NDEV + 1) / 2)


def test_all_gather_and_backward(coll):
    full = np.concatenate([_x(r)[:2] for r in range(NDEV)])
    for r, c in enumerate(coll):
        np.testing.assert_array_equal(c["all_gather"], full)
        np.testing.assert_array_equal(c["all_gather_grad"], 2.0 * _x(r)[:2])


def test_staged_collectives_match(coll):
    """The staged collectives (ppermute through host buffers, as an axis
    on gloo with CUDA tensors runs it) give what the unstaged ones give,
    bitwise."""
    staged = launch.run(runs.collectives, NDEV, args=(True,), device="cpu",
                        timeout=DEADLINE)
    for c, s in zip(coll, staged):
        assert s["staged"] and not c["staged"]
        for key in ("psum", "psum_grad", "ppermute", "ppermute_grad",
                    "ppermute_open", "ppermute_jvp", "ppermute_multi",
                    "ppermute_multi_grad", "ppermute_multi_jvp",
                    "pvary_grad", "all_gather",
                    "all_gather_grad", "shard", "shard_grad",
                    "shard_value"):
            np.testing.assert_array_equal(s[key], c[key], err_msg=key)


def test_shard_backward_is_whole(coll):
    full = np.arange(3.0 * NDEV)
    val = np.sum(full ** 2) * (1.0 + full[0])
    grad = 2.0 * full * (1.0 + full[0])
    grad[0] += np.sum(full ** 2)
    for r, c in enumerate(coll):
        np.testing.assert_array_equal(c["shard"], full[3 * r:3 * r + 3])
        np.testing.assert_allclose(c["shard_value"], val, rtol=1e-15)
        np.testing.assert_allclose(c["shard_grad"], grad, rtol=1e-15)


# ---------------------------------------------------------------------------
# Sharded operators and factors against JAX's under shard_map
# ---------------------------------------------------------------------------


def _grid_inputs(nx, ny, seed, ndev, multiple=1):
    grid = make_grid(nx, ny, 2.0, 1.0)
    conn = jnp.asarray(grid.conn)
    X = jnp.asarray(grid.X)
    Be, He, detJ = plane_stress_tables(X, conn)
    rhoE = jnp.asarray(np.random.default_rng(seed).uniform(
        0.4, 1.0, size=conn.shape[0]))
    dofs = jfem.element_dof_map(conn)
    K = jfem.stiffness_matrix(rhoE, Be, detJ, dofs, 2 * grid.nnodes,
                              jfem.plane_stress_C0())
    M = jfem.mass_matrix(rhoE, He, detJ, dofs, 2 * grid.nnodes)
    part = tgrid.make_partition(nx, ny, ndev, ndof=2, multiple=multiple)
    gidx = tgrid.element_gather_index(part)
    gsafe, real = np.maximum(gidx, 0), (gidx >= 0).astype(np.float64)

    def cm(mats):
        return np.asarray(mats)[gsafe] * real[:, None, None]

    return K, M, part, cm


@pytest.fixture(scope="module")
def cases():
    rng = np.random.default_rng(11)
    inp = {}
    # halo operator and Schwarz-PCG on 13x5 (not divisible by 4)
    K, M, part, cm = _grid_inputs(13, 5, 3, NDEV)
    sigma = -10.0
    inp["part"] = part
    inp["dofs_l"] = tgrid.local_dof_map(part).astype(np.int64)
    inp["mats_cm"] = cm(K.mats)
    inp["shifted_cm"] = cm(K.mats) - sigma * cm(M.mats)
    x = rng.standard_normal((part.n, 3))
    inp["xp"] = interop.to_padded(x, part)
    dense = {"K": np.asarray(K.to_dense()),
             "S": np.asarray(K.to_dense() - sigma * M.to_dense()), "x": x}

    # stencil, grid transfers and the multigrid factor on 16x8
    K2, M2, mp, _ = _grid_inputs(16, 8, 5, NDEV, multiple=4)
    shifted = np.asarray(K2.mats) + 10.0 * np.asarray(M2.mats)
    W = np.asarray(stencil_from_elements(jnp.asarray(shifted), 16, 8, 2))
    W_rep = np.zeros((NDEV * mp.L,) + W.shape[1:])
    W_rep[:mp.nlines] = W
    inp["mg_part"], inp["W_rep"] = mp, W_rep
    inp["xmg"] = interop.to_padded(rng.standard_normal((mp.n, 2)), mp)
    nc = (mp.L // 2) * (mp.ny // 2 + 1) * 2
    inp["xmg_c"] = rng.standard_normal((NDEV * nc, 2))

    # the station Schur factor on a small wingbox (its masked K + M)
    crm = CRM(nspan=6, nchord=3, nheight=1, N=2, m=32, device="cpu")
    cp, Xe_cm, comp_cm, dofs_cm, me_cm = station_buckets(crm, NDEV)
    t = np.asarray(crm.x)[comp_cm]
    Ke, Me = shell_element_matrices(jnp.asarray(Xe_cm), jnp.asarray(t),
                                    E=crm.E, nu=crm.nu, rho=crm.rho)
    mm = me_cm[:, :, None] * me_cm[:, None, :]
    inp["crm_part"] = cp
    inp["crm_mats_cm"] = (np.asarray(Ke) + np.asarray(Me)) * mm
    inp["crm_dofs_cm"] = dofs_cm
    fm = np.zeros(cp.n_padded)
    fm[:crm.nvars] = crm.free_mask.numpy()
    inp["crm_x"] = rng.standard_normal((cp.n_padded, 2)) * fm[:, None]

    inp["R"] = rng.standard_normal((NDEV * 40, 5)) * np.array(
        [1.0, 1e-3, 10.0, 1.0, 1e-6])
    mats = rng.standard_normal((22, 4, 4))
    mats = mats + mats.transpose(0, 2, 1)
    dofs = rng.integers(0, 30, size=(22, 4))
    inp["emv_mats"], inp["emv_dofs"] = mats, dofs.astype(np.int64)
    inp["emv_n"], inp["emv_x"] = 30, rng.standard_normal(30)
    inp["emv_w"] = rng.standard_normal(30)
    inp["wmg"] = rng.standard_normal(inp["xmg"].shape)
    port = launch.run(runs.ops, NDEV, args=(inp,), device="cpu",
                      timeout=DEADLINE)
    return inp, dense, port


def _smap(mesh, fn, *args, out=P("grid")):
    specs = tuple(P("grid") for _ in args)
    prog = jax.jit(shard_map(fn, mesh=mesh, in_specs=specs, out_specs=out))
    return np.asarray(prog(*[jnp.asarray(a) for a in args]))


def test_halo_operator(cases, mesh):
    inp, dense, port = cases
    part, dofs_l = inp["part"], jnp.asarray(inp["dofs_l"], dtype=jnp.int32)

    def apply(m, x):
        return jsh.GridHaloOperator(m, dofs_l, part, "grid").mv(x)

    ref = _smap(mesh, apply, inp["mats_cm"], inp["xp"])
    for r in range(NDEV):
        np.testing.assert_allclose(port[r]["halo_mv"], ref, atol=1e-10)
    np.testing.assert_allclose(port[0]["halo_mv_vec"], ref[:, 0], atol=1e-10)
    np.testing.assert_allclose(interop.from_padded(ref, part),
                               dense["K"] @ dense["x"], atol=1e-10)


def test_schwarz_pcg_factor(cases, mesh):
    inp, dense, port = cases
    part, dofs_l = inp["part"], jnp.asarray(inp["dofs_l"], dtype=jnp.int32)

    def solve(m, b):
        f = jsh.SchwarzPCGFactor.build(m, dofs_l, part, "grid", maxiter=200,
                                       tol=1e-13)
        return f.mv(b)

    ref = _smap(mesh, solve, inp["shifted_cm"], inp["xp"][:, 0])
    np.testing.assert_allclose(port[0]["schwarz_mv"], ref, rtol=1e-8,
                               atol=1e-12)
    np.testing.assert_allclose(
        interop.from_padded(port[0]["schwarz_mv"], part),
        np.linalg.solve(dense["S"], dense["x"][:, 0]), rtol=1e-8,
        atol=1e-10)


@pytest.mark.parametrize("which", ["stencil_mv", "restrict", "prolong"])
def test_stencil_and_grid_transfers(cases, mesh, which):
    inp, _, port = cases
    mp = inp["mg_part"]
    L, ny, nd = mp.L, mp.ny, 2
    W_rep = jnp.asarray(inp["W_rep"])
    if which == "stencil_mv":
        def fn(x):
            return jmg.sharded_stencil_matvec(W_rep, x, L, mp.nlines, ny, nd,
                                              "grid", NDEV)
        ref = _smap(mesh, fn, inp["xmg"])
    elif which == "restrict":
        def fn(x):
            return jmg.sharded_restrict(x, L, ny, nd, "grid", NDEV)
        ref = _smap(mesh, fn, inp["xmg"])
    else:
        def fn(x):
            return jmg.sharded_prolong(x, L // 2, ny // 2, nd, "grid", NDEV,
                                       mp.nlines)
        ref = _smap(mesh, fn, inp["xmg_c"])
    np.testing.assert_allclose(port[0][which], ref, rtol=1e-12, atol=1e-12)


def test_sharded_mg_factor(cases, mesh):
    inp, _, port = cases
    mp = inp["mg_part"]

    def solve(W_l, x):
        f = jmg.ShardedGridMGFactor.build(W_l, mp, "grid", shard_levels=2)
        return f.mv(x)

    ref = _smap(mesh, solve, inp["W_rep"], inp["xmg"][:, 0])
    np.testing.assert_allclose(port[0]["mg_mv"], ref, rtol=1e-10,
                               atol=1e-10 * np.abs(ref).max())


def test_station_schur_factor(cases, mesh):
    inp, _, port = cases
    cp = inp["crm_part"]

    def solve(m, d, x):
        return jsh.StationSchurFactor.build(m, d, cp, "grid").mv(x)

    ref = _smap(mesh, solve, inp["crm_mats_cm"],
                inp["crm_dofs_cm"].astype(np.int32), inp["crm_x"])
    np.testing.assert_allclose(port[0]["station_mv"], ref, rtol=1e-10,
                               atol=1e-10 * np.abs(ref).max())


def test_qr_tall_sharded(cases, mesh):
    inp, _, port = cases

    def qr(R):
        Q, r = j_qr_tall(R, "grid")
        return Q, r

    Q, r = shard_map(qr, mesh=mesh, in_specs=(P("grid"),),
                     out_specs=(P("grid"), P()))(jnp.asarray(inp["R"]))
    np.testing.assert_allclose(port[0]["qr_Q"], np.asarray(Q), atol=1e-12)
    np.testing.assert_allclose(port[0]["qr_R"], np.asarray(r), rtol=1e-12,
                               atol=1e-12 * np.abs(np.asarray(r)).max())


def test_sharded_element_matvec(cases, mesh):
    inp, _, port = cases
    mats_p, dofs_p = jsh.pad_elements(
        [jnp.asarray(inp["emv_mats"]),
         jnp.asarray(inp["emv_dofs"], dtype=jnp.int32)], NDEV)
    mv = jsh.sharded_element_matvec(mesh, "grid", mats_p, dofs_p, 30)
    ref = np.asarray(mv(jnp.asarray(inp["emv_x"])))
    np.testing.assert_allclose(port[0]["element_mv"], ref, atol=1e-12)
    serial = ElementOperator(jnp.asarray(inp["emv_mats"]),
                             jnp.asarray(inp["emv_dofs"]), 30).mv(
        jnp.asarray(inp["emv_x"]))
    np.testing.assert_allclose(ref, np.asarray(serial), atol=1e-12)


def test_sharded_element_matvec_gradient(cases, mesh):
    """The gradient of <w, A x> in x and in the padded element matrices,
    whole and equal on every rank, against jax.grad through JAX's
    shard_map."""
    inp, _, port = cases
    mats_p, dofs_p = jsh.pad_elements(
        [jnp.asarray(inp["emv_mats"]),
         jnp.asarray(inp["emv_dofs"], dtype=jnp.int32)], NDEV)
    w = jnp.asarray(inp["emv_w"])

    def f(x, m):
        return jnp.sum(w * jsh.sharded_element_matvec(mesh, "grid", m,
                                                      dofs_p, 30)(x))

    gx, gm = jax.grad(f, argnums=(0, 1))(jnp.asarray(inp["emv_x"]), mats_p)
    for r in range(NDEV):
        np.testing.assert_allclose(port[r]["element_mv_grad_x"],
                                   np.asarray(gx), atol=1e-12)
        np.testing.assert_allclose(port[r]["element_mv_grad_mats"],
                                   np.asarray(gm), atol=1e-12)


def test_sharded_stencil_matvec_gradient(cases, mesh):
    """The gradient of psum(<w, A x>) through the halo exchange, in the
    replicated stencil (equal on every rank) and in the sharded x, against
    jax.grad through JAX's shard_map."""
    inp, _, port = cases
    mp = inp["mg_part"]

    def local(W, x, w):
        y = jmg.sharded_stencil_matvec(W, x, mp.L, mp.nlines, mp.ny, 2,
                                       "grid", NDEV)
        return jax.lax.psum(jnp.sum(w * y), "grid")

    f = shard_map(local, mesh=mesh, in_specs=(P(), P("grid"), P("grid")),
                  out_specs=P())
    gW, gx = jax.jit(jax.grad(f, argnums=(0, 1)))(
        jnp.asarray(inp["W_rep"]), jnp.asarray(inp["xmg"]),
        jnp.asarray(inp["wmg"]))
    gW, gx = np.asarray(gW), np.asarray(gx)
    for r in range(NDEV):
        np.testing.assert_allclose(port[r]["stencil_mv_grad_W"], gW,
                                   rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(port[0]["stencil_mv_grad_x"], gx, rtol=1e-12,
                               atol=1e-12)


# ---------------------------------------------------------------------------
# The sharded PCG loops at world 1 against the loops they replaced
# ---------------------------------------------------------------------------


def _oracle_mgshard_pcg(fac, bb, matvec, rtol, maxiter):
    """``ShardedGridMGFactor._pcg`` as it stood before ``flexible_pcg``
    replaced it: (x, steps, final r2, exit)."""
    from eigd_tpu_torch.ops.collective import psum

    axis = fac.axis
    dtype = bb.dtype

    def M(r, r_old=None):
        z = fac._vcycle(r).to(dtype)
        sums = [torch.sum(r * z, dim=0), torch.sum(r * r, dim=0)]
        if r_old is not None:
            sums.append(torch.sum(r_old * z, dim=0))
        sums = psum(torch.stack(sums), axis)
        ok = sums[0] > 0.0
        return (torch.where(ok[None, :], z, r),
                torch.where(ok, sums[0], sums[1]), *sums[1:])

    tol2 = (rtol * rtol) * torch.clamp(
        psum(torch.sum(bb * bb, dim=0), axis), min=1e-300)
    x = M(bb)[0]
    r = bb - matvec(x)
    z, rz, r2 = M(r)
    p = z
    best = torch.sum(r2)
    bad = torch.zeros((), dtype=torch.int64, device=bb.device)
    k = 0
    while k < maxiter:
        unconverged, fresh = torch.stack(
            [torch.any(r2 > tol2), bad < fac.stag_bad]).tolist()
        if not (unconverged and fresh):
            why = "stagnated" if unconverged else "converged"
            break
        Ap = matvec(p)
        pAp = psum(torch.sum(p * Ap, dim=0), axis)
        active = (r2 > tol2).to(dtype)
        pos = pAp > 0
        alpha = torch.where(pos, rz / torch.where(pos, pAp, 1.0),
                            0.0) * active
        x = x + p * alpha[None, :]
        r_new = r - Ap * alpha[None, :]
        z, rz_new, r2, rz_old = M(r_new, r)
        rz_flex = rz_new - rz_old
        nz = rz != 0.0
        beta = torch.where(nz, rz_flex / torch.where(nz, rz, 1.0), 0.0)
        p = z + p * beta[None, :]
        improving = torch.sum(r2) < 0.9 * best
        bad = torch.where(improving, 0, bad + 1)
        best = torch.minimum(best, torch.sum(r2))
        r, rz = r_new, rz_new
        k += 1
    else:
        why = "maxiter"
    return x, k, r2, why


def _oracle_schwarz(fac, bvec):
    """``SchwarzPCGFactor.mv_info`` as it stood before ``blocked_pcg``
    replaced its loop: (x, info)."""
    from eigd_tpu_torch.ops.collective import psum

    axis = fac.axis

    def colsum(p, q):
        return psum(torch.sum(p * q, dim=0), axis)

    tol2 = (fac.tol ** 2) * torch.clamp(colsum(bvec, bvec), min=1e-300)
    x = torch.zeros_like(bvec)
    r = bvec
    p = fac.btf.mv(bvec)
    rz = colsum(bvec, p)
    r2 = colsum(r, r)
    k = 0
    while k < fac.maxiter and bool(torch.any(r2 > tol2)):
        ap = fac.op.mv(p)
        pap = colsum(p, ap)
        active = r2 > tol2
        alpha = torch.where(active & (pap != 0.0),
                            rz / torch.where(pap == 0.0, 1.0, pap), 0.0)
        x = x + alpha[None, :] * p
        r = r - alpha[None, :] * ap
        z = fac.btf.mv(r)
        rz_new, r2 = psum(torch.stack([torch.sum(r * z, dim=0),
                                       torch.sum(r * r, dim=0)]), axis)
        beta = torch.where(rz != 0.0,
                           rz_new / torch.where(rz == 0.0, 1.0, rz), 0.0)
        p = torch.where(active[None, :], z + beta[None, :] * p, p)
        rz = rz_new
        k += 1
    return x, {"niter": k, "res2": r2, "tol2": tol2}


@pytest.fixture(scope="module")
def world1():
    """The 16x8 shifted stencil and the 13x5 shifted element matrices on
    world-1 partitions, with right-hand sides of three columns."""
    rng = np.random.default_rng(13)
    K, M, mp, _ = _grid_inputs(16, 8, 5, 1, multiple=4)
    W = np.asarray(stencil_from_elements(
        jnp.asarray(np.asarray(K.mats) + 10.0 * np.asarray(M.mats)), 16, 8,
        2))
    W_rep = np.zeros((mp.L,) + W.shape[1:])
    W_rep[:mp.nlines] = W
    K, M, part, cm = _grid_inputs(13, 5, 3, 1)
    return dict(mg_part=mp, W=torch.as_tensor(W_rep),
                xmg=torch.as_tensor(interop.to_padded(
                    rng.standard_normal((mp.n, 3)), mp)),
                part=part, shifted=torch.as_tensor(cm(K.mats)
                                                   + 10.0 * cm(M.mats)),
                dofs=torch.as_tensor(tgrid.local_dof_map(part),
                                     dtype=torch.int64),
                x=torch.as_tensor(interop.to_padded(
                    rng.standard_normal((part.n, 3)), part)))


def _jax_mgshard_pcg(W_rep, part, b, lmaxs, tail_lmaxs, f64, rtol, maxiter):
    """JAX's ``ShardedGridMGFactor._pcg`` under ``shard_map`` on one
    device, its lambda_max estimates replaced by the port's (the two draw
    their power iterations' start vectors differently)."""
    def solve(W_l, bb):
        f = jmg.ShardedGridMGFactor.build(W_l, part, "grid", shard_levels=2)
        f.lmaxs = tuple(jnp.float32(v) for v in lmaxs)
        f.tail.lmaxs = tuple(jnp.float32(v) for v in tail_lmaxs)
        if f64:
            return f._pcg(bb, f._matvec64, rtol, maxiter)
        (L, nlines, _, ny), = f.meta[3][:1]
        return f._pcg(bb, lambda v: jmg.sharded_stencil_matvec(
            f.Ws[0], v, L, nlines, ny, part.ndof, "grid", 1), rtol, maxiter)

    mesh1 = Mesh(np.array(jax.devices()[:1]), ("grid",))
    return _smap(mesh1, solve, W_rep, b)


@pytest.mark.parametrize("f64", [True, False])
@pytest.mark.parametrize("exit_", ["converged", "stagnated", "maxiter"])
def test_sharded_mg_pcg_bitwise_at_world_1(world1, f64, exit_):
    """The line-sharded mg factor's PCG (f64 on K2's twin, f32 on K1's)
    on a world-1 gloo group: ``flexible_pcg`` with all-reduced sums
    against the loop it replaced, x and the residuals bitwise, the same
    steps and exit. The stagnating case (smoothers tuned to 0.6 of
    lambda_max) trips the descent guard, and only it does (its firings
    counted through the wrapped V-cycle). There the old loop took r_old.z
    from the V-cycle's output before the guard, where JAX's ``_pcg`` and
    the serial loop take it from the guarded direction: the solve is held
    bitwise to ``flexible_pcg`` with local sums on the same V-cycle, and
    to JAX's sharded ``_pcg`` within 64 f32 roundings of max |x| (the
    V-cycles' f32 sums run in other orders; the old loop's x lies 0.6 of
    max |x| from JAX's there)."""
    from eigd_tpu_torch.ops.multigrid import flexible_pcg
    from eigd_tpu_torch.parallel.mgshard import ShardedGridMGFactor

    maxiter = 3 if exit_ == "maxiter" else 60
    with launch.local_axis("cpu") as axis:
        fac = ShardedGridMGFactor.build(world1["W"], world1["mg_part"], axis,
                                        shard_levels=2)
        if exit_ == "stagnated":
            fac.levels = tuple(lv[:6] + (0.6 * lv[6],) for lv in fac.levels)
            fac.tail.lmaxs = tuple(0.6 * v for v in fac.tail.lmaxs)
        vcycle, fired = fac._vcycle, [0]

        def counted(r):
            z = vcycle(r)
            fired[0] += int((torch.sum(r * z.to(r.dtype), dim=0) <= 0).sum())
            return z

        fac._vcycle = counted
        b = world1["xmg"] if f64 else world1["xmg"].float()
        matvec, rtol = ((fac._matvec64, 1e-10) if f64
                        else (fac._matvec32, 1e-5))
        site = "mgshard_f64" if f64 else "mgshard_f32"
        sync.clear()
        x = fac._solve(b, f64, rtol, maxiter)
        exits, steps = dict(sync.LOOP_EXITS), sync.LOOP_STEPS[site]
        fac._vcycle = vcycle
        if exit_ == "stagnated":
            xr, info = flexible_pcg(b, matvec, fac._vcycle, rtol, maxiter,
                                    fac.stag_bad, site)
            kr = info["niter"]
        else:
            xr, kr, _, why = _oracle_mgshard_pcg(fac, b, matvec, rtol,
                                                 maxiter)
            assert why == exit_
    assert torch.equal(x, xr)
    assert exits == {f"{site}.{exit_}": 1} and steps == kr
    assert (fired[0] > 0) == (exit_ == "stagnated")
    if exit_ == "stagnated":
        W = world1["W"].numpy()
        ref = _jax_mgshard_pcg(W if f64 else W.astype(np.float32),
                               world1["mg_part"], b.numpy(),
                               [lv[6] for lv in fac.levels],
                               fac.tail.lmaxs, f64, rtol, maxiter)
        err = np.abs(x.numpy() - ref).max() / np.abs(ref).max()
        assert err <= 64 * np.finfo(np.float32).eps


@pytest.mark.parametrize("pre,maxiter,why", [
    ("block", 200, "converged"), ("none", 400, "converged"),
    ("none", 5, "maxiter")])
def test_schwarz_pcg_bitwise_at_world_1(world1, pre, maxiter, why):
    """SchwarzPCGFactor on a world-1 gloo group: ``blocked_pcg`` with
    all-reduced sums against the loop it replaced, x and the info bitwise,
    the same exit. At world 1 the rank-local block factor is exact (one
    step), so the loop also runs unpreconditioned (plain CG), to its
    tolerance and cut at maxiter."""
    from types import SimpleNamespace

    from eigd_tpu_torch.parallel.sharded import SchwarzPCGFactor

    with launch.local_axis("cpu") as axis:
        fac = SchwarzPCGFactor.build(world1["shifted"], world1["dofs"],
                                     world1["part"], axis, maxiter=maxiter,
                                     tol=1e-13)
        if pre == "none":
            fac.btf = SimpleNamespace(mv=torch.clone)
        sync.clear()
        x, info = fac.mv_info(world1["x"])
        exits = dict(sync.LOOP_EXITS)
        xr, ref = _oracle_schwarz(fac, world1["x"])
    assert torch.equal(x, xr) and info["niter"] == ref["niter"]
    assert torch.equal(info["res2"], ref["res2"])
    assert torch.equal(info["tol2"], ref["tol2"])
    assert exits == {f"schwarz_pcg.{why}": 1}
