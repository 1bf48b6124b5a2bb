"""The CUDA kernels on the card: K1 to K4 against their plain twins, the
kernel path against the plain path end to end, and the forward-mode
tangent on the card against the CPU.

Every test here carries the ``cuda`` marker and skips without a CUDA
device (the kernels have no CPU mode; tests/test_torch_stencil.py checks
the twins on the CPU). The file imports neither jax nor eigd_tpu, so it
runs on a GPU machine without them:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from eigd_tpu_torch.fem.assembly import element_density
from eigd_tpu_torch.models.natural_frequency import make_model
from eigd_tpu_torch.ops import cuda_probes as cp
from eigd_tpu_torch.ops import cuda_stencil as cs
from eigd_tpu_torch.ops.autodiff import eigh_gen_tangent
from eigd_tpu_torch.ops.stencil import stencil_matvec

pytestmark = pytest.mark.cuda


def require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


# grids (X, Y) of 1 and 2 nodes a side, one node under, at and over the
# kernel's 8 x 32 tile in each direction, one that is no multiple of it,
# and one of more tiles than FILL_BLOCKS, one node over a tile each way
# (its blocks take all k columns, in several chunks)
GRIDS = [(1, 1), (2, 2), (7, 31), (8, 32), (9, 33), (7, 33), (9, 31),
         (41, 24), (137, 513)]


# k 40: more columns than one chunk of the vector layout holds
@pytest.mark.parametrize("k", [1, 3, 5, 8, 16, 17, 40])
@pytest.mark.parametrize("ndof", [1, 2])
@pytest.mark.parametrize("X,Y", GRIDS)
def test_kernels_match_twins(X, Y, ndof, k):
    """K1 on the plane layout (contiguous and sliced x) and on the vector
    layout, 1e-5 of max|ref|; K2 on the vector layout (contiguous and
    transposed x), 1e-13 of 18 max|x| max|W|; at the edges of the tiles,
    of the 4-column chunks and of the column groups."""
    require_cuda()
    nx, ny = X - 1, Y - 1
    g = torch.Generator().manual_seed(1000 * X + 10 * k + ndof)
    W = torch.randn((X, Y, 3, 3, ndof, ndof), generator=g,
                    dtype=torch.float64).cuda()
    n = X * Y * ndof
    Wp, Wp64 = cs.stencil_planes(W, ndof), cs.stencil_planes(
        W, ndof, torch.float64)
    x = torch.randn((n, k), generator=g, dtype=torch.float64).cuda()
    big = torch.randn((ndof, k + 2, X, Y + 3), generator=g).cuda()
    for xq in (cs.to_planes(x.float(), nx, ny, ndof),
               big[:, 1:k + 1, :, 2:Y + 2]):
        ref = cs.matvec_planes_ref(Wp, xq, nx, ny, ndof)
        got = cs.matvec_planes(Wp, xq, nx, ny, ndof)
        assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()
    ref = stencil_matvec(W.float(), x.float(), nx, ny, ndof)
    got = cs.stencil_matvec32(Wp, x.float(), nx, ny, ndof)
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()
    xt = torch.randn((k, n), generator=g, dtype=torch.float64).cuda().T
    for xv in (x, xt):
        bound = 1e-13 * 18 * xv.abs().max() * W.abs().max()
        ref = stencil_matvec(W, xv.contiguous(), nx, ny, ndof)
        got = cs.stencil_matvec64(Wp64, xv, nx, ny, ndof)
        assert (got - ref).abs().max() <= bound


def test_kernel_path_gradient_matches_plain():
    """The 12x6 model's gradient with the kernels on (K1 V-cycle, K2
    solver matvecs) against the plain path, on the card: 1e-9 relative."""
    require_cuda()
    grads = []
    for kmv, vc in (("off", "plain"), ("on", "kernel")):
        topo = make_model(nx=12, ny=6, N=2, m=48, Lx=2.0, Ly=1.0, rfact=2.0,
                          factor_kind="mg", lanczos_block=4,
                          lanczos_ortho="local", lanczos_polish=1,
                          factor_options={"min_coarse": 64, "vcycle": vc},
                          kernel_mv=kmv, device="cuda")
        x = topo.x.clone().requires_grad_(True)
        k1, k2 = cs.K1_LAUNCHES, cs.K2_LAUNCHES
        lam, Q, _, _ = topo._solve_fn(x)
        (torch.sum(torch.sqrt(lam)) + torch.sum(Q[:6] ** 2)).backward()
        launched = (cs.K1_LAUNCHES - k1, cs.K2_LAUNCHES - k2)
        assert (min(launched) > 0) == (kmv == "on")
        grads.append(x.grad)
    rel = (grads[1] - grads[0]).abs().max() / grads[0].abs().max()
    assert rel <= 1e-9


# (slab width, output width) of the probe tests: every residue mod 4 of
# both, 16-byte rows with an aligned output (36, 32), the real unaligned
# layout (515, 513) and the aligned one (640, 640); K3 takes Y = slab
# width - 2
PROBE_WIDTHS = [(31, 29), (32, 30), (33, 31), (34, 32), (36, 32),
                (515, 513), (640, 640)]


def at_offset(shape, off, g):
    """A random contiguous CUDA tensor of ``shape`` at a storage offset of
    ``off`` floats."""
    n = int(np.prod(shape))
    return torch.randn(off + n, generator=g, device="cuda")[off:].view(shape)


@pytest.mark.parametrize("ndof,k", [(nd, k) for nd in (1, 2)
                                    for k in (1, 3, 8, 16)])
@pytest.mark.parametrize("off", [0, 1, 2, 3])
@pytest.mark.parametrize("Yx,Yo", PROBE_WIDTHS)
@pytest.mark.parametrize("R", [1, 37, 1040])
def test_probes_match_twins(R, Yx, Yo, off, ndof, k):
    """K3 (every body, its slabs row offsets into one padded buffer) and
    K4 (1 and 3 slabs, with and without W), every operand at a storage
    offset of ``off`` floats (16-byte aligned rows move quads, others go
    through the staged store): K3 copy and K4 exact, the K3 sums 1e-5 of
    max|ref|; each call launches once."""
    require_cuda()
    g = torch.Generator(device="cuda").manual_seed(
        100000 * R + 100 * Yx + 10 * off + 2 * k + ndof)
    C, Y = ndof * k, Yx - 2
    xpad = at_offset((C, R + 2, Yx), off, g)
    W = at_offset((9 * ndof * ndof, R, Y), off, g)
    slabs = [xpad[:, d:d + R] for d in range(3)]
    for kind in cp.FLOOR_KINDS:
        ref = cp.floor_variant_ref(kind, W, *slabs, ndof, k)
        tol = 0.0 if kind == "copy" else 1e-5 * float(ref.abs().max())
        n = cp.K3_LAUNCHES
        got = cp.floor_variant(kind, W, *slabs, ndof, k)
        assert cp.K3_LAUNCHES == n + 1
        assert float((got - ref).abs().max()) <= tol
    xs = [at_offset((C, R, Yx), off, g) for _ in range(3)]
    W4 = at_offset((2, R, Yx), off, g)
    for n_slabs in (1, 3):
        for with_w in (False, True):
            n = cp.K4_LAUNCHES
            got = cp.dma_probe(xs[:n_slabs], W4, Yo, with_w)
            assert cp.K4_LAUNCHES == n + 1
            assert torch.equal(got, cp.dma_probe_ref(xs[:n_slabs], W4, Yo,
                                                     with_w))


def test_tangent_on_card_matches_cpu():
    """eigh_gen_tangent at the 12x6 configuration, exact sweep, on the
    card (K1/K2) against the CPU (the twins): dlam 1e-10 relative, dPhi
    1e-8 of max, eigenvector signs aligned."""
    require_cuda()
    v0 = np.random.default_rng(11).uniform(-1.0, 1.0, (2 * 13 * 7, 4))
    dth = np.random.default_rng(3).uniform(-1.0, 1.0, 72)
    out = {}
    for dev in ("cpu", "cuda"):
        topo = make_model(nx=12, ny=6, N=2, m=32, Lx=2.0, Ly=1.0, rfact=2.0,
                          factor_kind="mg", lanczos_block=4,
                          lanczos_ortho="local", lanczos_tol=1e-11,
                          lanczos_polish=1, kernel_mv="on",
                          factor_options={"min_coarse": 64,
                                          "vcycle": "kernel"}, device=dev)
        topo.problem = dataclasses.replace(
            topo.problem, v0=lambda th, d=dev: torch.as_tensor(v0, device=d))
        th = element_density(topo.fltr.apply(topo.x), topo.conn)
        out[dev] = [t.cpu().numpy() for t in eigh_gen_tangent(
            th, torch.as_tensor(dth, device=dev), topo.problem, topo.cfg)]
    _, Phi, dlam, dPhi = out["cpu"]
    _, gPhi, gdlam, gdPhi = out["cuda"]
    sign = np.sign(np.sum(gPhi * Phi, axis=0))
    assert np.abs(gdlam - dlam).max() <= 1e-10 * np.abs(dlam).max()
    assert np.abs(gdPhi * sign - dPhi).max() <= 1e-8 * np.abs(dPhi).max()


@pytest.mark.parametrize("grid", [(64, 32), (512, 256)])
def test_buckling_operators_match_twins(grid):
    """K2 on the buckling model's masked operators at its design: K-hat
    (unit diagonal on the clamped edge folded into W) and G, k 1 and 6,
    against stencil_matvec, 1e-13 of 18 max|x| max|W|; each call launches
    K2 once. Then the model's gradient (KS + aggregate seeds) with the
    kernels on against the plain path at 24x12 on bcr_f32: 1e-9."""
    require_cuda()
    from eigd_tpu_torch.models.buckling import make_buckling_model

    nx, ny = grid
    topo = make_buckling_model(nx=nx, ny=ny, N=6, sigma=4.2e-3,
                               factor_kind="bcr", device="cuda")
    with torch.no_grad():
        rhoE = element_density(topo.fltr.apply(topo.x), topo.conn)
        u, _ = topo._static(rhoE)
        G, K = topo._assemble_pencil((rhoE, u))
    g = torch.Generator(device="cuda").manual_seed(nx)
    for op in (K, G):
        fast = op.with_kernels()
        assert fast.extra_diag is op.extra_diag
        for k in (1, 6):
            x = torch.randn((topo.nvars, k), generator=g, device="cuda",
                            dtype=torch.float64)
            n = cs.K2_LAUNCHES
            got = fast.mv(x)
            assert cs.K2_LAUNCHES == n + 1
            ref = stencil_matvec(op.W, x, nx, ny, 2)
            bound = 1e-13 * 18 * x.abs().max() * op.W.abs().max()
            assert (got - ref).abs().max() <= bound

    grads = []
    for kmv in ("off", "on"):
        topo = make_buckling_model(nx=24, ny=12, N=4, sigma=4.2e-3,
                                   factor_kind="bcr_f32", kernel_mv=kmv,
                                   device="cuda")
        topo.initialize()
        topo.initialize_adjoint()
        topo.add_ks_buckling_derivative(1.0, 100.0)
        topo.add_eigenvector_aggregate_derivative(1.0, 1.0, [49, 51])
        topo.finalize_adjoint()
        grads.append(topo.xb)
    assert (grads[1] - grads[0]).abs().max() <= 1e-9 * grads[0].abs().max()


@pytest.mark.parametrize("kind", ["cholesky", "bcr_f32"])
def test_crm_on_card_matches_cpu(kind):
    """The CRM at nspan 8 (nchord 2, nheight 1, N 4, m 40, nribs 2) on the
    card against the CPU, one protocol pass each from the same start
    vector: eigenvalues 1e-10, xb 1e-8 (index_add sums in another order
    on the card, so not bitwise)."""
    require_cuda()
    from eigd_tpu_torch.models.crm import CRM

    out = []
    for device in ("cpu", "cuda"):
        crm = CRM(nspan=8, nchord=2, nheight=1, N=4, m=40, nribs=2,
                  factor_kind=kind, device=device)
        crm.initialize()
        crm.initialize_adjoint()
        crm.add_modal_compliance_derivative(1.0)
        crm.finalize_adjoint()
        out.append((crm.lam.cpu().numpy(), crm.xb.cpu().numpy()))
    (lam_c, xb_c), (lam_g, xb_g) = out
    assert np.abs(lam_g - lam_c).max() <= 1e-10 * np.abs(lam_c).max()
    assert np.abs(xb_g - xb_c).max() <= 1e-8 * np.abs(xb_c).max()


def test_crm_protocol_matches_autograd_on_card():
    """The protocol's xb against torch.autograd of _solve_fn with the same
    seeds, on the card (bcr_f32, nspan 4): 1e-12, where the CPU agrees
    bitwise (tests/test_torch_crm.py): the second solve sums its
    index_adds in another order."""
    require_cuda()
    from eigd_tpu_torch.models.crm import CRM

    crm = CRM(nspan=4, nchord=2, nheight=1, N=3, m=40, nribs=1,
              device="cuda")
    crm.initialize()
    crm.initialize_adjoint()
    crm.add_modal_compliance_derivative(1.0)
    crm.finalize_adjoint()
    x = crm.x.clone().requires_grad_(True)
    lam, Qr = crm._solve_fn(x)
    (g,) = torch.autograd.grad((lam, Qr), x, (crm.lamb, crm.Qrb))
    gap = float((g - crm.xb).abs().max() / crm.xb.abs().max())
    assert gap <= 1e-12, gap


def solver_surface(dev):
    """dl, thick_restart_solve and BasicLanczos(mode="cayley") on the
    64x64 thermal model on the mg factor (kernels "on": K1/K2 on the
    card, their twins on the CPU): the dl gradient of sum(lam) +
    sum(Q[:20]^2), the restarted solve's lam (m 30, k 12, three cycles
    run: two restarts) and the Cayley map's lam (sigma -0.1, N 3,
    m 60)."""
    from eigd_tpu_torch import BasicLanczos, thick_restart_solve
    from eigd_tpu_torch.models.thermal import make_model as thermal_model
    from eigd_tpu_torch.ops.autodiff import _kernel_ops

    topo = thermal_model(nx=64, ny=64, Ly=1.15, N=6, factor_kind="mg",
                         adjoint_method="dl", kernel_mv="on",
                         factor_options={"vcycle": "kernel"}, device=dev)
    x = topo.x.clone().requires_grad_(True)
    lam, Q = topo._solve_fn(x)
    (torch.sum(lam) + torch.sum(Q[:20] ** 2)).backward()
    with torch.no_grad():
        A, B = _kernel_ops(*topo.problem.assemble(element_density(
            topo.fltr.apply(topo.x), topo.conn)), topo.cfg)
        factor = topo.problem.factor(A, B, topo.sigma, "normal")
        rlam = thick_restart_solve(A, B, factor, topo.sigma, 6, 30, k=12,
                                   ncycle=3).lam
        clam, _ = BasicLanczos(N=3, m=60, mode="cayley").solve(
            A, B, factor, topo.sigma)
    return [t.detach().cpu().numpy() for t in (x.grad, rlam, clam)]


def test_solver_surface_on_card_matches_cpu():
    """The dl gradient at 1e-8 of its largest entry, the restarted and
    the Cayley eigenvalues at rtol 1e-9 (atol 1e-10 for the constant
    mode), on the card against the CPU."""
    require_cuda()
    cpu, gpu = solver_surface("cpu"), solver_surface("cuda")
    assert np.abs(gpu[0] - cpu[0]).max() <= 1e-8 * np.abs(cpu[0]).max()
    for g, c in zip(gpu[1:], cpu[1:]):
        np.testing.assert_allclose(g, c, rtol=1e-9, atol=1e-10)


def sharded_nf(device):
    """The sharded NF objective (mg factor, 32x16, N 2, m 40, pcpg
    adjoint) at world 1 on ``device``: value and gradient."""
    from eigd_tpu_torch.parallel import launch, runs

    kw = dict(nx=32, ny=16, N=2, m=40, factor="mg", adjoint_method="pcpg",
              adjoint_maxiter=200)
    with launch.local_axis(device) as axis:
        r = runs.objective(axis, "nf", kw)
    return r["value"], r["grad"].detach().cpu().numpy()


def test_sharded_objective_on_card_matches_cpu():
    """The sharded NF objective at world 1 (NCCL on the card, K1/K2 in
    its V-cycle and outer PCG) against the same objective on the CPU
    (gloo, the kernels' twins): value rel 1e-9, gradient 1e-7 of its
    largest entry."""
    require_cuda()
    v_c, g_c = sharded_nf("cpu")
    k1, k2 = cs.K1_LAUNCHES, cs.K2_LAUNCHES
    v_g, g_g = sharded_nf("cuda")
    assert cs.K1_LAUNCHES > k1 and cs.K2_LAUNCHES > k2
    assert abs(v_g - v_c) <= 1e-9 * abs(v_c)
    assert np.abs(g_g - g_c).max() <= 1e-7 * np.abs(g_c).max()


def sharded_stencil_inputs(device):
    """A random 2-DOF stencil replicated over the lines of a 16x8
    partition at world 1 (L 20: the sharded mg factor's multiple of 4,
    padded lines zero), a 3-column x and a weight of its shape."""
    from eigd_tpu_torch.parallel.grid import make_partition

    part = make_partition(16, 8, 1, ndof=2, multiple=4)
    g = torch.Generator().manual_seed(11)
    W = torch.zeros((part.L, 9, 3, 3, 2, 2), dtype=torch.float64)
    W[:part.nlines] = torch.randn((part.nlines, 9, 3, 3, 2, 2), generator=g,
                                  dtype=torch.float64)
    x, w = (torch.randn((part.n_local, 3), generator=g, dtype=torch.float64)
            for _ in range(2))
    return part, W.to(device), x.to(device), w.to(device)


def test_sharded_stencil_gradient_on_card():
    """sharded_stencil_matvec at world 1 on the card (NCCL, the launcher's
    default device): the gradient of psum(<w, A x>) in the replicated
    stencil and in x exists and is within 1e-12 of its largest entry of
    the CPU's (gloo); without a gradient the call launches K2 and agrees
    with the plain stencil matvec to 1e-12. The wrappers refuse a CUDA
    input that requires grad under grad mode, and take it under
    torch.no_grad()."""
    require_cuda()
    from eigd_tpu_torch.parallel import launch, runs
    from eigd_tpu_torch.parallel.mgshard import sharded_stencil_matvec

    grads = {}
    for device in ("cpu", None):
        part, W, x, w = sharded_stencil_inputs(device or "cuda")
        with (launch.local_axis(device) if device else
              launch.local_axis()) as axis:
            grads[device] = runs.stencil_gradient(axis, W, x, w, part)
            if device is None:
                assert axis.backend == "nccl" and axis.device.type == "cuda"
                k2 = cs.K2_LAUNCHES
                with torch.no_grad():
                    y = sharded_stencil_matvec(W, x, part.L, part.nlines,
                                               part.ny, 2, axis)
                assert cs.K2_LAUNCHES == k2 + 1
                xe = torch.cat([torch.zeros_like(x[:18]), x,
                                torch.zeros_like(x[:18])])
                We = torch.cat([W.new_zeros((1,) + W.shape[1:]), W,
                                W.new_zeros((1,) + W.shape[1:])])
                ref = stencil_matvec(We, xe, part.L + 1, part.ny, 2)[18:-18]
                assert (y - ref).abs().max() <= 1e-12 * ref.abs().max()
    for c, g in zip(grads["cpu"], grads[None]):
        c, g = c.cpu().numpy(), g.cpu().numpy()
        assert np.abs(g - c).max() <= 1e-12 * np.abs(c).max()

    W = torch.randn((9, 9, 3, 3, 2, 2), dtype=torch.float64).cuda()
    x = torch.randn((9 * 9 * 2, 4), dtype=torch.float64).cuda()
    for mv, dt in ((cs.stencil_matvec64, torch.float64),
                   (cs.stencil_matvec32, torch.float32)):
        Wp = cs.stencil_planes(W, 2, dt)
        xg = x.to(dt).requires_grad_(True)
        with pytest.raises(RuntimeError, match="autograd"):
            mv(Wp, xg, 8, 8, 2)
        with pytest.raises(RuntimeError, match="autograd"):
            mv(Wp.clone().requires_grad_(True), x.to(dt), 8, 8, 2)
        with torch.no_grad():
            y = mv(Wp, xg, 8, 8, 2)
        assert y.shape == x.shape and not y.requires_grad
