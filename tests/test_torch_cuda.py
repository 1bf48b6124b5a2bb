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


@pytest.mark.parametrize("ndof", [1, 2])
def test_kernels_match_twins(ndof):
    """K1 (plane and vector layouts, 1e-5 of max|ref|) and K2 (1e-13 of
    18 max|x| max|W|) on a grid that is no multiple of the block size,
    including a non-contiguous input."""
    require_cuda()
    nx, ny = 40, 23
    g = torch.Generator().manual_seed(ndof)
    W = torch.randn((nx + 1, ny + 1, 3, 3, ndof, ndof), generator=g,
                    dtype=torch.float64).cuda()
    n = (nx + 1) * (ny + 1) * ndof
    Wp, Wp64 = cs.stencil_planes(W, ndof), cs.stencil_planes(
        W, ndof, torch.float64)
    for k in (1, 5):
        x = torch.randn((n, k), generator=g, dtype=torch.float64).cuda()
        xq = cs.to_planes(x.float(), nx, ny, ndof)
        ref = cs.matvec_planes_ref(Wp, xq, nx, ny, ndof)
        got = cs.matvec_planes(Wp, xq, nx, ny, ndof)
        assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()
        ref = stencil_matvec(W.float(), x.float(), nx, ny, ndof)
        got = cs.stencil_matvec32(Wp, x.float(), nx, ny, ndof)
        assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()
        bound = 1e-13 * 18 * x.abs().max() * W.abs().max()
        ref = stencil_matvec(W, x, nx, ny, ndof)
        got = cs.stencil_matvec64(Wp64, x, nx, ny, ndof)
        assert (got - ref).abs().max() <= bound
        xt = torch.randn((k, n), generator=g, dtype=torch.float64).cuda().T
        got = cs.stencil_matvec64(Wp64, xt, nx, ny, ndof)
        ref = stencil_matvec(W, xt.contiguous(), nx, ny, ndof)
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


@pytest.mark.parametrize("ndof", [1, 2])
def test_probes_match_twins(ndof):
    """K3 (every body; copy exact, the sums 1e-5 of max|ref|) with the
    three slabs as row offsets into one padded buffer, and K4 (1 and 3
    slabs, with and without W) on shapes that are no multiple of a block."""
    require_cuda()
    g = torch.Generator().manual_seed(10 + ndof)
    k, R, Y = 3, 37, 29
    C = ndof * k
    xpad = torch.randn((C, R + 2, Y + 2), generator=g).cuda()
    W = torch.randn((9 * ndof * ndof, R, Y), generator=g).cuda()
    slabs = [xpad[:, d:d + R] for d in range(3)]
    for kind in cp.FLOOR_KINDS:
        n = cp.K3_LAUNCHES
        got = cp.floor_variant(kind, W, *slabs, ndof, k)
        ref = cp.floor_variant_ref(kind, W, *slabs, ndof, k)
        assert cp.K3_LAUNCHES == n + 1
        tol = 0.0 if kind == "copy" else 1e-5 * float(ref.abs().max())
        assert float((got - ref).abs().max()) <= tol
    xs = [torch.randn((C, R, Y + 2), generator=g).cuda() for _ in range(3)]
    for n_slabs in (1, 3):
        for with_w in (False, True):
            got = cp.dma_probe(xs[:n_slabs], W, Y, with_w)
            ref = cp.dma_probe_ref(xs[:n_slabs], W, Y, with_w)
            assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


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
