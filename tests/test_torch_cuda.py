"""The CUDA kernels on the card: K1 and K2 against their plain twins, and
the kernel path against the plain path end to end.

Every test here carries the ``cuda`` marker and skips without a CUDA
device (the kernels have no CPU mode; tests/test_torch_stencil.py checks
the twins on the CPU). The file imports neither jax nor eigd_tpu, so it
runs on a GPU machine without them:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import pytest
import torch

from eigd_tpu_torch.models.natural_frequency import make_model
from eigd_tpu_torch.ops import cuda_stencil as cs
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
