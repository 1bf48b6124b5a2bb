"""The K3 and K4 twins against the JAX probe kernels, on the CPU.

``scripts/diag_pallas_floor.py`` and ``scripts/diag_pallas_dma.py`` build
their Pallas kernels at run time through ``pl.pallas_call``; patching that
attribute with ``interpret=True`` runs them on the CPU unchanged. On CPU
tensors the port's wrappers run their plain twins, which are what the
kernels are held to on the card (chip_smoke.py, tests/test_torch_cuda.py).

Tolerances: ``copy`` moves values and must match exactly; the sums of the
other bodies run in the Pallas bodies' order, so they match to f32
rounding: 1e-6 of max|ref|. The one-call library yardsticks of the K3
bodies (``diag.stencil_floor.library_call``) sum in another order: 1e-5
of max|ref|, as on the card.
"""

import functools
import importlib
import itertools
from pathlib import Path

import jax
import jax.experimental.pallas
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigd_tpu_torch.diag import stencil_floor
from eigd_tpu_torch.ops import cuda_probes

SCRIPTS = str(Path(__file__).resolve().parent.parent / "scripts")


@pytest.fixture
def interpret(monkeypatch):
    """Pallas in interpret mode, and the scripts importable at a small
    grid (diag_pallas_floor setdefaults EIGD_BENCH_NX/NY at import)."""
    monkeypatch.setenv("EIGD_BENCH_NX", "20")
    monkeypatch.setenv("EIGD_BENCH_NY", "9")
    monkeypatch.syspath_prepend(SCRIPTS)
    orig = jax.experimental.pallas.pallas_call
    monkeypatch.setattr(jax.experimental.pallas, "pallas_call",
                        functools.partial(orig, interpret=True))
    return importlib.import_module


def floor_case(interpret, kind, ndof):
    """The K3 script's kernel at a small grid on random operands: (xpad,
    W, Pallas result, k, XR)."""
    floor = interpret("diag_pallas_floor")
    nx, ny, k, TX = 20, 9, 3, 8
    X, Y = nx + 1, ny + 1
    XR = -(-X // TX) * TX
    C = ndof * k
    rng = np.random.default_rng(ndof)
    xpad = rng.standard_normal((C, XR + 2, Y + 2)).astype(np.float32)
    W = rng.standard_normal((9 * ndof * ndof, XR, Y)).astype(np.float32)
    run = floor.make_variant(kind, nx, ny, ndof, k, TX)
    ref = np.asarray(run(jnp.asarray(W), *(jnp.asarray(xpad[:, d:d + XR])
                                           for d in range(3))))
    return xpad, W, ref, k, XR


@pytest.mark.parametrize("ndof", [1, 2])
@pytest.mark.parametrize("kind", ["copy", "onetap", "noshift9"])
def test_floor_variant_matches_pallas(interpret, kind, ndof):
    xpad, W, ref, k, XR = floor_case(interpret, kind, ndof)
    C, Y = ndof * k, W.shape[2]
    xt = torch.as_tensor(xpad)
    launches = cuda_probes.K3_LAUNCHES
    got = cuda_probes.floor_variant(kind, torch.as_tensor(W),
                                    *(xt[:, d:d + XR] for d in range(3)),
                                    ndof, k).numpy()
    assert cuda_probes.K3_LAUNCHES == launches  # the twin ran, no kernel
    assert got.shape == ref.shape == (C, XR, Y)
    tol = 0.0 if kind == "copy" else 1e-6 * np.abs(ref).max()
    assert np.abs(got - ref).max() <= tol


@pytest.mark.parametrize("ndof", [1, 2])
@pytest.mark.parametrize("kind", ["copy", "onetap", "noshift9"])
def test_floor_library_call_matches_pallas(interpret, kind, ndof):
    """The K3 yardstick (one copy_ or einsum) computes the Pallas body."""
    xpad, W, ref, k, XR = floor_case(interpret, kind, ndof)
    xt = torch.as_tensor(xpad)
    slabs = [xt[:, d:d + XR] for d in range(3)]
    call = stencil_floor.library_call(kind, torch.as_tensor(W), slabs[0],
                                      slabs[1], ndof, k)
    got = call().reshape(ref.shape).numpy()
    tol = 0.0 if kind == "copy" else 1e-5 * np.abs(ref).max()
    assert np.abs(got - ref).max() <= tol


@pytest.mark.parametrize("Yx,Yw,Yo", [(12, 10, 10), (128, 128, 128)],
                         ids=["unaligned", "aligned"])
@pytest.mark.parametrize("with_w", [False, True])
@pytest.mark.parametrize("n_slabs", [1, 3])
def test_dma_probe_matches_pallas(interpret, n_slabs, with_w, Yx, Yw, Yo):
    dma = interpret("diag_pallas_dma")
    C, XR, TX, NT = 3, 16, 8, 36
    rng = np.random.default_rng(n_slabs + 2 * with_w)
    slabs = [rng.standard_normal((C, XR, Yx)).astype(np.float32)
             for _ in range(n_slabs)]
    W = rng.standard_normal((NT, XR, Yw)).astype(np.float32)
    run = dma.probe(C, XR, Yx, Yw, Yo, TX, n_slabs, with_w)
    args = slabs + ([W] if with_w else [])
    ref = np.asarray(run(*map(jnp.asarray, args)))
    launches = cuda_probes.K4_LAUNCHES
    got = cuda_probes.dma_probe([torch.as_tensor(s) for s in slabs],
                                torch.as_tensor(W), Yo, with_w).numpy()
    assert cuda_probes.K4_LAUNCHES == launches
    assert got.shape == ref.shape == (C, XR, Yo)
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("Yx,Yo", [(12, 10), (640, 640)],
                         ids=["unaligned", "aligned"])
@pytest.mark.parametrize("with_w", [False, True])
@pytest.mark.parametrize("n_slabs", [1, 3])
def test_dma_probe_twin_returns_a_new_tensor(n_slabs, with_w, Yx, Yo):
    """K4's plain twin writes its own output, as the kernel does: in the
    aligned one-slab case without W the first Yo columns of slab 0 are
    the whole slab, and the twin must still copy them (a view of its
    input would time no work)."""
    g = torch.Generator().manual_seed(n_slabs + 2 * with_w)
    slabs = [torch.randn((3, 16, Yx), generator=g) for _ in range(n_slabs)]
    W = torch.randn((4, 16, Yo), generator=g)
    got = cuda_probes.dma_probe_ref(slabs, W, Yo, with_w)
    assert got.is_contiguous() and got.shape == (3, 16, Yo)
    assert all(got.untyped_storage().data_ptr()
               != t.untyped_storage().data_ptr() for t in slabs + [W])
    ref = sum(s[:, :, :Yo] for s in slabs) + (W[0, :, :Yo] if with_w else 0)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("R", [1, 37, 1040])
def test_row_plan_covers_every_output_once(R):
    """rows_kernel's launch plan (K4 and K3 copy) at the shapes of
    tests/test_torch_cuda.py::test_probes_match_twins and of the diag entry
    points, aligned (quads) or not: its row blocks and channels cover
    every (channel, row) once with no empty block; its
    passes cover every unit of a row once, each pass non-empty, within
    PER_MAX units a lane; and the staged store of unaligned rows, as
    csrc/probes.cu computes it from the output offset mod 4, splits a pass
    into a head and a tail of at most 3 elements and quads 16-byte aligned
    in the output and in the warp's staging row (32*PER_MAX + 4 floats)."""
    widths = [29, 30, 31, 32, 513, 515, 640]
    for Yo, C, vec in itertools.product(widths, (1, 3, 16, 32),
                                        (False, True)):
        if vec and Yo % 4:
            continue
        plan = cuda_probes.row_plan(C, R, Yo, vec)
        blocks, chans = plan.grid
        assert chans == C
        rows = (np.arange(blocks)[:, None] * cuda_probes.ROW_WARPS
                + np.arange(cuda_probes.ROW_WARPS)[None, :]).ravel()
        rows = rows[rows < R]
        assert np.array_equal(rows, np.arange(R))
        assert (blocks - 1) * cuda_probes.ROW_WARPS < R
        assert plan.vec == vec
        per_max = cuda_probes.PER_MAX[vec]
        assert 1 <= plan.per <= per_max
        n = Yo // 4 if vec else Yo
        seen = np.zeros(n, int)
        span = 32 * plan.per
        for q in range(plan.passes):
            base = q * span
            lim = min(span, n - base)
            assert lim > 0
            u = (np.arange(per_max)[:, None] * 32
                 + np.arange(32)[None, :]).ravel()
            seen[base + u[u < lim]] += 1
            if vec:
                continue
            for sh in range(4):  # the pass's first output mod 4
                # lanes < head and lanes < lim - tail store an element
                # each, the lanes stride over the nq quads between
                head = min(lim, (4 - sh) & 3)
                nq = (lim - head) // 4
                tail = head + 4 * nq
                assert 0 <= head <= 3 and 0 <= lim - tail <= 3
                assert nq == 0 or (sh + head) % 4 == 0
                assert sh + lim <= 32 * per_max + 4
        assert (seen == 1).all()
