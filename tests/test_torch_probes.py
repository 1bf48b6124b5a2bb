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
