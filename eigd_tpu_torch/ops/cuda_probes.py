"""Wrappers of the stencil floor probe kernels, and their plain twins.

Replaces the two Pallas probe kernels of ``scripts/``:

* K3 (``floor_variant``) replaces ``kern`` of ``make_variant``
  (``scripts/diag_pallas_floor.py:51``, ``pallas_call`` at :87): the
  ``copy``, ``onetap`` and ``noshift9`` bodies, which move K1's bytes with
  none, one or all nine of its taps and none of its column shifts.
* K4 (``dma_probe``) replaces ``kern`` of ``probe``
  (``scripts/diag_pallas_dma.py:44``, ``pallas_call`` at :62): the sum of
  1 or 3 slabs, with or without W's plane 0.

Both live in ``csrc/probes.cu``. The TPU wrappers' TX row tiles and XR row
padding are BlockSpec artifacts: the kernels take any row count R. The
three K3 slabs x_-1, x_0, x_+1 are row offsets into one padded buffer
(``scripts/diag_pallas_floor.py:115-119``); the wrapper passes three
pointers into it and copies nothing.

A CPU tensor goes to the plain twin (``floor_variant_ref``,
``dma_probe_ref``, written from the Pallas bodies in their accumulation
order). A CUDA tensor goes to the kernel, or the call raises: there is no
fallback. ``K3_LAUNCHES``/``K4_LAUNCHES`` count launches and nothing else.
"""

from __future__ import annotations

import torch

K3_LAUNCHES = 0
K4_LAUNCHES = 0

FLOOR_KINDS = ("copy", "onetap", "noshift9")


def floor_variant_ref(kind, W, x_m1, x_0, x_p1, ndof, k):
    """Plain PyTorch K3: the body ``kind`` on slabs (ndof*k, R, Y+2) and
    planes W (9*ndof*ndof, R, Y); returns (ndof*k, R, Y)."""
    C = ndof * k
    Y = W.shape[2]
    if kind == "copy":
        return x_0[:C, :, 1:1 + Y].clone()
    if kind == "onetap":
        taps = [(0, x_0)]
    elif kind == "noshift9":
        taps = [(-1, x_m1), (0, x_0), (1, x_p1)]
    else:
        raise ValueError(f"Unknown floor variant {kind!r}")
    djs = (0,) if kind == "onetap" else (-1, 0, 1)
    acc = [None] * ndof
    for di, xr in taps:
        for b in range(ndof):
            xb = xr[b * k:(b + 1) * k, :, 1:1 + Y]
            for dj in djs:
                for a in range(ndof):
                    t = ((3 * (di + 1) + (dj + 1)) * ndof * ndof
                         + a * ndof + b)
                    term = W[t][None] * xb
                    acc[a] = term if acc[a] is None else acc[a] + term
    return torch.cat(acc, dim=0)


def dma_probe_ref(slabs, W, Yo, with_w):
    """Plain PyTorch K4: sum of the slabs' first Yo columns, plus W's
    plane 0 when ``with_w``."""
    acc = slabs[0][:, :, :Yo]
    for s in slabs[1:]:
        acc = acc + s[:, :, :Yo]
    if with_w:
        acc = acc + W[0, :, :Yo][None]
    return acc.contiguous()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda(tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"kernel needs every tensor on one CUDA device, "
                             f"got {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"kernel needs float32, got {t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError("kernel needs a contiguous last axis")


def floor_variant(kind, W, x_m1, x_0, x_p1, ndof, k):
    """K3: the floor probe body ``kind`` ("copy", "onetap" or "noshift9").

    W : contiguous f32 planes (9*ndof*ndof, R, Y); x_m1, x_0, x_p1 :
    (ndof*k, R, Y+2) f32 views with one set of strides (row offsets into
    one padded buffer, read in place). Returns (ndof*k, R, Y).
    """
    global K3_LAUNCHES
    if x_0.device.type == "cpu":
        return floor_variant_ref(kind, W, x_m1, x_0, x_p1, ndof, k)
    if kind not in FLOOR_KINDS:
        raise ValueError(f"Unknown floor variant {kind!r}")
    if ndof not in (1, 2):
        raise ValueError(f"kernel supports ndof 1 and 2, got {ndof}")
    _check_cuda([W, x_m1, x_0, x_p1])
    nt, R, Y = W.shape
    C = ndof * k
    if nt != 9 * ndof * ndof or not W.is_contiguous():
        raise ValueError(f"W must be contiguous ({9 * ndof * ndof}, R, Y), "
                         f"got {tuple(W.shape)}")
    for x in (x_m1, x_0, x_p1):
        if tuple(x.shape) != (C, R, Y + 2) or x.stride() != x_0.stride():
            raise ValueError(f"slabs must be ({C}, {R}, {Y + 2}) with one "
                             f"set of strides, got {tuple(x.shape)} "
                             f"{x.stride()}")
    from . import _build

    out = torch.empty((C, R, Y), dtype=torch.float32, device=x_0.device)
    rc = _build.load().eigd_probe_floor(
        FLOOR_KINDS.index(kind), W.data_ptr(), x_m1.data_ptr(),
        x_0.data_ptr(), x_p1.data_ptr(), out.data_ptr(), ndof, k, R, Y,
        x_0.stride(0), x_0.stride(1), _stream(x_0))
    if rc != 0:
        raise RuntimeError(f"eigd_probe_floor launch failed: cudaError {rc}")
    K3_LAUNCHES += 1
    return out


def dma_probe(slabs, W, Yo, with_w):
    """K4: sum of 1 or 3 f32 slabs (C, R, Yx) over their first Yo columns,
    plus W's plane 0 ((NT, R, Yw), first Yo columns) when ``with_w``.
    Returns (C, R, Yo)."""
    global K4_LAUNCHES
    if slabs[0].device.type == "cpu":
        return dma_probe_ref(slabs, W, Yo, with_w)
    if len(slabs) not in (1, 3):
        raise ValueError(f"kernel takes 1 or 3 slabs, got {len(slabs)}")
    _check_cuda(list(slabs) + ([W] if with_w else []))
    C, R, Yx = slabs[0].shape
    for s in slabs:
        if s.shape != slabs[0].shape or s.stride() != slabs[0].stride():
            raise ValueError("slabs must share one shape and one set of "
                             "strides")
    if Yo > Yx or (with_w and (W.shape[1] != R or Yo > W.shape[2])):
        raise ValueError(f"Yo={Yo} exceeds the slabs or W")
    from . import _build

    out = torch.empty((C, R, Yo), dtype=torch.float32,
                      device=slabs[0].device)
    ptrs = [s.data_ptr() for s in slabs] + [None] * (3 - len(slabs))
    rc = _build.load().eigd_probe_dma(
        *ptrs, len(slabs), W.data_ptr() if with_w else None, int(with_w),
        out.data_ptr(), C, R, Yo, slabs[0].stride(0), slabs[0].stride(1),
        W.stride(1) if with_w else 0, _stream(slabs[0]))
    if rc != 0:
        raise RuntimeError(f"eigd_probe_dma launch failed: cudaError {rc}")
    K4_LAUNCHES += 1
    return out
