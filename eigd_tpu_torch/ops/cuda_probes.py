"""Wrappers of the stencil floor probe kernels, and their plain twins.

Replaces the two Pallas probe kernels of ``scripts/``:

* K3 (``floor_variant``) replaces ``kern`` of ``make_variant``
  (``scripts/diag_pallas_floor.py:51``, ``pallas_call`` at :87): the
  ``copy``, ``onetap`` and ``noshift9`` bodies, which move K1's bytes with
  none, one or all nine of its taps and none of its column shifts.
* K4 (``dma_probe``) replaces ``kern`` of ``probe``
  (``scripts/diag_pallas_dma.py:44``, ``pallas_call`` at :62): the sum of
  1 or 3 slabs, with or without W's plane 0.

Both live in ``csrc/probes.cu``: K4 and K3 ``copy`` (K4's one-slab
function on the window that starts at column 1) are ``rows_kernel``, one
warp an output row, cut as ``row_plan`` says; K3 ``onetap`` and
``noshift9`` are ``taps_kernel``, one thread a node for all k columns, so
W is read once a call. The TPU wrappers' TX row tiles and XR row padding
are BlockSpec artifacts: the kernels take any row count R. The three K3
slabs x_-1, x_0, x_+1 are row offsets into one padded buffer
(``scripts/diag_pallas_floor.py:115-119``); the wrapper passes three
pointers into it and copies nothing.

A CPU tensor goes to the plain twin (``floor_variant_ref``,
``dma_probe_ref``, written from the Pallas bodies in their accumulation
order). A CUDA tensor goes to the kernel, or the call raises: there is no
fallback, and no autograd rule (``cuda_stencil.refuse_grad``).
``K3_LAUNCHES``/``K4_LAUNCHES`` count launches and nothing else.
The host path of a call is short (each C entry point is bound once, the
stream is read as a raw handle, the output comes from ``new_empty``), so
that back-to-back calls time the kernel and not the host.
"""

from __future__ import annotations

import collections
import functools

import torch

from .cuda_stencil import refuse_grad

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
    plane 0 when ``with_w``, in a new tensor as the kernel's (one slab
    without W is then a copy, never the input itself)."""
    acc = slabs[0][:, :, :Yo].clone(memory_format=torch.contiguous_format)
    for s in slabs[1:]:
        acc += s[:, :, :Yo]
    if with_w:
        acc += W[0, :, :Yo][None]
    return acc


# rows_kernel (csrc/probes.cu): a block of ROW_WARPS warps, one output row
# (channel, row) a warp, grid (row blocks, channels). A lane holds up to
# PER_MAX[vec] units of a row in one pass: elements, or 16-byte quads
# where every stream and the output are 16-byte aligned (vec).
ROW_WARPS = 4
PER_MAX = {False: 20, True: 8}

RowPlan = collections.namedtuple("RowPlan", "grid vec per passes")


@functools.lru_cache(maxsize=256)
def row_plan(C, R, Yo, vec):
    """rows_kernel's launch on C channels of R rows of Yo outputs: its grid
    (row blocks, channels), whether it moves quads, the units (elements,
    or quads where vec) a lane holds in one pass, and the passes of a row.
    Warp w of block (b, c) owns row b*ROW_WARPS + w of channel c; in pass p
    its lane l takes units p*32*per + 32*i + l for i < per, those within
    the row."""
    n = Yo // 4 if vec else Yo
    passes = max(1, -(-n // (32 * PER_MAX[vec])))
    per = max(1, -(-n // (32 * passes)))
    return RowPlan((-(-R // ROW_WARPS), C), vec, per, passes)


_ENTRY = {}  # the library's C entry points, bound at first launch


def _entry(name):
    fn = _ENTRY.get(name)
    if fn is None:
        from . import _build

        fn = _ENTRY[name] = getattr(_build.load(), name)
    return fn


def _check_cuda(tensors):
    refuse_grad(*tensors)
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"kernel needs every tensor on one CUDA device, "
                             f"got {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"kernel needs float32, got {t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError("kernel needs a contiguous last axis")


def _launch_rows(ptrs, wptr, out, ssc, ssr, wsr, dev):
    """rows_kernel: out (C, R, Yo) = sum of the windows at ``ptrs`` (1 or
    3, element strides (ssc, ssr, 1)) + the W window at ``wptr`` (row
    stride wsr) unless it is None."""
    C, R, Yo = out.shape
    vec = (Yo % 4 == 0 and ssc % 4 == 0 and ssr % 4 == 0 and wsr % 4 == 0
           and all(p % 16 == 0 for p in ptrs + [wptr or 0]))
    plan = row_plan(C, R, Yo, vec)
    rc = _entry("eigd_probe_rows")(
        *ptrs, *[None] * (3 - len(ptrs)), len(ptrs), wptr, out.data_ptr(),
        C, R, Yo, ssc, ssr, wsr, int(vec), plan.per, plan.passes,
        torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise RuntimeError(f"eigd_probe_rows launch failed: cudaError {rc}")


def floor_variant(kind, W, x_m1, x_0, x_p1, ndof, k):
    """K3: the floor probe body ``kind`` ("copy", "onetap" or "noshift9").

    W : contiguous f32 planes (9*ndof*ndof, R, Y); x_m1, x_0, x_p1 :
    (ndof*k, R, Y+2) f32 views with one set of strides (row offsets into
    one padded buffer, read in place). Returns (ndof*k, R, Y).
    """
    global K3_LAUNCHES
    if x_0.is_cpu:
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
        if x.shape != (C, R, Y + 2) or x.stride() != x_0.stride():
            raise ValueError(f"slabs must be ({C}, {R}, {Y + 2}) with one "
                             f"set of strides, got {tuple(x.shape)} "
                             f"{x.stride()}")
    out = x_0.new_empty((C, R, Y))
    xsc, xsr = x_0.stride(0), x_0.stride(1)
    dev = x_0.get_device()
    if kind == "copy":
        _launch_rows([x_0.data_ptr() + 4], None, out, xsc, xsr, 0, dev)
    else:
        rc = _entry("eigd_probe_taps")(
            FLOOR_KINDS.index(kind), W.data_ptr(), x_m1.data_ptr(),
            x_0.data_ptr(), x_p1.data_ptr(), out.data_ptr(), ndof, k, R, Y,
            xsc, xsr, torch._C._cuda_getCurrentRawStream(dev))
        if rc != 0:
            raise RuntimeError(f"eigd_probe_taps launch failed: cudaError "
                               f"{rc}")
    K3_LAUNCHES += 1
    return out


def dma_probe(slabs, W, Yo, with_w):
    """K4: sum of 1 or 3 f32 slabs (C, R, Yx) over their first Yo columns,
    plus W's plane 0 ((NT, R, Yw), first Yo columns) when ``with_w``.
    Returns (C, R, Yo)."""
    global K4_LAUNCHES
    s0 = slabs[0]
    if s0.is_cpu:
        return dma_probe_ref(slabs, W, Yo, with_w)
    if len(slabs) not in (1, 3):
        raise ValueError(f"kernel takes 1 or 3 slabs, got {len(slabs)}")
    _check_cuda(list(slabs) + ([W] if with_w else []))
    C, R, Yx = s0.shape
    for s in slabs:
        if s.shape != s0.shape or s.stride() != s0.stride():
            raise ValueError("slabs must share one shape and one set of "
                             "strides")
    if Yo > Yx or (with_w and (W.shape[1] != R or Yo > W.shape[2])):
        raise ValueError(f"Yo={Yo} exceeds the slabs or W")
    out = s0.new_empty((C, R, Yo))
    _launch_rows([s.data_ptr() for s in slabs],
                 W.data_ptr() if with_w else None, out, s0.stride(0),
                 s0.stride(1), W.stride(1) if with_w else 0, s0.get_device())
    K4_LAUNCHES += 1
    return out
