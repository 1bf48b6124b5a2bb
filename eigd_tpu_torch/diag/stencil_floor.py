"""Where K1's time goes at the 1M-DOF shapes: the K3 floor probes.

Counterpart of ``scripts/diag_pallas_floor.py``, at its shapes and seed:
nx=1024, ny=512, ndof 2, k 8 (C = 16 channels); x slabs (16, 1040, 515)
as row offsets into one padded buffer and W planes (36, 1040, 513), from
``default_rng(0)`` in the script's order. It times the three K3 bodies
(``copy``: the data-movement floor; ``onetap``: one tap, no shifts;
``noshift9``: K1's nine taps without its column shifts) and the full K1
(``cuda_stencil.matvec_planes`` at 1025x513, k 8, checked against its
plain twin), each beside its bound, its plain twin and the one PyTorch
call that computes the same function: ``Tensor.copy_`` for ``copy``, one
``torch.einsum`` over W's planes and the x window for ``onetap`` and
``noshift9`` (the three slabs as one strided view of their buffer), and
``torch.sparse.mm`` on the stencil as a CSR matrix for K1.

Each kernel and library call is timed twice: by events around 20
back-to-back calls (``cuda_time_ms``, as in earlier runs, which includes
the host's pace), and with the host taken out, as the median of five
replays of a CUDA graph of 20 calls, kernel and library in turns
(``graph_ms``); the second is the device time. SpMM is timed by events
only. The last line is K1's time split at 1M by the graph medians: copy,
onetap, noshift9, K1.

The script's R = 1040 rows are its TX=16 tile padding of 1025; the kernels
take any R, and run at the script's 1040 so the bytes are the script's.

Run on a machine with a CUDA device, from the root of the repository:

    python -m eigd_tpu_torch.diag.stencil_floor
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import cuda_probes as cp
from ..ops import cuda_stencil as cs
from .common import (card, line, require_cuda, stencil_csr, stencil_work,
                     timed)

NX, NY, NDOF, K, TX = 1024, 512, 2, 8, 16


def make_inputs():
    """The script's operands on the card, drawn from ``default_rng(0)`` in
    its order."""
    X, Y = NX + 1, NY + 1
    R = -(-X // TX) * TX
    C, NT = NDOF * K, 9 * NDOF * NDOF
    rng = np.random.default_rng(0)
    xpad = torch.as_tensor(rng.standard_normal(
        (C, R + 2, Y + 2)).astype(np.float32), device="cuda")
    Wpp = torch.as_tensor(rng.standard_normal(
        (NT, R, Y)).astype(np.float32), device="cuda")
    W64 = torch.as_tensor(rng.standard_normal((X, Y, 3, 3, NDOF, NDOF)),
                          device="cuda")
    xq = torch.as_tensor(rng.standard_normal(
        (NDOF, K, X, Y)).astype(np.float32), device="cuda")
    return {"slabs": tuple(xpad[:, d:d + R] for d in range(3)), "W": Wpp,
            "W64": W64, "xq": xq}


def probe_work(kind, R, Y):
    """(bytes, flops) of one K3 body: the x window it reads once (the
    three slabs of noshift9 are row offsets into one buffer: R+2 rows),
    the W planes it reads and the output."""
    C, nd2 = NDOF * K, NDOF * NDOF
    x_rows = R + 2 if kind == "noshift9" else R
    w_planes = {"copy": 0, "onetap": nd2, "noshift9": 9 * nd2}[kind]
    nbytes = 4 * (C * x_rows * Y + w_planes * R * Y + C * R * Y)
    return nbytes, 2 * w_planes * K * R * Y


def library_call(kind, W, x_m1, x_0, ndof, k):
    """The one PyTorch call that computes the K3 body ``kind`` on the
    operands of ``cuda_probes.floor_variant``, as a function of no
    arguments; its result holds the body's (ndof*k, R, Y) values."""
    _, R, Y = W.shape
    if kind == "copy":
        out = torch.empty((ndof * k, R, Y), device=W.device)
        return lambda: out.copy_(x_0[:, :, 1:1 + Y])
    Wt = W.view(3, 3, ndof, ndof, R, Y)  # (di, dj, a, b, R, Y)
    if kind == "onetap":
        xw = x_0[:, :, 1:1 + Y].unflatten(0, (ndof, k))
        return lambda: torch.einsum("abry,bkry->akry", Wt[1, 1], xw)
    # the slabs x_-1, x_0, x_+1 start at rows 0, 1, 2 of one buffer
    s0, s1 = x_m1.stride(0), x_m1.stride(1)
    xs = torch.as_strided(x_m1, (3, ndof, k, R, Y), (s1, k * s0, s0, s1, 1),
                          x_m1.storage_offset() + 1)
    return lambda: torch.einsum("ijabry,ibkry->akry", Wt, xs)


def run(inputs=None):
    """Time the three K3 bodies and the full K1 (checked against its
    twin); returns one dict per kernel line printed."""
    inp = make_inputs() if inputs is None else inputs
    x_m1, x_0, x_p1 = inp["slabs"]
    W = inp["W"]
    _, R, Y = W.shape
    rows = []
    for kind in cp.FLOOR_KINDS:
        args = (kind, W, x_m1, x_0, x_p1, NDOF, K)
        lib = library_call(kind, W, x_m1, x_0, NDOF, K)
        ref = cp.floor_variant_ref(*args)
        err = float((lib().reshape(ref.shape) - ref).abs().max())
        check(err <= 1e-5 * float(ref.abs().max()),
              f"the library call of K3 {kind} computes another function")
        rows.append(timed(f"K3 {kind}", lambda: cp.floor_variant(*args),
                          lambda: cp.floor_variant_ref(*args), lib,
                          *probe_work(kind, R, Y)))

    Wp = cs.stencil_planes(inp["W64"], NDOF)
    xq = inp["xq"]
    got = cs.matvec_planes(Wp, xq, NX, NY, NDOF)
    ref = cs.matvec_planes_ref(Wp, xq, NX, NY, NDOF)
    err = float((got - ref).abs().max())
    check(err <= 1e-5 * float(ref.abs().max()),
          "K1 disagrees with its twin at 1025x513")
    A = stencil_csr(inp["W64"], NX, NY, NDOF, torch.float32)
    xv = cs.from_planes(xq, NX, NY, NDOF).contiguous()
    rows.append(dict(timed(
        f"K1 full {NX + 1}x{NY + 1} k {K}",
        lambda: cs.matvec_planes(Wp, xq, NX, NY, NDOF),
        lambda: cs.matvec_planes_ref(Wp, xq, NX, NY, NDOF),
        lambda: torch.sparse.mm(A, xv),
        *stencil_work(NX + 1, NY + 1, NDOF, K, 4), library_in_graph=False),
        max_abs_err=err))
    for r in rows:
        print(line(r), flush=True)
    print("[K1 split at 1M] graph medians: " + " / ".join(
        f"{r['name'].split()[1].replace('full', 'K1')} {r['ms']:.4f}"
        for r in rows) + " ms", flush=True)
    return rows


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def main():
    require_cuda()
    print(card())
    run()


if __name__ == "__main__":
    main()
