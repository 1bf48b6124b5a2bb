"""Host time and device time of one K1/K2 call, apart, beside SpMM's.

The host time of a call is the wall time of back-to-back calls on the host
clock with no wait on the device in between, over their count: what the
Python wrapper, the allocation of y and the launch cost the host. A window
of 100 calls stays under the depth of the card's launch queue, so the host
never waits for the device inside it. The device time is by CUDA events
(``common.cuda_time_ms``). A call costs the larger of the two when calls
follow each other, as in the V-cycle.

Cases: K1 on the plane layout at every level shape of the 263k and 1M
paths (nd 2; k 1, 8, 16, and 6 at 1025x513), K1 on the vector layout (k 6,
SIBK's f32 B.mv) and K2 on the vector layout (k 1, 6, 8, 16), on random
stencils from a seed; each beside ``torch.sparse.mm`` of the same stencil
as a CSR matrix (``common.stencil_csr``).

The imports are absolute, so the script also times another checkout's
package: from the root of that checkout,

    python -c "import runpy; runpy.run_path('<this file>', run_name='__main__')"

and from the root of this one, on a machine with a CUDA device (which
also splits the host time of one call into its parts, ``breakdown``):

    python -m eigd_tpu_torch.diag.stencil_host
"""

from __future__ import annotations

import time

import torch

from eigd_tpu_torch.diag.common import (card, cuda_time_ms, require_cuda,
                                        stencil_csr)
from eigd_tpu_torch.ops import cuda_stencil as cs

PLANES = (((1024, 512), (1, 6, 8, 16)), ((512, 256), (1, 8, 16)),
          ((256, 128), (1, 8, 16)), ((128, 64), (1, 8, 16)),
          ((64, 32), (1, 16)))
VECTOR32 = (((512, 256), 6), ((1024, 512), 6))
VECTOR64 = (((512, 256), (1, 6, 16)), ((1024, 512), (1, 6, 8, 16)))


def host_us(fn, calls=100, windows=5):
    """Host µs of one call of fn: the least over ``windows`` windows of
    ``calls`` back-to-back calls on the host clock, each after a wait for
    the device (the least, because other work on a shared host only ever
    adds to a window)."""
    for _ in range(5):
        fn()
    best = float("inf")
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, time.perf_counter() - t0)
    torch.cuda.synchronize()
    return best / calls * 1e6


def random_stencil(nx, ny, nd, gen):
    return torch.randn((nx + 1, ny + 1, 3, 3, nd, nd), generator=gen,
                       dtype=torch.float64).cuda()


def k1_planes(W, nx, ny, nd, k, gen):
    """(kernel call, SpMM call) of K1 on the plane layout at k columns."""
    Wp = cs.stencil_planes(W, nd)
    xq = torch.randn((nd, k, nx + 1, ny + 1), generator=gen).cuda()
    A = stencil_csr(W, nx, ny, nd, torch.float32)
    xv = cs.from_planes(xq, nx, ny, nd).contiguous()
    return (lambda: cs.matvec_planes(Wp, xq, nx, ny, nd),
            lambda: torch.sparse.mm(A, xv))


def vector(W, nx, ny, nd, k, dtype, gen):
    """(kernel call, SpMM call) of K1 (f32) or K2 (f64) on the vector
    layout at k columns."""
    Wp = cs.stencil_planes(W, nd, dtype)
    x = torch.randn(((nx + 1) * (ny + 1) * nd, k), generator=gen,
                    dtype=dtype).cuda()
    A = stencil_csr(W, nx, ny, nd, dtype)
    mv = cs.stencil_matvec64 if dtype == torch.float64 else \
        cs.stencil_matvec32
    return (lambda: mv(Wp, x, nx, ny, nd), lambda: torch.sparse.mm(A, x))


def measure(name, calls):
    """One case: device ms and host µs of the kernel and of SpMM."""
    kern, spmm = calls
    r = {"name": name, "ms": cuda_time_ms(kern), "host_us": host_us(kern),
         "spmm_ms": cuda_time_ms(spmm), "spmm_host_us": host_us(spmm)}
    print(f"[{name}] device {r['ms']:.4f} ms  host {r['host_us']:.1f} "
          f"us/call  |  SpMM device {r['spmm_ms']:.4f} ms  host "
          f"{r['spmm_host_us']:.1f} us/call", flush=True)
    return r


def k1_host(shapes, k=16, nd=2, seed=0):
    """K1 on the plane layout at each (nx, ny) of shapes: its rows."""
    gen = torch.Generator().manual_seed(seed)
    return [measure(f"K1 planes {nx + 1}x{ny + 1} nd {nd} k {k}",
                    k1_planes(random_stencil(nx, ny, nd, gen), nx, ny, nd, k,
                              gen)) for nx, ny in shapes]


def breakdown(nx=64, ny=32, nd=2, k=16, seed=0):
    """Where the host time of one K1 plane-layout call goes, at a grid
    where the device is faster than the host: the allocation of y, the C
    entry point through ctypes with k = 0 (it returns before launching),
    the same entry point launching the kernel, and the whole wrapper.
    Needs the wrapper's ``_ENTRY`` and ``launch_plan``."""
    gen = torch.Generator().manual_seed(seed)
    W = random_stencil(nx, ny, nd, gen)
    Wp = cs.stencil_planes(W, nd)
    X, Y = nx + 1, ny + 1
    xq = torch.randn((nd, k, X, Y), generator=gen).cuda()
    y = cs.matvec_planes(Wp, xq, nx, ny, nd)
    entry = cs._ENTRY["eigd_stencil_f32"]
    plan = cs.launch_plan(X, Y, nd, k, 4, False)
    stream = torch._C._cuda_getCurrentRawStream(xq.get_device())
    args = (Wp.data_ptr(), xq.data_ptr(), y.data_ptr(), X, Y, nd)
    rest = (*xq.stride(), *y.stride(), plan.cols_per_group,
            plan.cols_per_chunk, stream)
    parts = {
        "new_empty": lambda: xq.new_empty((nd, k, X, Y)),
        "ctypes entry, k 0": lambda: entry(*args, 0, *rest),
        "ctypes entry, launch": lambda: entry(*args, k, *rest),
        "wrapper": lambda: cs.matvec_planes(Wp, xq, nx, ny, nd),
    }
    us = {name: host_us(fn) for name, fn in parts.items()}
    rest_us = us["wrapper"] - us["new_empty"] - us["ctypes entry, launch"]
    print(f"[K1 host breakdown {X}x{Y} nd {nd} k {k}] " + "  ".join(
        f"{name} {v:.1f} us" for name, v in us.items())
        + f"  (the rest, Python checks and plan: {rest_us:.1f} us)",
        flush=True)
    return us


def run(seed=0):
    gen = torch.Generator().manual_seed(seed)
    rows = []
    for (nx, ny), ks in PLANES:
        W = random_stencil(nx, ny, 2, gen)
        rows += [measure(f"K1 planes {nx + 1}x{ny + 1} nd 2 k {k}",
                         k1_planes(W, nx, ny, 2, k, gen)) for k in ks]
    for (nx, ny), k in VECTOR32:
        rows.append(measure(f"K1 vector {nx + 1}x{ny + 1} nd 2 k {k}",
                            vector(random_stencil(nx, ny, 2, gen), nx, ny, 2,
                                   k, torch.float32, gen)))
    for (nx, ny), ks in VECTOR64:
        W = random_stencil(nx, ny, 2, gen)
        rows += [measure(f"K2 vector {nx + 1}x{ny + 1} nd 2 k {k}",
                         vector(W, nx, ny, 2, k, torch.float64, gen))
                 for k in ks]
    return rows


def main():
    require_cuda()
    print(card(), flush=True)
    run()
    if hasattr(cs, "launch_plan"):
        breakdown()


if __name__ == "__main__":
    main()
