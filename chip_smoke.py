#!/usr/bin/env python3
"""Smoke run of eigd_tpu_torch on one CUDA GPU.

Builds the hand-written stencil kernels from ``eigd_tpu_torch/csrc``,
checks each against its plain PyTorch twin at the main path's shapes, checks
the kernel-on gradient against the kernel-off one on a small problem, and
then drives the main path once at full size: the 512x256 plane-stress
natural-frequency problem (263,682 DOF, N=6 modes) of ``bench.py``, value
and adjoint gradient of its eta-weighted objective through ``eigh_gen``,
with a Richardson central-difference check of the gradient.

Usage: ``python3 chip_smoke.py`` from the root of the repository, on a
machine with one CUDA GPU and nvcc. It exits non-zero, printing no result,
when there is no GPU or the package is missing, and on any failed phase.
The last line of standard output is the JSON contract line
``{"ok": true, "device": {...}}``; the line before it lists the kernels.
"""

from __future__ import annotations

import collections
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

NX, NY = 512, 256


def log(*a):
    print(*a, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def cuda_time_ms(fn, warmup=3, iters=20):
    """Mean device time of fn() in ms, by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bench_config():
    """The 263k configuration of bench.py:77-255 (vcycle on the kernels)."""
    fo = {"rtol": 1e-11, "maxiter": 60, "approx_rtol": 1e-5,
          "approx_maxiter": 18, "sweep_rtol": 0.0, "sweep_maxiter": 24,
          "degree": 3, "min_coarse": 4500, "stag_bad": 1000000,
          "vcycle": "kernel"}
    return dict(nx=NX, ny=NY, Lx=2.0, Ly=1.0, N=6, rfact=2.0, m=176,
                factor_kind="mg", lanczos_tol=None, lanczos_block=16,
                lanczos_ortho="local", lanczos_check_every=2, rtol=4e-8,
                sigma=-1.0, factor_options=fo, lanczos_polish=3,
                lanczos_polish_spare=8, adjoint_method="sibk",
                adjoint_options={"maxiter": 30, "nrestart": 8,
                                 "mixed": True, "ladder": "approx"},
                lanczos_sweep="approx")


def tail(lam, Q):
    """The bench objective (bench.py:268-276)."""
    eta = torch.exp(-2.0 * (lam - lam[0]))
    return torch.sum(torch.sqrt(lam)) + torch.sum(eta[None, :] * Q[:8] ** 2)


def phase_build():
    from eigd_tpu_torch.ops import _build

    t0 = time.perf_counter()
    so, blog = _build.build()
    _build.load()
    log(f"[build] {so.name} in {time.perf_counter() - t0:.1f} s")
    for line in blog.splitlines():
        if "ptxas" in line or "nvcc" in line:
            log(f"[build] {line.strip()}")


def phase_k1(levels, gen):
    """K1 against matvec_planes_ref on every MG level of the main path."""
    from eigd_tpu_torch.ops import cuda_stencil as cs

    cases = [(W, nx, ny, 2, k) for (W, (nx, ny)) in levels for k in (1, 16)]
    for nx, ny, nd in ((32, 16, 1), (100, 70, 2), (100, 70, 1)):
        W = torch.randn((nx + 1, ny + 1, 3, 3, nd, nd), generator=gen,
                        dtype=torch.float64).cuda()
        cases += [(W, nx, ny, nd, k) for k in (1, 8)]
    rep = None
    for W, nx, ny, nd, k in cases:
        Wp = cs.stencil_planes(W, nd)
        xq = torch.randn((nd, k, nx + 1, ny + 1), generator=gen).cuda()
        got = cs.matvec_planes(Wp, xq, nx, ny, nd)
        ref = cs.matvec_planes_ref(Wp, xq, nx, ny, nd)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        bound = 1e-5 * float(ref.abs().max())
        ms = cuda_time_ms(lambda: cs.matvec_planes(Wp, xq, nx, ny, nd))
        pms = cuda_time_ms(lambda: cs.matvec_planes_ref(Wp, xq, nx, ny, nd))
        log(f"[K1] grid {nx + 1}x{ny + 1} ndof {nd} k {k}: max_abs_err "
            f"{err:.3e} (bound {bound:.3e})  kernel {ms:.4f} ms  plain "
            f"{pms:.4f} ms")
        check(err <= bound, f"K1 disagrees at {nx}x{ny} ndof {nd} k {k}")
        if (nx, ny, nd, k) == (NX, NY, 2, 16):
            rep = (err, ms, pms)

    # the vector-layout entry: f32 B.mv of the mixed SIBK ladder, k = N
    Wp = cs.stencil_planes(levels[0][0], 2)
    x = torch.randn(((NX + 1) * (NY + 1) * 2, 6), generator=gen).cuda()
    got = cs.stencil_matvec32(Wp, x, NX, NY, 2)
    ref = cs.from_planes(cs.matvec_planes_ref(
        Wp, cs.to_planes(x, NX, NY, 2), NX, NY, 2), NX, NY, 2)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    bound = 1e-5 * float(ref.abs().max())
    log(f"[K1] vector layout grid {NX + 1}x{NY + 1} ndof 2 k 6: max_abs_err "
        f"{err:.3e} (bound {bound:.3e})")
    check(err <= bound, "K1 disagrees on the vector layout")
    return rep


def phase_k2(W64, gen):
    """K2 against stencil_matvec in f64 at 513x257."""
    from eigd_tpu_torch.ops import cuda_stencil as cs
    from eigd_tpu_torch.ops.stencil import stencil_matvec

    Wp = cs.stencil_planes(W64, 2, torch.float64)
    n = (NX + 1) * (NY + 1) * 2
    rep = None
    for k in (1, 6, 16):
        x = torch.randn((n, k), generator=gen, dtype=torch.float64).cuda()
        got = cs.stencil_matvec64(Wp, x, NX, NY, 2)
        ref = stencil_matvec(W64, x, NX, NY, 2)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        bound = 1e-13 * 18 * float(x.abs().max()) * float(W64.abs().max())
        ms = cuda_time_ms(lambda: cs.stencil_matvec64(Wp, x, NX, NY, 2))
        pms = cuda_time_ms(lambda: stencil_matvec(W64, x, NX, NY, 2))
        log(f"[K2] grid {NX + 1}x{NY + 1} ndof 2 k {k}: max_abs_err "
            f"{err:.3e} (bound {bound:.3e})  kernel {ms:.4f} ms  plain "
            f"{pms:.4f} ms")
        check(err <= bound, f"K2 disagrees at k {k}")
        if k == 16:
            rep = (err, ms, pms)
    return rep


def phase_on_off():
    """Kernel-on against kernel-off gradient at the 12x6 test config."""
    from eigd_tpu_torch.models.natural_frequency import make_model

    grads = {}
    for kmv, vc in (("off", "plain"), ("on", "kernel")):
        topo = make_model(nx=12, ny=6, N=2, m=32, Lx=2.0, Ly=1.0, rfact=2.0,
                          factor_kind="mg", lanczos_block=4,
                          lanczos_ortho="local",
                          factor_options={"min_coarse": 64, "vcycle": vc},
                          lanczos_tol=1e-11, lanczos_polish=1,
                          kernel_mv=kmv, device="cuda")
        x = topo.x.clone().requires_grad_(True)
        lam, Q, _, _ = topo._solve_fn(x)
        (torch.sum(torch.sqrt(lam)) + torch.sum(Q[:6] ** 2)).backward()
        grads[kmv] = x.grad
    rel = float((grads["on"] - grads["off"]).abs().max()
                / grads["off"].abs().max())
    log(f"[on/off] 12x6 gradient kernel-on vs kernel-off: rel {rel:.3e} "
        "(bound 1e-9)")
    check(rel <= 1e-9, "kernel-on gradient disagrees with kernel-off")


def phase_main(topo, gpu):
    """Value and gradient of the bench objective at full size."""
    from eigd_tpu_torch.ops import cuda_stencil as cs
    from eigd_tpu_torch.ops import sync

    def value_and_grad(x0):
        x = x0.clone().requires_grad_(True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lam, Q, _, _ = topo._solve_fn(x)
        v = tail(lam, Q)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fwd_syncs = dict(sync.HOST_SYNCS)
        v.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return lam.detach(), v.item(), x.grad, t1 - t0, t2 - t1, fwd_syncs

    x0 = topo.x
    t0 = time.perf_counter()
    value_and_grad(x0)  # warm run
    log(f"[main] warm run {time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    cs.K1_LAUNCHES = 0
    cs.K2_LAUNCHES = 0
    sync.HOST_SYNCS.clear()
    lam, val, g, t_fwd, t_bwd, fwd_syncs = value_and_grad(x0)
    k1, k2 = cs.K1_LAUNCHES, cs.K2_LAUNCHES
    bwd_syncs = dict(sync.HOST_SYNCS - collections.Counter(fwd_syncs))
    peak = torch.cuda.max_memory_allocated()
    lam_np = lam.cpu().numpy()
    log(f"[main] lam {lam_np.tolist()}  objective {val!r}")
    log(f"[main] forward {t_fwd:.3f} s  backward {t_bwd:.3f} s  peak "
        f"{peak / 2**30:.3f} GiB  host syncs "
        f"{sum(sync.HOST_SYNCS.values())} ({sum(fwd_syncs.values())} "
        f"forward)  K1 launches {k1}  K2 launches {k2}  on {gpu}")
    log(f"[main] host syncs by loop: forward {fwd_syncs}  backward "
        f"{bwd_syncs}")
    check(np.all(np.isfinite(lam_np)), "lam not finite")
    check(np.all(lam_np > 0), "lam not positive")
    check(np.all(np.diff(lam_np) >= 0), "lam not ascending")
    check(bool(torch.isfinite(g).all()), "gradient not finite")
    check(k1 > 0 and k2 > 0, "main path did not launch both kernels")

    # one directional check: Richardson-4 of central differences
    pert = torch.as_tensor(np.random.default_rng(7).uniform(size=x0.shape),
                           device=x0.device)
    ans = float(pert @ g)
    fds = {}
    with torch.no_grad():
        for h in (3e-2, 1.5e-2):
            vp = tail(*topo._solve_fn(x0 + h * pert)[:2])
            vm = tail(*topo._solve_fn(x0 - h * pert)[:2])
            fds[h] = (float(vp) - float(vm)) / (2 * h)
    fd4 = (4.0 * fds[1.5e-2] - fds[3e-2]) / 3.0
    rel = abs(ans - fd4) / abs(fd4)
    log(f"[main] FD check: adjoint {ans!r} richardson-4 {fd4!r} rel "
        f"{rel:.3e} (bound 1e-4); plain h=3e-2 "
        f"{abs(ans - fds[3e-2]) / abs(fds[3e-2]):.3e}, h=1.5e-2 "
        f"{abs(ans - fds[1.5e-2]) / abs(fds[1.5e-2]):.3e}")
    check(rel <= 1e-4, "gradient fails the FD check")
    return k1, k2


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from eigd_tpu_torch.fem.assembly import element_density
    from eigd_tpu_torch.models.natural_frequency import make_model

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    log(smi)
    gpu = smi.splitlines()[0]
    t_start = time.perf_counter()

    phase_build()
    topo = make_model(device="cuda", **bench_config())
    with torch.no_grad():  # the main path's operators and factor at x0
        rhoE = element_density(topo.fltr.apply(topo.x), topo.conn)
        A, B = topo.problem.assemble(rhoE)
        fac = topo.problem.factor(A, B, topo.sigma, "normal")
    levels = list(zip(fac.Ws, fac.shapes))
    gen = torch.Generator().manual_seed(0)
    k1_rep = phase_k1(levels, gen)
    k2_rep = phase_k2(A.W - topo.sigma * B.W, gen)
    del A, B, fac, levels
    phase_on_off()
    k1, k2 = phase_main(topo, gpu)
    log(f"[total] {time.perf_counter() - t_start:.1f} s")

    kernels = [
        {"name": "K1 f32 9-point block-stencil matvec", "route": "cuda",
         "source": "eigd_tpu_torch/csrc/stencil.cu",
         "replaces": "eigd_tpu/ops/pallas_stencil.py:121", "launches": k1,
         "max_abs_err": k1_rep[0], "ms": k1_rep[1], "plain_ms": k1_rep[2]},
        {"name": "K2 f64 9-point block-stencil matvec", "route": "cuda",
         "source": "eigd_tpu_torch/csrc/stencil.cu",
         "replaces": "eigd_tpu/ops/pallas_stencil.py:299", "launches": k2,
         "max_abs_err": k2_rep[0], "ms": k2_rep[1], "plain_ms": k2_rep[2]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
