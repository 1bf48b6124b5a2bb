#!/usr/bin/env python3
"""Smoke run of eigd_tpu_torch on one CUDA GPU.

Builds the hand-written kernels from ``eigd_tpu_torch/csrc`` (the K1/K2
stencils and the K3/K4 floor probes), checks each against its plain
PyTorch twin at the shapes its path gives it, times each beside its bound
and, where one PyTorch call computes the same function, that call (SpMM
for the stencils, ``copy_``, ``einsum`` or ``add`` for the probes),
checks K1 and K2 in both layouts on ragged grids at the edges of the
stencil kernel's tiles and column chunks, prints K1's host time per call
beside its device time (``[K1 host]``, ``diag/stencil_host.py``), checks
the kernel-on gradient against the kernel-off one on a small problem, and
then drives these paths:

* the 512x256 natural-frequency problem (263,682 DOF, N=6) of
  ``bench.py``: value and adjoint gradient of its eta-weighted objective,
  with a Richardson central-difference check;
* the K3/K4 diagnostic entry points (``eigd_tpu_torch.diag``) at the
  1M-DOF stencil shapes, each kernel and library call timed by events and
  by graph-replayed medians (``diag.common.graph_ms``), with the probe
  kernels' targets printed as held or missed (``[probe target]``);
* the natural-frequency optimisation protocol on the same 263k model
  (``[minfreq]``): ``MinFreqOpt``'s initialize / initialize_adjoint /
  finalize_adjoint and ``add_check_adjoint_residual``, K1 and K2 counted,
  ``xb`` held against a Richardson central difference of the KS value;
* the dense entry points (``[dense]``): ``eigh_gen_dense`` gradients with
  the sibk, pcpg and pgmres adjoints against ``eigh_gen_oracle`` (n 80
  and n 2,000, cuSOLVER's Cholesky and eigh on the path), and
  ``MinFreqOpt.test_ks_func`` on the dense 16x8 and 32x16 models;
* the 1024x512 north-star problem (1,051,650 DOF) of ``bench.py``'s big
  branch: K1 and K2 against their twins on its operators, value and
  gradient, forward-mode ``staged_jvp`` against the reverse-mode
  gradient, and the Richardson check;
* the thermal family at 1024x1024 (1,050,625 DOF, ``[thermal1m]``) on the
  multigrid factor, K1/K2 at ndof 1 checked and counted: ``ThermalOpt``'s
  protocol with two adjoint passes on one solve, a Richardson check of
  the KS gradient and forward mode against reverse mode;
* the same model on the cyclic-reduction factors (``[thermal-bcr]``):
  the f64 one held to the multigrid eigenvalues and gradient, the f32
  refined one measured beside it; and the 263k bench configuration on
  the f32 refined factor (``[nf-bcr]``) against ``[main]``.

Each phase's wall time is printed as ``[time]``.

Usage: ``python3 chip_smoke.py`` from the root of the repository, on a
machine with one CUDA GPU and nvcc. It exits non-zero, printing no result,
when there is no GPU or the package is missing, and on any failed phase.
The last line of standard output is the JSON contract line
``{"ok": true, "device": {...}}``; the line before it lists the kernels.
"""

from __future__ import annotations

import collections
import gc
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch


def log(*a):
    print(*a, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def phase_build():
    from eigd_tpu_torch.ops import _build

    t0 = time.perf_counter()
    so, blog = _build.build()
    _build.load()
    log(f"[build] {so.name} in {time.perf_counter() - t0:.1f} s")
    for line in blog.splitlines():
        if "ptxas" in line or "nvcc" in line or "spill" in line:
            log(f"[build] {line.strip()}")


def spmm_ms(W, nx, ny, nd, x, dtype):
    """The library yardstick of K1/K2: cuSPARSE SpMM (``torch.sparse.mm``)
    of the stencil as a CSR matrix on the (n, k) vector layout."""
    from eigd_tpu_torch.diag.common import cuda_time_ms, stencil_csr

    A = stencil_csr(W, nx, ny, nd, dtype)
    xv = x.to(dtype).contiguous()
    return cuda_time_ms(lambda: torch.sparse.mm(A, xv))


def k1_row(W, nx, ny, nd, k, gen):
    """K1 against matvec_planes_ref on the stencil W at k columns, timed
    beside its bound, its twin and SpMM on the same operator."""
    from eigd_tpu_torch.diag.common import (cuda_time_ms, line, result,
                                            stencil_work)
    from eigd_tpu_torch.ops import cuda_stencil as cs

    Wp = cs.stencil_planes(W, nd)
    xq = torch.randn((nd, k, nx + 1, ny + 1), generator=gen).cuda()
    got = cs.matvec_planes(Wp, xq, nx, ny, nd)
    ref = cs.matvec_planes_ref(Wp, xq, nx, ny, nd)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    tol = 1e-5 * float(ref.abs().max())
    ms = cuda_time_ms(lambda: cs.matvec_planes(Wp, xq, nx, ny, nd))
    pms = cuda_time_ms(lambda: cs.matvec_planes_ref(Wp, xq, nx, ny, nd))
    lib = spmm_ms(W, nx, ny, nd, cs.from_planes(xq, nx, ny, nd),
                  torch.float32)
    r = result(f"K1 {nx + 1}x{ny + 1} ndof {nd} k {k}", ms, pms, lib,
               *stencil_work(nx + 1, ny + 1, nd, k, 4))
    log(f"{line(r)}  max_abs_err {err:.3e} (bound {tol:.3e})")
    check(err <= tol, f"K1 disagrees at {nx}x{ny} ndof {nd} k {k}")
    return dict(r, max_abs_err=err)


def k1_vector_layout(W, nx, ny, gen):
    """K1 on the vector layout: the f32 B.mv of the mixed SIBK ladder,
    k = N = 6."""
    from eigd_tpu_torch.ops import cuda_stencil as cs

    Wp = cs.stencil_planes(W, 2)
    x = torch.randn(((nx + 1) * (ny + 1) * 2, 6), generator=gen).cuda()
    got = cs.stencil_matvec32(Wp, x, nx, ny, 2)
    ref = cs.from_planes(cs.matvec_planes_ref(
        Wp, cs.to_planes(x, nx, ny, 2), nx, ny, 2), nx, ny, 2)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    tol = 1e-5 * float(ref.abs().max())
    log(f"[K1] vector layout grid {nx + 1}x{ny + 1} ndof 2 k 6: max_abs_err "
        f"{err:.3e} (bound {tol:.3e})")
    check(err <= tol, "K1 disagrees on the vector layout")


def k2_row(W64, nx, ny, k, gen):
    """K2 against stencil_matvec in f64 at k columns, timed beside its
    bound, its twin and SpMM in f64."""
    from eigd_tpu_torch.diag.common import (cuda_time_ms, line, result,
                                            stencil_work)
    from eigd_tpu_torch.ops import cuda_stencil as cs
    from eigd_tpu_torch.ops.stencil import stencil_matvec

    Wp = cs.stencil_planes(W64, 2, torch.float64)
    n = (nx + 1) * (ny + 1) * 2
    x = torch.randn((n, k), generator=gen, dtype=torch.float64).cuda()
    got = cs.stencil_matvec64(Wp, x, nx, ny, 2)
    ref = stencil_matvec(W64, x, nx, ny, 2)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    tol = 1e-13 * 18 * float(x.abs().max()) * float(W64.abs().max())
    ms = cuda_time_ms(lambda: cs.stencil_matvec64(Wp, x, nx, ny, 2))
    pms = cuda_time_ms(lambda: stencil_matvec(W64, x, nx, ny, 2))
    lib = spmm_ms(W64, nx, ny, 2, x, torch.float64)
    r = result(f"K2 {nx + 1}x{ny + 1} ndof 2 k {k}", ms, pms, lib,
               *stencil_work(nx + 1, ny + 1, 2, k, 8), torch.float64)
    log(f"{line(r)}  max_abs_err {err:.3e} (bound {tol:.3e})")
    check(err <= tol, f"K2 disagrees at {nx}x{ny} k {k}")
    return dict(r, max_abs_err=err)


def phase_stencils(topo, fine_ks, coarse_ks, k2_ks, gen, extra=()):
    """K1 and K2 against their twins on the operators of a path at x0:
    K1 on every MG level of its factor (fine_ks columns at the finest
    level, coarse_ks below), on the vector layout at the finest, and on
    the extra (W, nx, ny, ndof, k) cases; K2 on A - sigma B. Returns the
    rows by name."""
    from eigd_tpu_torch.fem.assembly import element_density

    with torch.no_grad():
        rhoE = element_density(topo.fltr.apply(topo.x), topo.conn)
        A, B = topo.problem.assemble(rhoE)
        fac = topo.problem.factor(A, B, topo.sigma, "normal")
    rows = []
    for i, (W, (nx, ny)) in enumerate(zip(fac.Ws, fac.shapes)):
        for k in fine_ks if i == 0 else coarse_ks:
            rows.append(k1_row(W, nx, ny, 2, k, gen))
    rows += [k1_row(*case, gen) for case in extra]
    k1_vector_layout(fac.Ws[0], *fac.shapes[0], gen)
    nx, ny = fac.shapes[0]
    rows += [k2_row(A.W - topo.sigma * B.W, nx, ny, k, gen) for k in k2_ks]
    return {r["name"]: r for r in rows}


def random_stencils(gen):
    """Random stencils at grids no path has, ndof 1 and 2: (timed, ragged)
    cases. The ragged grids have 1 and 2 nodes a side, or one node under,
    at and over the kernel's 8 x 32 tile; their k cross its 4-column
    chunks and its column groups."""
    def case(nx, ny, nd, k):
        return (torch.randn((nx + 1, ny + 1, 3, 3, nd, nd), generator=gen,
                            dtype=torch.float64).cuda(), nx, ny, nd, k)

    timed = [case(nx, ny, nd, k) for nx, ny, nd in
             ((32, 16, 1), (100, 70, 2), (100, 70, 1)) for k in (1, 8)]
    ragged = [case(nx, ny, nd, k)
              for nx, ny in ((0, 0), (1, 1), (6, 30), (7, 31), (8, 32),
                             (6, 32), (8, 30))
              for nd in (1, 2) for k in (1, 3, 5, 17)]
    return timed, ragged


def ragged_row(W, nx, ny, nd, k, gen):
    """K1 (planes, contiguous and sliced; vector layout) and K2 (vector
    layout, contiguous and transposed) against their twins: 1e-5 of
    max|ref| in f32, 1e-13 of 18 max|x| max|W| in f64. Returns the largest
    error over its bound."""
    from eigd_tpu_torch.ops import cuda_stencil as cs
    from eigd_tpu_torch.ops.stencil import stencil_matvec

    X, Y = nx + 1, ny + 1
    n = X * Y * nd
    Wp, Wp64 = cs.stencil_planes(W, nd), cs.stencil_planes(W, nd,
                                                           torch.float64)
    x = torch.randn((n, k), generator=gen, dtype=torch.float64).cuda()
    xt = torch.randn((k, n), generator=gen, dtype=torch.float64).cuda().T
    big = torch.randn((nd, k + 2, X, Y + 3), generator=gen).cuda()
    xs = big[:, 1:k + 1, :, 2:Y + 2]
    pairs = []
    for xq in (cs.to_planes(x.float(), nx, ny, nd), xs):
        ref = cs.matvec_planes_ref(Wp, xq, nx, ny, nd)
        pairs.append((cs.matvec_planes(Wp, xq, nx, ny, nd), ref,
                      1e-5 * float(ref.abs().max())))
    ref = stencil_matvec(W.float(), x.float(), nx, ny, nd)
    pairs.append((cs.stencil_matvec32(Wp, x.float(), nx, ny, nd), ref,
                   1e-5 * float(ref.abs().max())))
    for xv in (x, xt):
        pairs.append((cs.stencil_matvec64(Wp64, xv, nx, ny, nd),
                      stencil_matvec(W, xv.contiguous(), nx, ny, nd),
                      1e-13 * 18 * float(xv.abs().max())
                      * float(W.abs().max())))
    torch.cuda.synchronize()
    return max(float((got - ref).abs().max()) / tol
               for got, ref, tol in pairs)


def phase_ragged(cases, gen):
    """Every ragged case through ragged_row; one line, fails on any."""
    worst = 0.0
    for case in cases:
        r = ragged_row(*case, gen)
        W, nx, ny, nd, k = case
        check(r <= 1.0, f"K1/K2 disagree at {nx + 1}x{ny + 1} ndof {nd} "
                        f"k {k} (error {r:.2f} of its bound)")
        worst = max(worst, r)
    log(f"[ragged] K1 planes (contiguous, sliced), K1 vector, K2 vector "
        f"(contiguous, transposed) on {len(cases)} ragged cases: largest "
        f"error {worst:.3f} of its bound")


def phase_host():
    """K1's host time per call beside its device time at the smallest and
    the finest 263k grids, k 16 (diag/stencil_host.py)."""
    from eigd_tpu_torch.diag.stencil_host import k1_host

    rows = k1_host(((64, 32), (512, 256)))
    log("[K1 host] " + "; ".join(
        f"{r['name'][10:]}: host {r['host_us']:.1f} us/call, device "
        f"{r['ms'] * 1e3:.1f} us (SpMM host {r['spmm_host_us']:.1f} us, "
        f"device {r['spmm_ms'] * 1e3:.1f} us)" for r in rows))
    return {r["name"][10:]: r["host_us"] for r in rows}


def phase_probes():
    """K3 and K4 against their twins on the diagnostic entry points'
    operands; then the entry points themselves, counted."""
    from eigd_tpu_torch.diag import stencil_dma, stencil_floor
    from eigd_tpu_torch.ops import cuda_probes as cp

    fin = stencil_floor.make_inputs()
    errs = {}
    for kind in cp.FLOOR_KINDS:
        args = (kind, fin["W"], *fin["slabs"], stencil_floor.NDOF,
                stencil_floor.K)
        got = cp.floor_variant(*args)
        ref = cp.floor_variant_ref(*args)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        tol = 0.0 if kind == "copy" else 1e-5 * float(ref.abs().max())
        log(f"[K3 {kind}] max_abs_err {err:.3e} (bound {tol:.3e})")
        check(err <= tol, f"K3 {kind} disagrees with its twin")
        errs[f"K3 {kind}"] = err
    din = stencil_dma.make_inputs()
    for name, *args in stencil_dma.cases(din):
        got = cp.dma_probe(*args)
        ref = cp.dma_probe_ref(*args)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        log(f"[{name}] max_abs_err {err:.3e} (bound 0)")
        check(err == 0.0, f"{name} disagrees with its twin")
        errs[name] = err

    cp.K3_LAUNCHES = cp.K4_LAUNCHES = 0
    rows = stencil_floor.run(fin) + stencil_dma.run(din)
    launches = {"K3": cp.K3_LAUNCHES, "K4": cp.K4_LAUNCHES}
    log(f"[probes] diag path launches: K3 {launches['K3']}  "
        f"K4 {launches['K4']}")
    check(min(launches.values()) > 0, "the diag path launched no K3 or K4")
    for r in rows:
        if r["name"] in errs:
            r["max_abs_err"] = errs[r["name"]]
    probe_targets({r["name"]: r for r in rows})
    return rows, launches


def probe_targets(rows):
    """The probe kernels' targets, by graph-replayed medians: the K4
    one-slab cases and K3 copy no slower than their library call and at
    0.65 of their bound or more, the K4 3-slab cases at 0.75, K3 onetap
    within 0.034 ms, K3 noshift9 faster than the full K1 and at 0.5 of its
    bound. Each is printed held or missed; none fails the run."""
    def share(r):
        return r["bound_ms"] / r["ms"]

    k1 = next(r for n, r in rows.items() if n.startswith("K1 full"))
    targets = []
    for n, r in rows.items():
        if n == "K3 copy" or (n.startswith("K4") and "1 slab" in n):
            targets.append((n, r["ms"] <= r["library_ms"]
                            and share(r) >= 0.65,
                            f"{r['ms']:.4f} ms vs library "
                            f"{r['library_ms']:.4f}, share {share(r):.2f} "
                            f"(>= 0.65)"))
        elif n.startswith("K4"):
            targets.append((n, share(r) >= 0.75,
                            f"share {share(r):.2f} (>= 0.75)"))
    r = rows["K3 onetap"]
    targets.append(("K3 onetap", r["ms"] <= 0.034,
                    f"{r['ms']:.4f} ms (<= 0.034)"))
    r = rows["K3 noshift9"]
    targets.append(("K3 noshift9", r["ms"] < k1["ms"] and share(r) >= 0.5,
                    f"{r['ms']:.4f} ms vs K1 full {k1['ms']:.4f}, share "
                    f"{share(r):.2f} (>= 0.5)"))
    for n, ok, what in targets:
        log(f"[probe target] {n}: {'held' if ok else 'MISSED'}: {what}")


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


def evaluate(topo, gpu, tag):
    """A warm run, then one counted value and gradient of the bench
    objective; prints times, memory, host syncs, loop exits and launches.
    Returns (gradient, objective, launches)."""
    from eigd_tpu_torch.diag.configs import tail
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

    t0 = time.perf_counter()
    value_and_grad(topo.x)  # warm run
    log(f"[{tag}] warm run {time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    cs.K1_LAUNCHES = cs.K2_LAUNCHES = 0
    sync.clear()
    lam, val, g, t_fwd, t_bwd, fwd_syncs = value_and_grad(topo.x)
    launches = {"K1": cs.K1_LAUNCHES, "K2": cs.K2_LAUNCHES}
    bwd_syncs = dict(sync.HOST_SYNCS - collections.Counter(fwd_syncs))
    peak = torch.cuda.max_memory_allocated()
    lam_np = lam.cpu().numpy()
    log(f"[{tag}] {topo.nvars} DOF  lam {lam_np.tolist()}  objective "
        f"{val!r}")
    log(f"[{tag}] forward {t_fwd:.3f} s  backward {t_bwd:.3f} s  peak "
        f"{peak / 2**30:.3f} GiB  host syncs "
        f"{sum(sync.HOST_SYNCS.values())} ({sum(fwd_syncs.values())} "
        f"forward)  K1 launches {launches['K1']}  K2 launches "
        f"{launches['K2']}  on {gpu}")
    log(f"[{tag}] host syncs by loop: forward {fwd_syncs}  backward "
        f"{bwd_syncs}")
    log(f"[{tag}] loop exits {dict(sync.LOOP_EXITS)}  steps "
        f"{dict(sync.LOOP_STEPS)}")
    check(np.all(np.isfinite(lam_np)), "lam not finite")
    check(np.all(lam_np > 0), "lam not positive")
    check(np.all(np.diff(lam_np) >= 0), "lam not ascending")
    check(bool(torch.isfinite(g).all()), "gradient not finite")
    check(min(launches.values()) > 0, "main path did not launch both kernels")
    return g, val, launches


def fd_check(topo, g, pert, bound, tag):
    """Richardson-4 of central differences along pert (bench.py:321-367)."""
    from eigd_tpu_torch.diag.configs import tail

    ans = float(pert @ g)
    x0 = topo.x
    fds = {}
    with torch.no_grad():
        for h in (3e-2, 1.5e-2):
            vp = tail(*topo._solve_fn(x0 + h * pert)[:2])
            vm = tail(*topo._solve_fn(x0 - h * pert)[:2])
            fds[h] = (float(vp) - float(vm)) / (2 * h)
    fd4 = (4.0 * fds[1.5e-2] - fds[3e-2]) / 3.0
    rel = abs(ans - fd4) / abs(fd4)
    log(f"[{tag}] FD check: adjoint {ans!r} richardson-4 {fd4!r} rel "
        f"{rel:.3e} (bound {bound:g}); plain h=3e-2 "
        f"{abs(ans - fds[3e-2]) / abs(fds[3e-2]):.3e}, h=1.5e-2 "
        f"{abs(ans - fds[1.5e-2]) / abs(fds[1.5e-2]):.3e}")
    check(rel <= bound, f"{tag} gradient fails the FD check")


def bench_direction(topo):
    return torch.as_tensor(np.random.default_rng(7).uniform(
        size=topo.x.shape), device=topo.x.device)


def phase_main(topo, gpu):
    """Value and gradient of the bench objective at 263k, FD-checked.
    Returns the launches, the objective and the gradient projected on the
    bench direction."""
    g, val, launches = evaluate(topo, gpu, "main")
    pert = bench_direction(topo)
    fd_check(topo, g, pert, 1e-4, "main")
    return launches, val, float(pert @ g)


def sync_device(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def peak_gib(device):
    """The peak of allocated device memory since the last reset, GiB (nan
    on the CPU)."""
    if torch.device(device).type != "cuda":
        return float("nan")
    return torch.cuda.max_memory_allocated() / 2**30


def phase_minfreq(topo, gpu):
    """MinFreqOpt's three-phase protocol on the main path's model, then
    add_check_adjoint_residual, with the K1/K2 launches of the four calls;
    xb against a Richardson-4 central difference of the KS value along
    the bench direction (h = 3e-2, 1.5e-2; bound 1e-4 as in [main])."""
    from eigd_tpu_torch.models.natural_frequency import MinFreqOpt
    from eigd_tpu_torch.ops import cuda_stencil as cs
    from eigd_tpu_torch.ops import sync

    opt = MinFreqOpt(topo)
    cs.K1_LAUNCHES = cs.K2_LAUNCHES = 0
    counts = {}
    if torch.device(topo.device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    def counted(name, fn):
        sync.clear()
        k1, k2 = cs.K1_LAUNCHES, cs.K2_LAUNCHES
        out = fn()
        counts[name] = (f"K1 {cs.K1_LAUNCHES - k1}, K2 {cs.K2_LAUNCHES - k2},"
                        f" syncs {dict(sync.HOST_SYNCS)}, exits "
                        f"{dict(sync.LOOP_EXITS)}")
        return out

    counted("initialize", opt.initialize)
    opt.initialize_adjoint()
    counted("finalize_adjoint", opt.finalize_adjoint)
    peak = peak_gib(topo.device)
    t0 = time.perf_counter()
    r = counted("add_check_adjoint_residual", topo.add_check_adjoint_residual)
    sync_device(topo.device)
    t_check = time.perf_counter() - t0
    launches = {"K1": cs.K1_LAUNCHES, "K2": cs.K2_LAUNCHES}
    prof = topo.profile
    for name, what in counts.items():
        log(f"[minfreq] {name}: {what}")
    ks = float(opt.get_min_frequency())
    log(f"[minfreq] {topo.nvars} DOF  KS min frequency {ks!r}  "
        f"frequencies {prof['natural frequencies']}")
    log(f"[minfreq] initialize {prof['eigenvalue solve time']:.3f} s  "
        f"finalize_adjoint {prof['adjoint solution time']:.3f} s  "
        f"add_check_adjoint_residual {t_check:.3f} s  K1 launches "
        f"{launches['K1']}  K2 launches {launches['K2']}  peak over "
        f"initialize and finalize_adjoint {peak:.3f} GiB  on {gpu}")
    scale = float(torch.sqrt(torch.max(torch.sum(topo.Qb**2, dim=0))))
    log(f"[minfreq] adjoint residual norms {r.tolist()} (||Qb|| {scale:.3e})"
        f"  orthogonality "
        f"{[prof[f'adjoint ortho[{i:2d}]'] for i in range(topo.N)]}")
    log(f"[minfreq] iterations: eigensolve {prof['eigensolve iterations']}  "
        f"adjoint {prof['adjoint iterations']}  factor apply "
        f"{prof.get('factor apply iterations')} (final res2 "
        f"{prof.get('factor apply final res2', float('nan')):.3e}, tol2 "
        f"{prof.get('factor apply tol2', float('nan')):.3e})  relative "
        f"adjoint residuals {prof['adjoint residuals']}")
    check(min(launches.values()) > 0, "[minfreq] launched no K1 or K2")
    check(bool(torch.isfinite(topo.xb).all()), "[minfreq] xb not finite")
    check(float(r.max()) <= 1e-6 * scale,
          "[minfreq] the adjoint equations are not solved")

    pert = bench_direction(topo)
    ans = float(pert @ topo.xb)
    x0 = topo.x
    fds = {}
    for h in (3e-2, 1.5e-2):
        vals = []
        for sgn in (1.0, -1.0):
            topo.x = x0 + sgn * h * pert
            opt.initialize()
            vals.append(float(opt.get_min_frequency()))
        fds[h] = (vals[0] - vals[1]) / (2 * h)
    topo.x = x0
    fd4 = (4.0 * fds[1.5e-2] - fds[3e-2]) / 3.0
    rel = abs(ans - fd4) / abs(fd4)
    log(f"[minfreq] FD check: adjoint {ans!r} richardson-4 {fd4!r} rel "
        f"{rel:.3e} (bound 1e-4)")
    check(rel <= 1e-4, "[minfreq] xb fails the FD check")
    # a second protocol at x0, its process warm
    times = []
    for _ in range(2):
        opt.initialize()
        opt.initialize_adjoint()
        counted("finalize_adjoint (again)", opt.finalize_adjoint)
        times.append((prof["eigenvalue solve time"],
                      prof["adjoint solution time"]))
    log(f"[minfreq] again at x0: (initialize, finalize_adjoint) {times} s; "
        f"last finalize_adjoint: {counts['finalize_adjoint (again)']}")
    return launches


def make_pencil(n, seed=0):
    """The pencil of tests/test_adjoint.py: eigenvalues 1..10^1.5 then
    100-300, congruent to a B near the identity."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    low = np.arange(1.0, 11.0) ** 1.5
    w = np.concatenate([low, np.linspace(100.0, 300.0, n - len(low))])
    A = Q @ np.diag(w) @ Q.T
    Bm = rng.standard_normal((n, n)) * 0.05
    Bm = Bm @ Bm.T + np.eye(n)
    L = np.linalg.cholesky(Bm)
    A = L @ A @ L.T
    return 0.5 * (A + A.T), Bm


def dense_gradients(n, N, m, device):
    """The tests/test_adjoint.py objective sum(log lam) + sum(Phi[:7]^2) of
    (A0 + diag x, B0 + 0.02 diag x): the gradient through eigh_gen_dense
    with each exact adjoint against eigh_gen_oracle's. Returns {method:
    (relative gap, seconds)} and the oracle's seconds."""
    from eigd_tpu_torch.ops.autodiff import (EighGenConfig, eigh_gen_dense,
                                             eigh_gen_oracle)

    A0, B0 = (torch.as_tensor(a, device=device)
              for a in make_pencil(n, seed=3))
    x0 = torch.as_tensor(0.05 * np.random.default_rng(4).standard_normal(n),
                         device=device)

    def grad(fn):
        x = x0.clone().requires_grad_(True)
        sync_device(device)
        t0 = time.perf_counter()
        lam, Phi = fn(A0 + torch.diag(x), B0 + 0.02 * torch.diag(x))
        (torch.sum(torch.log(lam)) + torch.sum(Phi[:7] ** 2)).backward()
        sync_device(device)
        return x.grad, time.perf_counter() - t0

    go, t_oracle = grad(lambda A, B: eigh_gen_oracle(A, B, N))
    out = {}
    for method in ("sibk", "pcpg", "pgmres"):
        cfg = EighGenConfig(N=N, m=m, sigma=0.0, adjoint_method=method,
                            adjoint_maxiter=60)
        g, sec = grad(lambda A, B: eigh_gen_dense(A, B, cfg))
        out[method] = (float((g - go).abs().max() / go.abs().max()), sec)
    return out, t_oracle


def phase_dense(gpu, device="cuda", ks_grid=(16, 8), example_grid=(32, 16)):
    """The dense entry points: eigh_gen_dense against the oracle (n 80,
    N 4, m 55 as tests/test_adjoint.py, and n 2,000, N 6; bound 1e-8),
    MinFreqOpt.test_ks_func on the dense model of
    tests/test_natural_frequency.py (16x8, N 6; bound 1e-6) and the fd_err
    of examples/natural_frequency.py's model (32x16, printed)."""
    from eigd_tpu_torch.models.natural_frequency import MinFreqOpt, make_model

    for n, N in ((80, 4), (2000, 6)):
        out, t_oracle = dense_gradients(n, N, 55, device)
        for method, (gap, sec) in out.items():
            log(f"[dense] n {n} N {N} {method}: gradient vs oracle rel "
                f"{gap:.3e} (bound 1e-8), {sec:.3f} s (oracle "
                f"{t_oracle:.3f} s) on {gpu}")
            check(gap <= 1e-8, f"[dense] {method} gradient disagrees with "
                               f"the oracle at n {n}")

    np.random.seed(0)
    nx, ny = ks_grid
    topo = make_model(nx=nx, ny=ny, Lx=2.0, Ly=1.0, N=6, rfact=2.0,
                      device=device)
    t0 = time.perf_counter()
    data = MinFreqOpt(topo).test_ks_func(dh_fd=1e-6)
    log(f"[dense] test_ks_func {nx}x{ny} ({topo.nvars} DOF): fd_err "
        f"{data['fd_err']:.3e} (bound 1e-6) in "
        f"{time.perf_counter() - t0:.2f} s")
    check(data["fd_err"] <= 1e-6, "[dense] test_ks_func fails its bound")

    np.random.seed(0)
    nx, ny = example_grid
    topo = make_model(nx=nx, ny=ny, Lx=2.0, Ly=1.0, N=6,
                      factor_kind="dense", device=device)
    t0 = time.perf_counter()
    data = MinFreqOpt(topo).test_ks_func()
    log(f"[dense] examples/natural_frequency.py model {nx}x{ny} "
        f"({topo.nvars} DOF, sibk, dense): fd_err {data['fd_err']:.3e} in "
        f"{time.perf_counter() - t0:.2f} s")
    check(np.isfinite(data["fd_err"]), "[dense] example fd_err not finite")


def phase_1m(gpu, gen):
    """The 1,051,650-DOF problem: K1 and K2 against their twins on its
    operators; value and gradient, forward mode against reverse mode
    (bench.py:369-391, the 1e-5 bar of bench.py:138-141), and the
    Richardson-4 FD check (its quotient carries the adaptive exit's noise
    at this size: bound 2e-3)."""
    from eigd_tpu_torch.diag.configs import bench_1m, tail
    from eigd_tpu_torch.fem.assembly import element_density
    from eigd_tpu_torch.models.natural_frequency import make_model
    from eigd_tpu_torch.ops.autodiff import staged_jvp

    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    topo = make_model(device="cuda", **bench_1m())
    log(f"[1m] model built in {time.perf_counter() - t0:.2f} s "
        f"({before / 2**30:.3f} GiB allocated before it)")
    rows = phase_stencils(topo, (1, 6, 8, 16), (8,), (1, 6, 8, 16), gen)
    g, val, launches = evaluate(topo, gpu, "1m")
    pert = bench_direction(topo)
    ans = float(pert @ g)

    def pre(x):
        return element_density(topo.fltr.apply(x), topo.conn)

    # the first forward-AD call of a process also imports torch._dynamo
    # (PyTorch's decompositions import it at their first call): time two
    fn = staged_jvp(pre, tail, topo.problem, topo.cfg)
    t_jvp, dvs = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vj, dv = fn(topo.x, pert)
        dvs.append(float(dv))
        t_jvp.append(time.perf_counter() - t0)
    rel = max(abs(ans - dv) / abs(dv) for dv in dvs)
    log(f"[1m] jvp-vs-vjp: vjp {ans!r} jvp {dvs[0]!r} rel {rel:.3e} (bound "
        f"1e-5; the larger of the two calls); primal drift "
        f"{abs(float(vj) - val):.1e}; staged_jvp {t_jvp[0]:.2f} s first "
        f"call, {t_jvp[1]:.2f} s second")
    check(rel <= 1e-5, "1M jvp disagrees with the reverse-mode gradient")
    fd_check(topo, g, pert, 2e-3, "1m")
    return launches, rows

# ---------------------------------------------------------------------------
# The thermal family at 1,050,625 DOF and the block factors
# ---------------------------------------------------------------------------

THERMAL_GRID = (1024, 1024)
RHO_KS = 10.0
KSB = {"case": 1.0}


def thermal_model(factor_kind, device="cuda", grid=THERMAL_GRID):
    """JAX's thermal make_model at Ly 1.15 (a distinct spectrum) and N 6,
    every other option at its default."""
    from eigd_tpu_torch.models.thermal import make_model

    nx, ny = grid
    return make_model(nx=nx, ny=ny, Ly=1.15, N=6, factor_kind=factor_kind,
                      device=device)


def thermal_opt(topo):
    """The example's transient (examples/thermal.py): heat 1 + 0.5 sin(4t)
    on the center set, 100 Crank-Nicolson steps to t = 2."""
    from eigd_tpu_torch.models.thermal import ThermalOpt

    heat = {"case": {"center": lambda t: 1.0 + 0.5 * torch.sin(4.0 * t)}}
    return ThermalOpt(topo, heat, nsteps=100, tfinal=2.0)


def timed_factor(topo, built):
    """Wrap the model's factor build: each build appends (seconds, stored
    bytes) to ``built``."""
    import dataclasses

    build, device = topo.problem.factor, topo.device  # no cycle via topo

    def factor_fn(A, B, sig, mode):
        sync_device(device)
        t0 = time.perf_counter()
        f = build(A, B, sig, mode)
        sync_device(device)
        inner = getattr(f, "inner", f)
        built.append((time.perf_counter() - t0,
                      getattr(inner, "nbytes", float("nan"))))
        return f

    topo.problem = dataclasses.replace(topo.problem, factor=factor_fn)


def stencil_row_nd1(W, nx, ny, k, dtype, gen):
    """K1 (f32, plane layout, as the V-cycle calls it) or K2 (f64, vector
    layout, as the f64 PCG residual and the solver's A.mv/B.mv call it) on
    the scalar stencil W at k columns: against its twin (K1 1e-5 of
    max|ref|, K2 1e-13 of 9 max|x| max|W|), graph-timed beside its bound
    and twin, with SpMM on the same stencil by events."""
    from eigd_tpu_torch.diag.common import (line, stencil_csr, stencil_work,
                                            timed)
    from eigd_tpu_torch.ops import cuda_stencil as cs
    from eigd_tpu_torch.ops.stencil import stencil_matvec

    X, Y = nx + 1, ny + 1
    if dtype == torch.float32:
        Wp = cs.stencil_planes(W, 1)
        xq = torch.randn((1, k, X, Y), generator=gen).cuda()
        xv = cs.from_planes(xq, nx, ny, 1).contiguous()

        def kern():
            return cs.matvec_planes(Wp, xq, nx, ny, 1)

        def plain():
            return cs.matvec_planes_ref(Wp, xq, nx, ny, 1)
        name, itemsize = f"K1 {X}x{Y} ndof 1 k {k}", 4
    else:
        Wp = cs.stencil_planes(W, 1, torch.float64)
        xv = torch.randn((X * Y, k), generator=gen,
                         dtype=torch.float64).cuda()

        def kern():
            return cs.stencil_matvec64(Wp, xv, nx, ny, 1)

        def plain():
            return stencil_matvec(W, xv, nx, ny, 1)
        name, itemsize = f"K2 {X}x{Y} ndof 1 k {k}", 8
    got, ref = kern(), plain()
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    tol = (1e-5 * float(ref.abs().max()) if dtype == torch.float32 else
           1e-13 * 9 * float(xv.abs().max()) * float(W.abs().max()))
    A = stencil_csr(W, nx, ny, 1, dtype)
    r = timed(name, kern, plain, lambda: torch.sparse.mm(A, xv),
              *stencil_work(X, Y, 1, k, itemsize), dtype,
              library_in_graph=False)
    log(f"{line(r)}  max_abs_err {err:.3e} (bound {tol:.3e})")
    check(err <= tol, f"{name} disagrees with its twin")
    return dict(r, max_abs_err=err)


def thermal_rows(topo, gen):
    """K1 and K2 at ndof 1 on the model's shifted stencil at x0, at the
    column counts its path gives them: k 1 (single-vector Lanczos and its
    PCG) and k Nmax (the SIBK block)."""
    from eigd_tpu_torch.fem.assembly import element_density

    with torch.no_grad():
        rhoE = element_density(topo.fltr.apply(topo.x), topo.conn)
        A, B = topo.problem.assemble(rhoE)
        W = A.W - topo.sigma * B.W
    nx, ny = topo.grid_shape
    rows = [stencil_row_nd1(W.float(), nx, ny, k, torch.float32, gen)
            for k in (1, topo.Nmax)]
    rows += [stencil_row_nd1(W, nx, ny, k, torch.float64, gen)
             for k in (1, topo.Nmax)]
    return {r["name"]: r for r in rows}


def counters_zero(device):
    from eigd_tpu_torch.ops import cuda_stencil as cs
    from eigd_tpu_torch.ops import sync

    cs.K1_LAUNCHES = cs.K2_LAUNCHES = 0
    sync.clear()
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def launches_now():
    from eigd_tpu_torch.ops import cuda_stencil as cs

    return {"K1": cs.K1_LAUNCHES, "K2": cs.K2_LAUNCHES}


def thermal_protocol(opt, tag, gpu):
    """initialize, then two adjoint passes on that one solve: the KS and
    compliance seeds, then the KS seeds alone. Prints times, peak, host
    syncs by loop, loop exits and steps, and K1/K2 launches. Returns
    (xb of the KS seeds, launches)."""
    from eigd_tpu_torch.ops import sync

    topo = opt.topo
    counters_zero(topo.device)
    opt.initialize()
    t_fwd = topo.profile["eigenvalue solve time"]
    fwd = collections.Counter(sync.HOST_SYNCS)
    times = []
    for seeds in ("ks+compliance", "ks"):
        opt.initialize_adjoint()
        opt.add_ks_derivative(RHO_KS, KSB)
        if seeds == "ks+compliance":
            opt.add_thermal_compliance_derivative()
        opt.finalize_adjoint()
        times.append(topo.profile["adjoint solution time"])
        check(bool(torch.isfinite(topo.xb).all()),
              f"[{tag}] xb ({seeds}) not finite")
    launches = launches_now()
    lam = topo.lam.cpu().numpy()
    ks = float(opt.eval_ks_functions(RHO_KS)["case"])
    log(f"[{tag}] {topo.nnodes} DOF  lam {lam.tolist()}  KS {ks!r}  "
        f"compliance {float(opt.get_thermal_compliance())!r}")
    log(f"[{tag}] initialize {t_fwd:.3f} s  finalize_adjoint (KS + "
        f"compliance) {times[0]:.3f} s  second finalize_adjoint (KS) on the "
        f"same initialize {times[1]:.3f} s  peak {peak_gib(topo.device):.3f}"
        f" GiB  K1 launches {launches['K1']}  K2 launches "
        f"{launches['K2']}  on {gpu}")
    log(f"[{tag}] host syncs by loop: initialize {dict(fwd)}  both adjoint "
        f"passes {dict(sync.HOST_SYNCS - fwd)}")
    log(f"[{tag}] loop exits {dict(sync.LOOP_EXITS)}  steps "
        f"{dict(sync.LOOP_STEPS)}")
    check(np.all(np.isfinite(lam)) and np.all(np.diff(lam) >= 0),
          f"[{tag}] lam not finite and ascending")
    return topo.xb.clone(), launches


def phase_thermal1m(gpu, gen, grid=THERMAL_GRID, device="cuda"):
    """The thermal family at 1,050,625 DOF on the mg factor (K1/K2 at
    ndof 1): K1 and K2 against their twins on its stencil; the protocol
    (``thermal_protocol``); xb of the KS seeds against a Richardson-4
    central difference of the weighted KS sum (h 3e-2, 1.5e-2; bound
    1e-4); and forward mode (``staged_jvp``) against reverse mode on the
    tail of tests/test_autodiff_jvp.py:62-91 (bound 1e-5). Returns the
    launches, the K1/K2 rows, lam and the projected KS gradient."""
    from eigd_tpu_torch.fem.assembly import element_density
    from eigd_tpu_torch.ops.autodiff import staged_jvp

    t0 = time.perf_counter()
    topo = thermal_model("mg", device, grid)
    log(f"[thermal1m] model built in {time.perf_counter() - t0:.2f} s")
    rows = thermal_rows(topo, gen) if device == "cuda" else {}
    opt = thermal_opt(topo)
    xb_ks, launches = thermal_protocol(opt, "thermal1m", gpu)
    check(min(launches.values()) > 0, "[thermal1m] launched no K1 or K2")
    check(abs(float(topo.lam[0])) < 1e-6 < float(topo.lam[1]),
          "[thermal1m] mode 0 is not the constant mode")

    pert = bench_direction(topo)
    ans = float(pert @ xb_ks)
    x0 = topo.x
    fds = {}
    with torch.no_grad():
        for h in (3e-2, 1.5e-2):
            vals = []
            for sgn in (1.0, -1.0):
                lam, Q = topo._solve_fn(x0 + sgn * h * pert)
                vals.append(float(opt._ks_from_eig(lam, Q, RHO_KS)["case"]))
            fds[h] = (vals[0] - vals[1]) / (2 * h)
    fd4 = (4.0 * fds[1.5e-2] - fds[3e-2]) / 3.0
    rel = abs(ans - fd4) / abs(fd4)
    log(f"[thermal1m] FD check of the KS seeds' xb: adjoint {ans!r} "
        f"richardson-4 {fd4!r} rel {rel:.3e} (bound 1e-4); plain h=3e-2 "
        f"{abs(ans - fds[3e-2]) / abs(fds[3e-2]):.3e}")
    check(rel <= 1e-4, "[thermal1m] xb fails the FD check")

    w = torch.sin(0.37 * torch.arange(topo.nnodes, dtype=torch.float64,
                                      device=topo.x.device))

    def pre(x):
        return element_density(topo.fltr.apply(x), topo.conn)

    def tail(lam, Q):
        f_q = w @ Q
        return torch.sum((f_q[1:] ** 2) / lam[1:]) + torch.sum(
            torch.sqrt(lam[1:]))

    x = topo.x.clone().requires_grad_(True)
    sync_device(device)
    t0 = time.perf_counter()
    tail(*topo._solve_fn(x)).backward()
    sync_device(device)
    t_vjp = time.perf_counter() - t0
    g_ans = float(pert @ x.grad)
    t0 = time.perf_counter()
    _, dv = staged_jvp(pre, tail, topo.problem, topo.cfg)(topo.x, pert)
    t_jvp = time.perf_counter() - t0
    rel = abs(g_ans - float(dv)) / abs(float(dv))
    log(f"[thermal1m] jvp-vs-vjp: vjp {g_ans!r} jvp {float(dv)!r} rel "
        f"{rel:.3e} (bound 1e-5); value and gradient {t_vjp:.2f} s, "
        f"staged_jvp {t_jvp:.2f} s")
    check(rel <= 1e-5, "[thermal1m] jvp disagrees with the reverse mode")
    return launches, rows, topo.lam.cpu().numpy(), ans


def thermal_block(kind, gpu, lam_mg, proj_mg, grid, device):
    """The 1M thermal model on a block factor ``kind``: build it (time,
    stored bytes), run the protocol, and set its lam and projected KS
    gradient beside the mg ones. Returns (largest lam gap over its bound,
    relative gradient gap)."""
    from eigd_tpu_torch.ops import sync

    tag = f"thermal-{kind.replace('_', ' ')}"
    t0 = time.perf_counter()
    topo = thermal_model(kind, device, grid)
    log(f"[{tag}] model built in {time.perf_counter() - t0:.2f} s")
    built = []
    timed_factor(topo, built)
    xb_ks, _ = thermal_protocol(thermal_opt(topo), tag, gpu)
    applies = sum(v for k, v in sync.LOOP_EXITS.items()
                  if k.startswith("refine."))
    passes = sync.LOOP_STEPS["refine"]
    log(f"[{tag}] factor built in {built[0][0]:.3f} s, stores "
        f"{built[0][1] / 2**30:.3f} GiB; {passes} refinement passes in "
        f"{applies} applies ({passes / max(applies, 1):.2f} an apply)")
    atol = max(1e-10, constant_mode_floor(topo))
    lam = topo.lam.cpu().numpy()
    gap = np.abs(lam - lam_mg) / (atol + 1e-9 * np.abs(lam_mg))
    proj = float(bench_direction(topo) @ xb_ks)
    rel = abs(proj - proj_mg) / abs(proj_mg)
    log(f"[{tag}] lam vs mg: gaps {np.abs(lam - lam_mg).tolist()}, largest "
        f"{gap.max():.3e} of the bound {atol:.3e} + 1e-9 |lam|; projected "
        f"KS gradient {proj!r} vs mg {proj_mg!r} rel {rel:.3e} (bound 1e-6)")
    return gap.max(), rel


def constant_mode_floor(topo):
    """The f64 rounding floor of the constant mode's eigenvalue, exactly 0
    in exact arithmetic: eps64 sum|K_ij| / sum M_ij, what rounding each
    entry of the shifted operator K - sigma M by eps64 can move the
    Rayleigh quotient of the constant vector. The mg factor (the stencil
    of K - sigma M) and the block factors (its element matrices) round it
    apart, and their constant modes differ by up to that. About 2e-13 at
    16x16; about 1e-9 at 1024x1024, with 4,096 times less mass a node."""
    from eigd_tpu_torch.fem.assembly import element_density

    with torch.no_grad():
        A, B = topo.problem.assemble(element_density(
            topo.fltr.apply(topo.x), topo.conn))
        ratio = A.W.abs().sum() / B.W.sum()
    return float(torch.finfo(torch.float64).eps * ratio)


def phase_thermal_bcr(gpu, lam_mg, proj_mg, grid=THERMAL_GRID,
                      device="cuda"):
    """The same model on the cyclic-reduction factors. ``bcr_f32`` (JAX's
    f32 factor refined against the stencil on K2) is measured and not
    held to the bound: at this size f32 cannot carry the 0.1 M shift
    beside the O(1) stiffness, so refinement stagnates (PERF.md, section 6).
    ``bcr`` (the f64 factor, a direct solve) is held to it: lam against
    the mg ones at rtol 1e-9 and atol 1e-10, or the constant mode's f64
    floor where that is larger (``constant_mode_floor``), and the KS
    gradient projected on [thermal1m]'s direction at 1e-6."""
    thermal_block("bcr_f32", gpu, lam_mg, proj_mg, grid, device)
    gc.collect()
    torch.cuda.empty_cache()
    gap, rel = thermal_block("bcr", gpu, lam_mg, proj_mg, grid, device)
    check(gap <= 1.0, "[thermal-bcr] lam disagrees with mg's")
    check(rel <= 1e-6, "[thermal-bcr] KS gradient disagrees with mg's")


def nf_value_and_grad(cfg, gpu, tag, device):
    """One value and gradient of the bench objective on the configuration
    ``cfg``, timed and counted. Returns (objective, gradient projected on
    the bench direction)."""
    from eigd_tpu_torch.diag.configs import tail
    from eigd_tpu_torch.models.natural_frequency import make_model
    from eigd_tpu_torch.ops import sync

    topo = make_model(device=device, **cfg)
    built = []
    timed_factor(topo, built)
    counters_zero(device)
    x = topo.x.clone().requires_grad_(True)
    sync_device(device)
    t0 = time.perf_counter()
    lam, Q, _, _ = topo._solve_fn(x)
    v = tail(lam, Q)
    sync_device(device)
    t1 = time.perf_counter()
    v.backward()
    sync_device(device)
    t2 = time.perf_counter()
    val = float(v.detach())
    proj = float(bench_direction(topo) @ x.grad)
    applies = sum(n for k, n in sync.LOOP_EXITS.items()
                  if k.startswith("refine."))
    launches = launches_now()
    log(f"[{tag}] {topo.nvars} DOF  objective {val!r}  forward "
        f"{t1 - t0:.3f} s (factor built in {built[0][0]:.3f} s, stores "
        f"{built[0][1] / 2**30:.3f} GiB)  backward {t2 - t1:.3f} s  peak "
        f"{peak_gib(device):.3f} GiB  refinement passes "
        f"{sync.LOOP_STEPS['refine']} in {applies} applies  K1 launches "
        f"{launches['K1']}  K2 launches {launches['K2']}  on {gpu}")
    log(f"[{tag}] host syncs by loop {dict(sync.HOST_SYNCS)}  exits "
        f"{dict(sync.LOOP_EXITS)}")
    return val, proj


def phase_nf_bcr(gpu, val_main, proj_main, device="cuda", config=None):
    """The 263k bench configuration on the f32 cyclic-reduction factor,
    its refinement options in ``factor_options`` (tol 1e-13, 20 passes),
    against [main]: the gradient projected on the bench direction at 1e-4.
    Its objective is held to the converged one, that of the same
    configuration with the exact sweep on mg: the block factor with the
    exact sweep at 1e-10; with the bench's approximate sweep at 1e-7, the
    f32 sweep's floor on this configuration (ROADMAP, ground rules). The
    approximate sweep and three polish steps leave [main] itself about
    2e-8 from the converged objective (PERF.md, section 6), so the two
    approximate objectives are not held to each other."""
    from eigd_tpu_torch.diag.configs import bench_263k

    base = config or bench_263k()
    bcr = dict(base, factor_kind="bcr_f32",
               factor_options={"tol": 1e-13, "max_refine": 20})
    val, proj = nf_value_and_grad(bcr, gpu, "nf-bcr", device)
    val_x, _ = nf_value_and_grad(dict(bcr, lanczos_sweep="exact"), gpu,
                                 "nf-bcr exact sweep", device)
    val_c, _ = nf_value_and_grad(dict(base, lanczos_sweep="exact"), gpu,
                                 "nf-bcr mg exact sweep", device)
    rel_g = abs(proj - proj_main) / abs(proj_main)
    rel_x = abs(val_x - val_c) / abs(val_c)
    gap = abs(val - val_c) / abs(val_c)
    gap_main = abs(val_main - val_c) / abs(val_c)
    log(f"[nf-bcr] vs [main]: objective rel "
        f"{abs(val - val_main) / abs(val_main):.3e}, projected gradient "
        f"{proj!r} vs {proj_main!r} rel {rel_g:.3e} (bound 1e-4)")
    log(f"[nf-bcr] vs the converged objective {val_c!r} (mg, exact sweep): "
        f"bcr_f32 exact sweep rel {rel_x:.3e} (bound 1e-10); bcr_f32 bench "
        f"sweep rel {gap:.3e} (bound 1e-7); [main] rel {gap_main:.3e}")
    check(rel_g <= 1e-4, "[nf-bcr] gradient disagrees with [main]'s")
    check(rel_x <= 1e-10, "[nf-bcr] converged objective disagrees with mg's")
    check(gap <= 1e-7, "[nf-bcr] objective off the converged one")


def kernel_entry(name, source, replaces, launches, rep, **extra):
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            **{k: rep[k] for k in keys}, **extra}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from eigd_tpu_torch.diag.common import card
    from eigd_tpu_torch.diag.configs import bench_263k
    from eigd_tpu_torch.models.natural_frequency import make_model

    smi = card()
    log(smi)
    gpu = smi.splitlines()[0]
    t_start = time.perf_counter()

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"[time] {name} {time.perf_counter() - t0:.1f} s")
        return out

    phase("build", phase_build)
    topo = make_model(device="cuda", **bench_263k())
    gen = torch.Generator().manual_seed(0)
    timed, ragged = random_stencils(gen)
    s263 = phase("stencils", phase_stencils, topo, (1, 16), (1, 16),
                 (1, 6, 16), gen, timed)
    phase("ragged", phase_ragged, ragged, gen)
    host = phase("K1 host", phase_host)
    probe_rows, probe_launches = phase("probes", phase_probes)
    phase("on/off", phase_on_off)
    l263, val_main, proj_main = phase("main", phase_main, topo, gpu)
    lmf = phase("minfreq", phase_minfreq, topo, gpu)
    del topo
    gc.collect()
    torch.cuda.empty_cache()
    phase("dense", phase_dense, gpu)
    l1m, s1m = phase("1m", phase_1m, gpu, gen)
    gc.collect()
    torch.cuda.empty_cache()
    lth, sth, lam_mg, proj_mg = phase("thermal1m", phase_thermal1m, gpu, gen)
    # the mg model's memory is back before the block factor's peak
    gc.collect()
    torch.cuda.empty_cache()
    phase("thermal-bcr", phase_thermal_bcr, gpu, lam_mg, proj_mg)
    gc.collect()
    torch.cuda.empty_cache()
    phase("nf-bcr", phase_nf_bcr, gpu, val_main, proj_main)
    log(f"[total] {time.perf_counter() - t_start:.1f} s")

    rows = {r["name"]: r for r in probe_rows}
    k3 = [r for n, r in rows.items() if n.startswith("K3")]
    k4 = [r for n, r in rows.items() if n.startswith("K4")]
    at = ("max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")
    kernels = [
        kernel_entry("K1 f32 9-point block-stencil matvec (513x257, ndof 2, "
                     "k 16)", "eigd_tpu_torch/csrc/stencil.cu",
                     "eigd_tpu/ops/pallas_stencil.py:121", l1m["K1"],
                     s263["K1 513x257 ndof 2 k 16"],
                     launches_by_path={"263k": l263["K1"], "1m": l1m["K1"],
                                       "minfreq": lmf["K1"],
                                       "thermal1m": lth["K1"]},
                     at_1m={k: s1m["K1 1025x513 ndof 2 k 8"][k] for k in at},
                     at_thermal1m=[{"name": r["name"], **{k: r[k] for k in at}}
                                   for n, r in sth.items()
                                   if n.startswith("K1")],
                     host_us_per_call=host),
        kernel_entry("K2 f64 9-point block-stencil matvec (513x257, ndof 2, "
                     "k 16)", "eigd_tpu_torch/csrc/stencil.cu",
                     "eigd_tpu/ops/pallas_stencil.py:299", l1m["K2"],
                     s263["K2 513x257 ndof 2 k 16"],
                     launches_by_path={"263k": l263["K2"], "1m": l1m["K2"],
                                       "minfreq": lmf["K2"],
                                       "thermal1m": lth["K2"]},
                     at_1m={k: s1m["K2 1025x513 ndof 2 k 6"][k] for k in at},
                     at_thermal1m=[{"name": r["name"], **{k: r[k] for k in at}}
                                   for n, r in sth.items()
                                   if n.startswith("K2")]),
        kernel_entry("K3 stencil floor probe (noshift9; 1040x513, C 16)",
                     "eigd_tpu_torch/csrc/probes.cu",
                     "scripts/diag_pallas_floor.py:87",
                     probe_launches["K3"], rows["K3 noshift9"],
                     cases=k3),
        kernel_entry("K4 stencil DMA probe (unaligned, 3 slabs + W; "
                     "1040x513, C 16)", "eigd_tpu_torch/csrc/probes.cu",
                     "scripts/diag_pallas_dma.py:62", probe_launches["K4"],
                     rows["K4 unaligned: 3 slabs + W"], cases=k4),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
