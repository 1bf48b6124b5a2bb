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
then drives three paths:

* the 512x256 natural-frequency problem (263,682 DOF, N=6) of
  ``bench.py``: value and adjoint gradient of its eta-weighted objective,
  with a Richardson central-difference check;
* the K3/K4 diagnostic entry points (``eigd_tpu_torch.diag``) at the
  1M-DOF stencil shapes;
* the 1024x512 north-star problem (1,051,650 DOF) of ``bench.py``'s big
  branch: K1 and K2 against their twins on its operators, value and
  gradient, forward-mode ``staged_jvp`` against the reverse-mode
  gradient, and the Richardson check.

Usage: ``python3 chip_smoke.py`` from the root of the repository, on a
machine with one CUDA GPU and nvcc. It exits non-zero, printing no result,
when there is no GPU or the package is missing, and on any failed phase.
The last line of standard output is the JSON contract line
``{"ok": true, "device": {...}}``; the line before it lists the kernels.
"""

from __future__ import annotations

import collections
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
        tol = 1e-5 * float(ref.abs().max())
        log(f"[{name}] max_abs_err {err:.3e} (bound {tol:.3e})")
        check(err <= tol, f"{name} disagrees with its twin")
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
    return rows, launches


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
    """Value and gradient of the bench objective at 263k, FD-checked."""
    g, _, launches = evaluate(topo, gpu, "main")
    fd_check(topo, g, bench_direction(topo), 1e-4, "main")
    return launches


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

    t0 = time.perf_counter()
    topo = make_model(device="cuda", **bench_1m())
    log(f"[1m] model built in {time.perf_counter() - t0:.2f} s")
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

    phase_build()
    topo = make_model(device="cuda", **bench_263k())
    gen = torch.Generator().manual_seed(0)
    timed, ragged = random_stencils(gen)
    s263 = phase_stencils(topo, (1, 16), (1, 16), (1, 6, 16), gen, timed)
    phase_ragged(ragged, gen)
    host = phase_host()
    probe_rows, probe_launches = phase_probes()
    phase_on_off()
    l263 = phase_main(topo, gpu)
    del topo
    torch.cuda.empty_cache()
    l1m, s1m = phase_1m(gpu, gen)
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
                     launches_by_path={"263k": l263["K1"], "1m": l1m["K1"]},
                     at_1m={k: s1m["K1 1025x513 ndof 2 k 8"][k] for k in at},
                     host_us_per_call=host),
        kernel_entry("K2 f64 9-point block-stencil matvec (513x257, ndof 2, "
                     "k 16)", "eigd_tpu_torch/csrc/stencil.cu",
                     "eigd_tpu/ops/pallas_stencil.py:299", l1m["K2"],
                     s263["K2 513x257 ndof 2 k 16"],
                     launches_by_path={"263k": l263["K2"], "1m": l1m["K2"]},
                     at_1m={k: s1m["K2 1025x513 ndof 2 k 6"][k] for k in at}),
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
