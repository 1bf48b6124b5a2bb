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
  the f32 refined factor (``[nf-bcr]``) against ``[main]``;
* the buckling family at 512x256 (263,682 DOF, ``[buckle]``) on the f64
  cyclic-reduction factor, the shift from a dense 32x16 pilot: K2 on the
  model's masked K and G checked and counted, the protocol with two
  adjoint passes on one solve, the true pencil residuals, a Richardson
  check and forward mode against reverse mode; the block-tridiagonal
  factor against it, the f32 refined factor against the f64 one at
  128x64 (and measured at 512x256), and examples/buckling.py's dense flow
  with each adjoint method;
* the CRM wingbox at 86,352 padded DOF (``[crm]``): the modal-compliance
  protocol cold and warm on JAX's defaults (``bcr_f32``: PCGFactor on the
  equilibrated, jittered f32 BCR), on f64 ``bcr`` and on ``bcr_f32`` with
  the exact sweep; forward mode (``objective_jvp``) against the reverse
  mode on each, central differences and the gaps to f64 ``bcr`` held
  where the forward converges (``phase_crm``); and the flagship at
  998,712 padded DOF (``[crm1m]``) on JAX's defaults and on f64 ``bcr``,
  jvp-vs-vjp held on the latter.

Right after ``[main]``, ``[surface]`` drives the rest of the public
surface on the same 263k model: ``factor(x)`` and ``op(x)`` against
their ``mv`` (bitwise, the same K1/K2 launches), the sharded stencil's
gradient under ``launch.local_axis()`` with no device (NCCL) against the
CPU's, ``launch.run`` with no device, the Dirichlet-reduction helpers on
the 24x12 buckling flow and ``detJ_tables`` at 512x256.

Beside these: ``EighGenConfig.measure_eig_res`` on the 263k model at
polish 0 (``[measure]``: the measured pencil residual against one
recomputed on K2, the solve unmoved by the flag); the Cayley map of
``BasicLanczos`` at n 2,000 (in ``[dense]``); the four example CLIs'
``main()`` at their default sizes, each FD-checked (``[examples]``); and
on [thermal1m]'s live 1M model (``[thermal-dl]``) the ``dl`` adjoint
against SIBK and the forward mode, ``BasicLanczos`` with its dl and sibk
adjoints, and ``IRAM`` (thick restart at m 40), K1/K2 counted in each.

The sharded solve (``eigd_tpu_torch/parallel``) closes the run:
``[sharded1]`` at world 1 on NCCL drives the NF sharded objective at
512x256 on the line-sharded multigrid factor (K1/K2 counted on its
extended local grid and held against their twins there; against a serial
twin on the f64 cyclic-reduction factor and a Richardson central
difference) and the station-sharded CRM at 86,352 padded DOF (against
the serial CRM on f64 ``bcr`` and a central difference);
``[sharded4]`` runs ``graft_entry.dryrun_multichip(4)`` (the NF train
step and the CRM) and the thermal and buckling families on four ranks
sharing the card through gloo, each against world 1 and a central
difference.

Each phase's wall time is printed as ``[time]``.

Usage: ``python3 chip_smoke.py`` from the root of the repository, on a
machine with one CUDA GPU and nvcc (``python3 chip_smoke.py surface``
builds the kernels and runs ``[surface]`` alone, without the JSON lines). It exits non-zero, printing no result,
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
    rows by name, and the operators and factor (A, B, factor)."""
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
    return {r["name"]: r for r in rows}, (A, B, fac)


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


def surface_calls(A, fac, gen, device):
    """factor(x) against factor.mv(x) and the stiffness stencil's op(x)
    against op.mv(x) on one f64 (n, 16) block: bitwise, with the same
    K1/K2 launches; FactorCounter(factor).shape."""
    from eigd_tpu_torch.utils.profile import FactorCounter

    n = fac.shape[0]
    x = torch.randn((n, 16), generator=gen, dtype=torch.float64).to(device)
    op = A.with_kernels()
    for name, f in (("GridMGFactor", fac), ("GridStencilOperator", op)):
        out, used = [], []
        for call in (f, f.mv):
            before = launches_now()
            out.append(call(x))
            sync_device(device)
            used.append({k: v - before[k] for k, v in launches_now().items()})
        log(f"[surface] {name} ({n} DOF, k 16): call vs mv bitwise "
            f"{torch.equal(*out)}, launches {used[0]} and {used[1]}")
        check(torch.equal(*out), f"[surface] {name}(x) is not its mv(x)")
        check(used[0] == used[1], f"[surface] {name}(x) launched other "
                                  "kernels than its mv(x)")
    shape = FactorCounter(fac).shape
    log(f"[surface] FactorCounter(GridMGFactor).shape {shape}")
    check(shape == (n, n), "[surface] FactorCounter shape")


def surface_stencil_grad(fac, gen, axis, device):
    """The sharded stencil's gradient (psum <w, A x> in the replicated
    stencil and in x; k 3) at the sharded NF's 512x256 line partition on
    ``axis`` against the same on the CPU through a gloo group of this
    process: 1e-12 of the largest entry. Then the no-grad call launches K2
    (on the card) and agrees with the plain version to 1e-12."""
    import torch.distributed as dist

    from eigd_tpu_torch.ops import cuda_stencil as cs
    from eigd_tpu_torch.ops.collective import Axis
    from eigd_tpu_torch.parallel.grid import make_partition
    from eigd_tpu_torch.parallel.mgshard import sharded_stencil_matvec
    from eigd_tpu_torch.parallel.runs import stencil_gradient

    nx, ny = fac.shapes[0]
    part = make_partition(nx, ny, axis.size, ndof=2, multiple=4)
    W = fac.W64.new_zeros((part.L,) + tuple(fac.W64.shape[1:]))
    W[:part.nlines] = fac.W64
    x, w = (torch.randn((part.n_local, 3), generator=gen,
                        dtype=torch.float64) for _ in range(2))
    group = dist.new_group([0], backend="gloo")
    try:
        host = Axis(group, "cpu")
        got = stencil_gradient(axis, W, x.to(device), w.to(device), part)
        ref = stencil_gradient(host, W.cpu(), x, w, part)
        with torch.no_grad():
            plain = sharded_stencil_matvec(W.cpu(), x, part.L, part.nlines,
                                           ny, 2, host)
    finally:
        dist.destroy_process_group(group)
    errs = [float((g.cpu() - r).abs().max() / r.abs().max())
            for g, r in zip(got[1:], ref[1:])]
    k2 = cs.K2_LAUNCHES
    with torch.no_grad():
        y = sharded_stencil_matvec(W, x.to(device), part.L, part.nlines, ny,
                                   2, axis)
    sync_device(device)
    k2 = cs.K2_LAUNCHES - k2
    err = float((y.cpu() - plain).abs().max() / plain.abs().max())
    log(f"[surface] sharded stencil gradient on {axis.backend} {axis.device} "
        f"({part.nlines} lines, L {part.L}, k 3) vs the CPU (gloo): W rel "
        f"{errs[0]:.3e}, x rel {errs[1]:.3e} (bound 1e-12); no-grad call: "
        f"K2 launches {k2}, vs plain rel {err:.3e} (bound 1e-12)")
    check(max(errs) <= 1e-12, "[surface] the sharded stencil's gradient "
                              "disagrees with the CPU's")
    check(err <= 1e-12, "[surface] the no-grad sharded stencil disagrees "
                        "with the plain version")
    if torch.device(device).type == "cuda":
        check(k2 == 1, "[surface] the no-grad sharded stencil did not "
                       "launch K2")


def surface_helpers(topo, device):
    """reduce_operator_dense / reduce_vector / expand_vector against the
    buckling model's own reduction at 24x12 (bitwise), the expansion zero
    exactly on the fixed DOFs; detJ_tables on the 512x256 mesh against
    the CPU, within the rounding bound of its formula there: each entry of
    J is a 4-term dot product of coordinates up to max|X| with weights of
    +-1/4 that cancels to about an edge, sqrt(detJ), so it carries a
    relative error up to 4u max|X| / sqrt(detJ) (u the f64 unit
    roundoff), detJ twice that, on each side of the comparison: 16u
    max|X| / sqrt(min detJ), 1.8e-12 on the 2 x 1 mesh at h 1/256."""
    from eigd_tpu_torch.fem.assembly import element_density
    from eigd_tpu_torch.fem.quad import detJ_tables
    from eigd_tpu_torch.models.buckling import make_buckling_model
    from eigd_tpu_torch.ops.operators import (expand_vector,
                                              reduce_operator_dense,
                                              reduce_vector)

    bk = make_buckling_model(nx=24, ny=12, N=4, sigma=1.0, device=device)
    free, n = bk.free, bk.nvars
    with torch.no_grad():
        rhoE = element_density(bk.fltr.apply(bk.x), bk.conn)
        Kr = reduce_operator_dense(bk._K_mats(rhoE), free).mat
        own = bk._stiffness_dense_reduced(rhoE)
    v = torch.linspace(1.0, 2.0, n, dtype=torch.float64, device=device)
    vr = reduce_vector(v, free)
    ve = expand_vector(vr, free, n)
    fixed = bk.fixed_mask > 0
    same = {"K": torch.equal(Kr, own),
            "f": torch.equal(reduce_vector(bk.f, free), bk.f[free]),
            "expand": torch.equal(ve, vr.new_zeros(n).index_put((free,),
                                                                  vr))}
    zero = bool((ve[fixed] == 0.0).all()) and torch.equal(ve[~fixed],
                                                          v[~fixed])
    dj = detJ_tables(topo.X, topo.conn)
    dc = detJ_tables(topo.X.cpu(), topo.conn.cpu())
    rel = float((dj.cpu() - dc).abs().max() / dc.abs().max())
    bound = 16 * (torch.finfo(torch.float64).eps / 2) * float(
        topo.X.abs().max().cpu() / dc.abs().min().sqrt())
    log(f"[surface] reduction helpers on the 24x12 buckling flow ({n} DOF, "
        f"{int(fixed.sum())} fixed): bitwise {same}, expansion zero on the "
        f"fixed DOFs {zero}; detJ_tables {tuple(dj.shape)} vs CPU rel "
        f"{rel:.3e} (bound {bound:.3e})")
    check(all(same.values()), "[surface] a reduction helper differs from "
                              "the buckling flow's own")
    check(zero, "[surface] expand_vector(reduce_vector(v)) is not zero "
                "exactly on the fixed DOFs")
    check(rel <= bound, "[surface] detJ_tables disagrees with the CPU")


def phase_surface(gpu, topo, ops, gen, device="cuda"):
    """The last public surface on [main]'s 512x256 model (263,682 DOF),
    its stiffness stencil and mg factor as [stencils] built them: calls
    (``surface_calls``); the sharded stencil's gradient under
    ``launch.local_axis()`` with no device, NCCL at world 1
    (``surface_stencil_grad``); ``launch.run(placement, 1)`` with no
    device, a CUDA device and NCCL inside the rank; the BC-reduction
    helpers and detJ_tables (``surface_helpers``). A device other than
    "cuda" (a CPU rehearsal) is passed to the launcher. Returns the K1/K2
    launches of the phase."""
    from eigd_tpu_torch.parallel import launch, runs

    A, _, fac = ops
    at = {} if device == "cuda" else {"device": device}
    counters_zero(device)
    t0 = time.perf_counter()
    surface_calls(A, fac, gen, device)
    with launch.local_axis(**at) as axis:
        surface_stencil_grad(fac, gen, axis, device)
    (rank,) = launch.run(runs.placement, 1, **at, timeout=120.0)
    want = "nccl" if device == "cuda" else "gloo"
    log(f"[surface] launch.run with no device: rank sees {rank}")
    check(rank["backend"] == want and rank["psum"] == 1.0
          and rank["device"].startswith(torch.device(device).type),
          "[surface] launch.run did not run on the card")
    surface_helpers(topo, device)
    launches = launches_now()
    log(f"[surface] {time.perf_counter() - t0:.2f} s  K1 launches "
        f"{launches['K1']}  K2 launches {launches['K2']} on {gpu}")
    return launches


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


def phase_measure(topo, gpu):
    """EighGenConfig.measure_eig_res on the main path's 263k model at
    polish 0 (block 16, local ortho, the approx sweep, the mg factor on
    K1/K2): the coupling bound eig_res beside the measured pencil
    residual eig_res_measured of the six modes; the measurement against
    an independent ||A Phi - B Phi lam|| on K2 (1e-10 relative); lam and
    Phi against the same solve without the flag (1e-14 relative).
    Returns the K1/K2 launches of the measured solve."""
    import dataclasses

    from eigd_tpu_torch.ops.autodiff import _forward_ops

    rhoE = element_density_of(topo)
    out = {}
    for flag in (True, False):
        cfg = dataclasses.replace(topo.cfg, polish=0, measure_eig_res=flag)
        counters_zero(topo.device)
        sync_device(topo.device)
        t0 = time.perf_counter()
        with torch.no_grad():
            A, B = topo.problem.assemble(rhoE)
            A, B, res, _ = _forward_ops(rhoE, topo.problem, A, B, cfg)
        sync_device(topo.device)
        out[flag] = (res, time.perf_counter() - t0, launches_now())
    res, sec, launches = out[True]
    ref = out[False][0]
    with torch.no_grad():
        R = A.mv(res.Phi) - B.mv(res.Phi) * res.lam[None, :]
        direct = torch.sqrt(torch.sum(R * R, dim=0))
    gap = float(((res.eig_res_measured - direct).abs() / direct).max())
    moved = max(relmax(res.lam, ref.lam), relmax(res.Phi, ref.Phi))
    log(f"[measure] {topo.nvars} DOF polish 0: coupling bound eig_res "
        f"{res.eig_res.tolist()}  eig_res_measured "
        f"{res.eig_res_measured.tolist()}")
    log(f"[measure] measured vs recomputed rel {gap:.3e} (bound 1e-10); "
        f"lam/Phi with vs without the flag rel {moved:.3e} (bound 1e-14); "
        f"solve {sec:.3f} s with, {out[False][1]:.3f} s without; K1 "
        f"launches {launches['K1']}  K2 launches {launches['K2']} on {gpu}")
    check(ref.eig_res_measured is None, "[measure] measured without the flag")
    check(gap <= 1e-10, "[measure] measured residual disagrees")
    check(moved <= 1e-14, "[measure] the measurement moved the solve")
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


def dense_cayley(gpu, device, n=2000, N=6):
    """BasicLanczos(mode="cayley") on the pencil at n 2,000 (sigma 0.5,
    below lam_1 = 1; m 60) against cuSOLVER's eigh of the Cholesky-reduced
    pencil (eigh_gen_oracle) at rtol 1e-9."""
    from eigd_tpu_torch import BasicLanczos, make_shift_factor
    from eigd_tpu_torch.ops.autodiff import eigh_gen_oracle

    A, B = (torch.as_tensor(a, device=device) for a in make_pencil(n, 3))
    sync_device(device)
    t0 = time.perf_counter()
    solver = BasicLanczos(N=N, m=60, mode="cayley")
    lam, _ = solver.solve(A, B, make_shift_factor(A, B, 0.5), 0.5)
    sync_device(device)
    sec = time.perf_counter() - t0
    ref, _ = eigh_gen_oracle(A, B, N)
    gap = float(((lam - ref).abs() / ref.abs()).max())
    log(f"[dense] cayley n {n} N {N}: lam vs eigh rel {gap:.3e} (bound "
        f"1e-9), eig_res max {float(solver.eig_res.max()):.3e}, {sec:.3f} s"
        f" on {gpu}")
    check(gap <= 1e-9, "[dense] the Cayley map disagrees with eigh")


def phase_examples(gpu, device="cuda"):
    """The four example CLIs' main() at their default sizes (those of
    examples/*.py): natural frequency 32x16 dense, the thermal transient and
    sweep at 16x16, buckling 24x12 (its 12x6 pilot), the CRM at nspan 64;
    each gradient held against its central difference at the bar JAX's
    tests hold that flow to."""
    import importlib

    runs = [("natural_frequency", [], 1e-6), ("thermal", ["transient"], 1e-6),
            ("thermal", [], None), ("buckling", [], 5e-6), ("crm", [], 1e-5)]
    for name, argv, bar in runs:
        mod = importlib.import_module(f"eigd_tpu_torch.examples.{name}")
        t0 = time.perf_counter()
        data = mod.main(argv + ["--device", device])
        sec = time.perf_counter() - t0
        what = f"{name} {' '.join(argv) or 'default'}"
        if bar is None:
            log(f"[examples] {what}: ||xb|| by epsilon "
                f"{[(d['epsilon'], d['xb_norm']) for d in data]} in "
                f"{sec:.2f} s on {gpu}")
            check(all(np.isfinite(d["xb_norm"]) for d in data),
                  f"[examples] {what} not finite")
            continue
        err = data.get("fd_err", data.get("cd_err"))
        log(f"[examples] {what}: FD rel error {err:.3e} (bound {bar:g}) in "
            f"{sec:.2f} s on {gpu}")
        check(err <= bar, f"[examples] {what} fails its FD bar")


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
    dense_cayley(gpu, device)

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
    rows, _ = phase_stencils(topo, (1, 6, 8, 16), (8,), (1, 6, 8, 16), gen)
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


def timed_build(build, device, built):
    """``build`` wrapped: each call appends (seconds, stored bytes) to
    ``built``."""
    def wrapped(*args):
        sync_device(device)
        t0 = time.perf_counter()
        f = build(*args)
        sync_device(device)
        inner = getattr(f, "inner", f)
        built.append((time.perf_counter() - t0,
                      getattr(inner, "nbytes", float("nan"))))
        return f

    return wrapped


def timed_factor(topo, built):
    """Wrap the model's factor build: each build appends (seconds, stored
    bytes) to ``built``."""
    import dataclasses

    topo.problem = dataclasses.replace(topo.problem, factor=timed_build(
        topo.problem.factor, topo.device, built))


def stencil_row_nd1(W, nx, ny, k, dtype, gen, nd=1, what=""):
    """K1 (f32, plane layout, as the V-cycle calls it) or K2 (f64, vector
    layout, as the f64 PCG residual and the solver's A.mv/B.mv call it) on
    the stencil W (the scalar one by default; ``nd`` DOFs a node) at k
    columns: against its twin (K1 1e-5 of max|ref|, K2 1e-13 of 9 nd
    max|x| max|W|), graph-timed beside its bound and twin, with SpMM on
    the same stencil by events. ``what`` names the operator."""
    from eigd_tpu_torch.diag.common import (line, stencil_csr, stencil_work,
                                            timed)
    from eigd_tpu_torch.ops import cuda_stencil as cs
    from eigd_tpu_torch.ops.stencil import stencil_matvec

    X, Y = nx + 1, ny + 1
    if dtype == torch.float32:
        Wp = cs.stencil_planes(W, nd)
        xq = torch.randn((nd, k, X, Y), generator=gen).cuda()
        xv = cs.from_planes(xq, nx, ny, nd).contiguous()

        def kern():
            return cs.matvec_planes(Wp, xq, nx, ny, nd)

        def plain():
            return cs.matvec_planes_ref(Wp, xq, nx, ny, nd)
        name, itemsize = f"K1 {X}x{Y} ndof {nd} k {k}{what}", 4
    else:
        Wp = cs.stencil_planes(W, nd, torch.float64)
        xv = torch.randn((X * Y * nd, k), generator=gen,
                         dtype=torch.float64).cuda()

        def kern():
            return cs.stencil_matvec64(Wp, xv, nx, ny, nd)

        def plain():
            return stencil_matvec(W, xv, nx, ny, nd)
        name, itemsize = f"K2 {X}x{Y} ndof {nd} k {k}{what}", 8
    got, ref = kern(), plain()
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    tol = (1e-5 * float(ref.abs().max()) if dtype == torch.float32 else
           1e-13 * 9 * nd * float(xv.abs().max()) * float(W.abs().max()))
    A = stencil_csr(W, nx, ny, nd, dtype)
    r = timed(name, kern, plain, lambda: torch.sparse.mm(A, xv),
              *stencil_work(X, Y, nd, k, itemsize), dtype,
              library_in_graph=False)
    log(f"{line(r)}  max_abs_err {err:.3e} (bound {tol:.3e})")
    check(err <= tol, f"{name} disagrees with its twin")
    return dict(r, max_abs_err=err)


def element_density_of(topo):
    """The model's element densities at its design, without autograd."""
    from eigd_tpu_torch.fem.assembly import element_density

    with torch.no_grad():
        return element_density(topo.fltr.apply(topo.x), topo.conn)


def thermal_rows(topo, gen):
    """K1 and K2 at ndof 1 on the model's shifted stencil at x0, at the
    column counts its path gives them: k 1 (single-vector Lanczos and its
    PCG) and k Nmax (the SIBK block)."""
    with torch.no_grad():
        A, B = topo.problem.assemble(element_density_of(topo))
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
    launches, the K1/K2 rows, lam, the projected KS gradient and what
    [thermal-dl] reuses (the protocol, the KS seeds' xb, the direction,
    the tail and its jvp)."""
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
    keep = {"opt": opt, "xb_ks": xb_ks, "pert": pert, "tail": tail,
            "jvp": float(dv)}
    return launches, rows, topo.lam.cpu().numpy(), ans, keep


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
    with torch.no_grad():
        A, B = topo.problem.assemble(element_density_of(topo))
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


def thermal_forms(topo, rhoE):
    """dAdx(W, V) and dBdx(W, V): sum_i w_i^T (dK/drhoE) v_i and the same
    of M, by autograd of the thermal model's element bilinear forms (the
    reference's deriv_type "tensor" contraction)."""
    from eigd_tpu_torch.fem import assembly as fem

    def form(build):
        def dXdx(W, V):
            with torch.enable_grad():
                r = rhoE.detach().requires_grad_(True)
                (g,) = torch.autograd.grad(torch.sum(W * build(r).mv(V)), r)
            return g
        return dXdx

    return (form(lambda r: fem.thermal_stiffness_matrix(
                r, topo.Be, topo.detJ, topo.conn, topo.nnodes,
                kappa=topo.kappa, beta=topo.beta, p=topo.p)),
            form(lambda r: fem.thermal_mass_matrix(
                r, topo.He, topo.detJ, topo.conn, topo.nnodes,
                density=topo.density, heat_capacity=topo.heat_capacity,
                beta=topo.beta)))


def relmax(a, b):
    return float((a - b).abs().max() / b.abs().max())


def thermal_dl_part(tag, device):
    """A context for one part of [thermal-dl]: counters zeroed on entry;
    on exit the time, host waits by loop and K1/K2 launches are printed,
    both kernels required, and the launches kept in ``out``."""
    import contextlib

    from eigd_tpu_torch.ops import sync

    out = {}

    @contextlib.contextmanager
    def part():
        counters_zero(device)
        sync_device(device)
        t0 = time.perf_counter()
        yield out
        sync_device(device)
        out.update(launches_now())
        log(f"[thermal-dl {tag}] {time.perf_counter() - t0:.2f} s  K1 "
            f"launches {out['K1']}  K2 launches {out['K2']}  host waits "
            f"{dict(sync.HOST_SYNCS)}  loop exits {dict(sync.LOOP_EXITS)}")
        if torch.device(device).type == "cuda":
            check(min(out["K1"], out["K2"]) > 0,
                  f"[thermal-dl {tag}] launched no K1 or K2")

    return part, out


def phase_thermal_dl(gpu, keep, device="cuda", ncycle=20):
    """The rest of the solver surface on [thermal1m]'s live model
    (1,050,625 DOF, mg factor, K1/K2 at ndof 1), each part's K1/K2
    launches counted and required:

    (a) adjoint_method "dl" on the model (same start vector): the KS
        seeds' xb against [thermal1m]'s SIBK xb (max-abs relative, bound
        1e-6), and the tail's reverse-mode gradient through dl against
        [thermal1m]'s forward-mode jvp (bound 1e-5);
    (b) BasicLanczos(N 10, m 60) on the model's A, B and factor (the kept
        forward): lam against the model's (rtol 1e-9, atol max(1e-10, the
        constant mode's f64 floor)); seeded with the protocol's KS seeds,
        add_total_derivative over the element bilinear forms after dl and
        after sibk (bound 1e-6);
    (c) IRAM(N 10, k 20) with up to ``ncycle`` cycles at m 40, and at m
        30 (its first expansion meets the 1e-13 exit at m 40, so m 30
        makes the restart run): lam held as in (b); eig_res, cycles,
        niter and the basis bytes printed beside the unrestarted m 60
        chain's; where it reached its exit, its sibk total derivative
        against (b)'s (bound 1e-6); dl raises.

    Returns the launches of each part."""
    import dataclasses

    from eigd_tpu_torch import IRAM, BasicLanczos
    from eigd_tpu_torch.ops import sync
    from eigd_tpu_torch.ops.autodiff import kept_forward

    opt, xb_sibk, pert, tail = (keep[k] for k in ("opt", "xb_ks", "pert",
                                                  "tail"))
    topo = opt.topo
    cfg0 = topo.cfg
    launches = {}

    part, launches["a"] = thermal_dl_part("a", device)
    with part():
        topo.cfg = dataclasses.replace(cfg0, adjoint_method="dl")
        opt.initialize()
        opt.initialize_adjoint()
        opt.add_ks_derivative(RHO_KS, KSB)
        lamb, Qb = topo.lamb.clone(), topo.Qb.clone()
        opt.finalize_adjoint()
        gap = relmax(topo.xb, xb_sibk)
        # the tail's seeds through the same solve's graph: dl's vjp
        _, lam_g, Q_g = topo._graph
        lam_s = lam_g.detach().requires_grad_(True)
        Q_s = Q_g.detach().requires_grad_(True)
        with torch.enable_grad():
            tail(lam_s, Q_s).backward()
        topo.initialize_adjoint()
        topo.lamb, topo.Qb = lam_s.grad, Q_s.grad
        topo.finalize_adjoint()
        vjp = float(pert @ topo.xb)
    rel = abs(vjp - keep["jvp"]) / abs(keep["jvp"])
    log(f"[thermal-dl a] dl xb of the KS seeds vs [thermal1m]'s sibk xb: "
        f"max-abs rel {gap:.3e} (bound 1e-6); jvp-vs-vjp(dl): vjp {vjp!r} "
        f"jvp {keep['jvp']!r} rel {rel:.3e} (bound 1e-5) on {gpu}")
    check(gap <= 1e-6, "[thermal-dl] dl xb disagrees with sibk's")
    check(rel <= 1e-5, "[thermal-dl] dl vjp disagrees with the jvp")

    A, B, _, factor = kept_forward(topo._graph[1])
    lam_m = topo.lam
    atol = max(1e-10, constant_mode_floor(topo))
    rhoE = element_density_of(topo)
    dAdx, dBdx = thermal_forms(topo, rhoE)
    zero = torch.zeros_like(rhoE)

    def lam_gap(lam):
        return float(((lam - lam_m).abs() / (atol + 1e-9 * lam_m.abs()))
                     .max())

    def seeds_for(Phi):
        sign = torch.sign(torch.sum(Phi * topo.Q, dim=0))
        return Qb * sign[None, :]

    part, launches["b"] = thermal_dl_part("b", device)
    with part():
        bl = BasicLanczos(N=topo.Nmax, m=60)
        lam_b, Phi_b = bl.solve(A, B, factor, topo.sigma)
        Phib = seeds_for(Phi_b)
        tot = {}
        for method in ("dl", "sibk"):
            kw = {} if method == "dl" else {"rtol": 1e-12}
            psi, data = bl.solve_adjoint(Phib, method=method, **kw)
            tot[method] = bl.add_total_derivative(
                lamb, Phib, psi, dAdx, dBdx, zero, adj_corr_data=data)
    gb, gd = lam_gap(lam_b), relmax(tot["dl"], tot["sibk"])
    log(f"[thermal-dl b] BasicLanczos N {topo.Nmax} m 60: lam gap "
        f"{gb:.3e} of rtol 1e-9 / atol {atol:.3e}; eig_res max "
        f"{float(bl.eig_res.max()):.3e}; total derivative dl vs sibk rel "
        f"{gd:.3e} (bound 1e-6)")
    check(gb <= 1.0, "[thermal-dl] BasicLanczos lam disagrees")
    check(gd <= 1e-6, "[thermal-dl] BasicLanczos dl and sibk disagree")

    part, launches["c"] = thermal_dl_part("c", device)
    with part():
        runs = []
        for m in (40, 30):
            exits = sync.LOOP_EXITS["restart.converged"]
            steps = sync.LOOP_STEPS["restart"]
            ir = IRAM(N=topo.Nmax, m=m, ncycle=ncycle)
            lam_i, Phi_i = ir.solve(A, B, factor, topo.sigma)
            tot_i = None
            if sync.LOOP_EXITS["restart.converged"] > exits:
                Phib = seeds_for(Phi_i)
                psi, data = ir.solve_adjoint(Phib, method="sibk", rtol=1e-12)
                tot_i = ir.add_total_derivative(lamb, Phib, psi, dAdx, dBdx,
                                                zero, adj_corr_data=data)
            runs.append((m, ir, lam_gap(lam_i),
                         sync.LOOP_STEPS["restart"] - steps, tot_i))
    n = topo.nnodes
    for m, ir, gi, cycles, tot_i in runs:
        log(f"[thermal-dl c] IRAM N {topo.Nmax} m {m} k {2 * topo.Nmax}: "
            f"{cycles} cycles (cap {ncycle}), niter {ir.niter}, exit "
            f"{'not reached' if tot_i is None else 'reached'}; eig_res "
            f"{ir.eig_res.tolist()}; lam gap {gi:.3e} of rtol 1e-9 / atol "
            f"{atol:.3e}; basis V+BV+W {(3 * m + 2) * n * 8 / 2**30:.3f} GiB"
            f" vs the unrestarted m 60 chain's "
            f"{(3 * 60 + 2) * n * 8 / 2**30:.3f} GiB")
        check(gi <= 1.0, f"[thermal-dl] IRAM m {m} lam disagrees")
        if tot_i is not None:
            gs = relmax(tot_i, tot["sibk"])
            log(f"[thermal-dl c] IRAM m {m} sibk total derivative vs (b) "
                f"rel {gs:.3e} (bound 1e-6)")
            check(gs <= 1e-6, f"[thermal-dl] IRAM m {m} total derivative "
                              "disagrees")
    try:
        ir.solve_adjoint(Phib, method="dl")
    except ValueError as e:
        log(f"[thermal-dl c] IRAM dl refused: {e}")
    else:
        check(False, "[thermal-dl] IRAM accepted dl")
    topo.cfg = cfg0
    return launches


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


# ---------------------------------------------------------------------------
# The buckling family at 263,682 DOF
# ---------------------------------------------------------------------------

BUCKLE_GRID = (512, 256)
BUCKLE_KS_RHO = 100.0


def buckle_pilot(device="cuda"):
    """BLF_1 of the dense pilot model (diag.configs.BUCKLE_PILOT, 32x16)
    from its full pencil, and the shift SIGMA_MARGIN below it."""
    from eigd_tpu_torch.diag.configs import BUCKLE_PILOT, SIGMA_MARGIN
    from eigd_tpu_torch.models.buckling import first_blf, make_buckling_model

    pilot = make_buckling_model(sigma=1.0, device=device, **BUCKLE_PILOT)
    blf1 = first_blf(pilot)
    return blf1, SIGMA_MARGIN * blf1


def buckle_model(sigma, grid, factor_kind, device):
    from eigd_tpu_torch.diag.configs import buckle_263k
    from eigd_tpu_torch.models.buckling import make_buckling_model

    nx, ny = grid
    return make_buckling_model(device=device, **dict(
        buckle_263k(sigma, factor_kind), nx=nx, ny=ny))


def buckle_dofs(grid):
    """The y-DOFs of the loaded right-edge nodes: the aggregate's set."""
    from eigd_tpu_torch.fem.model import make_grid
    from eigd_tpu_torch.models.buckling import load_nodes

    nx, ny = grid
    return [2 * nd + 1 for nd in load_nodes(make_grid(nx, ny, 2.0, 1.0))]


def buckle_value(topo, dofs):
    """The first pass's objective: KS of 1/BLF plus the eigenvector
    aggregate (rho 1) over ``dofs``."""
    return (float(topo.eval_ks_buckling(BUCKLE_KS_RHO))
            + float(topo.get_eigenvector_aggregate(1.0, dofs)))


def timed_buckle_factors(topo, built):
    """``timed_factor`` for both factors of a buckling model: the pencil's
    builds go to ``built["pencil"]``, the static solve's to
    ``built["K"]``."""
    built["pencil"], built["K"] = [], []
    timed_factor(topo, built["pencil"])
    topo._K_factor_w = timed_build(topo._K_factor_w, topo.device, built["K"])


def buckle_protocol(topo, dofs, tag, gpu, hold=True):
    """initialize; the KS and aggregate seeds in one adjoint pass; the
    aggregate-max seeds (rho 20) in a second pass on the same solve.
    Prints the load factors, compliance, the time of each step, peak,
    launches and host syncs by loop; with ``hold`` fails on load factors
    that are not finite, positive and ascending or an xb that is not
    finite. Returns (xb of the first pass, launches)."""
    from eigd_tpu_torch.ops import sync

    times = {}

    def step(name, fn, *args):
        sync_device(topo.device)
        t0 = time.perf_counter()
        fn(*args)
        sync_device(topo.device)
        times[name] = time.perf_counter() - t0

    counters_zero(topo.device)
    step("initialize", topo.initialize)
    fwd = collections.Counter(sync.HOST_SYNCS)
    step("initialize_adjoint", topo.initialize_adjoint)
    step("add KS", topo.add_ks_buckling_derivative, 1.0, BUCKLE_KS_RHO)
    step("add aggregate", topo.add_eigenvector_aggregate_derivative, 1.0,
         1.0, dofs)
    step("finalize_adjoint", topo.finalize_adjoint)
    xb = topo.xb.clone()
    step("initialize_adjoint (2)", topo.initialize_adjoint)
    step("add aggregate max",
         topo.add_eigenvector_aggregate_max_derivative, 1.0, 20.0, dofs)
    step("finalize_adjoint (2)", topo.finalize_adjoint)
    launches = launches_now()
    peak = peak_gib(topo.device)
    blf = topo.BLF.cpu().numpy()
    log(f"[{tag}] {topo.nvars} DOF  sigma {topo.sigma!r}  BLF "
        f"{blf.tolist()}  compliance {float(topo.compliance())!r}")
    log(f"[{tag}] " + "  ".join(f"{k} {v:.3f} s" for k, v in times.items())
        + f"  (second pass on the same initialize)  peak {peak:.3f} GiB  K1 "
        f"launches {launches['K1']}  K2 launches {launches['K2']}  on {gpu}")
    log(f"[{tag}] host syncs by loop: initialize {dict(fwd)}  both adjoint "
        f"passes {dict(sync.HOST_SYNCS - fwd)}  exits "
        f"{dict(sync.LOOP_EXITS)}")
    if hold:
        check(np.all(np.isfinite(blf)) and np.all(blf > 0.0)
              and np.all(np.diff(blf) >= 0.0),
              f"[{tag}] load factors not finite, positive and ascending")
        check(bool(torch.isfinite(xb).all()
                   and torch.isfinite(topo.xb).all()),
              f"[{tag}] xb not finite")
    return xb, launches


def pencil_residuals(topo):
    """||K phi_i + lam_i G phi_i|| / ||K phi_i|| of the solved pairs, on
    the plain operators at the design."""
    from eigd_tpu_torch.fem.assembly import element_density

    with torch.no_grad():
        rhoE = element_density(topo.fltr.apply(topo.x), topo.conn)
        u, _ = topo._static(rhoE)
        G, K = topo._assemble_pencil((rhoE, u))
        KQ, GQ = K.mv(topo.Qr), G.mv(topo.Qr)
        r = torch.linalg.norm(KQ + GQ * topo.lam[None, :], dim=0)
        return (r / torch.linalg.norm(KQ, dim=0)).cpu().numpy()


def buckle_rows(topo, gen):
    """K2 against its twin on the model's masked K-hat (unit diagonal on
    the clamped edge) and G at the design, k 1 (Lanczos) and k N (the
    adjoint blocks)."""
    from eigd_tpu_torch.fem.assembly import element_density

    with torch.no_grad():
        rhoE = element_density(topo.fltr.apply(topo.x), topo.conn)
        u, _ = topo._static(rhoE)
        G, K = topo._assemble_pencil((rhoE, u))
    nx, ny = topo.grid_shape
    rows = [stencil_row_nd1(op.W, nx, ny, k, torch.float64, gen, nd=2,
                            what=f" {name}")
            for name, op in (("K-hat", K), ("G", G)) for k in (1, topo.N)]
    return {r["name"]: r for r in rows}


def buckle_dense(gpu, device, grid=(24, 12)):
    """examples/buckling.py's flow with each adjoint method: the 12x6
    pilot, the dense model at 24x12 (N 4, sigma 0.8 BLF_1), the KS
    gradient (no eigenvector seeds, so every method's psi is zero) against
    a central difference (h 1e-6, bound 5e-6, as tests/test_buckling.py
    holds it); then the eigenvector aggregate of tests/test_buckling.py
    (rho 1, DOFs 11 and 29), whose adjoint each method solves, held the
    same way for the exact methods and printed for laa (a Galerkin
    guess, not an exact adjoint)."""
    from eigd_tpu_torch.models.buckling import first_blf, make_buckling_model

    sigma = 0.8 * first_blf(make_buckling_model(nx=12, ny=6, N=4, sigma=1.0,
                                                device=device))
    nx, ny = grid
    node = [11, 29]
    objectives = {
        "KS": (lambda t: t.add_ks_buckling_derivative(1.0, ks_rho=100.0),
               lambda t: t.eval_ks_buckling(ks_rho=100.0)),
        "aggregate": (
            lambda t: t.add_eigenvector_aggregate_derivative(1.0, 1.0, node),
            lambda t: t.get_eigenvector_aggregate(1.0, node))}
    for method in ("sibk", "laa", "pgmres", "pcpg"):
        t0 = time.perf_counter()
        topo = make_buckling_model(nx=nx, ny=ny, N=4, sigma=sigma,
                                   adjoint_method=method, device=device)
        x0 = topo.x
        pert = torch.as_tensor(np.random.default_rng(0).uniform(
            size=x0.shape), device=x0.device)
        out = []
        for name, (seed, value) in objectives.items():
            topo.x = x0
            topo.initialize()
            topo.initialize_adjoint()
            seed(topo)
            topo.finalize_adjoint()
            ans = float(pert @ topo.xb)
            vals = []
            for sgn in (1.0, -1.0):
                topo.x = x0 + sgn * 1e-6 * pert
                topo.initialize()
                vals.append(float(value(topo)))
            fd = (vals[0] - vals[1]) / 2e-6
            rel = abs(ans - fd) / abs(fd)
            held = name == "KS" or method != "laa"
            out.append(f"{name} {ans!r} FD {fd!r} rel {rel:.3e}"
                       + (" (bound 5e-6)" if held else " (not held)"))
            if held:
                check(rel <= 5e-6, f"[buckle dense] {method} {name} fails "
                                   f"the FD check")
        topo.x = x0
        log(f"[buckle dense] {nx}x{ny} ({topo.nvars} DOF) {method}: "
            f"{'; '.join(out)} in {time.perf_counter() - t0:.2f} s on {gpu}")


def buckle_against(ref, kind, grid, sigma, dofs, pert, gpu, device, tol_lam,
                   tol_proj, tag):
    """The model on factor ``kind`` at ``grid`` against ``ref`` = (BLF,
    projected first-pass gradient): relative gaps, held to the bounds
    when ``tol_lam`` is set. Returns the gaps."""
    from eigd_tpu_torch.ops import sync

    t0 = time.perf_counter()
    topo = buckle_model(sigma, grid, kind, device)
    log(f"[{tag}] model built in {time.perf_counter() - t0:.2f} s")
    built = {}
    timed_buckle_factors(topo, built)
    xb, _ = buckle_protocol(topo, dofs, tag, gpu, hold=tol_lam is not None)
    blf = topo.BLF.cpu().numpy()
    gap = float(np.max(np.abs(blf - ref[0]) / np.abs(ref[0])))
    proj = float(pert @ xb)
    rel = abs(proj - ref[1]) / abs(ref[1])
    passes = sync.LOOP_STEPS["refine"]
    applies = sum(v for k, v in sync.LOOP_EXITS.items()
                  if k.startswith("refine."))
    held = ("" if tol_lam is None else
            f" (bounds {tol_lam:g}, {tol_proj:g})")
    log(f"[{tag}] pencil factor built in {built['pencil'][0][0]:.3f} s "
        f"(K's in {built['K'][0][0]:.3f} s); BLF rel gap {gap:.3e}, "
        f"projected gradient {proj!r} vs {ref[1]!r} rel {rel:.3e}{held}; "
        f"refinement passes "
        f"{passes} in {applies} applies, exits "
        f"{ {k: v for k, v in sync.LOOP_EXITS.items() if 'refine' in k} }")
    if tol_lam is not None:
        check(gap <= tol_lam, f"[{tag}] load factors disagree")
        check(rel <= tol_proj, f"[{tag}] projected gradient disagrees")
    return gap, rel


def phase_buckle(gpu, gen, grid=BUCKLE_GRID, small=(128, 64),
                 dense_grid=(24, 12), device="cuda"):
    """The buckling family at 512x256 (263,682 DOF) on the f64 BCR factor:
    the dense pilot places the shift; K2 against its twin on the model's
    K-hat and G; the protocol (``buckle_protocol``), its K2 launches
    counted; the true pencil residuals (bound 1e-8); xb of the first pass
    against a Richardson-4 central difference (h 2e-3, 1e-3; bound 1e-4)
    and against forward mode through ``staged_jvp`` over
    x -> (rhoE, u) -> eigh_gen -> objective (bound 1e-5). Then the same
    model on the f64 block-tridiagonal factor (BLF 1e-10, projected
    gradient 1e-8), ``bcr_f32`` against ``bcr`` at 128x64 (1e-8, 1e-6),
    ``bcr_f32`` at 512x256 measured beside ``bcr`` (printed, not held:
    cond(K + sigma G) eps32 is about 3 there, PERF.md), and
    examples/buckling.py's dense flow with each adjoint method. Returns
    the launches and the K2 rows."""
    from eigd_tpu_torch.fem.assembly import element_density
    from eigd_tpu_torch.ops.autodiff import staged_jvp

    t0 = time.perf_counter()
    blf1, sigma = buckle_pilot(device)
    log(f"[buckle] pilot 32x16 (dense): BLF_1 {blf1!r}, sigma {sigma!r} in "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    topo = buckle_model(sigma, grid, "bcr", device)
    log(f"[buckle] model built in {time.perf_counter() - t0:.2f} s")
    rows = buckle_rows(topo, gen) if device == "cuda" else {}
    built = {}
    timed_buckle_factors(topo, built)
    dofs = buckle_dofs(grid)
    xb, launches = buckle_protocol(topo, dofs, "buckle", gpu)
    (tk, bk), (tp, bp) = built["K"][0], built["pencil"][0]
    log(f"[buckle] factors: K's built in {tk:.3f} s, stores "
        f"{bk / 2**30:.3f} GiB; the pencil's built in {tp:.3f} s, stores "
        f"{bp / 2**30:.3f} GiB")
    check(launches["K2"] > 0, "[buckle] launched no K2")
    blf = topo.BLF.cpu().numpy()
    res = pencil_residuals(topo)
    log(f"[buckle] pencil residuals ||K phi + lam G phi|| / ||K phi||: "
        f"{res.tolist()} (bound 1e-8)")
    check(float(res.max()) <= 1e-8, "[buckle] pencil residuals too large")

    # the KS seeds alone, a third pass on the same solve: the FD quotients
    # of the two terms are printed apart
    topo.initialize_adjoint()
    topo.add_ks_buckling_derivative(1.0, ks_rho=BUCKLE_KS_RHO)
    topo.finalize_adjoint()
    pert = bench_direction(topo)
    ans = float(pert @ xb)
    ans_ks = float(pert @ topo.xb)
    x0 = topo.x
    fds = {}
    for h in (2e-3, 1e-3):
        vals = []
        for sgn in (1.0, -1.0):
            topo.x = x0 + sgn * h * pert
            topo.initialize()
            vals.append(np.array([
                float(topo.eval_ks_buckling(BUCKLE_KS_RHO)),
                float(topo.get_eigenvector_aggregate(1.0, dofs))]))
            log(f"[buckle] FD point {sgn * h:+g}: BLF_1 "
                f"{float(topo.BLF[0])!r}")
        fds[h] = (vals[0] - vals[1]) / (2 * h)  # (KS, aggregate)
    topo.x = x0
    fd4 = (4.0 * fds[1e-3] - fds[2e-3]) / 3.0
    rel = abs(ans - fd4.sum()) / abs(fd4.sum())
    parts = (("KS", ans_ks, float(fd4[0])),
             ("aggregate", ans - ans_ks, float(fd4[1])))
    log(f"[buckle] FD check of the first pass's xb: adjoint {ans!r} "
        f"richardson-4 {float(fd4.sum())!r} rel {rel:.3e} (bound 1e-4); plain "
        f"h=2e-3 {abs(ans - fds[2e-3].sum()) / abs(fds[2e-3].sum()):.3e}, "
        f"h=1e-3 {abs(ans - fds[1e-3].sum()) / abs(fds[1e-3].sum()):.3e}; "
        "by term (printed): " + "; ".join(
            f"{name} adjoint {a!r} richardson-4 {f!r} (abs {abs(a - f):.3e})"
            for name, a, f in parts))
    check(rel <= 1e-4, "[buckle] xb fails the FD check")

    def pre(x):
        rhoE = element_density(topo.fltr.apply(x), topo.conn)
        return rhoE, topo._static(rhoE)[0]

    node = topo._nodes(dofs)

    def tail(lam, Q):
        return topo._ks(lam, BUCKLE_KS_RHO) + topo._aggregate(
            lam, Q, 1.0, node, "tanh")

    t0 = time.perf_counter()
    _, dv = staged_jvp(pre, tail, topo.problem, topo.cfg)(x0, pert)
    t_jvp = time.perf_counter() - t0
    rel = abs(ans - float(dv)) / abs(float(dv))
    log(f"[buckle] jvp-vs-vjp: vjp {ans!r} jvp {float(dv)!r} rel {rel:.3e} "
        f"(bound 1e-5); staged_jvp {t_jvp:.2f} s")
    check(rel <= 1e-5, "[buckle] jvp disagrees with the reverse mode")
    ref = (blf, ans)
    del topo
    gc.collect()
    torch.cuda.empty_cache()

    buckle_against(ref, "blocktridiag", grid, sigma, dofs, pert, gpu,
                   device, 1e-10, 1e-8, "buckle blocktridiag")
    gc.collect()
    buckle_against(ref, "bcr_f32", grid, sigma, dofs, pert, gpu, device,
                   None, None, "buckle bcr_f32")
    gc.collect()
    sdofs = buckle_dofs(small)
    topo = buckle_model(sigma, small, "bcr", device)
    xs, _ = buckle_protocol(topo, sdofs, f"buckle {small[0]}x{small[1]}", gpu)
    spert = bench_direction(topo)
    sref = (topo.BLF.cpu().numpy(), float(spert @ xs))
    del topo
    buckle_against(sref, "bcr_f32", small, sigma, sdofs, spert, gpu, device,
                   1e-8, 1e-6, f"buckle {small[0]}x{small[1]} bcr_f32")
    buckle_dense(gpu, device, dense_grid)
    return launches, rows


CRM_SHAPES = {"86k": (86_352, 257, 336), "1m": (998_712, 3_201, 312)}


def crm_passes(config, tag, gpu, device, **over):
    """The CRM of ``config`` (diag/configs.py; ``over`` replaces keywords)
    built and checked against its padded size, then the protocol twice,
    cold and warm (``diag.crm.protocol_pass``): times, host waits by
    site, PCG steps and exits, the peak, the pencil residuals. Returns
    (crm, the warm pass)."""
    from eigd_tpu_torch.diag import crm as dc

    crm, t_build = dc.build(config, device, **over)
    dc.describe(crm, tag, t_build)
    if isinstance(config, str):
        check((crm.nvars, crm.nb, crm.b) == CRM_SHAPES[config],
              f"[{tag}] layout {(crm.nvars, crm.nb, crm.b)}")
    for run in ("cold", "warm"):
        t0 = time.perf_counter()
        out = dc.protocol_pass(crm, f"{tag} {run}")
        log(f"[{tag} {run}] pass {time.perf_counter() - t0:.3f} s on {gpu}")
        lam = crm.lam.cpu().numpy()
        check(np.all(np.isfinite(lam)) and np.all(np.diff(lam) > 0)
              and bool(torch.isfinite(crm.xb).all()),
              f"[{tag}] lam or xb not finite, or lam not ascending")
    return crm, out


def crm_checks(crm, tag, held):
    """objective_jvp against p @ xb (p default_rng(3); bound 1e-8,
    tests/test_crm.py:211-227, always held) and a central difference at
    h = 1e-6 x0[0] (p default_rng(1); bound 1e-5, tests/test_crm.py:242-
    269, held when ``held``), Richardson-4 printed. Returns (lam, p @ xb)
    of the solve at x0 (the FD points solve again)."""
    from eigd_tpu_torch.diag import crm as dc

    lam = crm.lam.cpu().numpy()
    rel, proj, _, _ = dc.jvp_check(crm, tag)
    check(rel <= 1e-8, f"[{tag}] jvp disagrees with the reverse mode")
    rel_fd, _ = dc.fd_check(crm, tag)
    log(f"[{tag}] FD bound 1e-5 {'held' if held else 'printed, not held'}")
    if held:
        check(rel_fd <= 1e-5, f"[{tag}] xb fails the FD check")
    return lam, proj


def crm_against(got, ref, tag, held):
    """(lam, p @ xb) of a model against ``ref``, those of the f64 ``bcr``
    model: bounds 1e-9 and 1e-7, held when ``held``."""
    (lam, proj) = got
    gap = float(np.max(np.abs(lam - ref[0]) / np.abs(ref[0])))
    rel = abs(proj - ref[1]) / abs(ref[1])
    log(f"[{tag}] against f64 bcr: eigenvalues rel {gap:.3e} (bound 1e-9), "
        f"projected gradient {proj!r} vs {ref[1]!r} rel {rel:.3e} (bound "
        f"1e-7); {'held' if held else 'printed, not held'}")
    if held:
        check(gap <= 1e-9, f"[{tag}] eigenvalues disagree with f64 bcr")
        check(rel <= 1e-7, f"[{tag}] projected gradient disagrees with "
                           "f64 bcr")


def phase_crm(gpu, config="86k", device="cuda"):
    """The CRM wingbox at 86,352 padded DOF, three ways, each with the
    protocol cold and warm and jvp-vs-vjp held at 1e-8 (``crm_checks``):

    * ``[crm]``: JAX's defaults, ``bcr_f32`` (PCGFactor on the jittered
      f32 BCR), block 8, m 96, the approx sweep, polish 3, the mixed SIBK.
      They leave pencil residuals up to 1e-5 (PERF.md), too coarse for a
      central difference at 1e-6 of x0: its FD and its gaps to f64
      ``bcr`` are printed, not held.
    * ``[crm bcr]``: the f64 ``bcr`` factor (the sweep then applies it
      exactly): FD held at 1e-5; the reference of the gaps.
    * ``[crm exact]``: ``bcr_f32`` with JAX's below-60,000-DOF sweep
      (exact, no polish): FD held at 1e-5, and against ``[crm bcr]``
      eigenvalues 1e-9 and the projected gradient 1e-7."""
    crm, _ = crm_passes(config, "crm", gpu, device)
    got = crm_checks(crm, "crm", held=False)
    del crm
    gc.collect()
    crm, _ = crm_passes(config, "crm bcr", gpu, device, factor_kind="bcr")
    ref = crm_checks(crm, "crm bcr", held=True)
    del crm
    gc.collect()
    crm_against(got, ref, "crm", held=False)
    crm, _ = crm_passes(config, "crm exact", gpu, device,
                        lanczos_sweep="exact", lanczos_polish=0)
    crm_against(crm_checks(crm, "crm exact", held=True), ref, "crm exact",
                held=True)


def phase_crm1m(gpu, config="1m", device="cuda"):
    """The CRM flagship at 998,712 padded DOF: one protocol pass after a
    warm-up, the times and the peak, twice. ``[crm1m]`` on JAX's defaults
    (``bcr_f32``): its f32 approx solves stop at residuals about 0.5 and
    its accurate PCG at the 200-step cap (PERF.md), so its
    jvp-vs-vjp is printed, not held. ``[crm1m bcr]`` on the f64 ``bcr``
    factor: jvp-vs-vjp held at 1e-8."""
    from eigd_tpu_torch.diag import crm as dc

    crm, _ = crm_passes(config, "crm1m", gpu, device)
    rel, _, _, _ = dc.jvp_check(crm, "crm1m")
    log("[crm1m] jvp-vs-vjp bound 1e-8 printed, not held")
    del crm
    gc.collect()
    torch.cuda.empty_cache()
    crm, _ = crm_passes(config, "crm1m bcr", gpu, device, factor_kind="bcr")
    rel, _, _, _ = dc.jvp_check(crm, "crm1m bcr")
    check(rel <= 1e-8, "[crm1m bcr] jvp disagrees with the reverse mode")


# ---------------------------------------------------------------------------
# The sharded solve (eigd_tpu_torch/parallel)
# ---------------------------------------------------------------------------

# the dry run's settings at the bench mesh (263,682 DOF, 516 lines padded)
# with the serial twin's adjoint budget: at the dry run's 16 SIBK steps the
# adjoint stops near 1e-6 of the gradient, where the bound is
SHARDED_NF = dict(nx=512, ny=256, N=3, m=36, factor="mg",
                  adjoint_maxiter=40)


def sharded_kernel_rows(obj, x0, gen):
    """K1 on each sharded level's extended grid of L+2 lines (k 1 and N)
    and K2 on the extended fine grid, each held against its twin and timed
    beside its bound and SpMM, at the factor of the objective at x0."""
    from eigd_tpu_torch.ops import cuda_stencil as cs

    with torch.no_grad():
        A, B = obj.problem.assemble(obj.theta(x0))
        fac = obj.problem.factor(A, B, obj.cfg.sigma, "normal")
    ks = (1, obj.cfg.N)
    rows = []
    for L, _, _, ny, Wp, _, _ in fac.levels:
        W = cs.planes_to_stencil(Wp, 2)
        rows += [k1_row(W, L + 1, ny, 2, k, gen) for k in ks]
    L, ny = fac.levels[0][0], fac.levels[0][3]
    W64 = cs.planes_to_stencil(fac.Wp64, 2)
    rows += [k2_row(W64, L + 1, ny, k, gen) for k in ks]
    return rows


def timed_value_grad(obj, x0, device="cuda"):
    """(value, gradient, value s, gradient s) of a sharded objective."""
    x = x0.detach().clone().requires_grad_(True)
    sync_device(device)
    t0 = time.perf_counter()
    v = obj(x)
    sync_device(device)
    t1 = time.perf_counter()
    (g,) = torch.autograd.grad(v, x)
    sync_device(device)
    return float(v.detach()), g, t1 - t0, time.perf_counter() - t1


def sharded_report(tag, v, tv, tg, gpu, device="cuda"):
    from eigd_tpu_torch.ops import sync

    launches = launches_now()
    log(f"[{tag}] objective {v!r}  value {tv:.3f} s  gradient {tg:.3f} s  "
        f"peak {peak_gib(device):.3f} GiB  K1 launches {launches['K1']}  "
        f"K2 launches {launches['K2']}  on {gpu}")
    log(f"[{tag}] host waits by loop {dict(sync.HOST_SYNCS)}  loop exits "
        f"{dict(sync.LOOP_EXITS)}")
    return launches


def phase_sharded1(gpu, gen, axis, nf=None, crm_config=None,
                   device="cuda"):
    """The sharded solve at world 1 (``axis``: NCCL on the card):

    * the NF sharded objective at 512x256 (263,682 DOF, 265,224 padded)
      on the line-sharded multigrid factor, N 3, m 36, SIBK: value and
      gradient timed with the host waits and the peak, K1 and K2 counted
      on the path and held against their twins at its local shapes;
      against a serial twin on the f64 cyclic-reduction factor (value rel
      1e-6, gradient max-scaled 1e-6) and a Richardson-4 central
      difference (1e-4);
    * the station-sharded CRM at crm_86k (86,352 padded DOF, N 6, m 96) on
      StationSchurFactor with one Ritz polish step: value against the
      serial CRM on f64 bcr with the same N, m and polish (rel 1e-6), central
      difference at h 1e-6 x0 (1e-5).

    Returns (NF launches, kernel rows)."""
    from eigd_tpu_torch.diag.configs import crm_86k
    from eigd_tpu_torch.models.crm import CRM
    from eigd_tpu_torch.parallel import runs

    nf = SHARDED_NF if nf is None else nf
    obj, x0, part = runs.build(axis, "nf", nf)
    log(f"[sharded1] NF {part.n} DOF ({part.n_padded} padded, L "
        f"{part.L}), world {axis.size} on {axis.backend}, factor "
        f"{nf['factor']}, N {nf['N']}, m {nf['m']}")
    counters_zero(device)
    v, g, tv, tg = timed_value_grad(obj, x0, device)
    launches = sharded_report("sharded1", v, tv, tg, gpu, device)
    check(np.isfinite(v) and bool(torch.isfinite(g).all()),
          "[sharded1] value or gradient not finite")
    if torch.device(device).type == "cuda":
        check(min(launches.values()) > 0,
              "[sharded1] the sharded path did not launch both kernels")
        rows = sharded_kernel_rows(obj, x0, gen)
    else:
        rows = []

    t0 = time.perf_counter()
    sobj, _ = runs.serial_nf_objective(nf["nx"], nf["ny"], nf["N"], nf["m"],
                                       device=device)
    vs, gs, tvs, tgs = timed_value_grad(sobj, x0, device)
    rel_v = abs(v - vs) / abs(vs)
    rel_g = float((g - gs).abs().max() / gs.abs().max())
    log(f"[sharded1] serial twin (f64 bcr) objective {vs!r}  value "
        f"{tvs:.3f} s  gradient {tgs:.3f} s  (with build "
        f"{time.perf_counter() - t0:.1f} s); value rel {rel_v:.3e} (bound "
        f"1e-6), gradient max-scaled {rel_g:.3e} (bound 1e-6)")
    check(rel_v <= 1e-6, "[sharded1] value disagrees with the serial twin")
    check(rel_g <= 1e-6, "[sharded1] gradient disagrees with the serial "
                         "twin")
    del sobj
    gc.collect()

    pert = torch.as_tensor(np.random.default_rng(7).uniform(size=x0.shape),
                           device=x0.device)
    ans = float(pert @ g)
    fds = {}
    with torch.no_grad():
        for h in (1e-2, 5e-3):
            fds[h] = (float(obj(x0 + h * pert))
                      - float(obj(x0 - h * pert))) / (2 * h)
    fd4 = (4.0 * fds[5e-3] - fds[1e-2]) / 3.0
    rel = abs(ans - fd4) / abs(fd4)
    log(f"[sharded1] FD check: adjoint {ans!r} richardson-4 {fd4!r} rel "
        f"{rel:.3e} (bound 1e-4)")
    check(rel <= 1e-4, "[sharded1] gradient fails the FD check")
    del obj
    gc.collect()

    # one Ritz polish step, in both CRMs: the single-vector forward at m 96
    # leaves the value 1e-11 off, which a central difference at h 1e-8
    # turns into 5e-5 (the serial CRM on the same chain 1e-5; PERF.md
    # PR 10)
    cfg = crm_86k() if crm_config is None else crm_config
    polish = dict(lanczos_polish=1)
    cobj, cx0, cpart = runs.build(axis, "crm", dict(cfg, crm_kwargs=polish))
    log(f"[sharded1 crm] {cpart.n_padded} padded DOF ({cpart.nlines} "
        f"stations of {cpart.line_dofs}), N {cfg['N']}, m {cfg['m']}, "
        "polish 1, StationSchurFactor")
    counters_zero(device)
    cv, cg, ctv, ctg = timed_value_grad(cobj, cx0, device)
    sharded_report("sharded1 crm", cv, ctv, ctg, gpu, device)
    crm = CRM(factor_kind="bcr", lanczos_block=1, device=device, **polish,
              **cfg)
    crm.initialize()
    cvs = float(crm.get_modal_compliance())
    rel_v = abs(cv - cvs) / abs(cvs)
    log(f"[sharded1 crm] serial CRM (f64 bcr, block 1, polish 1) {cvs!r}: "
        f"value rel "
        f"{rel_v:.3e} (bound 1e-6)")
    check(rel_v <= 1e-6, "[sharded1 crm] value disagrees with the serial "
                         "CRM")
    del crm
    p = torch.as_tensor(np.random.default_rng(1).uniform(size=cx0.shape),
                        device=cx0.device)
    h = 1e-6 * float(cx0[0])
    with torch.no_grad():
        fd = (float(cobj(cx0 + h * p)) - float(cobj(cx0 - h * p))) / (2 * h)
    ans = float(p @ cg)
    rel = abs(ans - fd) / abs(fd)
    log(f"[sharded1 crm] FD check: adjoint {ans!r} central (h {h:g}) "
        f"{fd!r} rel {rel:.3e} (bound 1e-5)")
    check(rel <= 1e-5, "[sharded1 crm] gradient fails the FD check")
    return launches, rows


# the world-4 families at tests/test_sharding.py's fast sizes besides the
# dry run's two (buckling at 12x4: at 8x4 a floating subdomain makes JAX's
# value NaN on 4 ranks)
SHARDED4 = (
    ("thermal", dict(nx=8, ny=4, N=2, m=24, cg_maxiter=300,
                     adjoint_maxiter=30), 1e-6),
    ("buckling", dict(nx=12, ny=4, N=1, m=20, sigma=0.008,
                      adjoint_maxiter=25, ks_rho=160.0, load_frac=0.3),
     1e-6),
)


def held4(fam, r4, r1, bar, fd=None):
    """Hold a 4-rank value and gradient against world 1 (1e-6) and the
    4-rank directional derivative against a central difference (``bar``):
    the 4-rank one in r4, or ``fd``, world 1's."""
    g4, g1 = np.asarray(r4["grad"]), r1["grad"].detach().cpu().numpy()
    rel_v = abs(r4["value"] - r1["value"]) / abs(r1["value"])
    rel_g = float(np.abs(g4 - g1).max() / np.abs(g1).max())
    fd, where = (r4["fd"], "4 ranks") if fd is None else (fd, "world 1")
    rel_fd = abs(r4["directional"] - fd) / abs(fd)
    log(f"[sharded4 {fam}] {r4['n_padded']} padded DOF on 4 ranks "
        f"({r4['backend']}, staged {r4['staged']}): objective "
        f"{r4['value']!r}  {r4['timing']}  launches {r4['launches']}; "
        f"world 1 ({r1['backend']}) {r1['value']!r} value "
        f"{r1['value_s']:.3f} s gradient {r1['grad_s']:.3f} s; value rel "
        f"{rel_v:.3e}, gradient max-scaled {rel_g:.3e} (bound 1e-6); FD "
        f"({where}) rel {rel_fd:.3e} (bound {bar:g})")
    check(rel_v <= 1e-6 and rel_g <= 1e-6,
          f"[sharded4 {fam}] 4 ranks disagree with world 1")
    check(rel_fd <= bar, f"[sharded4 {fam}] gradient fails the FD check")


def phase_sharded4(gpu, axis, device="cuda", families=SHARDED4):
    """Four ranks sharing the card through gloo (NCCL refuses two ranks
    on one device; ``Axis.staged``: ppermute through host buffers, the
    compute on the card):

    * ``dryrun_multichip(4)``: the NF train step (mg, 64x32) and the CRM,
      each value and gradient against world 1 on ``axis`` (1e-6), and the
      4-rank gradient along a seeded direction against world 1's central
      difference at h 1e-6 (1e-6; CRM 1e-5);
    * thermal and buckling on four ranks, each against world 1 (1e-6) and
      a 4-rank central difference at h 1e-6 (1e-6).

    Returns the dry run's NF K1/K2 launches on rank 0."""
    from eigd_tpu_torch.graft_entry import (DRYRUN_CRM, DRYRUN_NF,
                                            dryrun_multichip)
    from eigd_tpu_torch.parallel import launch, runs

    t0 = time.perf_counter()
    dry = dryrun_multichip(4, device=device)
    log(f"[sharded4] dry run on {dry['backend']} (staged "
        f"{dry['staged']}) in {time.perf_counter() - t0:.1f} s")
    specs4, specs1 = [], []
    for fam, kw, _ in families:
        obj, x0, _ = runs.build(axis, fam, kw)
        pert = np.random.default_rng(7).uniform(size=tuple(x0.shape))
        x0 = x0.detach().cpu().numpy()
        specs4.append((fam, kw, dict(x0=x0, pert=pert, h=1e-6)))
        specs1.append((fam, kw, dict(x0=x0)))
        del obj
    t0 = time.perf_counter()
    w4 = launch.run(runs.families, 4, args=(specs4,), device=device,
                    timeout=900.0)[0]
    log(f"[sharded4] 4 ranks: {len(w4)} families in "
        f"{time.perf_counter() - t0:.1f} s")
    # world 1 at the dry run's design points, with the central differences
    x_nf = np.full(dry["grad"].shape, 0.95)  # the train step's x0
    p_nf = np.random.default_rng(7).uniform(size=x_nf.shape)
    p_crm = np.random.default_rng(7).uniform(size=dry["crm_x0"].shape)
    dry1 = [("nf", DRYRUN_NF, dict(x0=x_nf, pert=p_nf, h=1e-6)),
            ("crm", DRYRUN_CRM, dict(x0=dry["crm_x0"], pert=p_crm, h=1e-6))]
    w1 = runs.families(axis, dry1 + specs1)
    for (fam, _, opts), r1, bar, key in zip(dry1, w1, (1e-6, 1e-5),
                                            ("", "crm_")):
        nf = fam == "nf"
        g4 = dry[key + "grad"]
        r4 = {"value": dry["objective"] if nf else dry["crm"], "grad": g4,
              "directional": float(opts["pert"] @ g4),
              "n_padded": r1["n_padded"], "backend": dry["backend"],
              "staged": dry["staged"], "launches": dry["launches"] if nf
              else {}, "timing": f"value and gradient {dry[fam + '_s']:.3f} s"}
        held4(f"dry run {fam}", r4, r1, bar, fd=r1["fd"])
    for (fam, _, bar), r4, r1 in zip(families, w4, w1[len(dry1):]):
        r4 = dict(r4, timing=f"value {r4['value_s']:.3f} s  gradient "
                             f"{r4['grad_s']:.3f} s")
        held4(fam, r4, r1, bar)
    if torch.device(device).type == "cuda":
        check(min(dry["launches"].values()) > 0,
              "[sharded4] the NF path did not launch both kernels")
    return dry["launches"]


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
    if sys.argv[1:] == ["surface"]:
        # [surface] alone, on the operators and factor of the model at x0
        with torch.no_grad():
            A, B = topo.problem.assemble(element_density_of(topo))
            fac = topo.problem.factor(A, B, topo.sigma, "normal")
        phase("surface", phase_surface, gpu, topo, (A, B, fac),
              torch.Generator().manual_seed(11))
        log(f"[total] {time.perf_counter() - t_start:.1f} s")
        return 0
    gen = torch.Generator().manual_seed(0)
    timed, ragged = random_stencils(gen)
    s263, ops263 = phase("stencils", phase_stencils, topo, (1, 16),
                         (1, 16), (1, 6, 16), gen, timed)
    phase("ragged", phase_ragged, ragged, gen)
    host = phase("K1 host", phase_host)
    probe_rows, probe_launches = phase("probes", phase_probes)
    phase("on/off", phase_on_off)
    l263, val_main, proj_main = phase("main", phase_main, topo, gpu)
    lsf = phase("surface", phase_surface, gpu, topo, ops263,
                torch.Generator().manual_seed(11))
    del ops263
    lmf = phase("minfreq", phase_minfreq, topo, gpu)
    lme = phase("measure", phase_measure, topo, gpu)
    del topo
    gc.collect()
    torch.cuda.empty_cache()
    phase("dense", phase_dense, gpu)
    phase("examples", phase_examples, gpu)
    l1m, s1m = phase("1m", phase_1m, gpu, gen)
    gc.collect()
    torch.cuda.empty_cache()
    lth, sth, lam_mg, proj_mg, keep = phase("thermal1m", phase_thermal1m,
                                            gpu, gen)
    ldl = phase("thermal-dl", phase_thermal_dl, gpu, keep)
    del keep
    # the mg model's memory is back before the block factor's peak
    gc.collect()
    torch.cuda.empty_cache()
    phase("thermal-bcr", phase_thermal_bcr, gpu, lam_mg, proj_mg)
    gc.collect()
    torch.cuda.empty_cache()
    phase("nf-bcr", phase_nf_bcr, gpu, val_main, proj_main)
    gc.collect()
    torch.cuda.empty_cache()
    lbk, sbk = phase("buckle", phase_buckle, gpu, gen)
    gc.collect()
    torch.cuda.empty_cache()
    phase("crm", phase_crm, gpu)
    gc.collect()
    torch.cuda.empty_cache()
    phase("crm1m", phase_crm1m, gpu)
    gc.collect()
    torch.cuda.empty_cache()
    from eigd_tpu_torch.parallel import launch

    with launch.local_axis() as axis:
        lsh1, ssh1 = phase("sharded1", phase_sharded1, gpu, gen, axis)
        gc.collect()
        torch.cuda.empty_cache()
        lsh4 = phase("sharded4", phase_sharded4, gpu, axis)
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
                                       "surface": lsf["K1"],
                                       "minfreq": lmf["K1"],
                                       "thermal1m": lth["K1"],
                                       "measure": lme["K1"],
                                       **{f"thermal-dl {p}": v["K1"]
                                          for p, v in ldl.items()},
                                       "sharded1": lsh1["K1"],
                                       "sharded4 rank 0": lsh4["K1"]},
                     at_1m={k: s1m["K1 1025x513 ndof 2 k 8"][k] for k in at},
                     at_thermal1m=[{"name": r["name"], **{k: r[k] for k in at}}
                                   for n, r in sth.items()
                                   if n.startswith("K1")],
                     host_us_per_call=host,
                     at_sharded1=[{"name": r["name"], **{k: r[k] for k in at}}
                                  for r in ssh1
                                  if r["name"].startswith("K1")]),
        kernel_entry("K2 f64 9-point block-stencil matvec (513x257, ndof 2, "
                     "k 16)", "eigd_tpu_torch/csrc/stencil.cu",
                     "eigd_tpu/ops/pallas_stencil.py:299", l1m["K2"],
                     s263["K2 513x257 ndof 2 k 16"],
                     launches_by_path={"263k": l263["K2"], "1m": l1m["K2"],
                                       "surface": lsf["K2"],
                                       "minfreq": lmf["K2"],
                                       "thermal1m": lth["K2"],
                                       "measure": lme["K2"],
                                       **{f"thermal-dl {p}": v["K2"]
                                          for p, v in ldl.items()},
                                       "buckle": lbk["K2"],
                                       "sharded1": lsh1["K2"],
                                       "sharded4 rank 0": lsh4["K2"]},
                     at_1m={k: s1m["K2 1025x513 ndof 2 k 6"][k] for k in at},
                     at_thermal1m=[{"name": r["name"], **{k: r[k] for k in at}}
                                   for n, r in sth.items()
                                   if n.startswith("K2")],
                     at_buckle=[{"name": r["name"], **{k: r[k] for k in at}}
                                for r in sbk.values()],
                     at_sharded1=[{"name": r["name"], **{k: r[k] for k in at}}
                                  for r in ssh1
                                  if r["name"].startswith("K2")]),
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
