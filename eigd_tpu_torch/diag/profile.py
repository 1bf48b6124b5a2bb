"""Where one warm value-and-gradient evaluation spends its time on the card.

Builds the named bench configurations (``configs.CONFIGS``: ``263k``,
``1m``), runs two unprofiled evaluations (a warm one and a timed one, host
clock around work that ends in ``torch.cuda.synchronize()``), then one
under ``torch.profiler`` with CPU and CUDA activities. It prints the wall
times, the device time by class of kernel and by kernel, and the
program's spans of the profiled evaluation (``ops.sync``: each span's
self and inclusive host time and entries, and the host's wait in each
decision site).

``tangent:<size>`` does the same for ``staged_jvp`` along the bench's
direction (``default_rng(7)``): two timed calls, then one profiled, with
the time of each of its stages (the ``staged_jvp.*`` and
``eigh_gen_tangent.*`` ranges) and the ops that hold the host longest.
The first call of forward-mode AD in a process imports ``torch._dynamo``
(PyTorch's Python decompositions that forward AD reaches are wrapped to
disable it, and import it at their first call); its cost alone is timed
in a fresh interpreter.
``triangular`` times the forms of ``lanczos.b_qr_tall``'s column solve on
the 1M-DOF block (1,051,650 x 8).
``minfreq:<size>`` runs ``MinFreqOpt``'s protocol (initialize,
initialize_adjoint, finalize_adjoint) three times after one warm
evaluation, as chip_smoke's ``[minfreq]`` does, the first
``finalize_adjoint`` under ``torch.profiler``: the wall time of each call,
and the host ops and kernels that hold the first one longest.

Run on a machine with a CUDA device, from the root of the repository:

    python -m eigd_tpu_torch.diag.profile 263k 1m tangent:1m triangular \
        minfreq:263k
"""

from __future__ import annotations

import collections
import subprocess
import sys
import time

import numpy as np
import torch

from ..fem.assembly import element_density
from ..models.natural_frequency import make_model
from ..ops import sync
from ..ops.autodiff import staged_jvp
from .common import card, cuda_time_ms, require_cuda
from .configs import CONFIGS, tail

CLASSES = (("K1", ("stencil_kernel<float",)),
           ("K2", ("stencil_kernel<double",)),
           ("GEMM", ("gemm", "gemv", "xmma", "cutlass", "dot_kernel")),
           ("copy/memset", ("Memcpy", "Memset", "CatArrayBatchedCopy",
                            "copy_kernel")),
           ("reduction", ("reduce", "Reduce")),
           ("elementwise", ("elementwise", "vectorized", "index_elementwise",
                            "where_kernel")))


def classify(name):
    for cls, keys in CLASSES:
        if any(k in name for k in keys):
            return cls
    return "other"


def kernel_rows(events):
    """The device rows of ``key_averages()``: kernels, copies and memsets,
    not the device side of a range (a span or a stage)."""
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation]


def evaluate(topo):
    """One value and gradient; returns (forward s, backward s)."""
    x = topo.x.clone().requires_grad_(True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lam, Q, _, _ = topo._solve_fn(x)
    v = tail(lam, Q)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    v.backward()
    torch.cuda.synchronize()
    return t1 - t0, time.perf_counter() - t1


def profile(size, top=12):
    topo = make_model(device="cuda", **CONFIGS[size]())
    evaluate(topo)  # warm
    fwd, bwd = evaluate(topo)
    print(f"[{size}] unprofiled evaluation: forward {fwd:.3f} s  backward "
          f"{bwd:.3f} s", flush=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    sync.clear()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        evaluate(topo)
        wall = time.perf_counter() - t0
    by_class = collections.Counter()
    launches = collections.Counter()
    kernels = []
    # device rows only: a CPU op's row repeats its kernels' time
    for e in kernel_rows(prof.key_averages()):
        dev_us = e.self_device_time_total
        cls = classify(e.key)
        by_class[cls] += dev_us
        launches[cls] += e.count
        kernels.append((dev_us, e.count, e.key))
    total_s = sum(by_class.values()) / 1e6
    print(f"[{size}] profiled evaluation {wall:.3f} s: device kernel time "
          f"{total_s * 1e3:.1f} ms in {sum(launches.values())} device "
          f"events")
    for cls, us in by_class.most_common():
        print(f"[{size}]   {cls}: {us / 1e3:.1f} ms "
              f"({us / 1e6 / total_s:.1%}), {launches[cls]} launches, "
              f"mean {us / launches[cls]:.1f} us")
    for us, count, key in sorted(kernels, reverse=True)[:top]:
        print(f"[{size}]   kernel {us / 1e3:.2f} ms x{count}: {key[:110]}")
    for name, s in sync.SELF_S.most_common():
        print(f"[{size}]   span {name}: self {s * 1e3:.1f} ms, inclusive "
              f"{sync.SPAN_S[name] * 1e3:.1f} ms, x{sync.SPAN_N[name]}")
    for site, s in sync.WAIT_S.most_common():
        print(f"[{size}]   wait {site}: {s * 1e3:.1f} ms in "
              f"{sync.HOST_SYNCS[site]} decisions")


def tangent(size, top=12):
    """Where ``staged_jvp``'s time goes, against one evaluation."""
    topo = make_model(device="cuda", **CONFIGS[size]())
    evaluate(topo)  # warm
    fwd, bwd = evaluate(topo)
    print(f"[tangent {size}] evaluation: forward {fwd:.3f} s  backward "
          f"{bwd:.3f} s", flush=True)

    def pre(x):
        return element_density(topo.fltr.apply(x), topo.conn)

    p = torch.as_tensor(np.random.default_rng(7).uniform(
        size=topo.x.shape), device=topo.x.device)
    fn = staged_jvp(pre, tail, topo.problem, topo.cfg)
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(topo.x, p)
        torch.cuda.synchronize()
        print(f"[tangent {size}] staged_jvp call {i + 1}: "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
    code = ("import time, torch; t0 = time.perf_counter(); "
            "import torch._dynamo; print(time.perf_counter() - t0)")
    t_import = float(subprocess.run([sys.executable, "-c", code],
                                    capture_output=True, text=True,
                                    check=True).stdout)
    print(f"[tangent {size}] import torch._dynamo in a fresh interpreter: "
          f"{t_import:.3f} s", flush=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn(topo.x, p)
        torch.cuda.synchronize()
    events = prof.key_averages()
    rows = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CPU]
    for e in rows:
        if e.key.startswith(("staged_jvp.", "eigh_gen_tangent.")):
            print(f"[tangent {size}]   stage {e.key}: host "
                  f"{e.cpu_time_total / 1e3:.1f} ms", flush=True)
    rows.sort(key=lambda e: e.self_cpu_time_total, reverse=True)
    for e in rows[:top]:
        print(f"[tangent {size}]   op {e.key[:60]}: self host "
              f"{e.self_cpu_time_total / 1e3:.1f} ms x{e.count}", flush=True)
    kernels = sorted(kernel_rows(events),
                     key=lambda e: e.self_device_time_total, reverse=True)
    for e in kernels[:top]:
        print(f"[tangent {size}]   kernel {e.key[:80]}: "
              f"{e.self_device_time_total / 1e3:.1f} ms x{e.count}",
              flush=True)


def minfreq(size, top=12):
    """Where the protocol's calls spend their time; the first
    finalize_adjoint profiled."""
    from ..models.natural_frequency import MinFreqOpt

    topo = make_model(device="cuda", **CONFIGS[size]())
    evaluate(topo)  # warm, as chip_smoke's [main]
    opt = MinFreqOpt(topo)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for i in range(3):
        opt.initialize()
        opt.initialize_adjoint()
        if i == 0:
            with torch.profiler.profile(activities=acts) as prof:
                opt.finalize_adjoint()
        else:
            opt.finalize_adjoint()
        print(f"[minfreq {size}] protocol {i + 1}: initialize "
              f"{topo.profile['eigenvalue solve time']:.3f} s  "
              f"finalize_adjoint {topo.profile['adjoint solution time']:.3f}"
              f" s{' (profiled)' if i == 0 else ''}", flush=True)
    events = prof.key_averages()
    rows = sorted((e for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    for e in rows[:top]:
        print(f"[minfreq {size}]   op {e.key[:60]}: self host "
              f"{e.self_cpu_time_total / 1e3:.1f} ms x{e.count}", flush=True)
    kernels = sorted(kernel_rows(events),
                     key=lambda e: e.self_device_time_total, reverse=True)
    for e in kernels[:top]:
        print(f"[minfreq {size}]   kernel {e.key[:80]}: "
              f"{e.self_device_time_total / 1e3:.1f} ms x{e.count}",
              flush=True)


def triangular(n=1_051_650, p=8):
    """The column solve of ``b_qr_tall`` (X L^-T for an (n, p) block X
    and a p x p lower-triangular L) in each of its forms, by CUDA events."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float64, torch.float32):
        X = torch.randn((n, p), generator=gen, dtype=dtype, device="cuda")
        eye = torch.eye(p, dtype=dtype, device="cuda")
        L = torch.linalg.cholesky(X.T @ X / n + 0.1 * eye)
        solve = torch.linalg.solve_triangular
        forms = {
            "left, (p, n) transposed view": lambda: solve(
                L, X.T, upper=False).T,
            "left, (p, n) contiguous": lambda: solve(
                L, X.T.contiguous(), upper=False).T,
            "right, (n, p) as it is": lambda: solve(
                L.T, X, upper=True, left=False),
            "GEMM with the p x p inverse": lambda: X @ solve(
                L, eye, upper=False).T,
        }
        ref = forms["GEMM with the p x p inverse"]()
        for name, f in forms.items():
            err = float((f() - ref).abs().max() / ref.abs().max())
            ms = cuda_time_ms(f, warmup=1, iters=2)
            print(f"[triangular {n}x{p} {str(dtype)[6:]}] {name}: {ms:.3f} "
                  f"ms  rel diff to the GEMM form {err:.1e}", flush=True)


def main(argv=None):
    what = (argv if argv is not None else sys.argv[1:]) or ["263k"]
    require_cuda()
    print(card())
    for w in what:
        if w == "triangular":
            triangular()
        elif w.startswith("tangent:"):
            tangent(w.split(":", 1)[1])
        elif w.startswith("minfreq:"):
            minfreq(w.split(":", 1)[1])
        else:
            profile(w)


if __name__ == "__main__":
    main()
