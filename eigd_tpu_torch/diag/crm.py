"""The CRM wingbox's modal-compliance protocol at a configuration of
``diag/configs.py``, one pass cold and one warm.

Counterpart of ``scripts/run_crm_large.py`` and
``scripts/probe_crm_chunked.py`` without the SciPy baseline (ROADMAP item
10). For each pass: the build, factor, ``initialize`` and
``finalize_adjoint`` times, the host waits by ``ops/sync.py`` site, loop
exits and steps, the peak of device memory, the approx applies (each a
truncated f32 PCG on the element operator, whose f32 copy ``PCGFactor``
casts once a factor) and the true pencil residuals; then freq[0] and the
forward-mode ``objective_jvp`` against ``p @ xb``. On a machine with a
CUDA device, from the root of the repository:

    python -m eigd_tpu_torch.diag.crm --config 86k 1m

``--set KEY=VALUE`` replaces CRM keywords of the configuration (e.g.
``factor_kind='bcr'``), ``--fd`` adds the central-difference check of
``xb`` (``fd_check``), ``--jitters`` measures the factor alone
(``factor_sweep``) in place of the protocol, and ``--device cpu`` runs on
the CPU, where the times are the CPU's.
"""

from __future__ import annotations

import argparse
import ast
import collections
import dataclasses
import time

import numpy as np
import torch

from eigd_tpu_torch.diag.common import card, require_cuda
from eigd_tpu_torch.diag.configs import CRM_CONFIGS
from eigd_tpu_torch.models.crm import CRM
from eigd_tpu_torch.ops import sync
from eigd_tpu_torch.ops.autodiff import kept_forward


def log(*a):
    print(*a, flush=True)


def sync_device(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def build(config, device="cuda", **over):
    """The CRM of ``config`` (a name of ``CRM_CONFIGS`` or a keyword dict)
    with its factor builds timed: each appends (seconds, stored GiB) to
    ``crm.factor_builds``. Returns (crm, build seconds)."""
    kw = dict(CRM_CONFIGS[config]() if isinstance(config, str) else config)
    kw.update(over)
    t0 = time.perf_counter()
    crm = CRM(device=device, **kw)
    t_build = time.perf_counter() - t0
    # the closure holds the list, not the model: the solve's graph holds
    # the problem, and a model inside it would be a cycle gc cannot see
    builds = crm.factor_builds = []
    inner_factor = crm.problem.factor

    def timed(*args):
        sync_device(device)
        t0 = time.perf_counter()
        f = inner_factor(*args)
        sync_device(device)
        inner = getattr(f, "inner", f)
        builds.append((time.perf_counter() - t0,
                       getattr(inner, "nbytes", 0) / 2**30))
        return f

    crm.problem = dataclasses.replace(crm.problem, factor=timed)
    return crm, t_build


def pencil_residuals(crm):
    """||K phi - lam M phi|| / ||K phi|| of the solved modes, on the held
    graph's operators."""
    A, B, _, _ = kept_forward(crm._graph[1])
    with torch.no_grad():
        AQ = A.mv(crm.Qr)
        R = AQ - B.mv(crm.Qr) * crm.lam[None, :]
        return (torch.linalg.norm(R, dim=0)
                / torch.linalg.norm(AQ, dim=0)).cpu().numpy()


def protocol_pass(crm, tag):
    """initialize, initialize_adjoint, add_modal_compliance_derivative(1.0)
    and finalize_adjoint, with what the module docstring lists printed
    under ``tag``. Returns a dict of the pass's numbers."""
    dev = crm.device
    sync.clear()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    crm.factor_builds.clear()
    crm.initialize()
    fwd = collections.Counter(sync.HOST_SYNCS)
    fwd_exits = collections.Counter(sync.LOOP_EXITS)
    crm.initialize_adjoint()
    crm.add_modal_compliance_derivative(1.0)
    crm.finalize_adjoint()
    out = {"initialize": crm.profile["eigenvalue solve time"],
           "finalize_adjoint": crm.profile["adjoint solution time"],
           "factor": list(crm.factor_builds),
           "peak": (torch.cuda.max_memory_allocated() / 2**30
                    if dev.type == "cuda" else float("nan")),
           "syncs_fwd": dict(fwd), "syncs_adj": dict(sync.HOST_SYNCS - fwd),
           "exits": dict(sync.LOOP_EXITS), "steps": dict(sync.LOOP_STEPS),
           "freq0": crm.profile["natural frequencies (Hz)"][0],
           "residuals": pencil_residuals(crm)}
    def approx_applies(exits):
        return sum(v for k, v in exits.items()
                   if k.startswith("pcg_factor_f32"))

    mats_gib = crm.dofs.shape[0] * 24 * 24 * 4 / 2**30
    log(f"[{tag}] initialize {out['initialize']:.3f} s  finalize_adjoint "
        f"{out['finalize_adjoint']:.3f} s  factor builds (s, stored GiB) "
        f"{[(round(t, 3), round(g, 3)) for t, g in out['factor']]}  peak "
        f"{out['peak']:.3f} GiB")
    log(f"[{tag}] host waits by site: initialize {out['syncs_fwd']}  "
        f"finalize_adjoint {out['syncs_adj']}")
    log(f"[{tag}] loop exits {out['exits']}  steps {out['steps']}")
    log(f"[{tag}] approx applies {approx_applies(sync.LOOP_EXITS)} "
        f"(initialize {approx_applies(fwd_exits)}); uncached, each would "
        f"cast {mats_gib:.3f} GiB of f32 element matrices anew")
    log(f"[{tag}] freq[0] {out['freq0']!r} Hz  lam {crm.lam.tolist()}  "
        f"pencil residuals {out['residuals'].tolist()}")
    return out


def jvp_check(crm, tag, seed=3):
    """objective_jvp along a uniform p (numpy default_rng(seed)) against
    p @ xb of the last pass; returns (relative gap, vjp, jvp, seconds)."""
    p = np.random.default_rng(seed).uniform(size=crm.ncomp)
    ans = float(torch.as_tensor(p, device=crm.device) @ crm.xb)
    sync.clear()
    dv = crm.objective_jvp(p)
    t = crm.profile["tangent solution time"]
    rel = abs(ans - dv) / abs(dv)
    log(f"[{tag}] jvp-vs-vjp: vjp {ans!r} jvp {dv!r} rel {rel:.3e}; "
        f"objective_jvp {t:.3f} s, host waits {dict(sync.HOST_SYNCS)}")
    return rel, ans, dv, t


def factor_sweep(crm, tag, jitters, k=8, maxiter=2000):
    """The factor of K at x (sigma 0) for each BCR jitter of the f32 path
    and for the f64 ``bcr`` factor: build seconds and stored GiB, then one
    accurate PCG solve (tol ``factor_tol``, at most ``maxiter`` steps) and
    one approx solve of the same random masked block of k columns, each
    with its steps and true relative residual (the f64 factor: one
    apply)."""
    dev = crm.device
    with torch.no_grad():
        A, B = crm._assemble(crm.x)
        g = torch.Generator().manual_seed(7)
        rhs = (torch.rand((crm.nvars, k), generator=g, dtype=torch.float64)
               .to(dev) - 0.5) * crm.free_mask[:, None]
        kind, jit0 = crm.factor_kind, crm.factor_jitter

        def true_res(y):
            r = rhs - (A.mv(y) + (1.0 - crm.free_mask)[:, None] * y)
            return float((torch.linalg.norm(r, dim=0)
                          / torch.linalg.norm(rhs, dim=0)).max())

        def timed(fn):
            sync_device(dev)
            t0 = time.perf_counter()
            out = fn()
            sync_device(dev)
            return out, time.perf_counter() - t0

        try:
            for jitter in list(jitters) + ["f64"]:
                crm.factor_kind = "bcr" if jitter == "f64" else "bcr_f32"
                crm.factor_jitter = 0.0 if jitter == "f64" else jitter
                fac, t_b = timed(lambda: crm._factor(A, B, 0.0, "normal"))
                inner = getattr(fac, "inner", fac)
                head = (f"[{tag} factor {jitter}] built {t_b:.3f} s, stores "
                        f"{inner.nbytes / 2**30:.3f} GiB")
                if jitter == "f64":
                    y, t_s = timed(lambda: fac.mv(rhs))
                    log(f"{head}; one apply {t_s:.3f} s, residual "
                        f"{true_res(y):.3e}")
                    continue
                fac.maxiter = maxiter
                sync.clear()
                (y, info), t_s = timed(lambda: fac.mv_info(rhs))
                steps = dict(sync.LOOP_STEPS)
                sync.clear()
                ya, t_a = timed(lambda: fac.approx_mv(rhs))
                log(f"{head}; PCG {steps} steps, exits "
                    f"{dict(sync.LOOP_EXITS)} for the approx solve; "
                    f"accurate {t_s:.3f} s residual {true_res(y):.3e}, "
                    f"approx {dict(sync.LOOP_STEPS)} steps {t_a:.3f} s "
                    f"residual {true_res(ya.double()):.3e}")
        finally:
            crm.factor_kind, crm.factor_jitter = kind, jit0


def fd_check(crm, tag, seed=1, rel_h=1e-6):
    """xb of the last pass along p (default_rng(seed)) against central
    differences of the modal compliance at h = rel_h x0[0] and 2h, and
    their Richardson-4 combination. Returns (rel at h, rel of
    Richardson-4)."""
    p = torch.as_tensor(np.random.default_rng(seed).uniform(size=crm.ncomp),
                        device=crm.device)
    ans = float(p @ crm.xb)
    x0 = crm.x
    h = rel_h * float(x0[0])
    fd = {}
    for hh in (h, 2 * h):
        vals = []
        for sgn in (1.0, -1.0):
            crm.x = x0 + sgn * hh * p
            crm.initialize()
            vals.append(float(crm.get_modal_compliance()))
        fd[hh] = (vals[0] - vals[1]) / (2 * hh)
    crm.x = x0
    r4 = (4.0 * fd[h] - fd[2 * h]) / 3.0
    rel, rel4 = abs(ans - fd[h]) / abs(fd[h]), abs(ans - r4) / abs(r4)
    log(f"[{tag}] FD check: adjoint {ans!r} central (h {h:g}) {fd[h]!r} rel "
        f"{rel:.3e}; h {2 * h:g}: rel "
        f"{abs(ans - fd[2 * h]) / abs(fd[2 * h]):.3e}; richardson-4 {r4!r} "
        f"rel {rel4:.3e}")
    return rel, rel4


def describe(crm, tag, t_build):
    log(f"[{tag}] nvars {crm.nvars}  nb {crm.nb}  b {crm.b}  nnodes "
        f"{crm.nnodes}  nelems {crm.profile['nelems']}  factor "
        f"{crm.factor_kind}  block {crm.cfg.block}  m {crm.cfg.m}  sweep "
        f"{crm.cfg.lanczos_sweep}  polish {crm.cfg.polish}; built in "
        f"{t_build:.2f} s")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", nargs="+", default=["86k"],
                    choices=sorted(CRM_CONFIGS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                    help="CRM keywords over the configuration's (Python "
                    "literals), e.g. factor_kind='bcr'")
    ap.add_argument("--fd", action="store_true",
                    help="after the passes, the central-difference check")
    ap.add_argument("--jitters", nargs="*", type=float, default=None,
                    help="in place of the protocol: the factor at each "
                    "BCR jitter and in f64 (factor_sweep)")
    args = ap.parse_args(argv)
    over = {k: ast.literal_eval(v)
            for k, v in (kv.split("=", 1) for kv in args.set)}
    if args.device == "cuda":
        require_cuda()
        log(card())
    for name in args.config:
        tag = f"crm {name}"
        crm, t_build = build(name, args.device, **over)
        describe(crm, tag, t_build)
        if args.jitters is not None:
            factor_sweep(crm, tag, args.jitters)
            continue
        for run in ("cold", "warm"):
            t0 = time.perf_counter()
            protocol_pass(crm, f"{tag} {run}")
            log(f"[{tag} {run}] pass {time.perf_counter() - t0:.3f} s")
        jvp_check(crm, tag)
        if args.fd:
            fd_check(crm, tag)
        del crm
        if args.device == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
