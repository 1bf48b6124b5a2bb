"""Entry points of the port: a forward step on one device and a multi-rank
training-step dry run.

Counterpart of the repository's ``__graft_entry__.py`` (which stays the
JAX package's). ``entry`` builds the 32x16 natural-frequency model and
returns its forward function with the design point; ``dryrun_multichip``
runs one training step of the sharded natural-frequency objective on the
line-sharded multigrid factor and the station-sharded CRM wingbox on
``n_devices`` ranks (``parallel.launch``) and prints the two lines JAX's
dry run prints.

Both run on the card unless the caller asks for the CPU: with no CUDA
device and ``device`` left at "cuda" they fail, and do not carry on on the
CPU.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def entry(device="cuda"):
    """Forward step of the flagship model: natural-frequency topology
    analysis (filter -> FE assembly -> shift-invert Lanczos) on the 32x16
    grid. Returns (forward, (x0,)) with forward(x) -> (lam, Phi)."""
    from .models.natural_frequency import make_model
    from .parallel.launch import require

    require(device)
    topo = make_model(nx=32, ny=16, Lx=2.0, Ly=1.0, N=6, rfact=2.0,
                      device=device)
    x0 = topo.x.detach().clone()

    def forward(x):
        lam, Phi, _, _ = topo._solve_fn(x)
        return lam, Phi

    return forward, (x0,)


# the dry run's two families: the NF train step on the line-sharded
# multigrid factor and the station-sharded CRM wingbox. The NF adjoint runs
# 40 SIBK steps: at JAX's default 16 it stops short, and the gradients of
# world 1 and 4 differ by 2.5e-7 max-scaled (6e-13 at 40) on the CPU.
DRYRUN_NF = dict(nx=64, ny=32, factor="mg", N=3, m=36, adjoint_maxiter=40)
DRYRUN_CRM = dict(nspan=8, nchord=4, nheight=2, N=3, m=36)


def dryrun_rank(axis):
    """The dry run on one rank: the sharded NF train step (``DRYRUN_NF``,
    from x0 = 0.95) with its K1/K2 launches, and the CRM objective's value
    and gradient at its design point (``DRYRUN_CRM``), each timed."""
    from .ops import cuda_stencil as cs
    from .parallel.sharded import (make_sharded_crm_objective,
                                   sharded_train_step)

    def clock():
        if axis.device.type == "cuda":
            torch.cuda.synchronize(axis.device)
        return time.perf_counter()

    k1, k2 = cs.K1_LAUNCHES, cs.K2_LAUNCHES
    t0 = clock()
    x1, val, g = sharded_train_step(axis, **DRYRUN_NF)
    t1 = clock()
    launches = {"K1": cs.K1_LAUNCHES - k1, "K2": cs.K2_LAUNCHES - k2}
    obj, crm, _, _ = make_sharded_crm_objective(axis, **DRYRUN_CRM)
    t = crm.x.detach().clone().requires_grad_(True)
    t2 = clock()
    v = obj(t)
    (cg,) = torch.autograd.grad(v, t)
    t3 = clock()
    return {"objective": float(val), "x1": x1, "grad": g,
            "launches": launches, "nf_s": t1 - t0, "crm": float(v.detach()),
            "crm_grad": cg, "crm_x0": crm.x.detach(), "crm_s": t3 - t2,
            "backend": axis.backend, "staged": axis.staged}


def dryrun_multichip(n_devices: int, device="cuda", timeout=900.0):
    """One training step of the sharded NF objective and the CRM wingbox's
    value and gradient on ``n_devices`` ranks on ``device`` (ranks share a
    card through gloo where there are fewer cards than ranks); prints the
    two lines of JAX's dry run and returns rank 0's results."""
    from .parallel import launch

    out = launch.run(dryrun_rank, n_devices, device=device,
                     timeout=timeout)[0]
    if not (np.isfinite(out["objective"]) and np.all(np.isfinite(out["x1"]))):
        raise RuntimeError(f"sharded NF step not finite: {out['objective']}")
    print(f"dryrun_multichip({n_devices}): objective="
          f"{out['objective']:.6f} (sharded-mg factor) ok")
    if not (np.isfinite(out["crm"])
            and np.all(np.isfinite(out["crm_grad"]))):
        raise RuntimeError(f"sharded CRM not finite: {out['crm']}")
    print(f"dryrun_multichip({n_devices}): crm objective={out['crm']:.3e} "
          "(station-sharded wingbox) ok")
    return out
