"""Plain reference of the ``ks`` objective of the thermal family: the
transient of upstream ``ThermalOpt`` (``examples/thermal.py``), as the
program has it.

Each element set's mean temperature is coef_s . xi(t) with coef_s =
Phi^T v_s (``problem.mean_vecs``, in sorted order) over all N + 4 modes,
mode 0 included. The modal ODE xi' + lam xi = q(t) runs on t = linspace(0,
tfinal, nsteps + 1) by Crank-Nicolson,

    (1/dt + lam/2) xi_k = (1/dt - lam/2) xi_{k-1} + q_k,  xi_0 = 0,

with q_k = sum_s heat_s(t_k-1/2) coef_s at the step's midpoint, and the
value is the KS maximum at ``ks_rho`` of the sets' mean temperatures at
steps 1 to nsteps - 1 (upstream's ``xi[:, 1:nsteps]``, the last step left
out). ``params``: ``ks_rho``, ``nsteps``, ``tfinal`` and ``heat``, a set
name to {"mean", "amp", "omega"} for heat_s(t) = mean + amp sin(omega t)
(upstream's example: 1 + 0.5 sin(4t) on ``center``, 100 steps to t = 2,
ks_rho 10). The seeds come from torch's autograd of this small function
(plain torch on the CPU, in the dtype of the inputs) in lam and the coef,
and Phib = sum_s v_s coefb_s.
"""

from __future__ import annotations

import numpy as np
import torch

from .ksagg import ks_max


def value(lam, coef, heat, nsteps, tfinal, ks_rho):
    """KS of the sets' mean temperatures; coef (sets, modes), heat
    (nsteps, sets) at the midpoints."""
    beta = 1.0 / (tfinal / nsteps)
    J = beta + 0.5 * lam
    q = heat @ coef
    xi = [torch.zeros_like(lam)]
    for k in range(nsteps):
        xi.append(((beta - 0.5 * lam) * xi[-1] + q[k]) / J)
    xi = torch.stack(xi, dim=1)
    return ks_max((coef @ xi[:, 1:nsteps]).reshape(-1), ks_rho)


def heat_table(names, params):
    """(nsteps, sets) heat of each set at the steps' midpoints."""
    nsteps = params["nsteps"]
    t = np.linspace(0.0, params["tfinal"], nsteps + 1)
    tmid = 0.5 * (t[1:] + t[:-1])
    H = np.zeros((nsteps, len(names)))
    for j, name in enumerate(names):
        h = params["heat"].get(name)
        if h is not None:
            H[:, j] = h["mean"] + h["amp"] * np.sin(h["omega"] * tmid)
    return H


def reference(problem, lam, Phi, params):
    """(value, lamb, Phib) of the objective at the eigenpairs (numpy)."""
    names = sorted(problem.mean_vecs)
    V = np.stack([problem.mean_vecs[s] for s in names], axis=1).astype(
        Phi.dtype)
    lt = torch.tensor(lam, requires_grad=True)
    ct = torch.tensor(V.T @ Phi, requires_grad=True)
    f = value(lt, ct, torch.tensor(heat_table(names, params), dtype=lt.dtype),
              params["nsteps"], params["tfinal"], params["ks_rho"])
    lamb, coefb = torch.autograd.grad(f, (lt, ct))
    return float(f.detach()), lamb.numpy(), V @ coefb.numpy()
