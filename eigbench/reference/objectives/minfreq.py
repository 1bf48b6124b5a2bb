"""Plain reference of the ``minfreq`` objective: the upstream
``MinFreqOpt`` KS-min frequency of the structure with parasitic point
masses (Li and Kennedy, SMO 68:4, 2024).

For each point-mass node set S the mean modal displacements c (2, N) over
S give the reduced pencil (diag(omega^2), I + m c^T c); its frequencies are
KS-aggregated towards their minimum with ``ks_param``, and so are the
sets' values. The seeds come from torch's autograd of this small function
(plain torch on the CPU, in the dtype of the inputs).
"""

from __future__ import annotations

import numpy as np
import torch


def ks_min(v, ks):
    low = torch.min(v)
    return low - torch.log(torch.sum(torch.exp(-ks * (v - low)))) / ks


def value(lam, Phi, node_sets, ks_param, fixed_mass):
    omega = torch.sqrt(lam)
    N = omega.shape[0]
    eye = torch.eye(N, dtype=lam.dtype)
    vals = []
    for name in sorted(node_sets):
        nodes = torch.as_tensor(np.asarray(node_sets[name]), dtype=torch.long)
        c = torch.stack([Phi[2 * nodes].mean(dim=0),
                         Phi[2 * nodes + 1].mean(dim=0)])
        M0 = eye + fixed_mass * c.T @ c
        # the pencil (diag(omega^2), M0) as L^-1 diag(omega^2) L^-T
        Li = torch.linalg.inv(torch.linalg.cholesky(M0))
        A = Li @ torch.diag(omega**2) @ Li.T
        vals.append(ks_min(torch.sqrt(torch.linalg.eigvalsh(0.5 * (A + A.T))),
                           ks_param))
    return ks_min(torch.stack(vals), ks_param)


def reference(problem, lam, Phi, params):
    """(value, lamb, Phib) of the objective at the eigenpairs (numpy)."""
    lt = torch.tensor(lam, requires_grad=True)
    Pt = torch.tensor(Phi, requires_grad=True)
    f = value(lt, Pt, problem.node_sets, params["ks_param"],
              params["fixed_mass"])
    lamb, Phib = torch.autograd.grad(f, (lt, Pt))
    return float(f.detach()), lamb.numpy(), Phib.numpy()
