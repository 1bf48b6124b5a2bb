"""Plain reference of the ``ksagg`` objective of the buckling family: the
KS aggregate of the inverse load factors 1/lam at ``ks_rho`` plus the
tanh eigenvector aggregate at ``agg_rho`` over the y-DOFs of the loaded
nodes (``load_dofs``), as upstream ``examples/buckling.py`` evaluates
them.

The aggregate reads the modes normalised as the program's are,
phi^T K phi = 1, that is Phi / sqrt(lam) for the M-normalised pairs the
reference solves (M = -G); the seeds come from torch's autograd of this
small function (plain torch on the CPU, in the dtype of the inputs), so
they are on the M-normalised pairs that ``eig.adjoint_pairs`` takes.
"""

from __future__ import annotations

import numpy as np
import torch

LAM_B = 50.0  # the upper end of the tanh window of the aggregate's weights


def ks_max(v, rho):
    top = torch.max(v)
    return top + torch.log(torch.sum(torch.exp(rho * (v - top)))) / rho


def value(lam, Phi, rows, ks_rho, agg_rho):
    eta = torch.tanh(agg_rho * lam) - torch.tanh(agg_rho * (lam - LAM_B))
    eta = eta / torch.sum(eta)
    Q = Phi[rows] / torch.sqrt(lam)[None, :]
    return ks_max(1.0 / lam, ks_rho) + torch.sum(eta * torch.sum(Q**2, dim=0))


def reference(problem, lam, Phi, params):
    """(value, lamb, Phib) of the objective at the eigenpairs (numpy);
    Phi lives on ``problem.free``."""
    rows = np.searchsorted(problem.free, problem.aggregate_dofs)
    lt = torch.tensor(lam, requires_grad=True)
    Pt = torch.tensor(Phi, requires_grad=True)
    f = value(lt, Pt, torch.as_tensor(rows), params["ks_rho"],
              params["agg_rho"])
    lamb, Phib = torch.autograd.grad(f, (lt, Pt))
    return float(f.detach()), lamb.numpy(), Phib.numpy()
