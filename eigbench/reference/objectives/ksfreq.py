"""Plain reference of the ``ksfreq`` objective: the KS-min of the N
natural frequencies omega = sqrt(lam), with ``ks_param`` from the traffic
file. It depends on the eigenvalues alone, so its vector seed is zero."""

from __future__ import annotations

import numpy as np
import torch

from .minfreq import ks_min


def value(lam, ks_param):
    return ks_min(torch.sqrt(lam), ks_param)


def reference(problem, lam, Phi, params):
    del problem
    lt = torch.tensor(lam, requires_grad=True)
    f = value(lt, params["ks_param"])
    (lamb,) = torch.autograd.grad(f, lt)
    return float(f.detach()), lamb.numpy(), np.zeros_like(Phi)
