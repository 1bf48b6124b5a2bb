"""Plain reference of the ``compliance`` objective: the CRM modal
compliance sum_i (phi_i . f)^2 / lam_i under the tip load f of the
reference model (``problem.load``), times ``scale``."""

from __future__ import annotations


def reference(problem, lam, Phi, params):
    s = params.get("scale", 1.0)
    f = problem.load
    a = Phi.T @ f
    value = s * float((a**2 / lam).sum())
    lamb = -s * a**2 / lam**2
    Phib = s * 2.0 * f[:, None] * (a / lam)[None, :]
    return value, lamb, Phib
