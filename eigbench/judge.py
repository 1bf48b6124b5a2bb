"""The check that decides ``correct``: the plain reference at the judged
design, and the numbers compared with it.

The reference (``reference/<family>.py`` and
``reference/objectives/<objective>.py``) imports nothing of the program
and takes nothing it made: it builds the model again from the
configuration's keywords and the design x that the benchmark generated,
and works out the eigenpairs, the objective and its total derivative in
the design itself. The numbers compared:

* ``lam_rel``: the largest relative gap of the N eigenvalues;
  a family whose ``Problem`` declares ``null_modes = z`` (the count of
  leading modes whose exact eigenvalue is 0 and which the program still
  returns, as the constant field of a pure-Neumann pencil) has the gap of
  each of those modes divided by ``|lam_z|``, the first eigenvalue above
  the null space, and not by its own: both sides return such a mode's
  eigenvalue as rounding, whose ratio says nothing (about 1e2, or inf
  where the reference's is exactly 0). So the null modes are judged on the
  spectrum's scale, and the other modes as before;
* ``value_rel``: the relative gap of the objective;
* ``grad_rel``: the 2-norm of the gradient's gap over the reference
  gradient's 2-norm.
"""

from __future__ import annotations

import importlib
import subprocess
import time

import numpy as np

from .reference import eig


def reference(config, traffic, x, dtype=np.float64):
    """{value, lam, xb, seconds} of the reference at design x, computed in
    ``dtype`` (float32 is the control)."""
    t0 = time.perf_counter()
    fam = importlib.import_module(f"eigbench.reference.{config['family']}")
    obj = importlib.import_module(
        f"eigbench.reference.objectives.{traffic['objective']}")
    params = dict(traffic.get("params", {}))
    problem = fam.Problem(config["model"])
    lam, Phi, K, M = problem.solve(x, dtype)
    value, lamb, Phib = obj.reference(problem, lam, Phi, params)
    UK, UM = eig.adjoint_pairs(K, M, lam, Phi, lamb.astype(dtype),
                               Phib.astype(dtype), dtype)
    xb = problem.gradient(UK, UM, Phi)
    return {"value": float(value), "lam": np.asarray(lam, np.float64),
            "next_lam": float(problem.next_lam),
            "null_modes": int(getattr(problem, "null_modes", 0)),
            "xb": np.asarray(xb, np.float64),
            "seconds": time.perf_counter() - t0}


def compare(ref, value, lam, xb, limits):
    """{name: {"value", "limit"}} of the numbers compared. A ``ref``
    without ``null_modes`` has none."""
    scale = np.abs(ref["lam"])
    z = ref.get("null_modes", 0)
    scale[:z] = scale[z]
    gaps = {
        "lam_rel": float(np.max(np.abs(lam - ref["lam"]) / scale)),
        "value_rel": abs(value - ref["value"]) / abs(ref["value"]),
        "grad_rel": float(np.linalg.norm(xb - ref["xb"])
                          / np.linalg.norm(ref["xb"])),
    }
    return {k: {"value": v, "limit": limits[k]} for k, v in gaps.items()}


def card():
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"
