"""Thermal example: the repeated-eigenvalue epsilon sweep, or the
transient KS gradient against a central difference, the counterpart of
``examples/thermal.py``.

    python -m eigd_tpu_torch.examples.thermal [sweep|transient] \
        [mg|bcr_f32] [--device cuda|cpu]
"""

import numpy as np
import torch

from . import split_device


def run_sweep(device):
    """Domain-asymmetry sweep, distinct to numerically repeated
    eigenvalues: for each epsilon the eigenvalues and the norm of the
    eigenvector aggregate's gradient."""
    from ..models.thermal import make_opt_model

    out = []
    for epsilon in (0.1, 1e-6, 1e-8):
        print(f"\n=== epsilon = {epsilon} ===")
        np.random.seed(2)
        topo = make_opt_model(nx=16, epsilon=epsilon, N=5, Ntarget=5,
                              device=device)
        topo.initialize(store=True)
        lam = topo.lam[:topo.N].tolist()
        print("eigenvalues:", lam)
        topo.initialize_adjoint()
        topo.add_eigenvector_aggregate_derivative(1.0, 2.0, [7, 31])
        topo.finalize_adjoint()
        xb_norm = float(torch.linalg.norm(topo.xb))
        print("||xb|| =", xb_norm)
        out.append({"epsilon": epsilon, "lam": lam, "xb_norm": xb_norm})
    return out


def run_transient(device, argv):
    """``ThermalOpt.test_ks_func`` on the 16x16 model: 100 Crank-Nicolson
    steps to t = 2 of the heat 1 + 0.5 sin(4t) on the center set."""
    from ..models.thermal import ThermalOpt, make_model

    np.random.seed(0)
    factor_kind = "dense"
    for cand in ("mg", "bcr_f32"):
        if cand in argv:
            factor_kind = cand
            break
    topo = make_model(nx=16, ny=16, Ly=1.1, N=6, factor_kind=factor_kind,
                      device=device)
    heat = {"case": {"center": lambda t: 1.0 + 0.5 * torch.sin(4.0 * t)}}
    opt = ThermalOpt(topo, heat, nsteps=100, tfinal=2.0)
    return opt.test_ks_func(rho_ks=10.0)


def main(argv=None):
    """Returns ``test_ks_func``'s dict (transient) or the sweep's list."""
    device, argv = split_device(argv)
    if "transient" in argv:
        return run_transient(device, argv)
    return run_sweep(device)


if __name__ == "__main__":
    main()
