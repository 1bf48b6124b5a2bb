"""Buckling example: the load factors and the KS-of-1/BLF gradient
against a central difference, the counterpart of ``examples/buckling.py``.

    python -m eigd_tpu_torch.examples.buckling [sibk|laa|pgmres|pcpg] \
        [--device cuda|cpu]
"""

import numpy as np
import torch

from . import split_device


def main(argv=None):
    """Returns a dict: the load factors, the compliance, and the KS
    gradient along a uniform direction (ans) beside its central difference
    (fd) and their relative gap (fd_err)."""
    from ..models.buckling import first_blf, make_buckling_model

    device, argv = split_device(argv)
    method = "sibk"
    for cand in ("sibk", "laa", "pgmres", "pcpg"):
        if cand in argv:
            method = cand

    # the shift sits below BLF_1, located on a 2x coarser mesh by a dense
    # eigensolve (BLF_1 is mesh-stable to ~1% here; 0.8 adds margin)
    blf1 = first_blf(make_buckling_model(nx=12, ny=6, N=4, sigma=1.0,
                                         device=device))
    sigma = 0.8 * blf1
    print("coarse-mesh BLF_1 estimate:", blf1, " sigma:", sigma)

    topo = make_buckling_model(nx=24, ny=12, N=4, sigma=sigma,
                               adjoint_method=method, device=device)
    topo.initialize(store=True)
    data = {"BLF": topo.BLF.tolist(), "compliance": float(topo.compliance())}
    print("BLFs:", data["BLF"])
    print("compliance:", data["compliance"])

    g = topo.eval_ks_buckling_derivative(ks_rho=100.0)
    x0 = topo.x
    pert = torch.as_tensor(np.random.default_rng(0).uniform(size=x0.shape),
                           device=x0.device)
    h = 1e-6

    def val(x):
        topo.x = x
        topo.initialize()
        return float(topo.eval_ks_buckling(ks_rho=100.0))

    fd = (val(x0 + h * pert) - val(x0 - h * pert)) / (2 * h)
    topo.x = x0
    ans = float(pert @ g)
    data.update(ans=ans, fd=fd, fd_err=abs((ans - fd) / fd))
    print("%25s  %25s  %25s" % ("Answer", "FD", "FD Rel Error"))
    print("%25.15e  %25.15e  %25.15e" % (ans, fd, data["fd_err"]))
    return data


if __name__ == "__main__":
    main()
