"""Wingbox (CRM) example: modal solve, modal compliance and its
thickness gradient against a central difference, the counterpart of
``examples/crm.py``.

    python -m eigd_tpu_torch.examples.crm [small] [plot] [--device cuda|cpu]
"""

import numpy as np
import torch

from . import split_device


def main(argv=None):
    """Returns a dict: the frequencies (Hz), the modal compliance, and the
    gradient along a uniform direction (ans) beside its central difference
    (fd) and their relative gap (fd_err)."""
    from ..models.crm import CRM

    device, argv = split_device(argv)
    if "small" in argv:
        model = CRM(nspan=6, nchord=3, nheight=2, N=6, m=40, nribs=2,
                    device=device)
    else:
        model = CRM(nspan=64, nchord=10, nheight=4, N=6, m=60, device=device)
    print(f"wingbox: {model.nnodes} nodes, {6 * model.nnodes} DOF "
          f"({model.nb} stations x {model.b} padded block)")
    model.initialize(store=True)
    freqs = model.profile["natural frequencies (Hz)"]
    print("natural frequencies (Hz):", [f"{f:.2f}" for f in freqs])
    data = {"frequencies": freqs,
            "compliance": float(model.get_modal_compliance())}
    print("modal compliance:", data["compliance"])

    model.initialize_adjoint()
    model.add_modal_compliance_derivative(1.0)
    model.finalize_adjoint()
    for name, g in zip(model.component_names, model.xb.tolist()):
        print(f"  d(compliance)/d(t_{name}) = {g:+.6e}")

    x0 = model.x
    pert = torch.as_tensor(np.random.default_rng(0).uniform(size=x0.shape),
                           device=x0.device)
    h = 1e-6 * float(x0[0])

    def val(x):
        model.x = x
        model.initialize()
        return float(model.get_modal_compliance())

    fd = (val(x0 + h * pert) - val(x0 - h * pert)) / (2 * h)
    model.x = x0
    ans = float(pert @ model.xb)
    data.update(ans=ans, fd=fd, fd_err=abs((ans - fd) / fd))
    print("%25s  %25s  %25s" % ("Answer", "FD", "FD Rel Error"))
    print("%25.15e  %25.15e  %25.15e" % (ans, fd, data["fd_err"]))

    if "plot" in argv:
        print("mode shapes written:", model.write_modes(nmodes=3))
    return data


if __name__ == "__main__":
    main()
