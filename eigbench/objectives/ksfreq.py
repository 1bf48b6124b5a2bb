"""``ksfreq`` on the program: the KS-min of the natural frequencies,
seeded into the eigenvalues alone through ``add_frequency_derivatives``,
so the eigenvector seed is zero and the adjoint solve has no right-hand
side."""

import torch
from torch.profiler import record_function

from ..reference.objectives.ksfreq import value


class Port:
    def __init__(self, model, params, config):
        del config
        self.model = model
        self.ks = params["ks_param"]

    def iterate(self):
        m = self.model
        with record_function("eigbench.initialize"):
            m.initialize()
        m.initialize_adjoint()
        with record_function("eigbench.seeds"), torch.enable_grad():
            omega = torch.sqrt(m.lam).requires_grad_(True)
            f = value(omega**2, self.ks)
            (omegab,) = torch.autograd.grad(f, omega)
            m.add_frequency_derivatives(omegab)
        with record_function("eigbench.finalize_adjoint"):
            m.finalize_adjoint()
        return f.detach()
