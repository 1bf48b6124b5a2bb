"""``compliance`` on the program: the CRM modal compliance under the tip
load and its seeds, ``add_modal_compliance_derivative``."""

from torch.profiler import record_function


class Port:
    def __init__(self, model, params, config):
        del config
        self.model = model
        self.scale = params.get("scale", 1.0)

    def iterate(self):
        m = self.model
        with record_function("eigbench.initialize"):
            m.initialize()
        m.initialize_adjoint()
        with record_function("eigbench.seeds"):
            value = m.get_modal_compliance() * self.scale
            m.add_modal_compliance_derivative(self.scale)
        with record_function("eigbench.finalize_adjoint"):
            m.finalize_adjoint()
        return value
