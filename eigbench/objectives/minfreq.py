"""``minfreq`` on the program: ``MinFreqOpt``'s protocol, whose seeds the
program works out itself (the KS-min frequency with point masses)."""

from torch.profiler import record_function


class Port:
    def __init__(self, model, params, config):
        from eigd_tpu_torch.models.natural_frequency import MinFreqOpt

        del config
        self.model = model
        self.opt = MinFreqOpt(model, ks_param=params["ks_param"],
                              fixed_mass=params["fixed_mass"])

    def iterate(self):
        """One value and gradient at ``model.x``: the value (a 0-d tensor);
        ``model.lam`` and ``model.xb`` hold the rest."""
        with record_function("eigbench.initialize"):
            self.opt.initialize()
        self.opt.initialize_adjoint()
        with record_function("eigbench.finalize_adjoint"):
            self.opt.finalize_adjoint()
        return self.opt.get_min_frequency()
