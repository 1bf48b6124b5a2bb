"""``ksagg`` on the program: the KS aggregate of the inverse load factors
plus the tanh eigenvector aggregate over the y-DOFs of the loaded nodes
(``reference.buckle.load_dofs``), seeded by
``add_ks_buckling_derivative`` and
``add_eigenvector_aggregate_derivative`` into one ``finalize_adjoint``:
seeds in the load factors and in the eigenvectors, so the adjoint runs
SIBK in buckling mode and the path adjoint carries both. Each iteration
logs its first load factor over the configuration's shift and over the
shift its solve used, which has to stay above 1 for the shift's factor
K + sigma G to be positive definite."""

import sys

import numpy as np
from torch.profiler import record_function

from ..reference.buckle import load_dofs


class Port:
    def __init__(self, model, params, config):
        self.model = model
        self.ks = params["ks_rho"]
        self.agg = params["agg_rho"]
        self.dofs = np.asarray(load_dofs(config["model"]))
        self.sigma = float(config["model"]["sigma"])

    def iterate(self):
        m = self.model
        with record_function("eigbench.initialize"):
            m.initialize()
        m.initialize_adjoint()
        with record_function("eigbench.seeds"):
            value = (m.eval_ks_buckling(self.ks)
                     + m.get_eigenvector_aggregate(self.agg, self.dofs))
            m.add_ks_buckling_derivative(1.0, self.ks)
            m.add_eigenvector_aggregate_derivative(1.0, self.agg, self.dofs)
        with record_function("eigbench.finalize_adjoint"):
            m.finalize_adjoint()
        blf1 = float(m.lam[0])
        print(f"[ksagg] BLF_1/sigma {blf1 / self.sigma!r} BLF_1/shift "
              f"{blf1 / getattr(m, 'solve_sigma', m.sigma)!r}",
              file=sys.stderr, flush=True)
        return value.detach()
