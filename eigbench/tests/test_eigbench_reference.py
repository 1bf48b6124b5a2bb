"""The plain reference against the program on the CPU in f64, and against
its own central difference."""

import numpy as np
import pytest
import torch

from eigbench import design, judge
from eigbench.tests.conftest import small_pair

# every objective on its family, minfreq also while no cell runs it
PAIRS = [("nf_263k", "minfreq"), ("nf_263k", "ksfreq"),
         ("crm_86k", "compliance")]


def program(config, traffic, x):
    import importlib

    fam = importlib.import_module(f"eigbench.families.{config['family']}")
    obj = importlib.import_module(
        f"eigbench.objectives.{traffic['objective']}")
    model = fam.build(config["model"], "cpu")
    port = obj.Port(model, dict(traffic["params"]), config)
    model.x = torch.as_tensor(x)
    value = port.iterate()
    return float(value), model.lam.numpy(), model.xb.numpy()


def start(config, traffic, seed=0):
    """The start design of the traffic, voids and all, moved by one step
    of the reference's own gradient."""
    import importlib

    fam = importlib.import_module(f"eigbench.reference.{config['family']}")
    x, loop = design.for_cell(config, traffic, seed,
                              fam.Problem(config["model"]).ndv)
    return loop.step(x, judge.reference(config, traffic, x)["xb"])


@pytest.mark.parametrize("pair", PAIRS, ids=".".join)
def test_reference_matches_program(pair):
    config, traffic = small_pair(*pair)
    x = start(config, traffic)
    ref = judge.reference(config, traffic, x)
    value, lam, xb = program(config, traffic, x)
    checks = judge.compare(ref, value, lam, xb,
                           {"lam_rel": 0, "value_rel": 0, "grad_rel": 0})
    # the program's Lanczos stops at its rtol (1e-10 by default)
    assert checks["lam_rel"]["value"] < 1e-9
    assert checks["value_rel"]["value"] < 1e-9
    assert checks["grad_rel"]["value"] < 1e-7


@pytest.mark.parametrize("pair,h,tol",
                         [(("nf_263k", "minfreq"), 1e-6, 1e-7),
                          (("crm_86k", "compliance"), 1e-4, 1e-6)])
def test_reference_gradient_matches_its_central_difference(pair, h, tol):
    config, traffic = small_pair(*pair)
    x = start(config, traffic, seed=1)
    p = np.random.default_rng(2).uniform(-1, 1, x.shape) * x
    g = judge.reference(config, traffic, x)["xb"]
    fp = judge.reference(config, traffic, x + h * p)["value"]
    fm = judge.reference(config, traffic, x - h * p)["value"]
    fd = (fp - fm) / (2 * h)
    assert abs(p @ g - fd) <= tol * abs(fd)
