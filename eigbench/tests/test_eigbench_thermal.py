"""The plain thermal reference and its ``ks`` objective against the program
on the CPU in f64 (``ThermalOpt``'s KS value, and ``xb`` from
``add_ks_derivative`` and ``finalize_adjoint``), and against its own
central difference. No cell runs the family yet: the model and the
transient are upstream ``examples/thermal.py``'s, written here."""

import numpy as np
import pytest
import torch

from eigbench import judge

# upstream's transient: 1 + 0.5 sin(4t) on the center set, 100
# Crank-Nicolson steps to t = 2, KS at 10
TRAFFIC = {"objective": "ks",
           "params": {"ks_rho": 10.0, "nsteps": 100, "tfinal": 2.0,
                      "heat": {"center": {"mean": 1.0, "amp": 0.5,
                                          "omega": 4.0}}}}
# upstream's example model (Ly 1.1, N 6) on the dense factor, and on the
# multigrid factor the cell would run
GRIDS = {"16x16-dense": dict(nx=16, ny=16, Ly=1.1, N=6, factor_kind="dense"),
         "32x32-mg": dict(nx=32, ny=32, Ly=1.1, N=6, factor_kind="mg")}
TOL = {"lam_rel": 1e-9, "value_rel": 1e-9, "grad_rel": 1e-7}


def config(grid):
    return {"family": "thermal", "model": GRIDS[grid]}


def design(model, seed):
    n = (model["nx"] + 1) * (model["ny"] + 1)
    return 0.5 * np.exp(0.3 * np.random.default_rng(seed).uniform(-1, 1, n))


def program(model, x):
    """(value, lam, xb) of the program's ThermalOpt at x."""
    from eigd_tpu_torch.models.thermal import ThermalOpt, make_model

    p = TRAFFIC["params"]
    heat = {"case": {name: (lambda t, h=h: h["mean"] + h["amp"]
                            * torch.sin(h["omega"] * t))
                     for name, h in p["heat"].items()}}
    topo = make_model(device="cpu", **model)
    opt = ThermalOpt(topo, heat, nsteps=p["nsteps"], tfinal=p["tfinal"])
    topo.x = torch.as_tensor(x)
    opt.initialize()
    value = float(opt.eval_ks_functions(p["ks_rho"])["case"])
    opt.initialize_adjoint()
    opt.add_ks_derivative(p["ks_rho"], {"case": 1.0})
    opt.finalize_adjoint()
    return value, topo.lam.numpy(), topo.xb.numpy()


def readings(ref, value, lam, xb):
    return {k: c["value"] for k, c in judge.compare(
        ref, value, lam, xb, TOL).items()}


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_reference_matches_program(grid):
    """All N + 4 modes, the constant mode 0 judged on lambda_1; the
    float32 reference in the program's place is printed beside the
    program's readings and fails at least one tolerance."""
    x = design(GRIDS[grid], 4)
    ref = judge.reference(config(grid), TRAFFIC, x)
    assert ref["null_modes"] == 1 and ref["lam"].shape == (10,)
    assert abs(ref["lam"][0]) < 1e-9 * ref["lam"][1]
    got = readings(ref, *program(GRIDS[grid], x))
    ctl = judge.reference(config(grid), TRAFFIC, x, dtype=np.float32)
    f32 = readings(ref, ctl["value"], ctl["lam"], ctl["xb"])
    print(f"{grid}: program {got}; float32 reference {f32}")
    assert all(got[k] < TOL[k] for k in TOL), got
    assert any(f32[k] > TOL[k] for k in TOL), f32


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_reference_gradient_matches_its_central_difference(grid):
    x = design(GRIDS[grid], 1)
    p = np.random.default_rng(2).uniform(-1, 1, x.shape) * x
    h = 1e-5
    g = judge.reference(config(grid), TRAFFIC, x)["xb"]
    fp = judge.reference(config(grid), TRAFFIC, x + h * p)["value"]
    fm = judge.reference(config(grid), TRAFFIC, x - h * p)["value"]
    fd = (fp - fm) / (2 * h)
    assert abs(p @ g - fd) <= 1e-5 * abs(fd)
