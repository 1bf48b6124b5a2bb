"""The cells of the buckling family and ``crm_86k.ksfreq`` on the CPU: the
plain buckling reference against the program (load factors, the ``ksagg``
value and gradient) on the dense and the BCR paths, and against its own
central difference; the CRM reference of ``ksfreq`` against the program;
a harness run of each cell correct, and not correct with the timed path
broken underneath; the float32 control not correct."""

import copy

import numpy as np
import pytest
import torch

from eigbench import control, judge, run
from eigbench.tests.conftest import small_cell, small_pair
from eigbench.tests.test_eigbench_reference import program, start

CELLS = ["buckle_263k.ksagg", "crm_86k.ksfreq"]


def small_buckle(nx=16, ny=8, factor_kind="bcr"):
    """(cell, config, traffic, limits, bench) of the buckling cell on an
    nx x ny grid; the shift of the 32x16 pilot stays below the first load
    factor at these sizes."""
    cell, config, traffic, limits, bench = run.find_cell("buckle_263k.ksagg")
    config = copy.deepcopy(config)
    config["model"].update(nx=nx, ny=ny, factor_kind=factor_kind)
    return cell, config, traffic, limits, bench


def small(name):
    return small_buckle() if name.startswith("buckle") else small_cell(name)


@pytest.mark.parametrize("grid", [(32, 16, "cholesky"), (32, 16, "bcr"),
                                  (16, 8, "bcr"), "crm_86k.ksfreq"],
                         ids=["buckle-32x16-dense", "buckle-32x16-bcr",
                              "buckle-16x8-bcr", "crm-ksfreq"])
def test_reference_matches_program(grid):
    if isinstance(grid, str):
        config, traffic = small_pair("crm_86k", "ksfreq")
    else:
        _, config, traffic, _, _ = small_buckle(*grid)
    x = start(config, traffic, seed=3)
    ref = judge.reference(config, traffic, x)
    value, lam, xb = program(config, traffic, x)
    checks = judge.compare(ref, value, lam, xb,
                           {"lam_rel": 0, "value_rel": 0, "grad_rel": 0})
    assert checks["lam_rel"]["value"] < 1e-9
    assert checks["value_rel"]["value"] < 1e-9
    assert checks["grad_rel"]["value"] < 1e-8


def test_reference_gradient_matches_its_richardson_difference():
    """p @ xb of the buckling reference against a Richardson-4 central
    difference (h 1e-3, 5e-4) of its own value at 32x16 (1e-8; plain
    central differences stop at 5e-8 here, the load factors' noise over
    h)."""
    _, config, traffic, _, _ = small_buckle(32, 16)
    x = start(config, traffic, seed=1)
    p = np.random.default_rng(2).uniform(-1, 1, x.shape) * x
    g = judge.reference(config, traffic, x)["xb"]

    def central(h):
        fp = judge.reference(config, traffic, x + h * p)["value"]
        fm = judge.reference(config, traffic, x - h * p)["value"]
        return (fp - fm) / (2 * h)

    fd = (4.0 * central(5e-4) - central(1e-3)) / 3.0
    assert abs(p @ g - fd) <= 1e-8 * abs(fd)


def test_reference_shift_above_the_first_load():
    """A configuration's shift above the design's first load factor: the
    reference halves it until K + sigma G is positive definite and finds
    the same lowest load factors (1e-10) and gradient (1e-8) as with a
    shift below it."""
    _, config, traffic, _, _ = small_buckle()
    x = start(config, traffic, seed=2)
    low = judge.reference(config, traffic, x)
    config["model"]["sigma"] *= 3.0
    high = judge.reference(config, traffic, x)
    assert np.max(np.abs(high["lam"] / low["lam"] - 1.0)) < 1e-10
    assert (np.linalg.norm(high["xb"] - low["xb"])
            < 1e-8 * np.linalg.norm(low["xb"]))


def model_class(config):
    if config["family"] == "buckle":
        from eigd_tpu_torch.models.buckling import BucklingTopologyAnalysis
        return BucklingTopologyAnalysis
    from eigd_tpu_torch.models.crm import CRM
    return CRM


def break_step(monkeypatch, cls):
    """initialize returns the state unchanged after its first call."""
    orig = cls.initialize

    def stale(self, *a, **k):
        if getattr(self, "_graph", None) is None:
            return orig(self, *a, **k)
        return None

    monkeypatch.setattr(cls, "initialize", stale)


def alter_answer(monkeypatch, cls):
    """finalize_adjoint's gradient altered by a thousandth."""
    orig = cls.finalize_adjoint

    def altered(self, *a, **k):
        orig(self, *a, **k)
        self.xb = self.xb * 1.001

    monkeypatch.setattr(cls, "finalize_adjoint", altered)


def drop_half(monkeypatch, cls):
    """finalize_adjoint pulls the seeds of the upper half of the modes
    only. Both objectives weigh the lowest mode far above the rest (KS at
    ks 1 over frequencies tens apart, KS at 100 over 1/lam), so leaving
    out the upper half would change the gradient by less than rounding
    in ``crm_86k.ksfreq``: the lower half is the one left out here."""
    orig = cls.finalize_adjoint

    def half(self, *a, **k):
        drop = self.lamb.shape[0] // 2
        self.lamb = torch.cat([torch.zeros_like(self.lamb[:drop]),
                               self.lamb[drop:]])
        Qrb = self.Qrb.clone()
        Qrb[:, :drop] = 0.0
        self.Qrb = Qrb
        orig(self, *a, **k)

    monkeypatch.setattr(cls, "finalize_adjoint", half)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [None, break_step, alter_answer, drop_half],
                         ids=["sound", "state_unchanged", "answer_altered",
                              "half_the_modes"])
def test_a_broken_step_is_not_correct(cpu_cuda, monkeypatch, name, fault):
    cell, config, traffic, limits, bench = small(name)
    if fault is not None:
        fault(monkeypatch, model_class(config))
    names = run.metric_names(bench, cell, "end_to_end")
    units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
    result, _ = run.run_cell(cell, config, traffic, limits, 4242, 1.0, False,
                             names, units, device="cpu")
    assert result["correct"] is (fault is None), result["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    """The reference in float32, put in the program's place, fails the
    cell's limits (here at a CPU test size; at the cell's own size by
    control.py)."""
    _, config, traffic, limits, _ = small(name)
    if config["family"] == "buckle":
        config["model"].update(nx=32, ny=16)
    out = control.readings(config, traffic, limits, 5)
    assert out["correct"] is False, out["checks"]
