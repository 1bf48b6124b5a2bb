"""The check catches what it is there for: a run of the harness on the CPU
(no look for a card) with the timed path broken underneath comes out not
correct, and so does the control, the reference in float32. The cells run
on one card, so no exchange between cards can be left out."""

import pytest
import torch

from eigbench import control, run
from eigbench.tests.conftest import small_cell

CELLS = ["nf_263k.ksfreq", "crm_86k.compliance"]


def model_class(config):
    if config["family"] == "nf":
        from eigd_tpu_torch.models.natural_frequency import TopologyAnalysis
        return TopologyAnalysis
    from eigd_tpu_torch.models.crm import CRM
    return CRM


def go(name, seconds=1.0):
    cell, config, traffic, limits, bench = small_cell(name)
    names = run.metric_names(bench, cell, "end_to_end")
    units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
    result, _ = run.run_cell(cell, config, traffic, limits, 4242, seconds,
                             False, names, units, device="cpu")
    return result


def break_step(monkeypatch, name):
    """initialize returns the state unchanged after its first call."""
    _, config, *_ = small_cell(name)
    cls = model_class(config)
    orig = cls.initialize

    def stale(self, *a, **k):
        if getattr(self, "_graph", None) is None:
            return orig(self, *a, **k)
        return None

    monkeypatch.setattr(cls, "initialize", stale)


def alter_answer(monkeypatch, name):
    """finalize_adjoint's gradient altered by a thousandth."""
    _, config, *_ = small_cell(name)
    cls = model_class(config)
    orig = cls.finalize_adjoint

    def altered(self, *a, **k):
        orig(self, *a, **k)
        self.xb = self.xb * 1.001

    monkeypatch.setattr(cls, "finalize_adjoint", altered)


def drop_half(monkeypatch, name):
    """finalize_adjoint pulls the seeds of the first half of the modes
    only (the modes are the batch of one adjoint solve)."""
    _, config, *_ = small_cell(name)
    cls = model_class(config)
    orig = cls.finalize_adjoint

    def half(self, *a, **k):
        keep = self.lamb.shape[0] // 2
        self.lamb = torch.cat([self.lamb[:keep],
                               torch.zeros_like(self.lamb[keep:])])
        vec = "Qb" if hasattr(self, "Qb") else "Qrb"
        Qb = getattr(self, vec).clone()
        Qb[:, keep:] = 0.0
        setattr(self, vec, Qb)
        orig(self, *a, **k)

    monkeypatch.setattr(cls, "finalize_adjoint", half)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [None, break_step, alter_answer, drop_half],
                         ids=["sound", "state_unchanged", "answer_altered",
                              "half_the_modes"])
def test_a_broken_step_is_not_correct(cpu_cuda, monkeypatch, name, fault):
    if fault is not None:
        fault(monkeypatch, name)
    result = go(name)
    assert result["correct"] is (fault is None), result["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    """The reference in float32, put in the program's place, fails the
    cell's limits (here at a CPU test size; at the cell's own size by
    control.py)."""
    _, config, traffic, limits, _ = small_cell(name)
    if config["family"] == "nf":
        # float32's error grows with the mesh: at 16x8 it reads under the
        # limits (lam 8e-7), at 32x16 over them (lam 4e-6)
        config["model"].update(nx=32, ny=16)
    out = control.readings(config, traffic, limits, 5)
    assert out["correct"] is False, out["checks"]
