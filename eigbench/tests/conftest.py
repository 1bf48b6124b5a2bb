"""Small CPU versions of the cells, and ``torch.cuda`` stubbed so that the
harness's run drives the program on the CPU (its plain twins)."""

import copy

import pytest
import torch

from eigbench import run

SMALL = {
    "nf": dict(nx=16, ny=8, factor_kind="dense", m=None, lanczos_block=1,
               lanczos_ortho="full", lanczos_polish=0,
               lanczos_polish_spare=0, lanczos_sweep="exact",
               factor_options=None),
    "crm": dict(nspan=16, nchord=4, nheight=2, m=None),
}


def small(config):
    """A configuration with its model cut to a size the CPU runs in a
    second."""
    config = copy.deepcopy(config)
    config["model"].update(SMALL[config["family"]])
    config["model"] = {k: v for k, v in config["model"].items()
                       if v is not None}
    return config


def small_cell(name):
    """(cell, config, traffic, limits, bench) of a cell, its model cut to
    a size the CPU runs in a second."""
    cell, config, traffic, limits, bench = run.find_cell(name)
    return cell, small(config), traffic, limits, bench


def small_pair(config, traffic):
    """(config, traffic) by their file names, also where no cell pairs
    them, the model cut as in ``small_cell``."""
    return (small(run.load_json(run.HERE / "configs" / f"{config}.json")),
            run.load_json(run.HERE / "traffic" / f"{traffic}.json"))


@pytest.fixture
def cpu_cuda(monkeypatch):
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **k: 0)


@pytest.fixture
def card():
    """Skips unless a CUDA card is present (decided here, not at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
