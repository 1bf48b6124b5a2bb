"""The harness finds every piece of a cell by name from files, and its
result line carries the contract's keys."""

import ast
import importlib
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from eigbench import run
from eigbench.tests.conftest import small_cell

HERE = Path(run.__file__).resolve().parent
BENCH = run.load_json(run.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_piece_of_a_cell_is_found_by_name(cell):
    cell, config, traffic, limits, bench = run.find_cell(cell)
    importlib.import_module(f"eigbench.families.{config['family']}")
    importlib.import_module(f"eigbench.reference.{config['family']}")
    importlib.import_module(f"eigbench.objectives.{traffic['objective']}")
    importlib.import_module(
        f"eigbench.reference.objectives.{traffic['objective']}")
    assert set(limits) == {"lam_rel", "value_rel", "grad_rel"}
    for kind in ("end_to_end", "per_layer"):
        names = run.metric_names(bench, cell, kind)
        assert names, kind
        if kind == "per_layer":
            for name in names:
                assert hasattr(importlib.import_module(
                    f"eigbench.metrics.{name}"), "read")
    assert "setup_s" in run.metric_names(bench, cell, "end_to_end")


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("eigbench/")
        assert run.load_json(run.ROOT / c["file"])["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("trace_on", [False, True])
def test_result_line_carries_the_contract_keys(cpu_cuda, trace_on):
    cell, config, traffic, limits, bench = small_cell("crm_86k.compliance")
    kind = "per_layer" if trace_on else "end_to_end"
    names = run.metric_names(bench, cell, kind)
    units = {m["name"]: m["unit"] for m in bench[kind]}
    result, r = run.run_cell(cell, config, traffic, limits, 2**31 + 5, 0.5,
                             trace_on, names, units, device="cpu")
    line = run.result_line(result, "NVIDIA H100 80GB HBM3")
    keys = list(line)
    assert keys[-1] == "checks"
    assert set(keys) <= {"correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"}
    assert line["correct"] is True and line["failed"] == 0
    if trace_on:  # the untraced window's iterations are judged too
        assert line["attempted"] > r.iterations >= 1
    else:
        assert line["attempted"] == r.iterations >= 1
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if not trace_on:
        assert set(line["metrics"]) == {"peak_gib", "setup_s"}
    else:  # no card: the trace has no device events, so no device metric
        assert set(line["metrics"]) == {"loop_iter_s", "init_s",
                                        "adjoint_s", "host_waits"}
        assert line["metrics"]["loop_iter_s"]["value"] > 0
    json.dumps(line)


def test_run_without_a_card_fails_and_prints_nothing():
    proc = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload",
         "crm_86k.compliance", "--seed", "1", "--seconds", "1", "--trace",
         "0"],
        capture_output=True, text=True, timeout=120,
        cwd=run.ROOT)
    assert proc.returncode != 0 and proc.stdout == ""


def imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {m.split(".")[0] for m in imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "eigd_tpu"}
    if "reference" in path.relative_to(HERE).parts:
        assert "eigd_tpu_torch" not in tops


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct(card):
    proc = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload",
         "crm_86k.compliance", "--seed", "77", "--seconds", "3", "--trace",
         "1"],
        capture_output=True, text=True, timeout=900, cwd=run.ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0
