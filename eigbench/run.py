"""Run one benchmark cell once and print its result line.

    python eigbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Everything is found by name from ``BENCHMARK.json`` at the root of the
checkout: the cell, its configuration file (``configs/<config>.json``,
whose ``family`` names ``families/<family>.py`` on the program's side and
``reference/<family>.py`` on the reference's), its traffic file
(``traffic/<traffic>.json``, whose ``objective`` names
``objectives/<objective>.py`` and ``reference/objectives/<objective>.py``),
the limits of its check (``limits/<workload>.json``) and each per-layer
metric's reader (``metrics/<name>.py``).

A run: set-up (imports, the card, the model, one warm design iteration at
the start design), then a window of closed-loop design iterations for
``--seconds`` (no iteration starts after it; each design is the
optimiser's step from the last one and the program's gradient there,
``design.py``), then, with the program's
state freed, the plain reference at one iteration of the window drawn
from the seed, and the comparison that decides ``correct``. With
``--trace 1`` an untraced window comes first, whose pace is the per-layer
``loop_iter_s``, and the traced window goes on from its last design; the
judged iteration is drawn from both. The last line
of standard output is the result; the numbers compared, each beside its
limit, are the last lines of standard error and the result's last key.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / "eigbench" / sub)
os.environ["USE_FLAX"] = "0"
# load from one process with few threads: the host's pools stay idle
for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import record_function  # noqa: E402

from eigbench import design, judge, trace  # noqa: E402

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "eigd_tpu")
GIB = 2.0**30
# a traced run's window: the profiler doubles the iteration time, and its
# collection and the reduction cost about 2 s a traced second afterwards,
# so the trace covers the first 20 s and the run stays well inside 360 s
TRACE_SECONDS = 20.0


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def forbidden_modules():
    """Top-level names of loaded modules that a run may not hold, compared
    whole (``eigd_tpu_torch`` is not ``eigd_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def fmt(values):
    """min / median / max of a list, for the log."""
    v = sorted(values)
    return f"{v[0]:.4f}/{v[len(v) // 2]:.4f}/{v[-1]:.4f}" if v else "-"


def load_json(path):
    with open(path) as f:
        return json.load(f)


def find_cell(name, bench=None):
    """(workload, config file, traffic file, limits) of a cell by name."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    (cell,) = [w for w in bench["workloads"] if w["name"] == name]
    (conf,) = [c for c in bench["configs"] if c["name"] == cell["config"]]
    return (cell, load_json(ROOT / conf["file"]),
            load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
            load_json(HERE / "limits" / f"{name}.json"), bench)


def metric_names(bench, cell, kind):
    out = []
    for m in bench[kind]:
        if cell["name"] in m.get("workloads", [cell["name"]]):
            out.append(m["name"])
    return out


def window(port, model, loop, x, g, seconds, device, tracer=None):
    """The measured iterations from design x with gradient g: (run
    namespace, designs, outputs)."""
    from eigd_tpu_torch.ops import cuda_stencil, sync

    syncs0, steps0, exits0 = (sync.HOST_SYNCS.copy(), sync.LOOP_STEPS.copy(),
                              sync.LOOP_EXITS.copy())
    launches0 = (cuda_stencil.K1_LAUNCHES, cuda_stencil.K2_LAUNCHES)
    xs, outs, init_t, adj_t = [], [], [], []
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    prof = None
    if tracer is not None:
        tracer.patch()
        prof = trace.profiler()
        prof.__enter__()
    t0 = time.perf_counter()
    with record_function("eigbench.window"):
        while time.perf_counter() - t0 < seconds:
            with record_function("eigbench.design"):
                x = loop.step(x, g)
            model.x = torch.as_tensor(x, device=device)
            value = port.iterate()
            xb = model.xb.clone()
            g = xb.cpu().numpy()  # the optimiser waits for the gradient
            xs.append(x)
            outs.append((value.detach().reshape(()).clone(), model.lam.clone(),
                         xb))
            init_t.append(model.profile["eigenvalue solve time"])
            adj_t.append(model.profile["adjoint solution time"])
        torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    run = types.SimpleNamespace(
        iterations=len(xs), window_s=t1 - t0, init_times=init_t,
        adjoint_times=adj_t,
        host_syncs=sync.HOST_SYNCS - syncs0,
        loop_steps=sync.LOOP_STEPS - steps0,
        loop_exits=dict(sync.LOOP_EXITS - exits0),
        launches=(cuda_stencil.K1_LAUNCHES - launches0[0],
                  cuda_stencil.K2_LAUNCHES - launches0[1]),
        peak_bytes=torch.cuda.max_memory_allocated(device),
        trace=None, kernel_calls={}, prof=prof)
    if tracer is not None:
        prof.__exit__(None, None, None)
        tracer.unpatch()
        run.kernel_calls = tracer.calls
    return run, xs, outs


def log_window(what, run):
    log(f"[{what}] {run.iterations} iterations in {run.window_s:.6f} s, "
        f"peak {run.peak_bytes / GIB:.6f} GiB, K1/K2 launches "
        f"{run.launches}, host waits {dict(run.host_syncs)}, loop exits "
        f"{run.loop_exits}; initialize s {fmt(run.init_times)}, "
        f"finalize_adjoint s {fmt(run.adjoint_times)}")


def run_cell(cell, config, traffic, limits, seed, seconds, trace_on, names,
             units, device="cuda", t_start=None):
    """Run one cell; returns (result without ``device``'s platform, kind
    and count, the run's namespace). ``names`` are the metrics to report,
    with their ``units``. A ``device`` other than cuda is for the
    harness's own tests on the CPU, with ``torch.cuda`` stubbed by the
    caller."""
    t_start = T_START if t_start is None else t_start
    family = importlib.import_module(f"eigbench.families.{config['family']}")
    objective = importlib.import_module(
        f"eigbench.objectives.{traffic['objective']}")
    params = dict(traffic.get("params", {}))

    model = family.build(config["model"], device)
    port = objective.Port(model, params, config)
    x0, loop = design.for_cell(config, traffic, seed, model.x.numel())
    model.x = torch.as_tensor(x0, device=device)
    port.iterate()  # the one warm iteration, at the start design
    g0 = model.xb.cpu().numpy()
    setup_s = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_allocated(device)
    log(f"[setup] {setup_s:.6f} s, peak {setup_peak / GIB:.6f} GiB")

    xs, outs, peak = [], [], 0  # peak: the windows' own
    tracer = None
    if trace_on:
        # the loop's own pace comes from an untraced window: the profiler
        # doubles the iteration time of the traced one, which goes on from
        # its last design
        seconds = min(seconds, TRACE_SECONDS)
        plain, xs, outs = window(port, model, loop, x0, g0, seconds, device)
        log_window("untraced window", plain)
        x0, g0, peak = xs[-1], outs[-1][2].cpu().numpy(), plain.peak_bytes
        tracer = trace.Tracer()
    run, more_xs, more_outs = window(port, model, loop, x0, g0, seconds,
                                     device, tracer)
    paced = plain if trace_on else run
    run.loop_iter_s = paced.window_s / paced.iterations
    xs, outs = xs + more_xs, outs + more_outs
    peak = max(peak, run.peak_bytes)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {found}")
    if run.prof is not None:
        t = time.perf_counter()
        run.trace = trace.analyse(run.prof)
        run.prof = None
        log(f"[trace] analysed in {time.perf_counter() - t:.3f} s")
    log_window("traced window" if trace_on else "window", run)

    # judge one iteration drawn from the seed, on the host, with the
    # program's state freed
    attempted = len(outs)
    pick = int(np.random.default_rng([seed, 7]).integers(attempted))
    finite = [bool(torch.isfinite(v).all() and torch.isfinite(lam).all()
                   and torch.isfinite(xb).all()) for v, lam, xb in outs]
    value, lam, xb = (t.cpu().numpy() for t in outs[pick])
    del port, model, outs
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = judge.reference(config, traffic, xs[pick])
    log(f"[reference] iteration {pick} of {attempted}: plain SciPy "
        f"reference in {time.perf_counter() - t:.3f} s; its eigenvalues "
        f"{ref['lam'].tolist()} and the next {ref['next_lam']!r}; the "
        f"program's {lam.tolist()}")
    checks = judge.compare(ref, float(value), lam, xb, limits)
    failed = finite.count(False)
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())

    end_to_end = {"peak_gib": peak / GIB, "setup_s": setup_s}
    metrics = {}
    for name in names:
        if trace_on:
            v = importlib.import_module(f"eigbench.metrics.{name}").read(run)
        else:
            v = end_to_end[name]
        if v is not None:
            metrics[name] = {"value": v, "unit": units[name]}
    result = {"correct": correct, "attempted": attempted,
              "failed": failed, "metrics": metrics,
              "device": {"count": 1,
                         "memory_peak_bytes": max(setup_peak, peak)}}
    if trace_on and run.trace is not None:
        result["device"]["busy_s"] = run.trace["busy_s"]
        result["device"]["window_s"] = run.trace["window_s"]
        result["breakdown"] = {
            "device_ops": [list(p) for p in run.trace["device_ops"]],
            "idle_gaps": [list(p) for p in run.trace["idle_gaps"]]}
        log(f"[trace] device events {run.trace['device_events']}, "
            f"launches {run.trace['launches']}, stencil calls "
            f"{run.trace['calls']} with kernel seconds "
            f"{run.trace['kernel_s']} (by the device spans "
            f"{run.trace['kernel_s_by_span']}), traced iter_s "
            f"{run.window_s / run.iterations:.6f}")
    result["checks"] = checks
    return result, run


def result_line(result, kind, count=1):
    """The result as the last line prints it: the contract's keys, then the
    numbers compared, each with its limit, under ``checks``, last."""
    line = {k: result[k] for k in ("correct", "attempted", "failed",
                                   "metrics")}
    line["device"] = {"platform": "gpu", "kind": kind, "count": count,
                      **result["device"]}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["checks"] = result["checks"]
    return line


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell, config, traffic, limits, bench = find_cell(args.workload)
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark runs only on the card")
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        log(f"the cell needs {cell['chips']} cards, "
            f"{torch.cuda.device_count()} present")
        return 2
    kind = "per_layer" if args.trace else "end_to_end"
    names = metric_names(bench, cell, kind)
    units = {m["name"]: m["unit"] for m in bench[kind]}
    result, _ = run_cell(cell, config, traffic, limits, args.seed,
                         args.seconds, args.trace == 1, names, units)
    found = forbidden_modules()
    if found:
        log(f"forbidden modules loaded: {found}")
        return 3
    log(f"[card] {judge.card()}")
    line = result_line(result, torch.cuda.get_device_name(0))
    for name, c in line["checks"].items():
        log(f"[check] {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
