"""The control of a cell's check: the plain reference put in the
program's place and computed in float32, the precision below the float64
that the configuration states, judged by the cell's own comparison
against the float64 reference. It has to come out not correct.

    python eigbench/control.py --workload <name> --seeds 1 2 3

For each seed the design is the cell's start design for that seed moved
by one optimiser's step, from the float64 reference's gradient there: the
reference stands in the program's place in the loop as well, and the
design is the first that a window judges. The program is not run, so this needs no
card; the benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from eigbench import design, judge, run  # noqa: E402


def readings(config, traffic, limits, seed):
    import importlib

    fam = importlib.import_module(f"eigbench.reference.{config['family']}")
    x, loop = design.for_cell(config, traffic, seed,
                              fam.Problem(config["model"]).ndv)
    x = loop.step(x, judge.reference(config, traffic, x)["xb"])
    ref = judge.reference(config, traffic, x)
    ctl = judge.reference(config, traffic, x, dtype=np.float32)
    checks = judge.compare(ref, ctl["value"], ctl["lam"], ctl["xb"], limits)
    return {"seed": seed, "f64_s": ref["seconds"],
            "f32_s": ctl["seconds"], "checks": checks,
            "correct": all(c["value"] <= c["limit"]
                           for c in checks.values())}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    _, config, traffic, limits, _ = run.find_cell(args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        out = readings(config, traffic, limits, seed)
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
