"""The designs of a closed optimisation loop: the one general generator
that every traffic mix feeds.

An optimiser waits for each gradient before it moves. Here it takes a
move-limited projected-gradient step from the program's own gradient
``xb`` at the last design, under a volume constraint whose multiplier is
found by bisection, as the optimality-criteria update of Sigmund's
99-line code does (Struct. Multidisc. Optim. 21:120-127, 2001). The
program receives only the new design. A loop is given by parameters (the
configuration's ``design`` object, updated by the traffic file's
``design``; the traffic's ``sense`` says whether the objective is
maximised or minimised):

* ``space``: ``"linear"`` moves x itself; ``"log"`` moves log x (sizing
  variables, whose move limit is then a factor exp(+-``move``));
* ``move``: the move limit of every variable an iteration;
* ``lo``, ``hi``: the bounds of x;
* ``start``: ``value`` everywhere, each variable multiplied by
  exp(``jitter`` times a uniform draw in [-1, 1)) when ``jitter`` is
  given, and ``holes`` of x = ``lo``: discs of ``radius`` on a square
  lattice of ``pitch`` (in the model's lengths, over the design
  variables' ``points``), the lattice shifted from the seed by up to
  ``jitter`` times the pitch on each axis.

The step: the ascent direction d (the gradient, signed by ``sense``, and
times x in the log space), scaled so that the 90th percentile of
|d - median d| is one move limit; x + d - mu, clipped to the move limits
and bounds, with mu such that the sum of x stays that of the start.
"""

from __future__ import annotations

import importlib

import numpy as np

BISECTIONS = 64


def start(spec, seed, size, points=None):
    """The start design of a loop, drawn from the seed."""
    s = spec["start"]
    rng = np.random.default_rng([seed, 1])
    x = np.full(size, float(s["value"]))
    if "jitter" in s:
        x *= np.exp(s["jitter"] * rng.uniform(-1.0, 1.0, size))
    if "holes" in s:
        h = s["holes"]
        pitch = float(h["pitch"])
        shift = pitch * (0.5 + h["jitter"] * rng.uniform(-1.0, 1.0, 2))
        u = (np.asarray(points, dtype=np.float64) - shift) / pitch
        dist = pitch * np.linalg.norm(u - np.round(u), axis=1)
        x[dist < h["radius"]] = spec["lo"]
    return np.clip(x, spec["lo"], spec["hi"])


def for_cell(config, traffic, seed, size):
    """(start design, Loop) of a cell's traffic from the seed; ``size`` is
    the number of design variables. Holes are laid over the reference
    family's ``design_points``."""
    spec = {**config["design"], **traffic.get("design", {})}
    points = None
    if "holes" in spec["start"]:
        fam = importlib.import_module(
            f"eigbench.reference.{config['family']}")
        points = fam.design_points(config["model"])
    x0 = start(spec, seed, size, points)
    return x0, Loop(spec, traffic["sense"], x0)


class Loop:
    """The optimiser's steps from ``x0``; ``sense`` is ``"max"`` or
    ``"min"``."""

    def __init__(self, spec, sense, x0):
        if spec["space"] not in ("linear", "log"):
            raise ValueError(f"unknown design space {spec['space']!r}")
        if sense not in ("max", "min"):
            raise ValueError(f"unknown sense {sense!r}")
        self.log = spec["space"] == "log"
        self.sign = 1.0 if sense == "max" else -1.0
        self.move = float(spec["move"])
        self.lo, self.hi = float(spec["lo"]), float(spec["hi"])
        self.volume = float(np.sum(x0))

    def step(self, x, g):
        """The next design (a new array) from design x and the gradient g
        of the objective there."""
        x = np.asarray(x, dtype=np.float64)
        d = self.sign * np.asarray(g, dtype=np.float64)
        if self.log:
            z, d = np.log(x), d * x
            zlo, zhi = np.log(self.lo), np.log(self.hi)
        else:
            z, zlo, zhi = x, self.lo, self.hi
        spread = np.quantile(np.abs(d - np.median(d)), 0.9)
        trial = z + d * (self.move / spread) if spread > 0 else z
        lower = np.maximum(zlo, z - self.move)
        upper = np.minimum(zhi, z + self.move)

        def moved(mu):
            v = np.clip(trial - mu, lower, upper)
            return np.exp(v) if self.log else v

        # mu at a puts every variable at its upper limit, at b at its lower
        a, b = np.min(trial - upper), np.max(trial - lower)
        for _ in range(BISECTIONS):
            mu = 0.5 * (a + b)
            if np.sum(moved(mu)) > self.volume:
                a = mu
            else:
                b = mu
        return moved(0.5 * (a + b))
