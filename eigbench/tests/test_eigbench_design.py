"""The optimiser's step that makes the traffic: move limits, bounds and
volume hold, it climbs (or descends) the gradient it is given, and the
same seed gives the same designs."""

import numpy as np
import pytest

from eigbench import design

LINEAR = {"space": "linear", "move": 0.05, "lo": 0.0, "hi": 1.0,
          "start": {"value": 1.0,
                    "holes": {"pitch": 0.25, "radius": 0.1, "jitter": 0.1}}}
LOG = {"space": "log", "move": 0.05, "lo": 0.005, "hi": 0.02,
       "start": {"value": 0.01, "jitter": 0.05}}


def points(n=4000, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (n, 2))


def test_the_start_has_holes_and_follows_the_seed():
    p = points()
    x = design.start(LINEAR, 2**31 + 9, len(p), p)
    assert 0.3 < np.mean(x == 0.0) < 0.7 and np.all((x == 0) | (x == 1))
    assert np.array_equal(x, design.start(LINEAR, 2**31 + 9, len(p), p))
    assert not np.array_equal(x, design.start(LINEAR, 2**31 + 10, len(p),
                                              p))
    t = design.start(LOG, 3, 5)
    assert np.all(np.abs(np.log(t / 0.01)) <= 0.05)


@pytest.mark.parametrize("spec,sense", [(LINEAR, "max"), (LINEAR, "min"),
                                        (LOG, "min")])
def test_a_step_keeps_its_limits_and_follows_the_gradient(spec, sense):
    n = 4000 if spec is LINEAR else 5
    x = design.start(spec, 1, n, points(n) if spec is LINEAR else None)
    loop = design.Loop(spec, sense, x)
    g = np.random.default_rng(4).normal(size=n)
    y = loop.step(x, g)
    assert np.all(y >= spec["lo"]) and np.all(y <= spec["hi"])
    if spec["space"] == "linear":
        assert np.all(np.abs(y - x) <= spec["move"] + 1e-12)
    else:
        assert np.all(np.abs(np.log(y / x)) <= spec["move"] + 1e-12)
    assert np.sum(y) == pytest.approx(np.sum(x), rel=1e-12)
    climb = float((y - x) @ g)
    assert climb > 0 if sense == "max" else climb < 0
    assert np.array_equal(y, loop.step(x, g))
