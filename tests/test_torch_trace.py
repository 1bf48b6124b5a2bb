"""The program's spans and host-wait counters (``ops.sync.span``), on the
CPU: silent without a profiler; under ``torch.profiler`` one range per
layer boundary, nested as the layers are, with self and inclusive times
that add up to the protocol's, factor columns counted as
``FactorCounter`` counts them, a wait time for every decision site; the
benchmark's own ranges still bite, and its per-layer readers read them.

One design iteration each of a 16x8 natural-frequency model (dense
factor, ``MinFreqOpt``'s eigenvector seeds), an 8-station CRM (f64
BCR, modal compliance) and a 16x8 buckling column (f64 BCR, KS of the
inverse load factors plus the eigenvector aggregate, so the static solve
and its path adjoint run as well): one with no profiler, one under the
profiler with the benchmark's ``Tracer`` patched in, as its traced window
has it. The static-path spans (``eigd.static.*``) are entered in the
buckling iteration alone.
"""

import importlib
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from eigd_tpu_torch.models.buckling import make_buckling_model
from eigd_tpu_torch.models.crm import CRM
from eigd_tpu_torch.models.natural_frequency import MinFreqOpt, make_model
from eigd_tpu_torch.ops import sync

torch.set_num_threads(1)

SPANS = ("eigd.protocol.initialize", "eigd.protocol.finalize_adjoint",
         "eigd.factor.build", "eigd.eig.lanczos", "eigd.factor.apply",
         "eigd.adjoint.solve")
STATIC = ("eigd.static.solve", "eigd.static.adjoint")
NEW = ("SPAN_S", "SELF_S", "SPAN_N", "SPAN_WORK", "WAIT_S")
READERS = ("model_s", "lanczos_s", "factor_build_s", "factor_apply_s",
           "factor_columns", "adjoint_solve_s", "host_wait_s")


def _nf():
    opt = MinFreqOpt(make_model(nx=16, ny=8, N=2, Lx=2.0, Ly=1.0, rfact=2.0,
                                kernel_mv="off", device="cpu"))

    def iterate():
        opt.initialize()
        opt.initialize_adjoint()
        opt.finalize_adjoint()

    return iterate


def _crm():
    crm = CRM(nspan=8, nchord=4, nheight=2, N=4, m=48, factor_kind="bcr",
              device="cpu")

    def iterate():
        crm.initialize()
        crm.initialize_adjoint()
        crm.add_modal_compliance_derivative(1.0)
        crm.finalize_adjoint()

    return iterate


def _buckle():
    topo = make_buckling_model(nx=16, ny=8, N=4, factor_kind="bcr",
                               sigma=0.004, device="cpu")
    dofs = [2 * (16 * 9 + j) + 1 for j in range(3, 6)]

    def iterate():
        topo.initialize()
        topo.initialize_adjoint()
        topo.add_ks_buckling_derivative(1.0, 100.0)
        topo.add_eigenvector_aggregate_derivative(1.0, 1.0, dofs)
        topo.finalize_adjoint()

    return iterate


def _snapshot():
    return {name: getattr(sync, name).copy() for name in NEW + ("HOST_SYNCS",)}


@pytest.fixture(scope="module", params=["nf", "crm", "buckle"])
def runs(request):
    """The counters and ranges of one iteration with no profiler, then of
    one under the profiler with the benchmark's ``Tracer`` patched in."""
    from eigbench.trace import Tracer

    iterate = {"nf": _nf, "crm": _crm, "buckle": _buckle}[request.param]()
    entered = []
    rf = torch.autograd.profiler.record_function
    enter = rf.__enter__
    sync.clear()
    rf.__enter__ = lambda self: entered.append(self.name) or enter(self)
    try:
        iterate()
    finally:
        rf.__enter__ = enter
    off = _snapshot()
    sync.clear()
    tracer = Tracer()
    tracer.patch()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            iterate()
    finally:
        tracer.unpatch()
    on = _snapshot()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
               getattr(e, "is_user_annotation", lambda: True)())
              for e in prof.profiler.kineto_results.events()]
    sync.clear()
    return types.SimpleNamespace(kind=request.param, entered=entered,
                                 off=off, on=on, events=events)


def test_silent_without_a_profiler(runs):
    assert not runs.entered
    assert all(not runs.off[name] for name in NEW)
    assert sum(runs.off["HOST_SYNCS"].values()) > 0


def test_every_span_is_a_user_annotation(runs):
    seen = {name for name, _, _, user in runs.events if user}
    spans = set(SPANS) | (set(STATIC) if runs.kind == "buckle" else set())
    assert spans <= seen
    assert set(runs.on["SPAN_N"]) == spans
    assert runs.on["SPAN_N"]["eigd.protocol.initialize"] == 1
    assert runs.on["SPAN_N"]["eigd.protocol.finalize_adjoint"] == 1


def test_adjoint_solve_nests_under_finalize_adjoint(runs):
    def spans(name):
        return [(s, t) for n, s, t, _ in runs.events if n == name]

    outer = spans("eigd.protocol.finalize_adjoint")
    inner = spans("eigd.adjoint.solve")
    assert inner and all(any(a <= s and t <= b for a, b in outer)
                         for s, t in inner)


def test_layer_times_sum_to_the_protocol(runs):
    self_s, span_s = runs.on["SELF_S"], runs.on["SPAN_S"]
    protocol = ("eigd.protocol.initialize", "eigd.protocol.finalize_adjoint")
    five = (sum(self_s[n] for n in protocol) + self_s["eigd.eig.lanczos"]
            + span_s["eigd.factor.build"] + span_s["eigd.factor.apply"]
            + self_s["eigd.adjoint.solve"] + sum(self_s[n] for n in STATIC))
    total = sum(span_s[n] for n in protocol)
    assert total > 0 and five == pytest.approx(total, rel=1e-9)
    assert all(self_s[n] >= 0 for n in SPANS + STATIC)


def test_every_decision_site_has_a_wait_time(runs):
    assert set(runs.on["WAIT_S"]) == set(runs.on["HOST_SYNCS"])
    assert runs.on["HOST_SYNCS"] == runs.off["HOST_SYNCS"]


@pytest.mark.parametrize("read, t, want", [
    (sync.host_bool, torch.tensor(True), True),
    (sync.host_flags, torch.tensor([True, False]), [True, False])])
def test_decisions_are_timed_only_under_a_profiler(read, t, want):
    sync.clear()
    assert read(t, "off") == want
    with profile(activities=[ProfilerActivity.CPU]):
        assert read(t, "on") == want
    waits, syncs = dict(sync.WAIT_S), dict(sync.HOST_SYNCS)
    sync.clear()
    assert set(waits) == {"on"} and waits["on"] >= 0.0
    assert syncs == {"off": 1, "on": 1}


def test_benchmark_sync_ranges_still_bite(runs):
    """Every decision of the solver modules that the harness patches
    (``eigbench/trace.py`` ``SYNC_USERS``) opens its range; the buckling
    model's shift decisions (``models/buckling.py``) are not among them."""
    n = sum(1 for name, *_ in runs.events if name.startswith("eigbench.sync."))
    syncs = runs.on["HOST_SYNCS"]
    assert (runs.kind == "buckle") == (syncs["buckling_shift"] > 0)
    assert n == sum(syncs.values()) - syncs["buckling_shift"] > 0


def test_factor_columns_count_as_factor_counter():
    """SPAN_WORK of the factor applies equals ``FactorCounter``'s count on
    the same dense single-vector Lanczos solve (blocks of 3 columns
    applied through it count 3 each)."""
    from eigd_tpu_torch.ops.factor import make_shift_factor
    from eigd_tpu_torch.ops.lanczos import lanczos_solve
    from eigd_tpu_torch.utils.profile import FactorCounter

    gen = torch.Generator().manual_seed(4)
    n = 40
    X = torch.rand((n, n), generator=gen, dtype=torch.float64)
    A = X @ X.T + n * torch.eye(n, dtype=torch.float64)
    B = torch.diag(1.0 + torch.rand(n, generator=gen, dtype=torch.float64))
    counter = FactorCounter(make_shift_factor(A, B, 0.0))
    sync.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        lanczos_solve(A, B, counter, 0.0, 4, 20)
        counter.mv(torch.zeros((n, 3), dtype=torch.float64))
    work = sync.SPAN_WORK["eigd.factor.apply"]
    sync.clear()
    assert work == int(counter.count) == 23


@pytest.mark.parametrize("name", READERS)
def test_readers(runs, name):
    """None with no trace; the Counter's total over the iterations
    otherwise."""
    read = importlib.import_module(f"eigbench.metrics.{name}").read
    on = runs.on
    protocol = ("eigd.protocol.initialize", "eigd.protocol.finalize_adjoint")
    total = {"model_s": sum(on["SELF_S"][n] for n in protocol),
             "lanczos_s": on["SELF_S"]["eigd.eig.lanczos"],
             "factor_build_s": on["SPAN_S"]["eigd.factor.build"],
             "factor_apply_s": on["SPAN_S"]["eigd.factor.apply"],
             "factor_columns": on["SPAN_WORK"]["eigd.factor.apply"],
             "adjoint_solve_s": on["SELF_S"]["eigd.adjoint.solve"],
             "host_wait_s": sum(on["WAIT_S"].values())}[name]
    sync.clear()
    for counter in NEW:
        getattr(sync, counter).update(on[counter])
    try:
        assert read(types.SimpleNamespace(trace=None, iterations=2)) is None
        got = read(types.SimpleNamespace(trace={}, iterations=2))
    finally:
        sync.clear()
    assert got == pytest.approx(total / 2, rel=1e-12)
    assert total > 0 or name == "host_wait_s"


def test_static_spans_enter_in_buckling_alone(runs):
    """The static solve and its path adjoint once an iteration, the static
    factor's build counted with the shift factor's; nf and crm enter
    neither span, so their layer times keep their meaning."""
    n = runs.on["SPAN_N"]
    if runs.kind != "buckle":
        assert not set(n) & set(STATIC)
        assert n["eigd.factor.build"] == 1
        return
    assert n["eigd.static.solve"] == n["eigd.static.adjoint"] == 1
    assert n["eigd.factor.build"] == 2

    def spans(name):
        return [(s, t) for m, s, t, _ in runs.events if m == name]

    # one of the two builds, and an apply, lie inside the static solve;
    # an apply (the path adjoint's) inside the static adjoint
    for outer, inner in (("eigd.static.solve", "eigd.factor.build"),
                         ("eigd.static.solve", "eigd.factor.apply"),
                         ("eigd.static.adjoint", "eigd.factor.apply")):
        (a, b), = spans(outer)
        assert any(a <= s and t <= b for s, t in spans(inner))


def test_static_spans_count_the_iterations():
    """Two iterations of the 16x8 buckling column under a profiler enter
    each static span twice and build four factors; with no profiler the
    Counters stay empty."""
    iterate = _buckle()
    sync.clear()
    iterate()
    assert all(not getattr(sync, name) for name in NEW)
    with profile(activities=[ProfilerActivity.CPU]):
        iterate()
        iterate()
    n = sync.SPAN_N.copy()
    sync.clear()
    assert n["eigd.static.solve"] == n["eigd.static.adjoint"] == 2
    assert n["eigd.factor.build"] == 4


@pytest.mark.parametrize("name, span", [("static_solve_s", STATIC[0]),
                                        ("path_adjoint_s", STATIC[1])])
def test_static_readers(runs, name, span):
    """The inclusive time of the span per iteration where the program
    entered it; None with no trace, and None in nf and crm, which never
    enter it (as on a program without the span)."""
    read = importlib.import_module(f"eigbench.metrics.{name}").read
    sync.clear()
    for counter in NEW:
        getattr(sync, counter).update(runs.on[counter])
    try:
        assert read(types.SimpleNamespace(trace=None, iterations=2)) is None
        got = read(types.SimpleNamespace(trace={}, iterations=2))
    finally:
        sync.clear()
    if runs.kind != "buckle":
        assert got is None
    else:
        total = runs.on["SPAN_S"][span]
        assert total > 0 and got == pytest.approx(total / 2, rel=1e-12)
