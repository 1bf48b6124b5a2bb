"""Peak device memory of a design iteration by phase, in the benchmark's
three models, and of the natural-frequency optimisation protocol at
263,682 DOF with a second adjoint pass.

``crm_86k`` and ``nf_263k`` (``phases``): the CRM of ``diag/configs.py``
``crm_86k`` on the f64 ``bcr`` factor with the modal-compliance seeds
(``eigbench``'s ``crm_86k.compliance``), and ``make_model(**bench_263k())``
with the KS-min (ks 1) of the frequencies seeded into the eigenvalues
(``nf_263k.ksfreq``). ``buckle_263k``: ``make_buckling_model`` with the
keywords of ``diag/configs.py`` ``buckle_263k`` (f64 ``bcr``, the shift
0.8 BLF_1 of the dense pilot) at its start design, with the KS of the
inverse load factors (ks 100) plus the tanh eigenvector aggregate (rho 1)
over the y-DOFs of the loaded nodes (``buckle_263k.ksagg``'s seeds). One
warm iteration, then a measured one whose peak of allocated memory is
read in each phase: in buckling the static solve (the preload's factor
build and apply, ``_static``), then the assembly and the factor build
(``initialize`` up to the end of the span ``eigd.factor.build``), the
Lanczos solve (the span ``eigd.eig.lanczos``), the rest of ``initialize``
with ``initialize_adjoint``, the seeds, and ``finalize_adjoint``; each
phase's peak counts what was allocated when it began, and a phase entered
again (the buckling model's second solve at a moved shift) reads its
highest. ``minfreq``:
``MinFreqOpt``'s initialize, initialize_adjoint and finalize_adjoint on
the ``bench_263k`` model (a warm protocol first, then a measured one): the
peak over the three calls and what stays allocated after them; then a
second initialize_adjoint and finalize_adjoint on the same solve, with its
peak, or the exception it raises.

The imports are absolute, so the script also measures another checkout's
package: from the root of that checkout,

    python -c "import runpy, sys; sys.argv[1:] = ['crm_86k'];
               runpy.run_path('<this file>', run_name='__main__')"

and from the root of this one, on a machine with a CUDA device (every
mode when none is named):

    python -m eigd_tpu_torch.diag.protocol_peak [crm_86k] [nf_263k]
        [buckle_263k] [minfreq]
"""

from __future__ import annotations

import contextlib
import sys

import torch

from eigd_tpu_torch.diag.common import card, require_cuda
from eigd_tpu_torch.diag.configs import bench_263k, buckle_263k, crm_86k
from eigd_tpu_torch.ops import autodiff

PHASES = ("static solve", "assembly+build", "lanczos", "initialize rest",
          "seeds", "finalize_adjoint")
# the span whose end closes a phase, and the phase it opens
SPAN_ENDS = {"eigd.factor.build": ("assembly+build", "lanczos"),
             "eigd.eig.lanczos": ("lanczos", "initialize rest")}


def gib(nbytes):
    return nbytes / 2**30


class PhasePeaks:
    """The peak of allocated memory in each phase: ``begin(name)`` ends
    the phase open, if any, and opens ``name``; ``end()`` closes it."""

    def __init__(self):
        self.peaks, self.open = {}, None

    def end(self):
        if self.open is not None:
            torch.cuda.synchronize()
            self.peaks[self.open] = max(self.peaks.get(self.open, 0),
                                        torch.cuda.max_memory_allocated())
            self.open = None

    def begin(self, name):
        self.end()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.open = name

    def after(self, phase, following):
        """Open ``following`` if ``phase`` is the one open."""
        if self.open == phase:
            self.begin(following)


@contextlib.contextmanager
def watched_spans(meter):
    """``autodiff``'s spans, with the ends of the factor build and of the
    Lanczos solve moving ``meter`` to the next phase."""
    plain = autodiff.span

    @contextlib.contextmanager
    def then(ctx, phase, following):
        with ctx:
            yield
        meter.after(phase, following)

    def span(name, work=0):
        ctx = plain(name, work)
        if name in SPAN_ENDS and not callable(work):
            return then(ctx, *SPAN_ENDS[name])
        return ctx

    autodiff.span = span
    try:
        yield
    finally:
        autodiff.span = plain


def crm_cell():
    from eigd_tpu_torch.models.crm import CRM

    model = CRM(device="cuda", factor_kind="bcr", **crm_86k())

    def seeds():
        value = model.get_modal_compliance()
        model.add_modal_compliance_derivative(1.0)
        return value

    return model, seeds


def nf_cell(ks=1.0):
    from eigd_tpu_torch.models.natural_frequency import make_model

    model = make_model(device="cuda", **bench_263k())

    def seeds():
        with torch.enable_grad():
            omega = torch.sqrt(model.lam).requires_grad_(True)
            low = torch.min(omega)
            f = low - torch.log(torch.sum(torch.exp(-ks * (omega - low)))) / ks
            (omegab,) = torch.autograd.grad(f, omega)
        model.add_frequency_derivatives(omegab)
        return f.detach()

    return model, seeds


def buckle_cell(ks=100.0, agg=1.0):
    from eigd_tpu_torch.diag.configs import BUCKLE_PILOT, SIGMA_MARGIN
    from eigd_tpu_torch.models.buckling import first_blf, make_buckling_model

    pilot = make_buckling_model(sigma=1.0, device="cuda", **BUCKLE_PILOT)
    sigma = SIGMA_MARGIN * first_blf(pilot)
    model = make_buckling_model(device="cuda", **buckle_263k(sigma))
    # the load is in x: the y-DOFs of the loaded nodes follow its DOFs
    dofs = (torch.nonzero(model.f).flatten() + 1).cpu().numpy()

    def seeds():
        value = (model.eval_ks_buckling(ks)
                 + model.get_eigenvector_aggregate(agg, dofs))
        model.add_ks_buckling_derivative(1.0, ks)
        model.add_eigenvector_aggregate_derivative(1.0, agg, dofs)
        return value

    return model, seeds


def phases(name, make):
    model, seeds = make()
    meter = PhasePeaks()
    static = getattr(model, "_static", None)
    if static is not None:  # the buckling model's preload: a phase apart

        def watched(rhoE):
            meter.begin("static solve")
            out = static(rhoE)
            meter.begin("assembly+build")
            return out

        model._static = watched
    for run in ("warm", "measured"):
        meter.peaks = {}
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        with watched_spans(meter):
            meter.begin(PHASES[0] if static else PHASES[1])
            model.initialize()
            model.initialize_adjoint()
            meter.begin("seeds")
            seeds()
            meter.begin("finalize_adjoint")
            model.finalize_adjoint()
            meter.end()
        top = max(meter.peaks, key=meter.peaks.get)
        cells = ", ".join(f"{p} {gib(meter.peaks[p]):.6f}" for p in PHASES
                          if p in meter.peaks)
        print(f"[{name} {run}] peak GiB by phase: {cells}; highest "
              f"{top}; {gib(held):.6f} GiB allocated before, "
              f"{gib(torch.cuda.memory_allocated()):.6f} after", flush=True)


def minfreq():
    from eigd_tpu_torch.models.natural_frequency import MinFreqOpt, make_model

    opt = MinFreqOpt(make_model(device="cuda", **bench_263k()))
    for run in ("warm", "measured"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        opt.initialize()
        opt.initialize_adjoint()
        opt.finalize_adjoint()
        torch.cuda.synchronize()
        peak = gib(torch.cuda.max_memory_allocated())
        print(f"[protocol {run}] peak {peak:.3f} GiB over initialize + "
              f"finalize_adjoint; "
              f"{gib(torch.cuda.memory_allocated()):.3f} GiB allocated after",
              flush=True)
    xb = opt.topo.xb.clone()
    torch.cuda.reset_peak_memory_stats()
    try:
        opt.initialize_adjoint()
        opt.finalize_adjoint()
    except Exception as e:  # the outcome is the measurement: report it
        print(f"[second pass] raises {type(e).__name__}: {e}", flush=True)
        return
    torch.cuda.synchronize()
    gap = float((opt.topo.xb - xb).abs().max() / xb.abs().max())
    print(f"[second pass] peak {gib(torch.cuda.max_memory_allocated()):.3f} "
          f"GiB; xb against the first pass's: rel {gap:.3e}", flush=True)


MODES = {"crm_86k": lambda: phases("crm_86k", crm_cell),
         "nf_263k": lambda: phases("nf_263k", nf_cell),
         "buckle_263k": lambda: phases("buckle_263k", buckle_cell),
         "minfreq": minfreq}


def main(argv=None):
    names = (sys.argv[1:] if argv is None else argv) or list(MODES)
    require_cuda()
    print(card(), flush=True)
    for name in names:
        MODES[name]()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
