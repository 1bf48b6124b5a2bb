"""Peak device memory of a design iteration by phase, in the benchmark's
two models, and of the natural-frequency optimisation protocol at 263,682
DOF with a second adjoint pass.

``crm_86k`` and ``nf_263k`` (``phases``): the CRM of ``diag/configs.py``
``crm_86k`` on the f64 ``bcr`` factor with the modal-compliance seeds
(``eigbench``'s ``crm_86k.compliance``), and ``make_model(**bench_263k())``
with the KS-min (ks 1) of the frequencies seeded into the eigenvalues
(``nf_263k.ksfreq``). One warm iteration, then a measured one whose peak
of allocated memory is read in each phase: the assembly and the factor
build (``initialize`` up to the end of the span ``eigd.factor.build``), the
Lanczos solve (the span ``eigd.eig.lanczos``), the rest of ``initialize``
with ``initialize_adjoint``, the seeds, and ``finalize_adjoint``; each
phase's peak counts what was allocated when it began. ``minfreq``:
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

    python -m eigd_tpu_torch.diag.protocol_peak [crm_86k] [nf_263k] [minfreq]
"""

from __future__ import annotations

import contextlib
import sys

import torch

from eigd_tpu_torch.diag.common import card, require_cuda
from eigd_tpu_torch.diag.configs import bench_263k, crm_86k
from eigd_tpu_torch.ops import autodiff

PHASES = ("assembly+build", "lanczos", "initialize rest", "seeds",
          "finalize_adjoint")
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
            self.peaks[self.open] = torch.cuda.max_memory_allocated()
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


def phases(name, make):
    model, seeds = make()
    meter = PhasePeaks()
    for run in ("warm", "measured"):
        meter.peaks = {}
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        with watched_spans(meter):
            meter.begin(PHASES[0])
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
