"""Peak device memory of the natural-frequency optimisation protocol at
263,682 DOF, and whether a second adjoint pass runs on one solve.

``MinFreqOpt``'s initialize, initialize_adjoint and finalize_adjoint on
the ``bench_263k`` model (a warm protocol first, then a measured one): the
peak of allocated memory over the three calls and what stays allocated
after them; then a second initialize_adjoint and finalize_adjoint on the
same solve, with its peak, or the exception it raises. The imports are
absolute, so the script also measures another checkout's package: from the
root of that checkout,

    python -c "import runpy; runpy.run_path('<this file>',
               run_name='__main__')"

and from the root of this one, on a machine with a CUDA device:

    python -m eigd_tpu_torch.diag.protocol_peak
"""

from __future__ import annotations

import torch

from eigd_tpu_torch.diag.common import card, require_cuda
from eigd_tpu_torch.diag.configs import bench_263k
from eigd_tpu_torch.models.natural_frequency import MinFreqOpt, make_model


def gib(nbytes):
    return nbytes / 2**30


def main():
    require_cuda()
    print(card(), flush=True)
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


if __name__ == "__main__":
    main()
