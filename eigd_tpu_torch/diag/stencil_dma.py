"""Which input stream of K1 costs what at the 1M-DOF shapes: the K4 probes.

Counterpart of ``scripts/diag_pallas_dma.py``, at its shapes and seed: C =
16 channels over R = 1040 rows, for the unaligned real layout (slab width
515, W width 513, output width 513) and a 640-wide aligned one; three
slabs (16, 1040, Yx) and W (36, 1040, Yw) per layout from
``default_rng(0)`` in the script's order. It times the six K4 cases (1
slab; 1 slab + W's plane 0; 3 slabs + W's plane 0, per layout), each
beside its bound, its plain twin and, where one PyTorch call computes the
same function, that call (``Tensor.copy_`` of the window for 1 slab, one
broadcast ``torch.add`` for 1 slab + W). Kernel and library are timed as
in ``stencil_floor``: events around back-to-back calls, and the median of
graph replays in turns.

The TPU probe moved all 36 W planes into VMEM for each block while its
body reads plane 0; the Hopper kernel reads only plane 0, and the bound
counts only what the function reads.

Run on a machine with a CUDA device, from the root of the repository:

    python -m eigd_tpu_torch.diag.stencil_dma
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import cuda_probes as cp
from .common import card, line, require_cuda, timed

C, R, NT = 16, 1040, 36
LAYOUTS = ((515, 513, 513, "unaligned"), (640, 640, 640, "aligned 640"))
CASES = (("1 slab, no W", 1, False), ("1 slab + W", 1, True),
         ("3 slabs + W", 3, True))


def make_inputs():
    """{layout tag: (slabs, W, Yo)} on the card, drawn from
    ``default_rng(0)`` in the script's order."""
    rng = np.random.default_rng(0)
    out = {}
    for Yx, Yw, Yo, tag in LAYOUTS:
        slabs = [torch.as_tensor(rng.standard_normal(
            (C, R, Yx)).astype(np.float32), device="cuda") for _ in range(3)]
        W = torch.as_tensor(rng.standard_normal(
            (NT, R, Yw)).astype(np.float32), device="cuda")
        out[tag] = (slabs, W, Yo)
    return out


def cases(inputs):
    """(name, slabs, W, Yo, with_w) of the six cases."""
    for tag, (slabs, W, Yo) in inputs.items():
        for name, n, with_w in CASES:
            yield f"K4 {tag}: {name}", slabs[:n], W, Yo, with_w


def run(inputs=None):
    """Time the six K4 cases; returns one dict per case line printed."""
    inp = make_inputs() if inputs is None else inputs
    rows = []
    for name, slabs, W, Yo, with_w in cases(inp):
        args = (slabs, W, Yo, with_w)
        out = torch.empty((C, R, Yo), device=slabs[0].device)
        lib = None
        if len(slabs) == 1 and not with_w:
            lib = lambda: out.copy_(slabs[0][:, :, :Yo])  # noqa: E731
        elif len(slabs) == 1:
            lib = lambda: torch.add(  # noqa: E731
                slabs[0][:, :, :Yo], W[0, :, :Yo][None], out=out)
        # the slab windows, W's plane 0 window when read, and the output
        nbytes = 4 * R * Yo * (C * len(slabs) + int(with_w) + C)
        flops = C * R * Yo * (len(slabs) - 1 + int(with_w))
        rows.append(timed(name, lambda: cp.dma_probe(*args),
                          lambda: cp.dma_probe_ref(*args), lib, nbytes,
                          flops))
    for r in rows:
        print(line(r), flush=True)
    return rows


def main():
    require_cuda()
    print(card())
    run()


if __name__ == "__main__":
    main()
