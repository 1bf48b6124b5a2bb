"""How far the f32 cyclic-reduction factor of the thermal model's shifted
operator K + 0.1 M carries the shift, by grid size.

For each n, on JAX's thermal ``make_model(nx=n, ny=n, Ly=1.15, N=6,
factor_kind="bcr_f32")`` at x = 0.95:

* the row sums of one shifted element matrix in f64 and rounded to f32
  (exactly 0.1 M's row sums in exact arithmetic: K's are 0);
* ``RefinedFactor.mv`` of a random right-hand side: refinement passes, the
  exit and the relative residual;
* the constant mode: with x = M 1 the solve is exactly 10 * 1; the bare
  f32 apply's mean gain, the refined one's, and the relative residual of
  each of 12 refinement passes with no exit rule.

Run on the CPU (the default) or the card:

    python -m eigd_tpu_torch.diag.f32_shift [--device cuda] 64 256 512
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from eigd_tpu_torch.fem.assembly import element_density
from eigd_tpu_torch.models.thermal import make_model
from eigd_tpu_torch.ops import sync


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("sizes", type=int, nargs="+")
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    for n in args.sizes:
        topo = make_model(nx=n, ny=n, Ly=1.15, N=6, factor_kind="bcr_f32",
                          device=args.device)
        with torch.no_grad():
            A, B = topo._assemble(element_density(topo.fltr.apply(topo.x),
                                                  topo.conn))
            S = A.mats[0] - topo.sigma * B.mats[0]
            rs64 = S.sum(dim=1)
            rs32 = S.float().double().sum(dim=1)
            f = topo.problem.factor(A, B, topo.sigma, "normal")

            x = torch.as_tensor(np.random.default_rng(0).standard_normal(
                (A.n, 2)), device=args.device)
            sync.clear()
            y = f.mv(x)
            res = ((x - f.op.mv(y)).norm(dim=0) / x.norm(dim=0)).tolist()
            print(f"[{n}x{n}] element row sums f64 {rs64[0].item():.6e}, "
                  f"f32 {rs32[0].item():.6e} (rel "
                  f"{abs(rs32[0] / rs64[0] - 1).item():.3f}); random rhs: "
                  f"{sync.LOOP_STEPS['refine']} passes, exits "
                  f"{dict(sync.LOOP_EXITS)}, rel residual "
                  f"{max(res):.3e}", flush=True)

            xc = B.mv(torch.ones(A.n, dtype=torch.float64,
                                 device=args.device))
            bare = f._approx(xc)
            refined = f.mv(xc)
            yk, hist = bare, []
            for _ in range(12):
                r = xc - f.op.mv(yk)
                hist.append(float(r.norm() / xc.norm()))
                yk = yk + f._approx(r)
            print(f"[{n}x{n}] constant mode (exact gain 10): bare f32 "
                  f"{bare.mean().item():.6f}, refined "
                  f"{refined.mean().item():.6f}; residual by pass "
                  f"{' '.join(f'{h:.2e}' for h in hist)}", flush=True)


if __name__ == "__main__":
    main()
