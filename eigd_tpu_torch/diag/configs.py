"""The configurations that the port drives on the card: the two of
``bench.py`` with the bench objective, and the buckling one.

``bench_263k``: the 512x256 problem (263,682 DOF) of ``bench.py:77-255``.
``bench_1m``: the 1024x512 north-star problem (1,051,650 DOF) of its big
branch (``bench.py:80-155``): adaptive Lanczos exit, block 8, polish 2 with
no spare, PCG stagnation exits, the approx sweep at approx_rtol and
adjoint rtol 1e-7. Both run the V-cycle on the kernels. Nothing is cut.
``buckle_263k``: JAX's ``make_buckling_model`` at the same 512x256 grid
(263,682 DOF) on the f64 cyclic-reduction factor, every other option at
its default (spatial filter, m 60, single-vector Lanczos, SIBK), with the
shift from a dense pilot at 32x16 (``BUCKLE_PILOT``, ``SIGMA_MARGIN``).
``crm_86k``, ``crm_143k``, ``crm_1m``: the CRM wingbox of
``scripts/bench_crm.py:40-44`` (86,352 padded DOF), of
``tests/test_crm.py:275-284`` (143,832) and of
``scripts/run_crm_large.py:54-62`` (998,712), N 6 and every other option
JAX's ``CRM`` default: ``bcr_f32`` (PCGFactor on the jittered f32 BCR),
block 8, the approx sweep, polish 3, the mixed SIBK. Nothing is cut.
"""

from __future__ import annotations

import torch

ADJOINT = {"maxiter": 30, "nrestart": 8, "mixed": True, "ladder": "approx"}


def bench_263k():
    fo = {"rtol": 1e-11, "maxiter": 60, "approx_rtol": 1e-5,
          "approx_maxiter": 18, "sweep_rtol": 0.0, "sweep_maxiter": 24,
          "degree": 3, "min_coarse": 4500, "stag_bad": 1000000,
          "vcycle": "kernel"}
    return dict(nx=512, ny=256, Lx=2.0, Ly=1.0, N=6, rfact=2.0, m=176,
                factor_kind="mg", lanczos_tol=None, lanczos_block=16,
                lanczos_ortho="local", lanczos_check_every=2, rtol=4e-8,
                sigma=-1.0, factor_options=fo, lanczos_polish=3,
                lanczos_polish_spare=8, adjoint_method="sibk",
                adjoint_options=dict(ADJOINT), lanczos_sweep="approx")


def bench_1m():
    fo = {"rtol": 1e-11, "maxiter": 60, "approx_rtol": 1e-5,
          "approx_maxiter": 18, "sweep_rtol": None, "sweep_maxiter": None,
          "degree": 3, "min_coarse": 4500, "stag_bad": 2, "vcycle": "kernel"}
    return dict(nx=1024, ny=512, Lx=2.0, Ly=1.0, N=6, rfact=2.0, m=176,
                factor_kind="mg", lanczos_tol=1e-11, lanczos_block=8,
                lanczos_ortho="local", lanczos_check_every=2, rtol=1e-7,
                sigma=-1.0, factor_options=fo, lanczos_polish=2,
                lanczos_polish_spare=0, adjoint_method="sibk",
                adjoint_options=dict(ADJOINT), lanczos_sweep="approx")


CONFIGS = {"263k": bench_263k, "1m": bench_1m}

# the dense model that estimates the first load factor, and the margin of
# the shift below it (examples/buckling.py)
BUCKLE_PILOT = dict(nx=32, ny=16, Lx=2.0, Ly=1.0, rfact=2.0, N=6,
                    load_frac=0.2)
SIGMA_MARGIN = 0.8


def buckle_263k(sigma, factor_kind="bcr"):
    """make_buckling_model's keywords at 512x256 with the shift sigma."""
    return dict(nx=512, ny=256, Lx=2.0, Ly=1.0, rfact=2.0, N=6,
                load_frac=0.2, factor_kind=factor_kind, sigma=sigma)


def tail(lam, Q):
    """The bench objective (bench.py:268-276)."""
    eta = torch.exp(-2.0 * (lam - lam[0]))
    return torch.sum(torch.sqrt(lam)) + torch.sum(eta[None, :] * Q[:8] ** 2)


def crm_86k():
    """The CRM bench mesh: 11,720 nodes, 12,288 elements, 257 stations x
    b 336 = 86,352 padded DOF, m 96."""
    return dict(nspan=256, nchord=16, nheight=4, N=6, m=96)


def crm_143k():
    """The CRM record mesh: 19,731 nodes, 20,664 elements, 461 x 312 =
    143,832 padded DOF."""
    return dict(nspan=460, nchord=12, nheight=6, N=6)


def crm_1m():
    """The CRM flagship mesh: 137,236 nodes, 144,000 elements, 3,201 x
    312 = 998,712 padded DOF."""
    return dict(nspan=3200, nchord=12, nheight=6, N=6, span=29.38,
                c_root=7.0)


CRM_CONFIGS = {"86k": crm_86k, "143k": crm_143k, "1m": crm_1m}
