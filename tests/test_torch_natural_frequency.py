"""The port's main path end to end against eigd_tpu's, on the CPU.

The natural-frequency model (conv filter -> grid stencils -> multigrid
block shift-invert Lanczos -> eigh_gen adjoint) at the configuration of
tests/test_pallas_stencil.py's end-to-end test, with the bench's
eta-weighted objective, from the same numpy start block on both sides.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigd_tpu.models.natural_frequency import make_model as j_make_model
from eigd_tpu_torch.fem.filter import NodeFilter
from eigd_tpu_torch.interop import (analysis_from_numpy, filter_from_numpy,
                                    mg_factor_from_numpy,
                                    stencil_operator_from_numpy,
                                    thermal_from_numpy)
from eigd_tpu_torch.models.natural_frequency import make_model as t_make_model
from eigd_tpu_torch.models.thermal import make_model as t_thermal_model
from eigd_tpu_torch.ops import cuda_stencil, sync

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
KW = dict(nx=12, ny=6, N=2, m=32, Lx=2.0, Ly=1.0, rfact=2.0, factor_kind="mg",
          lanczos_block=4, lanczos_ortho="local", lanczos_tol=1e-11,
          lanczos_polish=1)
MIXED = {"mixed": True, "ladder": "approx", "maxiter": 30, "nrestart": 8}
V0 = np.random.default_rng(11).uniform(-1.0, 1.0, (2 * 13 * 7, 4))


def j_value_and_grad(sweep):
    kw = dict(KW, lanczos_sweep=sweep, factor_options={"min_coarse": 64})
    if sweep == "approx":
        kw["adjoint_options"] = MIXED
    topo = j_make_model(pallas_mv="off", **kw)
    topo.problem = dataclasses.replace(topo.problem,
                                       v0=lambda th: jnp.asarray(V0))

    def f(x):
        lam, Q, _, _ = topo._solve_fn(x)
        eta = jnp.exp(-2.0 * (lam - lam[0]))
        val = jnp.sum(jnp.sqrt(lam)) + jnp.sum(eta[None, :] * Q[:8] ** 2)
        return val, lam

    (v, lam), g = jax.value_and_grad(f, has_aux=True)(jnp.asarray(topo.x))
    return float(v), np.asarray(lam), np.asarray(g), topo


def t_model(sweep="exact", kernel_mv="on", jax_topo=None, **over):
    """The port's model: from make_model, or (jax_topo given) from the JAX
    model's state carried across by interop.analysis_from_numpy."""
    kw = dict(KW, lanczos_sweep=sweep, kernel_mv=kernel_mv,
              factor_options={"min_coarse": 64,
                              "vcycle": "kernel" if kernel_mv == "on"
                              else "plain"})
    if sweep == "approx":
        kw["adjoint_options"] = MIXED
    kw.update(over)
    if jax_topo is None:
        topo = t_make_model(device="cpu", **kw)
    else:
        f = jax_topo.fltr
        for name in ("nx", "ny", "Lx", "Ly", "rfact"):
            kw.pop(name)
        topo = analysis_from_numpy(
            np.asarray(jax_topo.x), np.asarray(jax_topo.X),
            np.asarray(jax_topo.conn), np.asarray(f.dvmap),
            f.num_design_vars, np.asarray(f._kernel), f.grid_shape, f.r0,
            device="cpu", **kw)
    topo.problem = dataclasses.replace(topo.problem,
                                       v0=lambda th: torch.as_tensor(V0))
    return topo


def t_objective(topo, x):
    lam, Q, _, _ = topo._solve_fn(x)
    eta = torch.exp(-2.0 * (lam - lam[0]))
    val = torch.sum(torch.sqrt(lam)) + torch.sum(eta[None, :] * Q[:8] ** 2)
    return val, lam


def t_value_and_grad(topo):
    x = topo.x.clone().requires_grad_(True)
    v, lam = t_objective(topo, x)
    v.backward()
    return v.item(), lam.detach().numpy(), x.grad.numpy()


def test_port_imports_no_jax():
    code = ("import sys; import eigd_tpu_torch, eigd_tpu_torch.interop, "
            "eigd_tpu_torch.models.natural_frequency, "
            "eigd_tpu_torch.models.thermal, eigd_tpu_torch.ops.blockfactor, "
            "eigd_tpu_torch.ops.autodiff, eigd_tpu_torch.ops.cuda_probes, "
            "eigd_tpu_torch.diag.common, eigd_tpu_torch.diag.stencil_floor, "
            "eigd_tpu_torch.diag.stencil_dma, eigd_tpu_torch.diag.profile, "
            "eigd_tpu_torch.diag.build_time, "
            "eigd_tpu_torch.diag.protocol_peak, "
            "eigd_tpu_torch.diag.f32_shift, "
            "eigd_tpu_torch.diag.stencil_host, eigd_tpu_torch.models.crm, "
            "eigd_tpu_torch.fem.shell, eigd_tpu_torch.fem.bdf, "
            "eigd_tpu_torch.diag.crm, eigd_tpu_torch.ops.restart, "
            "eigd_tpu_torch.utils.checkpoint, eigd_tpu_torch.utils.profile, "
            "eigd_tpu_torch.utils.plot, "
            "eigd_tpu_torch.examples.natural_frequency, "
            "eigd_tpu_torch.examples.thermal, "
            "eigd_tpu_torch.examples.buckling, "
            "eigd_tpu_torch.examples.crm, eigd_tpu_torch.parallel, "
            "eigd_tpu_torch.parallel.grid, eigd_tpu_torch.parallel.launch, "
            "eigd_tpu_torch.parallel.sharded, "
            "eigd_tpu_torch.parallel.mgshard, eigd_tpu_torch.parallel.runs, "
            "eigd_tpu_torch.graft_entry, chip_smoke; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'eigd_tpu.')) or m == 'eigd_tpu']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


@pytest.mark.parametrize("entry", ["make_model", "make_model_dense",
                                   "NodeFilter_spatial",
                                   "NodeFilter_helmholtz",
                                   "analysis_from_numpy", "filter_from_numpy",
                                   "stencil_operator_from_numpy",
                                   "mg_factor_from_numpy",
                                   "thermal_make_model",
                                   "thermal_from_numpy"])
def test_entry_points_default_to_the_card(entry):
    """With no device given, an entry point builds on the card: on a
    machine without one it fails on the first CUDA allocation and never
    returns a CPU object."""
    jt = j_make_model(nx=4, ny=2, N=2, m=16, Lx=2.0, Ly=1.0, rfact=2.0,
                      factor_kind="mg", lanczos_block=4)
    f = jt.fltr
    W = np.random.default_rng(0).standard_normal((5, 3, 3, 3, 2, 2))
    X, conn = np.asarray(jt.X), np.asarray(jt.conn)
    calls = {
        "make_model": lambda: t_make_model(nx=4, ny=2, N=2, m=16,
                                           factor_kind="mg",
                                           lanczos_block=4),
        "make_model_dense": lambda: t_make_model(nx=4, ny=2, N=2),
        "NodeFilter_spatial": lambda: NodeFilter(conn, X, r0=0.5),
        "NodeFilter_helmholtz": lambda: NodeFilter(conn, X, r0=0.5,
                                                   ftype="helmholtz"),
        "filter_from_numpy": lambda: filter_from_numpy(
            conn, X, 0.5, "spatial", (np.zeros((15, 2), np.int64),
                                      np.ones((15, 2)))),
        "analysis_from_numpy": lambda: analysis_from_numpy(
            np.asarray(jt.x), np.asarray(jt.X), np.asarray(jt.conn),
            np.asarray(f.dvmap), f.num_design_vars, np.asarray(f._kernel),
            f.grid_shape, f.r0, N=2, m=16, lanczos_block=4),
        "stencil_operator_from_numpy": lambda: stencil_operator_from_numpy(
            W, None, None, 30, (4, 2), 2),
        "mg_factor_from_numpy": lambda: mg_factor_from_numpy(
            [W], [np.ones(30)], [1.0], np.eye(30), W, [(4, 2)], 2),
        "thermal_make_model": lambda: t_thermal_model(nx=4, ny=2, N=2,
                                                      factor_kind="mg"),
        "thermal_from_numpy": lambda: thermal_from_numpy(
            np.ones(15), X, conn, {}, (np.zeros((15, 2), np.int64),
                                       np.ones((15, 2))), (4, 2), 0.5, N=2),
    }
    if torch.cuda.is_available():
        obj = calls[entry]()
        t = next((getattr(obj, a) for a in ("x", "W", "wts", "_Bmat")
                  if getattr(obj, a, None) is not None), None)
        t = obj.Ws[0] if t is None else t
        assert t.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            calls[entry]()


# Bounds: "exact" solves every factor apply to rtol 1e-13, so the two
# packages run the same algorithm up to f64 rounding (measured 6e-14 on the
# gradient). "approx" drives the sweep and the adjoint ladder with f32
# solves at approx_rtol 1e-5 whose rounding differs between XLA:CPU and
# torch (and between the vector and plane V-cycle layouts); the polish and
# the f64 restarts contract that difference but do not remove it. Measured
# there: lam 2e-10, objective 1.2e-7, gradient 8.3e-7 (plane V-cycle) and
# 2.9e-7 (vector V-cycle); the bounds are 1e-8, 1e-6 and 5e-6.
@pytest.mark.parametrize("sweep,lam_tol,val_tol,grad_tol",
                         [("exact", 1e-12, 1e-12, 1e-8),
                          ("approx", 1e-8, 1e-6, 5e-6)])
def test_gradient_matches_jax(sweep, lam_tol, val_tol, grad_tol):
    jv, jlam, jg, jtopo = j_value_and_grad(sweep)
    k1, k2 = cuda_stencil.K1_LAUNCHES, cuda_stencil.K2_LAUNCHES
    # kernel path on the JAX model's carried-across state; plain path on
    # the port's own make_model
    for kernel_mv, carried in (("on", jtopo), ("off", None)):
        tv, tlam, tg = t_value_and_grad(t_model(sweep, kernel_mv, carried))
        assert np.abs(tlam - jlam).max() <= lam_tol * np.abs(jlam).max()
        assert abs(tv - jv) <= val_tol * abs(jv)
        assert np.abs(tg - jg).max() <= grad_tol * np.abs(jg).max()
    # on CPU tensors the kernel path ran the twins and launched nothing
    assert (cuda_stencil.K1_LAUNCHES, cuda_stencil.K2_LAUNCHES) == (k1, k2)


def test_gradient_matches_finite_difference():
    """The port alone against a central difference at 1e-6. m=48 (block
    degree 12 >= 2N+6): at the parity config's m=32 the sweep is short of
    converged, and the objective's FD reads 3e-3 on both packages alike."""
    topo = t_model(m=48, lanczos_tol=None)
    sync.HOST_SYNCS.clear()
    _, _, g = t_value_and_grad(topo)
    # every f64 PCG iteration and SIBK round is one counted host decision
    assert sync.HOST_SYNCS["pcg_f64"] > 0 and sync.HOST_SYNCS["sibk_round"] > 0
    p = torch.as_tensor(np.random.default_rng(7).uniform(size=g.shape))
    h = 1e-5
    with torch.no_grad():
        fd = (t_objective(topo, topo.x + h * p)[0].item()
              - t_objective(topo, topo.x - h * p)[0].item()) / (2 * h)
    ans = float(p.numpy() @ g)
    assert abs(ans - fd) <= 1e-6 * abs(fd)


def test_vjp_without_parts_is_the_one_assembly():
    """A problem without ``assemble_parts`` (the NF model) takes the
    bilinear-form VJP over one assembly: xb of ``EighGen``'s backward is
    bitwise the adjoint solve on the kept solve followed by one
    ``torch.autograd.grad`` of sum(W_A * A phi) - sum(W_B * B phi) over
    ``problem.assemble``, and the backward assembles once."""
    from eigd_tpu_torch.fem import assembly as tfem
    from eigd_tpu_torch.ops import autodiff as tad

    topo = t_model()
    assert topo.problem.assemble_parts is None
    built = []

    def counted(theta):
        built.append(1)
        return topo.problem.assemble(theta)

    problem = dataclasses.replace(topo.problem, assemble=counted)
    rhoE = tfem.element_density(topo.fltr.apply(topo.x), topo.conn)
    rhoE = rhoE.detach().requires_grad_(True)
    lam, Phi = tad.eigh_gen(rhoE, problem, topo.cfg)
    g = torch.Generator().manual_seed(5)
    lam_bar = torch.rand(lam.shape, generator=g, dtype=lam.dtype)
    Phi_bar = torch.rand(Phi.shape, generator=g, dtype=Phi.dtype)

    (leaf,), (A, B, res, factor) = tad._kept_solve(lam.grad_fn)
    W_A, W_B, Phi_k = tad.solve_eig_adjoint(A, B, res, factor, lam_bar,
                                            Phi_bar, topo.cfg)
    with torch.enable_grad():
        th = leaf.detach().requires_grad_(True)
        A2, B2 = topo.problem.assemble(th)
        f = (torch.sum(W_A * A2.mv(Phi_k))
             - torch.sum(W_B * B2.mv(Phi_k)))
        (ref,) = torch.autograd.grad(f, th)

    built.clear()
    (xb,) = torch.autograd.grad((lam, Phi), rhoE, (lam_bar, Phi_bar))
    assert torch.equal(xb, ref)
    assert len(built) == 1
