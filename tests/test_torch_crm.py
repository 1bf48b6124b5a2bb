"""Parity of the port's CRM wingbox family and ``eigh_gen_fwdmode`` with
eigd_tpu's, on the CPU (x64).

The shell element (``fem/shell.py``) on random warped quads, with its
rigid modes and mass; the mesh, the station balancing, the BDF reader and
the BFS levels, bitwise; the model at nspan 4, nchord 2, nheight 1
(N 4, m 40, nribs 1) on the dense and the ``bcr_f32`` paths from JAX's
start vector (eigenvalues, compliance, xb, the forward-mode
``objective_jvp``, a second adjoint pass on one solve, the protocol
against autograd of ``_solve_fn``); the f64 ``bcr`` factor under the
approx sweep; ``from_bdf`` on tests/test_bdf.py's plate deck; and
``torch.func.jvp`` through ``eigh_gen_fwdmode`` against ``jax.jvp``
through JAX's, on the natural-frequency and the buckling chains of
tests/test_autodiff_jvp.py. Each JAX model is solved once, in a
module-scoped fixture.

Bounds. The dense path solves exactly: eigenvalues 1e-10, xb 1e-8
(measured 4.7e-13, 5.8e-12). ``bcr_f32``'s mixed SIBK ladder runs f32 PCG
solves that XLA:CPU and torch round differently: eigenvalues 1e-9, xb
1e-7 (measured 1.8e-13, 3.9e-12). jvp-vs-vjp within the port shares the
primal solve: 1e-8, JAX's bar (tests/test_crm.py:211-227).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigd_tpu.fem import assembly as jfem
from eigd_tpu.fem import bdf as jbdf
from eigd_tpu.fem.shell import shell_element_matrices as j_shell
from eigd_tpu.models import crm as jcrm
from eigd_tpu.ops import autodiff as jad
from eigd_tpu.ops.operators import ElementOperator as JElement
from eigd_tpu_torch.fem import assembly as tfem
from eigd_tpu_torch.fem import bdf as tbdf
from eigd_tpu_torch.fem.shell import shell_dof_map
from eigd_tpu_torch.fem.shell import shell_element_matrices as t_shell
from eigd_tpu_torch.interop import buckling_from_numpy, crm_from_numpy
from eigd_tpu_torch.models import crm as tcrm
from eigd_tpu_torch.ops import autodiff as tad
from eigd_tpu_torch.ops.operators import ElementOperator
from tests.test_bdf import plate_bdf_lines

torch.set_num_threads(1)
KW = dict(nspan=4, nchord=2, nheight=1, N=4, m=40, nribs=1)
P3 = np.random.default_rng(3).uniform(size=5)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def j_start(n, seed=12345):
    """JAX's default single-vector Lanczos start vector."""
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (n,),
                                         dtype=jnp.float64, minval=-1.0,
                                         maxval=1.0))


def random_quads(n=40, seed=0):
    """n warped, rotated, stretched unit quads and their thicknesses."""
    rng = np.random.default_rng(seed)
    base = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [1.0, 1.0, 0.0],
                     [0.0, 1.0, 0.0]])
    Q, _ = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    Xe = np.einsum("nij,nkj->nki", Q, base * rng.uniform(0.5, 2.0, (n, 1, 3)))
    Xe = Xe + 0.1 * rng.standard_normal((n, 4, 3))
    return Xe, rng.uniform(0.002, 0.03, n)


# ---------------------------------------------------------------------------
# fem: the shell element
# ---------------------------------------------------------------------------


def test_shell_element_matrices_match_jax():
    """Ke, Me on random warped quads, and the thickness gradient of a
    bilinear form of both (autograd against jax.grad): 1e-12 relative."""
    Xe, t = random_quads()
    Kj, Mj = j_shell(jnp.asarray(Xe), jnp.asarray(t))
    W = np.random.default_rng(1).standard_normal((len(t), 24, 24))

    def j_form(tt):
        K, M = j_shell(jnp.asarray(Xe), tt)
        return jnp.sum(jnp.asarray(W) * (K + 1e7 * M))

    gj = jax.grad(j_form)(jnp.asarray(t))
    tt = torch.as_tensor(t).requires_grad_(True)
    K, M = t_shell(torch.as_tensor(Xe), tt)
    (gt,) = torch.autograd.grad(torch.sum(torch.as_tensor(W) * (K + 1e7 * M)),
                                tt)
    assert rel(K.detach(), Kj) <= 1e-12
    assert rel(M.detach(), Mj) <= 1e-12
    assert rel(gt, gj) <= 1e-12


@pytest.mark.parametrize("case", ["rigid", "rotated", "mass"])
def test_shell_element_physics(case):
    """tests/test_crm.py:14-54 on the port: six zero-energy modes with no
    drilling stiffness, a stiffness spectrum invariant under a rigid
    rotation, and the translational mass rho t area."""
    if case == "rigid":
        Xe = torch.tensor([[[0.0, 0.0, 0.5], [1.0, 0.0, 0.5],
                            [1.1, 0.9, 0.5], [0.1, 1.0, 0.5]]],
                          dtype=torch.float64)
        K, _ = t_shell(Xe, torch.tensor([0.01], dtype=torch.float64),
                       drill=0.0)
        w = np.linalg.eigvalsh(K[0].numpy())
        assert (np.abs(w) < 1e-9 * np.abs(w).max()).sum() >= 6
    elif case == "rotated":
        Xe0 = np.array([[[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [1.0, 1.0, 0.0],
                         [0.0, 1.0, 0.0]]])
        th = 0.7
        Rz = np.array([[np.cos(th), -np.sin(th), 0.0],
                       [np.sin(th), np.cos(th), 0.0], [0.0, 0.0, 1.0]])
        Rx = np.array([[1.0, 0.0, 0.0], [0.0, np.cos(0.4), -np.sin(0.4)],
                       [0.0, np.sin(0.4), np.cos(0.4)]])
        Xe1 = np.einsum("ij,nkj->nki", Rx @ Rz, Xe0)
        t = torch.tensor([0.02], dtype=torch.float64)
        w0 = np.linalg.eigvalsh(t_shell(torch.as_tensor(Xe0), t)[0][0])
        w1 = np.linalg.eigvalsh(t_shell(torch.as_tensor(Xe1), t)[0][0])
        np.testing.assert_allclose(w1, w0, rtol=1e-8,
                                   atol=1e-4 * abs(w0).max())
    else:
        Xe = torch.tensor([[[0.0, 0.0, 0.0], [2.0, 0.0, 0.0],
                            [2.0, 1.0, 0.0], [0.0, 1.0, 0.0]]],
                          dtype=torch.float64)
        _, M = t_shell(Xe, torch.tensor([0.01], dtype=torch.float64),
                       rho=2700.0)
        tz = torch.zeros(24, dtype=torch.float64)
        tz[2::6] = 1.0
        np.testing.assert_allclose(float(tz @ M[0] @ tz), 2700.0 * 0.02,
                                   rtol=1e-10)


def test_shell_dof_map_matches_jax():
    conn = np.random.default_rng(2).integers(0, 50, (30, 4))
    from eigd_tpu.fem.shell import shell_dof_map as j_map

    assert np.array_equal(shell_dof_map(conn), np.asarray(j_map(conn)))


# ---------------------------------------------------------------------------
# mesh, station balancing, BDF ingestion (numpy, bitwise)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", [(24, 8, 4, 5), (4, 2, 1, 1)],
                         ids=["24x8x4-ribbed", "4x2x1"])
def test_wingbox_mesh_and_balance_match_jax(mesh):
    nspan, nchord, nheight, nribs = mesh
    ref = jcrm.make_wingbox_mesh(nspan, nchord, nheight, nribs=nribs)
    got = tcrm.make_wingbox_mesh(nspan, nchord, nheight, nribs=nribs)
    for a, b in zip(got[:3], ref[:3]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got[3] == ref[3]
    X, conn = ref[0], ref[1]
    ys = np.unique(np.round(X[:, 1], 9))
    station = np.searchsorted(ys, np.round(X[:, 1], 9))
    assert np.array_equal(
        tcrm.balance_node_blocks(station, conn, len(ys)),
        jcrm.balance_node_blocks(station, conn, len(ys)))


def _decks():
    plate = plate_bdf_lines()
    orphan = plate[:-1] + ["GRID,9999,,5.0,5.0,5.0", plate[-1]]
    partial = plate[:-1] + ["SPC,5,17,3,0.0", plate[-1]]
    return {"plate": plate, "orphan-grid": orphan, "partial-spc": partial}


@pytest.mark.parametrize("deck", sorted(_decks()))
def test_bdf_and_levels_match_jax(deck):
    """parse_bdf's every field and bfs_levels, bitwise, on
    tests/test_bdf.py's plate deck and its orphan-grid and partial-SPC
    variants."""
    lines = _decks()[deck]
    ref, got = jbdf.parse_bdf(lines), tbdf.parse_bdf(lines)
    for name in ("X", "node_ids", "conn", "comp", "thickness", "spc_nodes"):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for name in ("component_names", "E", "nu", "rho", "skipped",
                 "warnings"):
        assert getattr(got, name) == getattr(ref, name), name
    lv_j = jbdf.bfs_levels(ref.conn, ref.X.shape[0], ref.spc_nodes)
    lv_t = tbdf.bfs_levels(got.conn, got.X.shape[0], got.spc_nodes)
    assert np.array_equal(lv_t[0], lv_j[0]) and lv_t[1] == lv_j[1]


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _j_pass(jt):
    jt.initialize()
    jt.initialize_adjoint()
    jt.add_modal_compliance_derivative(1.0)
    jt.finalize_adjoint()
    return (np.asarray(jt.lam), float(jt.get_modal_compliance()),
            np.asarray(jt.xb))


@pytest.fixture(scope="module")
def solved():
    """JAX's model on each path, one protocol pass; bcr_f32 also its
    objective_jvp along P3."""
    out = {}
    for kind in ("cholesky", "bcr_f32"):
        jt = jcrm.CRM(factor_kind=kind, **KW)
        lam, comp, xb = _j_pass(jt)
        jvp = jt.objective_jvp(P3) if jt.scalable else None
        out[kind] = (jt, lam, comp, xb, jvp)
    return out


def _j_v0(jt):
    if jt.scalable:
        return np.asarray(jt._v0(None))
    return j_start(int(jt.free.shape[0]))


def _port(jt, **over):
    """The port's CRM on JAX's mesh, design and start vector."""
    mesh = {"X": np.asarray(jt.X), "conn": np.asarray(jt.conn),
            "comp": np.asarray(jt.comp), "names": jt.component_names,
            "station": jt.station_of_node, "thickness": None}
    config = dict(factor_kind=jt.factor_kind, N=jt.N, m=jt.m)
    config.update(over)
    return crm_from_numpy(mesh, np.asarray(jt.x), v0=_j_v0(jt),
                          device="cpu", **config)


def _t_pass(tt):
    tt.initialize()
    tt.initialize_adjoint()
    tt.add_modal_compliance_derivative(1.0)
    tt.finalize_adjoint()
    return tt.lam.numpy(), float(tt.get_modal_compliance()), tt.xb.numpy()


@pytest.mark.parametrize("kind,tol_lam,tol_xb",
                         [("cholesky", 1e-10, 1e-8), ("bcr_f32", 1e-9, 1e-7)])
def test_model_matches_jax(solved, kind, tol_lam, tol_xb):
    """Eigenvalues, modal compliance and xb against JAX's; then a second
    adjoint pass on the same solve returns the same xb, bitwise."""
    jt, lam_j, comp_j, xb_j, _ = solved[kind]
    tt = _port(jt)
    lam, comp, xb = _t_pass(tt)
    assert rel(lam, lam_j) <= tol_lam
    assert abs(comp - comp_j) <= tol_lam * abs(comp_j)
    assert rel(xb, xb_j) <= tol_xb
    tt.initialize_adjoint()
    tt.add_modal_compliance_derivative(1.0)
    tt.finalize_adjoint()
    assert np.array_equal(tt.xb.numpy(), xb)


def test_layout_matches_jax(solved):
    """The station layout (the rank of each node in its block taken by a
    stable sort where JAX loops over nodes): nb, b, node_dof0, dofs and
    free_mask bitwise; the tip load alike."""
    jt = solved["bcr_f32"][0]
    tt = _port(jt)
    assert (tt.nb, tt.b, tt.nvars) == (jt.nb, jt.b, jt.nvars)
    for name in ("node_dof0", "dofs", "free_mask", "free"):
        assert np.array_equal(getattr(tt, name).numpy(),
                              np.asarray(getattr(jt, name))), name
    assert np.array_equal(tt.tip_load().numpy(), np.asarray(jt.tip_load()))


@pytest.mark.parametrize("kind", ["cholesky", "bcr_f32"])
def test_objective_jvp_matches_vjp(solved, kind):
    """The forward-mode objective_jvp on the held solve against p @ xb:
    1e-8 (JAX's bar); on bcr_f32 also against JAX's own jvp_prog, within
    the mixed ladder's f32 rounding: 1e-7."""
    jt, _, _, _, jvp_j = solved[kind]
    tt = _port(jt)
    _t_pass(tt)
    dv = tt.objective_jvp(P3)
    ans = float(P3 @ tt.xb.numpy())
    assert abs(ans - dv) <= 1e-8 * abs(dv)
    if jvp_j is not None:
        assert abs(dv - jvp_j) <= 1e-7 * abs(jvp_j)


def test_protocol_matches_autograd_of_solve(solved):
    """JAX's test_staged_protocol_matches_fused_vjp in the port: the
    protocol's xb against torch.autograd of _solve_fn with the same seeds,
    bitwise on the CPU."""
    jt = solved["bcr_f32"][0]
    tt = _port(jt, N=3)
    _, _, xb = _t_pass(tt)
    x = tt.x.clone().requires_grad_(True)
    lam, Qr = tt._solve_fn(x)
    (g,) = torch.autograd.grad((lam, Qr), x, (tt.lamb, tt.Qrb))
    assert np.array_equal(lam.detach().numpy(), tt.lam.numpy())
    assert np.array_equal(g.numpy(), xb)


def _count_parts(tt, monkeypatch):
    """The list that gets an entry for each part the problem's
    ``assemble_parts`` builds; set before the solve, whose graph keeps
    the problem."""
    built = []
    parts = tt.problem.assemble_parts

    def counted(theta):
        for AB in parts(theta):
            built.append(1)
            yield AB

    monkeypatch.setattr(tt, "problem", dataclasses.replace(
        tt.problem, assemble_parts=counted))
    return built


def _adjoint_pass(tt, monkeypatch, part, built):
    """xb of the modal-compliance seeds on the held solve, the VJP in
    parts of ``part`` elements, all of which it builds."""
    monkeypatch.setattr(tcrm, "VJP_PART", part)
    built.clear()
    tt.initialize_adjoint()
    tt.add_modal_compliance_derivative(1.0)
    tt.finalize_adjoint()
    assert len(built) == -(-tt.dofs.shape[0] // part)
    return tt.xb.numpy()


def test_vjp_in_parts_matches_one_part(monkeypatch):
    """The f64 ``bcr`` model's bilinear-form VJP in element parts of 8 (4
    parts of the 26 shells) against one part on the same solve: xb within
    1e-13 (the parts reorder sums only), and the forward-mode
    objective_jvp against p @ xb at JAX's 1e-8."""
    tt = tcrm.CRM(factor_kind="bcr", device="cpu", **KW)
    built = _count_parts(tt, monkeypatch)
    tt.initialize()
    one = _adjoint_pass(tt, monkeypatch, tt.dofs.shape[0], built)
    parts = _adjoint_pass(tt, monkeypatch, 8, built)
    assert rel(parts, one) <= 1e-13
    dv = tt.objective_jvp(P3)
    assert abs(float(P3 @ parts) - dv) <= 1e-8 * abs(dv)


def test_vjp_parts_lower_the_adjoint_peak(monkeypatch):
    """finalize_adjoint's rise over the seeds (the peak of the running
    total of torch.profiler's memory records) on the f64 ``bcr`` model at
    nspan 64, 3,072 shells: in parts of 512 shells at most half the rise
    of one part, since one part's element-matrix graph is freed before
    the next is built (24.8 against 125.9 MiB on a CPU); xb within 1e-13
    of one part's."""
    from torch.profiler import ProfilerActivity, profile

    tt = tcrm.CRM(factor_kind="bcr", device="cpu", nspan=64, nchord=16,
                  nheight=4, N=6)
    tt.initialize()

    def rise(part):
        monkeypatch.setattr(tcrm, "VJP_PART", part)
        tt.initialize_adjoint()
        tt.add_modal_compliance_derivative(1.0)
        with profile(activities=[ProfilerActivity.CPU],
                     profile_memory=True) as prof:
            tt.finalize_adjoint()
        records = sorted((e for e in prof.profiler.kineto_results.events()
                          if e.name() == "[memory]"),
                         key=lambda e: e.start_ns())
        total = peak = 0
        for e in records:
            total += e.nbytes()
            peak = max(peak, total)
        return peak, tt.xb.numpy()

    one, xb_one = rise(tt.dofs.shape[0])
    parts, xb_parts = rise(512)
    assert parts <= 0.5 * one, (parts / 2**20, one / 2**20)
    assert rel(xb_parts, xb_one) <= 1e-13


def test_port_start_vector():
    """The port's own start vector: uniform on [-1, 1), zero exactly on
    the clamped and padded DOFs; the model solves from it to JAX's
    eigenvalues (1e-9)."""
    tt = tcrm.CRM(factor_kind="bcr_f32", device="cpu", **KW)
    v = tt._v0(None).numpy()
    free = tt.free_mask.numpy() == 1.0
    assert np.all(v[~free] == 0.0) and np.all(v[free] != 0.0)
    assert np.all(np.abs(v) <= 1.0)
    jt = jcrm.CRM(factor_kind="bcr_f32", **KW)
    jt.initialize()
    tt.initialize()
    assert rel(tt.lam.numpy(), np.asarray(jt.lam)) <= 1e-9


def test_f64_bcr_under_the_approx_sweep():
    """The f64 ``bcr`` factor has no approx channel: under
    lanczos_sweep="approx" (the at-scale default) the sweep applies it
    exactly, as JAX's does (the port raised AttributeError): eigenvalues
    and xb against JAX's at block 2, polish 1."""
    kw = dict(KW, factor_kind="bcr", lanczos_block=2, lanczos_sweep="approx",
              lanczos_polish=1)
    jt = jcrm.CRM(**kw)
    lam_j, comp_j, xb_j = _j_pass(jt)
    tt = _port(jt, lanczos_block=2, lanczos_sweep="approx",
               lanczos_polish=1)
    lam, comp, xb = _t_pass(tt)
    assert rel(lam, lam_j) <= 1e-10
    assert rel(xb, xb_j) <= 1e-8


def test_frequency_derivatives_match_central_difference():
    """add_frequency_derivatives seeds lamb with omegab / (2 sqrt(lam)), as
    the NF model does: p @ xb of the KS-min (ks 1) of the frequencies
    against a Richardson-4 central difference (h 1e-3, 5e-4) on the f64
    BCR factor (1e-6; the eigenvalues' noise puts plain central
    differences at 1e-7 at best here)."""
    tt = tcrm.CRM(factor_kind="bcr", device="cpu", **KW)
    x0 = tt.x.clone() * (1.0 + 0.1 * torch.as_tensor(P3))

    def ks_min(omega):
        low = torch.min(omega)
        return low - torch.log(torch.sum(torch.exp(-(omega - low))))

    def value(x):
        tt.x = x
        tt.initialize()
        return float(ks_min(tt.get_frequencies()))

    value(x0)
    tt.initialize_adjoint()
    omega = tt.get_frequencies().requires_grad_(True)
    (omegab,) = torch.autograd.grad(ks_min(omega), omega)
    tt.add_frequency_derivatives(omegab)
    tt.finalize_adjoint()
    p = torch.as_tensor(np.random.default_rng(4).uniform(-1, 1, 5)) * x0

    def central(h):
        return (value(x0 + h * p) - value(x0 - h * p)) / (2 * h)

    fd = (4.0 * central(5e-4) - central(1e-3)) / 3.0
    assert abs(float(p @ tt.xb) - fd) <= 1e-6 * abs(fd)


def test_element_operator_promotes_like_jax():
    """ElementOperator.mv of an f32 block on f64 element matrices computes
    in f64, as JAX's einsum promotes (the mixed SIBK ladder hands it f32
    blocks; the port raised a dtype error): bitwise f64 against the f64
    matvec of the same values."""
    rng = np.random.default_rng(4)
    mats = rng.standard_normal((12, 24, 24))
    dofs = rng.integers(0, 60, (12, 24))
    x32 = rng.standard_normal((60, 3)).astype(np.float32)
    op = ElementOperator(torch.as_tensor(mats), torch.as_tensor(dofs), 60)
    got = op.mv(torch.as_tensor(x32))
    assert got.dtype == torch.float64
    assert torch.equal(got, op.mv(torch.as_tensor(x32).double()))
    ref = JElement(jnp.asarray(mats), jnp.asarray(dofs), 60).mv(
        jnp.asarray(x32))
    assert ref.dtype == jnp.float64
    assert rel(got.numpy(), ref) <= 1e-14


@pytest.mark.parametrize("kind", ["cholesky", "bcr_f32"])
def test_from_bdf_matches_jax(tmp_path, kind):
    """CRM.from_bdf on the plate deck (N 3, m 40): components,
    eigenvalues and the compliance gradient against JAX's (1e-9, 1e-7),
    from JAX's start vector."""
    path = tmp_path / "plate.bdf"
    path.write_text("\n".join(plate_bdf_lines()) + "\n")
    jt = jcrm.CRM.from_bdf(str(path), N=3, m=40, factor_kind=kind)
    lam_j, _, xb_j = _j_pass(jt)
    tt = tcrm.CRM.from_bdf(str(path), N=3, m=40, factor_kind=kind,
                           device="cpu")
    v = torch.as_tensor(np.array(_j_v0(jt)))
    tt.problem = dataclasses.replace(tt.problem, v0=lambda th: v)
    assert tt.ncomp == jt.ncomp == 2 and tt.nvars == jt.nvars
    lam, _, xb = _t_pass(tt)
    assert rel(lam, lam_j) <= 1e-9
    assert rel(xb, xb_j) <= 1e-7


def test_node_displacements_match_jax(solved):
    jt = solved["cholesky"][0]
    tt = _port(jt)
    tt.initialize()
    for mode in (0, 3):
        a, b = tt.node_displacements(mode), jt.node_displacements(mode)
        sign = np.sign(np.sum(a * b))
        assert rel(sign * a, b) <= 1e-8


@pytest.mark.parametrize("entry", ["CRM", "from_bdf", "crm_from_numpy"])
def test_crm_entry_points_default_to_the_card(tmp_path, entry):
    """With no device given, the CRM builds on the card: without one it
    fails on the first CUDA allocation and never returns a CPU object."""
    path = tmp_path / "plate.bdf"
    path.write_text("\n".join(plate_bdf_lines()) + "\n")
    X, conn, comp, names = tcrm.make_wingbox_mesh(4, 2, 1, nribs=1)
    ys = np.unique(np.round(X[:, 1], 9))
    mesh = {"X": X, "conn": conn, "comp": comp, "names": names,
            "station": np.searchsorted(ys, np.round(X[:, 1], 9)),
            "thickness": None}
    calls = {"CRM": lambda: tcrm.CRM(**KW),
             "from_bdf": lambda: tcrm.CRM.from_bdf(str(path), N=3, m=40),
             "crm_from_numpy": lambda: crm_from_numpy(mesh, np.full(5, 0.01),
                                                      N=4, m=40)}
    if torch.cuda.is_available():
        assert calls[entry]().x.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            calls[entry]()


# ---------------------------------------------------------------------------
# eigh_gen_fwdmode: torch.func.jvp through a chain
# ---------------------------------------------------------------------------


def test_fwdmode_natural_frequency_chain_matches_jax():
    """tests/test_autodiff_jvp.py's natural-frequency chain (12x6, N 4,
    m 50, dense): torch.func.jvp through eigh_gen_fwdmode against jax.jvp
    through JAX's, from one start vector: value and jvp 1e-8; and the
    port's jvp against its own reverse mode, 1e-10 (JAX's bar)."""
    from eigd_tpu_torch.models.natural_frequency import make_model
    from tests.test_autodiff_jvp import _nf_objectives

    jt, _, obj_jvp = _nf_objectives()
    n = 2 * jt.nnodes
    v0 = np.random.default_rng(11).uniform(-1.0, 1.0, n)
    jt.problem = dataclasses.replace(jt.problem,
                                     v0=lambda th: jnp.asarray(v0))
    x0 = np.asarray(jt.x)
    p = np.random.default_rng(3).uniform(size=x0.shape)
    v_j, dv_j = jax.jvp(obj_jvp, (jnp.asarray(x0),), (jnp.asarray(p),))

    tt = make_model(nx=12, ny=6, Lx=2.0, Ly=1.0, N=4, rfact=2.0, m=50,
                    device="cpu")
    tt.problem = dataclasses.replace(tt.problem,
                                     v0=lambda th: torch.as_tensor(v0))

    def pre(x):
        return tfem.element_density(tt.fltr.apply(x), tt.conn)

    def tail(lam, Q):
        eta = torch.exp(-(lam - lam[0]))
        return torch.sum(torch.sqrt(lam)) + torch.sum(eta[None, :]
                                                      * Q[:9, :] ** 2)

    def obj(x, eig):
        return tail(*eig(pre(x), tt.problem, tt.cfg))

    xt, pt = torch.as_tensor(x0), torch.as_tensor(p)
    v, dv = torch.func.jvp(lambda x: obj(x, tad.eigh_gen_fwdmode), (xt,),
                           (pt,))
    assert abs(float(v) - float(v_j)) <= 1e-8 * abs(float(v_j))
    assert abs(float(dv) - float(dv_j)) <= 1e-8 * abs(float(dv_j))
    x = xt.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(obj(x, tad.eigh_gen), x)
    assert abs(float(pt @ g) - float(dv)) <= 1e-10 * abs(float(dv))


def test_fwdmode_buckling_chain_matches_jax():
    """tests/test_autodiff_jvp.py's buckling chain (14x7, N 4, dense: the
    static solve, the stress stiffness, the pencil eigensolve in buckling
    mode, KS + aggregate + compliance): torch.func.jvp through
    eigh_gen_fwdmode with theta the tuple (rhoE, u) against jax.jvp through
    JAX's, from JAX's start vector: 1e-8."""
    from eigd_tpu.models.buckling import _chol_solve as j_chol_solve
    from eigd_tpu.models.buckling import make_buckling_model
    from eigd_tpu_torch.models.buckling import _chol_solve
    from tests.test_buckling import _pick_sigma

    jt = make_buckling_model(nx=14, ny=7, N=4, sigma=_pick_sigma())

    def j_chain(x):
        rhoE = jfem.element_density(jt.fltr.apply(x), jt.conn)
        L = jnp.linalg.cholesky(jt._stiffness_dense_reduced(rhoE))
        fr = jt.f[jt.free]
        ur = j_chol_solve(L, fr)
        lam, Qr = jad.eigh_gen_fwdmode((rhoE, ur), jt.problem, jt.cfg)
        eta = jnp.exp(-(lam - lam[0]))
        ks = lam[0] - jnp.log(
            jnp.sum(jnp.exp(-160.0 * (lam - lam[0])))) / 160.0
        return ks + jnp.sum(eta[None, :] * Qr[:9, :] ** 2) + fr @ ur

    x0 = np.asarray(jt.x)
    p = np.random.default_rng(9).uniform(size=x0.shape)
    v_j, dv_j = jax.jvp(j_chain, (jnp.asarray(x0),), (jnp.asarray(p),))

    tt = buckling_from_numpy(
        x0, np.asarray(jt.X), np.asarray(jt.conn), np.asarray(jt.free),
        np.asarray(jt.f), (np.asarray(jt.fltr.idx), np.asarray(jt.fltr.wts)),
        jt.fltr.r0, v0=j_start(int(jt.free.shape[0])), device="cpu",
        N=jt.N, sigma=jt.sigma, factor_kind="cholesky")

    def t_chain(x):
        rhoE = tfem.element_density(tt.fltr.apply(x), tt.conn)
        L = torch.linalg.cholesky(tt._stiffness_dense_reduced(rhoE))
        fr = tt.f[tt.free]
        ur = _chol_solve(L, fr)
        lam, Qr = tad.eigh_gen_fwdmode((rhoE, ur), tt.problem, tt.cfg)
        eta = torch.exp(-(lam - lam[0]))
        ks = lam[0] - torch.log(
            torch.sum(torch.exp(-160.0 * (lam - lam[0])))) / 160.0
        return ks + torch.sum(eta[None, :] * Qr[:9, :] ** 2) + fr @ ur

    v, dv = torch.func.jvp(t_chain, (torch.as_tensor(x0),),
                           (torch.as_tensor(p),))
    assert abs(float(v) - float(v_j)) <= 1e-8 * abs(float(v_j))
    assert abs(float(dv) - float(dv_j)) <= 1e-8 * abs(float(dv_j))
