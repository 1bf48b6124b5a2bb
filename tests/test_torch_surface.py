"""The last of the JAX package's public surface in the port, on the CPU in
x64 against eigd_tpu: ``detJ_tables``, the Dirichlet-reduction helpers
(``reduce_operator_dense``, ``expand_vector``, ``reduce_vector``),
calling an operator or factor (``__call__`` = ``mv``),
``GridMGFactor.shape``, ``laa(D0=)``, the reference keywords that
sibk/pcpg/pgmres accept and discard, and a scan of both packages' sources
for any public name or argument of eigd_tpu the port lacks.
"""

import ast
import inspect
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigd_tpu.fem import quad as jquad
from eigd_tpu.fem.model import make_grid
from eigd_tpu.ops import adjoint as jadj
from eigd_tpu.ops import operators as jops
from eigd_tpu_torch.fem import quad as tquad
from eigd_tpu_torch.ops import adjoint as tadj
from eigd_tpu_torch.ops import factor as tfac
from eigd_tpu_torch.ops import operators as tops
from eigd_tpu_torch.ops.lanczos import LanczosResult
from eigd_tpu_torch.ops.multigrid import GridMGFactor
from eigd_tpu_torch.ops.stencil import GridStencilOperator
from eigd_tpu_torch.utils.profile import FactorCounter

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def test_detj_tables_match_jax():
    """detJ at the four quadrature points of a 16x8 mesh with jittered
    interior nodes: (4, 128), rel 1e-14 of JAX's."""
    m = make_grid(16, 8, 2.0, 1.0)
    X = m.X.copy()
    inner = (X[:, 0] > 0) & (X[:, 0] < 2.0) & (X[:, 1] > 0) & (X[:, 1] < 1.0)
    X[inner] += 0.03 * np.random.default_rng(3).uniform(
        -1.0, 1.0, (int(inner.sum()), 2))
    dj = np.asarray(jquad.detJ_tables(jnp.asarray(X), jnp.asarray(m.conn)))
    dt = tquad.detJ_tables(torch.as_tensor(X),
                           torch.as_tensor(m.conn, dtype=torch.int64))
    assert dt.shape == (4, m.nelems) == dj.shape
    assert np.abs(dt.numpy() - dj).max() <= 1e-14 * np.abs(dj).max()
    assert np.ptp(dj) > 0.1 * np.abs(dj).max()  # the jitter shows


def test_reduction_helpers_match_jax_and_buckling():
    """On the 24x12 buckling model's stiffness (clamped left edge):
    reduce_operator_dense is the free-free block the model's dense path
    builds and JAX's helper builds, bitwise; reduce_vector and
    expand_vector are JAX's, bitwise, and the expansion is zero exactly on
    the fixed DOFs."""
    from eigd_tpu_torch.fem.assembly import element_density
    from eigd_tpu_torch.models.buckling import make_buckling_model

    topo = make_buckling_model(nx=24, ny=12, N=4, sigma=1.0, device="cpu")
    with torch.no_grad():
        rhoE = element_density(topo.fltr.apply(topo.x), topo.conn)
        K = topo._K_mats(rhoE)
        Kr = tops.reduce_operator_dense(K, topo.free)
        own = topo._stiffness_dense_reduced(rhoE)
    free = topo.free.numpy()
    jr = jops.reduce_operator_dense(jops.DenseOperator(
        jnp.asarray(K.to_dense().numpy())), jnp.asarray(free))
    assert isinstance(Kr, tops.DenseOperator)
    assert torch.equal(Kr.mat, own)
    assert np.array_equal(Kr.mat.numpy(), np.asarray(jr.mat))

    n = topo.nvars
    v = np.random.default_rng(0).standard_normal((n, 3))
    vr = tops.reduce_vector(torch.as_tensor(v), topo.free)
    assert np.array_equal(vr.numpy(), np.asarray(
        jops.reduce_vector(jnp.asarray(v), jnp.asarray(free))))
    ve = tops.expand_vector(vr, topo.free, n)
    assert np.array_equal(ve.numpy(), np.asarray(jops.expand_vector(
        jnp.asarray(vr.numpy()), jnp.asarray(free), n)))
    fixed = np.setdiff1d(np.arange(n), free)
    assert fixed.size > 0 and np.all(ve.numpy()[fixed] == 0.0)
    assert np.array_equal(ve.numpy()[free], v[free])


def _stencil(nx, ny, seed):
    """An SPD 2-DOF stencil from random SPD element matrices, and the
    element operator it sums."""
    from eigd_tpu_torch.ops.stencil import stencil_from_elements

    g = torch.Generator().manual_seed(seed)
    R = torch.randn((nx * ny, 8, 8), generator=g, dtype=torch.float64)
    mats = R @ R.transpose(1, 2) + 8.0 * torch.eye(8, dtype=torch.float64)
    grid = make_grid(nx, ny, 1.0, 1.0)
    conn = torch.as_tensor(grid.conn, dtype=torch.int64)
    dofs = torch.stack([2 * conn, 2 * conn + 1], dim=2).reshape(-1, 8)
    n = 2 * grid.nnodes
    return stencil_from_elements(mats, nx, ny, 2), mats, dofs, n


def _operator(kind):
    W, mats, dofs, n = _stencil(8, 4, 1)
    el = tops.ElementOperator(mats, dofs, n)
    dense = el.to_dense()
    if kind == "DenseOperator":
        return tops.DenseOperator(dense)
    if kind == "DiagonalOperator":
        return tops.DiagonalOperator(torch.diagonal(dense).clone())
    if kind == "ElementOperator":
        return el
    if kind == "CholeskyFactor":
        return tfac.CholeskyFactor.from_matrix(dense)
    if kind == "EighFactor":
        return tfac.EighFactor.from_matrix(dense)
    if kind == "CGFactor":
        return tfac.CGFactor(el, torch.diagonal(dense).clone(), maxiter=40)
    if kind == "GridStencilOperator":
        return GridStencilOperator(mats, dofs, n, W, (8, 4), 2)
    return GridMGFactor.build(W, (8, 4), 2, min_coarse=16)


CALLABLES = ["DenseOperator", "DiagonalOperator", "ElementOperator",
             "CholeskyFactor", "EighFactor", "CGFactor",
             "GridStencilOperator", "GridMGFactor"]


@pytest.mark.parametrize("kind", CALLABLES)
def test_call_is_mv(kind):
    """op(x) is op.mv(x), bitwise, on a vector and on a block; JAX's class
    of the same name is callable too."""
    op = _operator(kind)
    assert type(op).__name__ == kind
    g = torch.Generator().manual_seed(2)
    n = op.shape[0]
    for x in (torch.randn(n, generator=g, dtype=torch.float64),
              torch.randn((n, 3), generator=g, dtype=torch.float64)):
        assert torch.equal(op(x), op.mv(x))
    jmod = {"DenseOperator": "operators", "DiagonalOperator": "operators",
            "ElementOperator": "operators", "GridStencilOperator": "stencil",
            "GridMGFactor": "multigrid"}.get(kind, "factor")
    src = (ROOT / "eigd_tpu" / "ops" / f"{jmod}.py").read_text()
    cls = next(c for c in ast.parse(src).body
               if isinstance(c, ast.ClassDef) and c.name == kind)
    assert any(isinstance(f, ast.FunctionDef) and f.name == "__call__"
               for f in cls.body)


def test_mg_factor_shape_matches_jax():
    """GridMGFactor.shape is (n, n) as JAX's, and FactorCounter passes it
    through on both sides."""
    from eigd_tpu.ops.multigrid import GridMGFactor as JFactor
    from eigd_tpu.utils.profile import FactorCounter as JCounter

    W, _, _, n = _stencil(8, 4, 1)
    ft = GridMGFactor.build(W, (8, 4), 2, min_coarse=16)
    fj = JFactor.build(jnp.asarray(W.numpy()), (8, 4), 2, min_coarse=16)
    assert ft.shape == tuple(fj.shape) == (n, n) == (90, 90)
    assert FactorCounter(ft).shape == tuple(JCounter(fj).shape)


@pytest.fixture(scope="module")
def pencil():
    """The 60-DOF pencil of tests/test_torch_utils.py, JAX's single-vector
    Lanczos solve on its dense factor (N 4, m 20) carried across to the
    port, and a seeded Phib."""
    from eigd_tpu.ops.factor import make_shift_factor as j_factor
    from eigd_tpu.ops.lanczos import lanczos_solve as j_solve
    from test_torch_lanczos import make_spd_pencil

    A, B = make_spd_pencil(60, seed=4)
    v0 = np.random.default_rng(0).uniform(-1.0, 1.0, 60)
    fj = j_factor(jnp.asarray(A), jnp.asarray(B), 0.0)
    with jax.disable_jit():
        rj = j_solve(jnp.asarray(A), jnp.asarray(B), fj, 0.0, 4, 20,
                     v0=jnp.asarray(v0))
    rt = LanczosResult(**{f: torch.as_tensor(np.array(getattr(rj, f)))
                          for f in ("lam", "Phi", "V", "BV", "alpha", "beta",
                                    "H", "theta", "Y", "order", "lam_all",
                                    "eig_res", "sigma")},
                       niter=int(rj.niter))
    Phib = np.random.default_rng(1).standard_normal((60, 4))
    return A, B, fj, rj, rt, Phib


def test_laa_with_d0_matches_jax(pencil):
    """laa with a given (m, N) coefficient matrix D0 against JAX's
    laa(D0=...): rel 1e-12 of max|psi|; D0 replaces the masked Galerkin
    coefficients (the answer moves)."""
    A, B, fj, rj, rt, Phib = pencil
    D0 = np.random.default_rng(6).standard_normal((20, 4))
    pj = np.asarray(jadj.laa(jnp.asarray(Phib), jnp.asarray(B), fj, rj,
                             D0=jnp.asarray(D0)))
    At, Bt = torch.as_tensor(A), torch.as_tensor(B)
    ft = tfac.make_shift_factor(At, Bt, 0.0)
    pt = tadj.laa(torch.as_tensor(Phib), Bt, ft, rt, D0=torch.as_tensor(D0))
    assert np.abs(pt.numpy() - pj).max() <= 1e-12 * np.abs(pj).max()
    plain = tadj.laa(torch.as_tensor(Phib), Bt, ft, rt)
    assert np.abs(plain.numpy() - pj).max() > 1e-3 * np.abs(pj).max()


@pytest.mark.parametrize("method", ["sibk", "pcpg", "pgmres"])
def test_reference_keywords_are_discarded(pencil, method):
    """sibk/pcpg/pgmres take the reference keywords that JAX's take
    (sibk: bs_target, update_guess, callback; pcpg and pgmres: callback)
    and give the same psi as without them, bitwise."""
    A, B, _, _, rt, Phib = pencil
    extra = {"bs_target": 2, "update_guess": True,
             "callback": lambda *a: None}
    jparams = set(inspect.signature(getattr(jadj, method)).parameters)
    extra = {k: v for k, v in extra.items() if k in jparams}
    assert set(extra) == ({"bs_target", "update_guess", "callback"}
                          if method == "sibk" else {"callback"})
    At, Bt = torch.as_tensor(A), torch.as_tensor(B)
    ft = tfac.make_shift_factor(At, Bt, 0.0)
    fn = getattr(tadj, method)
    args = (torch.as_tensor(Phib), At, Bt, rt.lam, rt.Phi)
    kw = dict(sigma=0.0, factor=ft, maxiter=20)
    p0, _, _ = fn(*args, **kw)
    p1, _, _ = fn(*args, **kw, **extra)
    assert torch.equal(p0, p1) and bool(torch.isfinite(p0).all())
    assert tadj.apply_adjoint_correction is tadj.generate_adjoint_correction


# Public names and arguments of eigd_tpu that the port does not carry, and
# why: ROADMAP item 18's TPU/XLA workarounds (dd GEMMs, jacobi.py, the
# host-chunked programs, the V-cycle's barrier variant, Pallas tiling and
# interpret mode, pytree hooks, native/), and replacements by design (a
# torch.distributed Axis for a Mesh and its device count, a Generator for
# a PRNG seed, solve_spd's forward rule for solve_spd_fwdmode, a
# staticmethod KSmax, with_kernels for with_pallas).
NOT_PORTED = {
    "ops/adjoint.py": {"sibk_round", "sibk_finish"},
    "ops/autodiff.py": {"solve_spd_fwdmode", "staged_eigh_gen_vjp",
                        "staged_value_and_grad"},
    "ops/lanczos.py": {"block_coupling_converged_host", "block_lanczos_start",
                       "block_lanczos_extract", "block_lanczos_sweep_chunk"},
    "ops/multigrid.py": {"GridMGFactor.build(dd)", "cheb_smooth(barrier)",
                         "estimate_lmax(seed)"},
    "ops/pallas_stencil.py": {"pallas_stencil_matvec", "stencil_planes_dd",
                              "matvec_planes(TX)", "matvec_planes(interpret)"},
    "ops/stencil.py": {"GridStencilOperator.with_pallas"},
    "parallel/grid.py": {"make_mesh"},
    "parallel/mgshard.py": {"sharded_prolong(ndev)", "sharded_restrict(ndev)",
                            "sharded_stencil_matvec(ndev)"},
    "parallel/sharded.py": {
        "make_sharded_buckling_objective(mesh)",
        "make_sharded_buckling_objective(n_devices)",
        "make_sharded_crm_objective(mesh)",
        "make_sharded_crm_objective(n_devices)",
        "make_sharded_objective(mesh)", "make_sharded_objective(n_devices)",
        "make_sharded_thermal_objective(mesh)",
        "make_sharded_thermal_objective(n_devices)",
        "sharded_element_matvec(mesh)", "sharded_train_step(n_devices)"},
    "models/thermal.py": {"ThermalTopologyAnalysis.KSmax(self)"},
}
# the port's module of another name (K1/K2's wrappers)
PORTED_AS = {"ops/pallas_stencil.py": "ops/cuda_stencil.py"}


def _surface(path):
    """{public name or Class.method: its argument names} of a module."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
            out[node.name] = {a.arg for a in node.args.args
                              + node.args.kwonlyargs}
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            out[node.name] = set()
            for f in node.body:
                if isinstance(f, ast.FunctionDef) and (
                        not f.name.startswith("_") or f.name == "__call__"):
                    out[f"{node.name}.{f.name}"] = {
                        a.arg for a in f.args.args + f.args.kwonlyargs}
        elif isinstance(node, ast.Assign):
            out.update({t.id: set() for t in node.targets
                        if isinstance(t, ast.Name)
                        and not t.id.startswith("_")})
    return out


def test_public_surface_matches_jax():
    """Every public top-level name, class method (and __call__) and
    argument of each eigd_tpu module is in its eigd_tpu_torch counterpart,
    apart from NOT_PORTED; pytree hooks, the dd GEMMs, native/ and
    jacobi.py (ROADMAP item 18) aside."""
    missing = {}
    for jpath in sorted((ROOT / "eigd_tpu").rglob("*.py")):
        rel = jpath.relative_to(ROOT / "eigd_tpu").as_posix()
        if rel.startswith("native/") or rel == "ops/jacobi.py":
            continue
        theirs = _surface(ROOT / "eigd_tpu_torch" / PORTED_AS.get(rel, rel))
        gaps = set()
        for name, args in _surface(jpath).items():
            if name.endswith(("tree_flatten", "tree_unflatten")) \
                    or name.startswith("dd_"):
                continue
            if name not in theirs:
                gaps.add(name)
            else:
                gaps |= {f"{name}({a})" for a in args - theirs[name]}
        gaps -= NOT_PORTED.get(rel, set())
        if gaps:
            missing[rel] = sorted(gaps)
    assert not missing, missing
