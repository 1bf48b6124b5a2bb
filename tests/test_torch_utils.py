"""The port's utilities and example CLIs on the CPU: checkpoints and the
natural-frequency model's warm restart against eigd_tpu's, the factor
counter against JAX's on one Lanczos solve, the profile's JSON, the plots
and CRM mode shapes with and without matplotlib, and each example's
``main()`` at a small size on ``--device cpu``.
"""

import builtins
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigd_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from eigd_tpu_torch.utils.profile import FactorCounter, Profile

torch.set_num_threads(1)


def test_checkpoint_round_trip(tmp_path):
    """A dict of tensors comes back bit for bit, on ``like``'s dtype; an
    entry of another shape raises."""
    state = {"x": torch.linspace(0.0, 1.0, 17, dtype=torch.float64),
             "lam": torch.tensor([1.0, 2.5, 2.5], dtype=torch.float64),
             "Q": torch.arange(12.0, dtype=torch.float64).reshape(4, 3)}
    path = str(tmp_path / "ckpt.pt")
    assert save_checkpoint(path, state) == "torch"
    out = load_checkpoint(path)
    like = load_checkpoint(path, {k: torch.zeros_like(v)
                                  for k, v in state.items()})
    for k, v in state.items():
        assert torch.equal(out[k], v) and torch.equal(like[k], v)
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(path, {"Q": torch.zeros(3, 4)})


def _nf_pair(make, **device):
    return make(nx=16, ny=8, Lx=2.0, Ly=1.0, N=4, rfact=2.0, **device)


def test_save_restore_rearms_sign_continuity(tmp_path):
    """The dense 16x8 model (N 4, m 60) at 0.9 x0: save_state, then a
    fresh model restores x, lam and Q bit for bit, and its next initialize
    returns the saved eigenvectors with their signs (atol 1e-8), as JAX's
    restore_state does, though its own start vector (seed 7) gave two of
    them the other sign; lam against JAX's at 1e-10 and |Q| at 1e-8."""
    from eigd_tpu.models.natural_frequency import make_model as j_make
    from eigd_tpu_torch.models.natural_frequency import make_model as t_make

    jt = _nf_pair(j_make)
    jt.x = jnp.asarray(jt.x) * 0.9
    jt.initialize()
    jt.save_state(str(tmp_path / "jax_state"))
    jt2 = _nf_pair(j_make).restore_state(str(tmp_path / "jax_state"))
    jt2.initialize()
    assert np.abs(np.asarray(jt2.Q) - np.asarray(jt.Q)).max() <= 1e-8

    tt = _nf_pair(t_make, device="cpu")
    tt.x = tt.x * 0.9
    tt.initialize()
    path = str(tmp_path / "state.pt")
    tt.save_state(path)
    tt2 = _nf_pair(t_make, device="cpu")
    tt2.cfg = dataclasses.replace(tt2.cfg, seed=7)
    tt2.restore_state(path)
    for name in ("x", "lam", "Q"):
        assert torch.equal(getattr(tt2, name), getattr(tt, name))
    tt2.initialize()
    assert bool((tt2._signs < 0).any())
    assert np.abs(tt2.Q.numpy() - tt.Q.numpy()).max() <= 1e-8
    lam_j = np.asarray(jt2.lam)
    assert np.abs(tt2.lam.numpy() - lam_j).max() <= 1e-10 * lam_j.max()
    assert np.abs(np.abs(tt2.Q.numpy()) - np.abs(np.asarray(jt2.Q))).max() \
        <= 1e-8


def test_factor_counter_matches_jax():
    """FactorCounter around the dense factor of a 60-DOF pencil, through
    one single-vector Lanczos solve (m 20): the port's device count equals
    JAX's (JAX's loops run eagerly under disable_jit, so its count is
    concrete)."""
    from eigd_tpu.ops.factor import make_shift_factor as j_factor
    from eigd_tpu.ops.lanczos import lanczos_solve as j_solve
    from eigd_tpu.utils.profile import FactorCounter as JCounter
    from eigd_tpu_torch.ops.factor import make_shift_factor as t_factor
    from eigd_tpu_torch.ops.lanczos import lanczos_solve as t_solve
    from test_torch_lanczos import make_spd_pencil

    A, B = make_spd_pencil(60, seed=4)
    v0 = np.random.default_rng(0).uniform(-1.0, 1.0, 60)
    with jax.disable_jit():
        cj = JCounter(j_factor(jnp.asarray(A), jnp.asarray(B), 0.0))
        j_solve(jnp.asarray(A), jnp.asarray(B), cj, 0.0, 4, 20,
                v0=jnp.asarray(v0))
    At, Bt = torch.as_tensor(A), torch.as_tensor(B)
    ct = FactorCounter(t_factor(At, Bt, 0.0))
    t_solve(At, Bt, ct, 0.0, 4, 20, v0=torch.as_tensor(v0))
    assert ct.count.dtype == torch.int64 and ct.count.ndim == 0
    assert int(ct.count) == int(cj.count) == 20
    ct.mv(torch.zeros((60, 3), dtype=torch.float64))
    assert int(ct.count) == 23
    ct.reset()
    assert ct.count is None


def test_profile_json_keys(tmp_path):
    """Profile.phase, record and to_json give the keys of JAX's Profile
    used alike; trace writes a torch.profiler trace."""
    from eigd_tpu.utils.profile import Profile as JProfile

    out = []
    for cls, arr in ((JProfile, jnp.arange(3.0)), (Profile, torch.arange(3.0))):
        p = cls(nnodes=10, kind="dense")
        with p.phase("solve"):
            pass
        p.record("lam", arr)
        p["note"] = object()
        out.append(json.loads(p.to_json()))
        assert "solve time" in p and p["lam"] == [0.0, 1.0, 2.0]
    assert sorted(out[0]) == sorted(out[1])
    assert out[1]["nnodes"] == 10 and isinstance(out[1]["note"], str)
    with p.trace(str(tmp_path)):
        torch.ones(8).sum()
    with open(tmp_path / "trace.json") as f:
        assert "traceEvents" in json.load(f)


@pytest.fixture
def no_matplotlib(monkeypatch):
    """matplotlib hidden: its import raises ImportError."""
    real_import = builtins.__import__

    def hide(name, *a, **kw):
        if name.startswith("matplotlib"):
            raise ImportError(name)
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", hide)


def _plots(tmp_path):
    """Every plot of the port on small inputs, each to its own PNG."""
    from eigd_tpu_torch.fem.model import make_grid
    from eigd_tpu_torch.models.crm import CRM
    from eigd_tpu_torch.utils import plot

    mesh = make_grid(4, 2, 2.0, 1.0)
    rho = torch.linspace(0.0, 1.0, mesh.nnodes)
    mode = torch.sin(torch.arange(2.0 * mesh.nnodes))
    paths = [str(tmp_path / f"{k}.png") for k in ("field", "mode", "res")]
    out = [plot.plot_field(mesh.X, mesh.conn, rho, path=paths[0]),
           plot.plot_mode(mesh.X, mesh.conn, rho, mode, path=paths[1]),
           plot.plot_residuals(torch.logspace(0, -8, 5), path=paths[2])]
    crm = CRM(nspan=4, nchord=2, nheight=1, N=2, m=30, nribs=1,
              factor_kind="cholesky", device="cpu")
    crm.initialize()
    written = crm.write_modes(prefix=str(tmp_path / "crm_mode"), nmodes=2)
    return out, paths, written


def test_plots_write_pngs(tmp_path):
    """With matplotlib: the field, mode and residual plots and the CRM's
    two mode shapes are PNG files."""
    out, paths, written = _plots(tmp_path)
    assert all(ax is not None for ax in out)
    assert len(written) == 2
    for p in paths + written:
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_plots_are_no_ops_without_matplotlib(tmp_path, no_matplotlib):
    out, _, written = _plots(tmp_path)
    assert out == [None, None, None] and written == []
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("name,argv,bar", [
    ("natural_frequency", ["16", "8"], 1e-6),
    ("thermal", ["transient"], 1e-6),
    ("thermal", ["sweep"], None),
    ("buckling", [], 5e-6),
    ("crm", ["small"], 1e-5),
])
def test_example_main_on_the_cpu(name, argv, bar):
    """Each example's main() at its small size on --device cpu returns its
    data; the gradient against its central difference holds the bar JAX's
    tests hold that flow to (fd_err, or cd_err for the thermal transient).
    The sweep returns its three epsilons with a finite gradient norm."""
    import importlib

    mod = importlib.import_module(f"eigd_tpu_torch.examples.{name}")
    data = mod.main(argv + ["--device", "cpu"])
    if bar is None:
        assert [d["epsilon"] for d in data] == [0.1, 1e-6, 1e-8]
        assert all(np.isfinite(d["xb_norm"]) for d in data)
    else:
        assert data.get("fd_err", data.get("cd_err")) <= bar
