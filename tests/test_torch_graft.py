"""The port's graft entry points (``eigd_tpu_torch.graft_entry``) against
``__graft_entry__.py``'s.

``entry(device="cpu")``'s eigenvalues match ``__graft_entry__.entry()``'s
(rel 1e-8); ``dryrun_multichip(4, device="cpu")`` runs the sharded NF
train step and the CRM on 4 gloo ranks and prints JAX's two lines with
finite values. Without a card, neither runs unless the CPU is asked for.
"""

import re

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jge
from eigd_tpu_torch import graft_entry as tge


def test_entry_matches_jax():
    fn, args = tge.entry(device="cpu")
    lam, Phi = fn(*args)
    jfn, jargs = jge.entry()
    jlam, _ = jax.jit(jfn)(*jargs)
    jlam = np.asarray(jlam)
    assert lam.shape == jlam.shape and Phi.shape[1] == lam.shape[0]
    np.testing.assert_allclose(lam.detach().numpy(), jlam, rtol=1e-8)


def test_dryrun_multichip_cpu(capsys):
    out = tge.dryrun_multichip(4, device="cpu", timeout=180.0)
    lines = capsys.readouterr().out.strip().splitlines()
    assert re.fullmatch(r"dryrun_multichip\(4\): objective=-?\d+\.\d{6} "
                        r"\(sharded-mg factor\) ok", lines[-2]), lines
    assert re.fullmatch(r"dryrun_multichip\(4\): crm objective=\S+ "
                        r"\(station-sharded wingbox\) ok", lines[-1]), lines
    assert np.isfinite(out["objective"]) and np.isfinite(out["crm"])
    assert np.all(np.isfinite(out["x1"]))
    # the train step: x1 = 0.95 - 0.05 grad
    np.testing.assert_allclose(out["x1"], 0.95 - 0.05 * out["grad"],
                               rtol=0, atol=1e-15)
    assert np.all(np.isfinite(out["crm_grad"]))
    assert out["backend"] == "gloo"


@pytest.mark.parametrize("call", ["entry", "dryrun_multichip"])
def test_graft_entry_needs_the_card_by_default(call):
    fn = {"entry": lambda: tge.entry(),
          "dryrun_multichip": lambda: tge.dryrun_multichip(2)}[call]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        fn()
