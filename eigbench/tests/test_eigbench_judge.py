"""The comparison that decides ``correct``: null modes judged on the
spectrum's scale, and every other input read as before.

``RECORDED`` holds what the program and the plain reference returned on
the CPU at the small sizes of the other test files (``ksfreq`` on nf
16x8, ``compliance`` on the 16-station CRM, ``ksagg`` on buckle 16x8 with
the f64 BCR; seed 3, the first 12 gradient components), and under
``expected`` what ``compare`` read on them before null modes were judged
apart, digit for digit.
"""

import importlib

import numpy as np
import pytest
import scipy.linalg as sl

from eigbench import design, judge
from eigbench.reference import eig, thermal
from eigbench.tests.conftest import small_pair

LIMITS = {"lam_rel": 1e-6, "value_rel": 1e-6, "grad_rel": 1e-6}

RECORDED = {
    "nf": {
        "ref_lam": [
            0.6492457397707858, 1.6176501389754248, 2.240538489047469,
            3.8999523680506893, 3.974364147970375, 4.666100718172807
        ],
        "ref_value": -0.2935615953840949,
        "ref_xb": [
            0.15307048938644158, -0.018871933923237376, -0.02060725341843707,
            -0.014095584607101499, 0.002010743660935842, 0.008312992866823757,
            0.020427735103231776, 0.03308044262354659, 0.019199396595354093,
            0.02631463086827482, 0.04759661729757117, 0.06734522415198835
        ],
        "lam": [
            0.6492457397707818, 1.6176501389754154, 2.240538489047464,
            3.8999523680506805, 3.9743641479703697, 4.666100718172786
        ],
        "value": -0.29356159538409754,
        "xb": [
            0.1530704893864403, -0.0188719339232377, -0.020607253418437724,
            -0.014095584607101917, 0.0020107436609354784,
            0.008312992866823323, 0.020427735103231516, 0.033080442623546494,
            0.019199396595354065, 0.02631463086827466, 0.04759661729757099,
            0.06734522415198829
        ],
        "expected": {
            "lam_rel": 6.156071027992609e-15,
            "value_rel": 9.076579842176249e-15,
            "grad_rel": 9.091021553989563e-15,
        },
    },
    "crm": {
        "ref_lam": [
            2578.100058946091, 6754.918070917602, 8589.6743348851,
            9021.361995284551, 11248.877712435497, 14901.457611467691
        ],
        "ref_value": 1.5873005739371322e-06,
        "ref_xb": [
            -6.857841446421743e-05, -6.609284212429322e-05,
            -8.55638517859394e-06, -9.565590653245356e-06,
            5.175452757025628e-07
        ],
        "lam": [
            2578.100059002686, 6754.918070717447, 8589.674334902373,
            9021.361995293133, 11248.877712391179, 14901.457612315618
        ],
        "value": 1.5873005738860565e-06,
        "xb": [
            -6.857841446046327e-05, -6.609284211659903e-05,
            -8.556385177193464e-06, -9.565590652972744e-06,
            5.17545275823666e-07
        ],
        "expected": {
            "lam_rel": 5.6902310467841316e-11,
            "value_rel": 3.217768836073238e-11,
            "grad_rel": 9.031883605239634e-11,
        },
    },
    "buckle": {
        "ref_lam": [
            0.005700692640240619, 0.01413289122705888, 0.02139878888349314,
            0.021748188162808525, 0.024108934763410014, 0.02561930353559986
        ],
        "ref_value": 264.8390858813933,
        "ref_xb": [
            -15.238818063950255, -17.495580007742586, -9.93138831244874,
            -3.392883089424195, -1.5015437052739777, -3.1721191358559713,
            -9.48736235290024, -16.98209349304028, -14.90658766539654,
            -22.429725350523622, -26.248773018967615, -15.516906830214982
        ],
        "lam": [
            0.005700692640239361, 0.01413289122705851, 0.021398788883492004,
            0.021748188162808314, 0.02410893476340945, 0.025619303535598867
        ],
        "value": 264.8390858814532,
        "xb": [
            -15.238818063960158, -17.495580007753954, -9.931388312455274,
            -3.3928830894265984, -1.5015437052751195, -3.172119135857885,
            -9.487362352905688, -16.982093493050147, -14.90658766540529,
            -22.429725350537776, -26.24877301898423, -15.51690683022498
        ],
        "expected": {
            "lam_rel": 2.206178440853637e-13,
            "value_rel": 2.2600938929096388e-13,
            "grad_rel": 6.274604939535022e-13,
        },
    },
}


def recorded_ref(rec):
    return {"lam": np.array(rec["ref_lam"]), "value": rec["ref_value"],
            "xb": np.array(rec["ref_xb"])}


@pytest.mark.parametrize("name", sorted(RECORDED))
@pytest.mark.parametrize("null_modes", [None, 0], ids=["no-key", "zero"])
def test_recorded_inputs_compare_as_before(name, null_modes):
    """Without null modes, declared 0 or not at all, every number is the
    one ``compare`` read before, bit for bit."""
    rec = RECORDED[name]
    ref = recorded_ref(rec)
    if null_modes is not None:
        ref["null_modes"] = null_modes
    checks = judge.compare(ref, rec["value"], np.array(rec["lam"]),
                           np.array(rec["xb"]), LIMITS)
    assert {k: c["value"] for k, c in checks.items()} == rec["expected"]
    assert {k: c["limit"] for k, c in checks.items()} == LIMITS


def neumann_pencil(seed):
    """K, M of the 16x16 scalar pure-Neumann pencil (the thermal
    reference's) at a design drawn from the seed."""
    problem = thermal.Problem(dict(nx=16, ny=16, Ly=1.1, N=6))
    x = 0.5 * np.exp(0.3 * np.random.default_rng(seed).uniform(
        -1.0, 1.0, problem.ndv))
    _, K, M = problem.matrices(x)
    return K, M


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_a_null_mode_is_judged_on_the_first_eigenvalue_above_it(seed):
    """Dense eigh as the reference, ARPACK as the program, both solving the
    same pencil to rounding: with ``null_modes`` 1 the gap reads rounding
    over lambda_1; with 0 the null mode's gap is rounding over rounding
    (0.2-1.1 here), far over every ``lam_rel`` limit of the benchmark
    (at most 1e-5); and inf where the reference's lambda_0 is 0 exactly."""
    K, M = neumann_pencil(seed)
    dense = sl.eigh(K.toarray(), M.toarray(), eigvals_only=True)[:10]
    lam, _ = eig.lowest_pairs(K, M, -0.1, 10)
    assert abs(dense[0]) < 1e-12 < 1.0 < dense[1]
    ref = {"lam": dense, "value": 1.0, "xb": np.ones(3), "null_modes": 1}

    def lam_rel(ref):
        return judge.compare(ref, 1.0, lam, np.ones(3),
                             LIMITS)["lam_rel"]["value"]

    assert np.isfinite(lam_rel(ref)) and lam_rel(ref) < 1e-8
    assert lam_rel(dict(ref, null_modes=0)) > 1e-3
    exact = dict(ref, lam=np.concatenate([[0.0], dense[1:]]))
    assert lam_rel(exact) < 1e-8
    with np.errstate(divide="ignore"):
        assert lam_rel(dict(exact, null_modes=0)) == np.inf


@pytest.mark.parametrize("pair,null_modes",
                         [(("nf_263k", "ksfreq"), 0),
                          (("crm_86k", "compliance"), 0)])
def test_reference_reports_its_null_modes(pair, null_modes):
    """``judge.reference`` carries the family's declaration, 0 where a
    family declares none (the thermal family's 1 is read in
    ``test_eigbench_thermal.py``)."""
    config, traffic = small_pair(*pair)
    fam = importlib.import_module(f"eigbench.reference.{config['family']}")
    x, _ = design.for_cell(config, traffic, 0,
                           fam.Problem(config["model"]).ndv)
    assert judge.reference(config, traffic, x)["null_modes"] == null_modes
