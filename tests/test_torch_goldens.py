"""The reference-pgmpy goldens against the port.

``reference_goldens_v2.json`` and ``reference_goldens_extras.json`` hold
outputs of the reference pgmpy library.  Their posterior, MAP and
virtual-evidence cases run here through the port's VariableElimination and
BeliefPropagation at the tolerance the JAX package's own golden tests use
(atol 2e-6); the Bayesian-estimator goldens run through the port's
``BayesianEstimator`` on the exact frame the reference saw."""

import filecmp
import json
import os

import numpy as np
import pytest

from _golden_data import standalone_sample
from _torch_parity import np_values
from pgmpy_tpu_torch.estimators import BayesianEstimator
from pgmpy_tpu_torch.factors import TabularCPD
from pgmpy_tpu_torch.inference import BeliefPropagation, VariableElimination
from pgmpy_tpu_torch.utils import get_example_model
from pgmpy_tpu_torch.utils.utils import _EXAMPLE_DIR, DISCRETE_MODELS

HERE = os.path.dirname(os.path.abspath(__file__))
with open(os.path.join(HERE, "reference_goldens_v2.json")) as fh:
    V2 = json.load(fh)
with open(os.path.join(HERE, "reference_goldens_extras.json")) as fh:
    EXTRAS = json.load(fh)

ENGINES = {"ve": VariableElimination, "bp": BeliefPropagation}


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("name", sorted(V2))
def test_v2_posteriors(name, engine):
    infer = ENGINES[engine](get_example_model(name))
    for case in V2[name]["bp_queries"]:
        phi = infer.query([case["variable"]], evidence=case["evidence"], show_progress=False)
        assert [str(s) for s in phi.state_names[case["variable"]]] == case["states"]
        np.testing.assert_allclose(np_values(phi.values), np.asarray(case["values"]),
                                   atol=2e-6, err_msg=str(case))


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("name", sorted(V2))
def test_v2_map_queries(name, engine):
    infer = ENGINES[engine](get_example_model(name))
    for case in V2[name]["bp_queries"]:
        got = infer.map_query([case["variable"]], evidence=case["evidence"], show_progress=False)
        assert str(got[case["variable"]]) == case["map"], case


@pytest.mark.parametrize("name", sorted(V2))
def test_v2_staged_elimination(name):
    """The same posteriors through the staged loop (MinFill order)."""
    infer = VariableElimination(get_example_model(name))
    for case in V2[name]["bp_queries"]:
        phi = infer.query([case["variable"]], evidence=case["evidence"],
                          elimination_order="MinFill", show_progress=False)
        np.testing.assert_allclose(np_values(phi.values), np.asarray(case["values"]),
                                   atol=2e-6, err_msg=str(case))


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_extras_virtual_evidence(engine):
    entry = EXTRAS["virtual_evidence"]
    model = get_example_model(entry["network"])
    virt = TabularCPD(
        entry["virtual"]["variable"], 2, [[v] for v in entry["virtual"]["values"]],
        state_names={entry["virtual"]["variable"]: entry["virtual"]["states"]},
    )
    infer = ENGINES[engine](model)
    for case in entry["cases"]:
        phi = infer.query([case["variable"]], evidence=case["evidence"] or None,
                          virtual_evidence=[virt], show_progress=False)
        assert [str(s) for s in phi.state_names[case["variable"]]] == case["states"]
        np.testing.assert_allclose(np_values(phi.values), np.asarray(case["values"]),
                                   atol=2e-6, err_msg=f"{engine}: {case}")


@pytest.mark.parametrize("name", sorted(EXTRAS["bayesian_estimator"]))
def test_extras_bayesian_estimator(name):
    entry = EXTRAS["bayesian_estimator"][name]
    model = get_example_model(name)
    df = standalone_sample(model, entry["n_rows"], seed=entry["data_seed"])
    estimator = BayesianEstimator(model, df)
    for node, want in entry["cpds"].items():
        bdeu = estimator.estimate_cpd(node, prior_type="BDeu", equivalent_sample_size=10)
        assert [str(v) for v in bdeu.variables[1:]] == want["evidence"]
        np.testing.assert_allclose(bdeu.get_values().astype(np.float64).ravel(),
                                   np.asarray(want["bdeu"]), atol=2e-6, err_msg=node)
        k2 = estimator.estimate_cpd(node, prior_type="K2")
        np.testing.assert_allclose(k2.get_values().astype(np.float64).ravel(),
                                   np.asarray(want["k2"]), atol=2e-6, err_msg=node)


@pytest.mark.parametrize("name", sorted(DISCRETE_MODELS))
def test_example_network_is_a_copy_of_the_jax_packages(name):
    """The port ships its own example networks: each file is byte-identical
    to the JAX package's."""
    mine = os.path.join(_EXAMPLE_DIR, f"{name}.bif.gz")
    theirs = os.path.join(os.path.dirname(HERE), "pgmpy_tpu", "utils", "example_models",
                          f"{name}.bif.gz")
    assert os.path.dirname(mine).endswith(os.path.join("pgmpy_tpu_torch", "utils", "example_models"))
    assert filecmp.cmp(mine, theirs, shallow=False)
