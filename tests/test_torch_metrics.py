"""The port's model-quality metrics and ``BayesianModelProbability`` (K13)
against pgmpy_tpu on the CPU.

Both packages get the same networks (the port's copy carries the JAX model's
float32 tables) and the same seeded frames.  The CI-test and score metrics
are host float64 over equal integer counts (1e-10); the per-row log
probability is a float32 sum in both packages (1e-5 relative) and, with the
port in float64, equal to a numpy gather-sum over the CPD tables to 1e-12.
"""

import numpy as np
import pandas as pd
import pytest

import pgmpy_tpu.metrics as jax_metrics
from _golden_data import standalone_sample
from _torch_parity import random_bn_pair
from pgmpy_tpu.base import DAG as JaxDAG
from pgmpy_tpu_torch import metrics
from pgmpy_tpu_torch.base import DAG
from pgmpy_tpu_torch.config import config
from pgmpy_tpu_torch.estimators import chi_square
from pgmpy_tpu_torch.metrics import BayesianModelProbability
from pgmpy_tpu_torch.utils.interop import bn_from_numpy

SEEDS = [0, 1, 2]


@pytest.fixture(scope="module", params=SEEDS)
def case(request):
    port_model, jax_model = random_bn_pair(request.param, n_nodes=7)
    frame = standalone_sample(jax_model, 1500, seed=10 + request.param)
    return port_model, jax_model, frame


def test_log_probability_matches_jax(case):
    port_model, jax_model, frame = case
    from pgmpy_tpu.metrics import BayesianModelProbability as JaxProbability

    got = BayesianModelProbability(port_model).log_probability(frame)
    want = JaxProbability(jax_model).log_probability(frame)
    assert got.dtype == np.float64 and got.shape == (len(frame),)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert metrics.log_likelihood_score(port_model, frame) == pytest.approx(
        jax_metrics.log_likelihood_score(jax_model, frame), rel=1e-6)


def numpy_log_probability(model, frame):
    """log P(row) in float64 by numpy: per node, the CPD entry of the row's
    state given its parents' states, log-clamped at 1e-38 as both samplers
    do, summed over nodes."""
    total = np.zeros(len(frame))
    for cpd in model.get_cpds():
        values = np.asarray(cpd.get_values(), dtype=np.float64)
        names = {v: list(cpd.state_names[v]) for v in cpd.variables}
        col = np.zeros(len(frame), dtype=np.int64)
        for parent in cpd.variables[1:]:
            codes = frame[parent].map({s: i for i, s in enumerate(names[parent])})
            col = col * len(names[parent]) + codes.to_numpy(dtype=np.int64)
        row = frame[cpd.variable].map({s: i for i, s in enumerate(names[cpd.variable])})
        total += np.log(np.maximum(values[row.to_numpy(dtype=np.int64), col], 1e-38))
    return total


def test_log_probability_in_float64_matches_numpy(case):
    port_model, _, frame = case
    previous = config.DTYPE
    config.set_dtype("float64")
    try:
        got = BayesianModelProbability(port_model).log_probability(frame)
    finally:
        config.set_dtype(previous)
    np.testing.assert_allclose(got, numpy_log_probability(port_model, frame), rtol=1e-12)


def _zero_cell_pair():
    from pgmpy_tpu.factors import TabularCPD as JaxCPD
    from pgmpy_tpu.models import DiscreteBayesianNetwork as JaxBN

    states = {"a": ["a0", "a1"], "b": ["b0", "b1"]}
    tables = [("a", 2, np.array([[1.0], [0.0]]), [], [], {"a": states["a"]}),
              ("b", 2, np.array([[0.0, 0.5], [1.0, 0.5]]), ["a"], [2], states)]
    jax_model = JaxBN([("a", "b")])
    jax_model.add_cpds(*[JaxCPD(v, c, t, evidence=e or None, evidence_card=ec or None,
                                state_names=sn) for v, c, t, e, ec, sn in tables])
    return bn_from_numpy([("a", "b")], tables, nodes=["a", "b"]), jax_model


def test_a_zero_probability_row_is_the_same_finite_number():
    from pgmpy_tpu.metrics import BayesianModelProbability as JaxProbability

    port_model, jax_model = _zero_cell_pair()
    frame = pd.DataFrame({"a": ["a0", "a1", "a0"], "b": ["b1", "b0", "b0"]})
    got = BayesianModelProbability(port_model).log_probability(frame)
    want = JaxProbability(jax_model).log_probability(frame)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, numpy_log_probability(port_model, frame), rtol=1e-6)
    assert got[0] == 0.0 and got[1] < -80 and got[2] < -80


def test_reduce_tables_and_unknown_states(case):
    port_model, jax_model, frame = case
    from pgmpy_tpu.metrics import BayesianModelProbability as JaxProbability

    port, ref = BayesianModelProbability(port_model), JaxProbability(jax_model)
    variable = list(port_model.nodes())[-1]
    got, want = port.pre_compute_reduce(variable), ref.pre_compute_reduce(variable)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], np.asarray(want[key], dtype=np.float64), atol=1e-7)
    got_maps = port.pre_compute_reduce_maps(variable)
    want_maps = ref.pre_compute_reduce_maps(variable)
    assert got_maps[0] == want_maps[0]
    bad = frame.astype(str).copy()
    bad.iloc[0, 0] = "no such state"
    with pytest.raises(ValueError, match="state names"):
        port.log_probability(bad)


@pytest.mark.parametrize("method", ["k2", "bdeu", "bds", "bic-d", "aic-d"])
def test_structure_score_matches_jax(case, method):
    port_model, jax_model, frame = case
    assert metrics.structure_score(port_model, frame, scoring_method=method) == pytest.approx(
        jax_metrics.structure_score(jax_model, frame, scoring_method=method), rel=1e-10)


def test_ci_metrics_match_jax(case):
    port_model, jax_model, frame = case
    pd.testing.assert_frame_equal(
        metrics.implied_cis(port_model, frame, "chi_square", show_progress=False),
        jax_metrics.implied_cis(jax_model, frame, "chi_square", show_progress=False),
        rtol=1e-10)
    assert metrics.fisher_c(port_model, frame, "chi_square") == pytest.approx(
        jax_metrics.fisher_c(jax_model, frame, "chi_square"), rel=1e-10, abs=1e-12)
    np.testing.assert_allclose(
        metrics.fisher_c(port_model, frame, chi_square, compute_rmsea=True),
        jax_metrics.fisher_c(jax_model, frame, "chi_square", compute_rmsea=True),
        rtol=1e-10, atol=1e-12)
    for significance_level in (0.05, 0.2):
        assert metrics.correlation_score(
            port_model, frame, significance_level=significance_level) == pytest.approx(
            jax_metrics.correlation_score(jax_model, frame,
                                          significance_level=significance_level), abs=1e-12)
    got = metrics.correlation_score(port_model, frame, return_summary=True)
    want = jax_metrics.correlation_score(jax_model, frame, return_summary=True)
    pd.testing.assert_frame_equal(got, want)


def test_fisher_c_keeps_the_nansum_quirk():
    """A fully degenerate conditional test has p = NaN: it adds nothing to C
    but still counts in the dof, in both packages."""
    rng = np.random.default_rng(5)
    z = rng.integers(0, 3, 400)
    frame = pd.DataFrame({"z": z, "x": z % 3, "y": rng.integers(0, 2, 400)}).astype(str)
    edges = [("z", "x"), ("z", "y")]
    got = metrics.fisher_c(DAG(edges), frame, "chi_square", compute_rmsea=True)
    want = jax_metrics.fisher_c(JaxDAG(edges), frame, "chi_square", compute_rmsea=True)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert np.isnan(chi_square("x", "y", ["z"], frame, boolean=False)[1])
    with pytest.raises(ValueError, match="latent"):
        metrics.fisher_c(DAG(edges, latents=["z"]), frame, "chi_square")


def test_shd_and_get_metrics():
    pairs = [([("a", "b"), ("b", "c")], [("a", "b"), ("c", "b")]),
             ([("a", "b"), ("b", "c"), ("a", "c")], [("b", "a")]),
             ([("a", "b")], [("a", "b")])]
    for true, est in pairs:
        nodes = sorted({n for e in true + est for n in e})
        t, e = DAG(true), DAG(est)
        t.add_nodes_from(nodes)
        e.add_nodes_from(nodes)
        jt, je = JaxDAG(true), JaxDAG(est)
        jt.add_nodes_from(nodes)
        je.add_nodes_from(nodes)
        assert metrics.SHD(t, e) == jax_metrics.SHD(jt, je)
    with pytest.raises(ValueError, match="same nodes"):
        metrics.SHD(DAG([("a", "b")]), DAG([("a", "c")]))
    assert sorted(metrics.get_metrics()) == sorted(jax_metrics.get_metrics())
    assert metrics.get_metrics(["SHD"]) == {"SHD": metrics.SHD}
    with pytest.raises(ValueError, match="Missing columns"):
        metrics.correlation_score(DAG([("a", "b")]), pd.DataFrame({"a": [0]}))


def test_validate_matches_jax(case):
    port_model, jax_model, frame = case
    chosen = ("correlation", "log-likelihood", "bic", "aic")
    got = port_model.validate(frame, metrics=chosen)
    want = jax_model.validate(frame, metrics=chosen)
    assert list(got["metric"]) == list(want["metric"]) == list(chosen)
    np.testing.assert_allclose(got["value"].astype(float), want["value"].astype(float), rtol=1e-6)
    default = port_model.validate(frame)
    assert list(default["metric"]) == ["correlation", "log-likelihood", "bic"]
    # a bare DAG has no CPDs: the log-likelihood row reports the error
    dag = DAG(port_model.edges())
    rows = dag.validate(frame, metrics=("log-likelihood", "bic", metrics.SHD))
    ref = JaxDAG(jax_model.edges()).validate(frame, metrics=("log-likelihood", "bic"))
    assert str(rows["value"][0]).startswith("error:") and str(ref["value"][0]).startswith("error:")
    assert rows["value"][1] == pytest.approx(ref["value"][1], rel=1e-10)
    assert rows["metric"][2] == "SHD" and str(rows["value"][2]).startswith("error:")
