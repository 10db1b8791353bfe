"""Count tables and parameter fits of the port against pgmpy_tpu on ALARM,
with 5,000 rows from the shared numpy ancestral sampler.  Counts must be
exact; fitted CPDs agree to atol 1e-6."""

import numpy as np
import pytest

from pgmpy_tpu.estimators import BayesianEstimator as JaxBayes
from pgmpy_tpu.estimators import MaximumLikelihoodEstimator as JaxMLE
from pgmpy_tpu.estimators.base import _CodedData as JaxCoded
from pgmpy_tpu.utils import get_example_model as jax_example

from _golden_data import standalone_sample
from _torch_parity import np_values, to_port
from pgmpy_tpu_torch.config import as_tensor
from pgmpy_tpu_torch.estimators import BayesianEstimator, MaximumLikelihoodEstimator
from pgmpy_tpu_torch.estimators.base import _CodedData

SPECS = [
    ("HISTORY", ()),
    ("CVP", ("LVEDVOLUME",)),
    ("HR", ("CATECHOL",)),
    ("BP", ("CO", "TPR")),
    ("VENTLUNG", ("INTUBATION", "KINKEDTUBE", "VENTTUBE")),
]


@pytest.fixture(scope="module")
def alarm():
    model = jax_example("alarm")
    df = standalone_sample(model, 5000, seed=7)
    return model, df


@pytest.fixture(scope="module")
def coded(alarm):
    model, df = alarm
    states = {k: [str(s) for s in v] for k, v in model.states.items()}
    return _CodedData(df, states), JaxCoded(df, states)


@pytest.mark.parametrize("variable,parents", SPECS)
def test_counts_exact(coded, variable, parents):
    port, ref = coded
    got = port.counts(variable, parents)
    np.testing.assert_array_equal(got, np.asarray(ref.counts(variable, parents)))
    assert got.sum() == 5000


def test_multi_counts_exact_and_one_dispatch(coded):
    port, ref = coded
    before = port.n_dispatches
    got = port.multi_counts(SPECS)
    assert port.n_dispatches == before + 1
    for a, b in zip(got, ref.multi_counts(SPECS)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_weighted_counts(coded):
    port, ref = coded
    w = np.random.default_rng(0).random(5000).astype(np.float32)
    got = port.counts("BP", ("CO", "TPR"), weights=as_tensor(w))
    import jax.numpy as jnp

    expect = np.asarray(ref.counts("BP", ("CO", "TPR"), weights=jnp.asarray(w)))
    np.testing.assert_allclose(got, expect, atol=1e-3, rtol=1e-5)


def test_missing_rows_are_dropped(alarm):
    model, df = alarm
    df = df.copy()
    rng = np.random.default_rng(1)
    for col in ["CVP", "LVEDVOLUME", "HISTORY"]:
        df.loc[rng.random(len(df)) < 0.1, col] = np.nan
    port, ref = _CodedData(df), JaxCoded(df)
    assert port.state_names == ref.state_names
    for spec in [("CVP", ("LVEDVOLUME",)), ("HISTORY", ())]:
        np.testing.assert_array_equal(port.counts(*spec), np.asarray(ref.counts(*spec)))
    for a, b in zip(port.multi_counts(SPECS[:2]), ref.multi_counts(SPECS[:2])):
        np.testing.assert_array_equal(a, np.asarray(b))


def _assert_cpds_close(port_cpds, jax_cpds):
    port = {c.variable: c for c in port_cpds}
    assert set(port) == {c.variable for c in jax_cpds}
    for ref in jax_cpds:
        got = port[ref.variable]
        assert got.variables == ref.variables
        assert got.state_names == ref.state_names
        np.testing.assert_allclose(got.get_values(), np.asarray(ref.get_values()), atol=1e-6)


@pytest.mark.parametrize("state_names", [False, True])
def test_mle_fit(alarm, state_names):
    model, df = alarm
    kwargs = {"state_names": model.states} if state_names else {}
    _assert_cpds_close(MaximumLikelihoodEstimator(to_port(model), df, **kwargs).get_parameters(),
                       JaxMLE(model, df, **kwargs).get_parameters())


@pytest.mark.parametrize("prior", [("BDeu", 5), ("K2", None), ("BDeu", 1)])
def test_bayesian_fit(alarm, prior):
    model, df = alarm
    prior_type, ess = prior
    kwargs = dict(prior_type=prior_type)
    if ess is not None:
        kwargs["equivalent_sample_size"] = ess
    port = BayesianEstimator(to_port(model), df, state_names=model.states).get_parameters(**kwargs)
    ref = JaxBayes(model, df, state_names=model.states).get_parameters(**kwargs)
    _assert_cpds_close(port, ref)


@pytest.mark.parametrize("prior", [
    dict(prior_type="BDeu", equivalent_sample_size=5),
    dict(prior_type="K2"),
    dict(prior_type="dirichlet", pseudo_counts=0.5),
])
def test_bayesian_get_parameters_is_one_dispatch(alarm, prior):
    """All 37 tables of a Bayesian fit come from ONE count call, where the
    JAX estimator makes one per node."""
    model, df = alarm
    est = BayesianEstimator(to_port(model), df, state_names=model.states)
    ref = JaxBayes(model, df, state_names=model.states)
    _assert_cpds_close(est.get_parameters(**prior), ref.get_parameters(**prior))
    assert est._coded.n_dispatches == 1
    assert ref._coded.n_dispatches == len(model.nodes())


def test_bayesian_per_node_priors_and_shape_check(alarm):
    model, df = alarm
    ess = {node: 1.0 + i % 3 for i, node in enumerate(sorted(model.nodes()))}
    port = BayesianEstimator(to_port(model), df, state_names=model.states)
    ref = JaxBayes(model, df, state_names=model.states)
    _assert_cpds_close(port.get_parameters(equivalent_sample_size=ess),
                       ref.get_parameters(equivalent_sample_size=ess))
    wrong = {node: np.ones((1, 2)) for node in model.nodes()}
    with pytest.raises(ValueError):
        port.get_parameters(prior_type="dirichlet", pseudo_counts=wrong)
    assert port._coded.n_dispatches == 1  # a bad prior is refused before any count


@pytest.mark.parametrize("prior_type", ["BDeu", "K2"])
def test_bayesian_estimate_cpd_is_one_table(alarm, prior_type):
    model, df = alarm
    est = BayesianEstimator(to_port(model), df, state_names=model.states)
    ref = JaxBayes(model, df, state_names=model.states)
    _assert_cpds_close([est.estimate_cpd("BP", prior_type=prior_type)],
                       [ref.estimate_cpd("BP", prior_type=prior_type)])
    assert est._coded.n_dispatches == 1


def test_weighted_fit_matches(alarm):
    model, df = alarm
    df = df.copy()
    df["_weight"] = np.random.default_rng(2).random(len(df)).astype(np.float32)
    port = MaximumLikelihoodEstimator(to_port(model), df, state_names=model.states)
    ref = JaxMLE(model, df, state_names=model.states)
    port_cpds, ref_cpds = port.get_parameters(weighted=True), ref.get_parameters(weighted=True)
    got = {c.variable: c for c in port_cpds}
    for cpd in ref_cpds:  # f32 weighted sums in another order: atol 1e-5 on probabilities
        np.testing.assert_allclose(got[cpd.variable].get_values(), np.asarray(cpd.get_values()),
                                   atol=1e-5)


@pytest.mark.parametrize("method", ["multi_counts", "multi_counts_padded"])
def test_multi_counts_on_alarm(coded, method):
    port, ref = coded
    for a, b in zip(getattr(port, method)(SPECS), getattr(ref, method)(SPECS)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_state_counts_frame(alarm):
    model, df = alarm
    port = MaximumLikelihoodEstimator(to_port(model), df).state_counts("BP")
    ref = JaxMLE(model, df).state_counts("BP")
    np.testing.assert_array_equal(port.to_numpy(), np_values(ref.to_numpy()))
    assert list(port.columns) == list(ref.columns)
