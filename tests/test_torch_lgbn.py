"""LinearGaussianCPD, LinearGaussianBayesianNetwork and the Gaussian example
networks of the port against ``pgmpy_tpu`` on identical numpy inputs.

Everything but ``predict``'s linear solve is host float64 numpy in both
packages and must agree to 1e-12; the solve runs in float32 on the device in
both (``jnp.linalg.solve`` there, ``torch.linalg.solve`` here), so the
conditional mean and covariance agree to rtol 1e-4 of the covariance's scale,
and to 1e-9 against numpy when the port runs in float64."""

import numpy as np
import pandas as pd
import pytest

from pgmpy_tpu.factors import LinearGaussianCPD as JaxCPD
from pgmpy_tpu.models import LinearGaussianBayesianNetwork as JaxLGBN
from pgmpy_tpu.utils.utils import get_example_model as jax_example

from _torch_parity import lgbn_tuples, to_port_lgbn
from pgmpy_tpu_torch.config import config
from pgmpy_tpu_torch.factors import LinearGaussianCPD
from pgmpy_tpu_torch.models import LinearGaussianBayesianNetwork
from pgmpy_tpu_torch.utils.utils import GAUSSIAN_MODELS, get_example_model

SEEDS = [0, 1, 2]


def random_pair(seed, n_nodes=7):
    ref = JaxLGBN.get_random(n_nodes=n_nodes, edge_prob=0.4, seed=seed)
    return to_port_lgbn(ref), ref


def chain_lgbn():
    model = LinearGaussianBayesianNetwork([("x1", "x2"), ("x2", "x3")])
    model.add_cpds(
        LinearGaussianCPD("x1", [1], 4),
        LinearGaussianCPD("x2", [-5, 0.5], 4, evidence=["x1"]),
        LinearGaussianCPD("x3", [4, -1], 3, evidence=["x2"]),
    )
    return model


@pytest.mark.parametrize("seed", SEEDS)
def test_joint_gaussian_matches(seed):
    port, ref = random_pair(seed)
    variables, mean, cov = port.joint_gaussian()
    ref_variables, ref_mean, ref_cov = ref.joint_gaussian()
    assert variables == ref_variables
    np.testing.assert_allclose(mean, ref_mean, rtol=0, atol=1e-12)
    np.testing.assert_allclose(cov, ref_cov, rtol=1e-12, atol=1e-12)
    for got, want in zip(port.to_joint_gaussian(), ref.to_joint_gaussian()):
        assert np.array_equal(got, want)


def test_joint_gaussian_closed_form():
    variables, mean, cov = chain_lgbn().joint_gaussian()
    assert variables == ["x1", "x2", "x3"]
    np.testing.assert_allclose(mean, [1.0, -4.5, 8.5], atol=1e-12)
    np.testing.assert_allclose(cov, [[16, 8, -8], [8, 20, -20], [-8, -20, 29]], atol=1e-10)


@pytest.mark.parametrize("seed", SEEDS)
def test_log_likelihood_fit_and_simulate_match_on_one_frame(seed):
    port, ref = random_pair(seed)
    frame = ref.simulate(n_samples=300, seed=seed)  # one shared frame
    assert port.simulate(n_samples=300, seed=seed).equals(frame)
    assert port.log_likelihood(frame) == pytest.approx(ref.log_likelihood(frame), rel=1e-12)
    for std_estimator in ("unbiased", "mle"):
        a = LinearGaussianBayesianNetwork(list(port.edges()))
        a.add_nodes_from(port.nodes())
        b = JaxLGBN(list(ref.edges()))
        b.add_nodes_from(ref.nodes())
        a.fit(frame, std_estimator=std_estimator)
        b.fit(frame, std_estimator=std_estimator)
        for got, want in zip(lgbn_tuples(a), lgbn_tuples(b)):
            assert got[:2] == want[:2]
            np.testing.assert_allclose(got[2], want[2], rtol=1e-12, atol=1e-12)
            assert got[3] == pytest.approx(want[3], rel=1e-12)


def test_log_likelihood_matches_scipy():
    from scipy.stats import multivariate_normal

    model = chain_lgbn()
    df = model.simulate(n_samples=100, seed=2)
    variables, mean, cov = model.joint_gaussian()
    expected = multivariate_normal(mean, cov).logpdf(df.loc[:, variables].to_numpy()).sum()
    assert model.log_likelihood(df) == pytest.approx(expected, rel=1e-9)


@pytest.mark.parametrize("seed", SEEDS)
def test_predict_matches(seed):
    port, ref = random_pair(seed)
    variables = list(port.joint_gaussian()[0])
    frame = ref.simulate(n_samples=40, seed=seed).drop(columns=variables[-2:] + variables[:1])
    missing, mean, cov = port.predict(frame)
    ref_missing, ref_mean, ref_cov = ref.predict(frame)
    assert missing == ref_missing and mean.shape == (40, 3)
    scale = float(np.abs(ref_cov).max())
    np.testing.assert_allclose(mean, ref_mean, rtol=1e-4, atol=1e-4 * max(scale, 1.0))
    np.testing.assert_allclose(cov, ref_cov, rtol=1e-4, atol=1e-4 * max(scale, 1.0))


def test_predict_in_float64_matches_numpy():
    port, _ = random_pair(1)
    variables, mean, cov = port.joint_gaussian()
    frame = port.simulate(n_samples=10, seed=0).drop(columns=variables[2:4])
    config.set_dtype("float64")
    try:
        missing, cond_mean, cond_cov = port.predict(frame)
    finally:
        config.set_dtype("float32")
    a = [variables.index(v) for v in missing]
    b = [i for i in range(len(variables)) if i not in a]
    K = np.linalg.solve(cov[np.ix_(b, b)], cov[np.ix_(a, b)].T)
    x_b = frame.loc[:, [variables[i] for i in b]].to_numpy()
    np.testing.assert_allclose(cond_mean, mean[a] + (x_b - mean[b]) @ K, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(cond_cov, cov[np.ix_(a, a)] - cov[np.ix_(a, b)] @ K,
                               rtol=1e-9, atol=1e-9)


def test_predict_conditioning_by_hand():
    missing, cond_mean, cond_cov = chain_lgbn().predict(pd.DataFrame({"x1": [1.0], "x2": [-4.5]}))
    assert missing == ["x3"]
    np.testing.assert_allclose(cond_mean[0], [8.5], atol=1e-4)
    np.testing.assert_allclose(cond_cov, [[9.0]], atol=1e-3)
    with pytest.raises(ValueError, match="Nothing to predict"):
        chain_lgbn().predict(pd.DataFrame({"x1": [1.0], "x2": [0.0], "x3": [0.0]}))


@pytest.mark.parametrize("seed", SEEDS)
def test_simulate_with_interventions_matches(seed):
    port, ref = random_pair(seed, n_nodes=6)
    variables = list(port.joint_gaussian()[0])
    do = {variables[1]: 0.7}
    soft = (variables[3], [0.25], 0.5)
    evidence = {variables[-1]: -0.3}
    got = port.simulate(50, do=do, virtual_intervention=[LinearGaussianCPD(*soft)], seed=seed)
    want = ref.simulate(50, do=do, virtual_intervention=[JaxCPD(*soft)], seed=seed)
    pd.testing.assert_frame_equal(got, want, rtol=1e-12, atol=1e-12)
    # conditioning goes through predict's float32 solve
    got = port.simulate(50, evidence=evidence, seed=seed)
    want = ref.simulate(50, evidence=evidence, seed=seed)
    assert list(got.columns) == list(want.columns)
    np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), rtol=1e-3, atol=1e-3)
    for kwargs in ({"do": {"nope": 1}}, {"evidence": {"nope": 1}},
                   {"do": do, "evidence": {variables[1]: 0.0}}):
        with pytest.raises(ValueError):
            port.simulate(5, **kwargs)


def test_simulate_moments_and_latents():
    model = chain_lgbn()
    df = model.simulate(n_samples=100_000, seed=0)
    np.testing.assert_allclose(df.mean(), [1.0, -4.5, 8.5], atol=0.1)
    np.testing.assert_allclose(np.cov(df.T.to_numpy()),
                               [[16, 8, -8], [8, 20, -20], [-8, -20, 29]], atol=0.5)
    model.latents = {"x2"}
    assert list(model.simulate(5, seed=0).columns) == ["x1", "x3"]
    assert list(model.simulate(5, seed=0, include_latents=True).columns) == ["x1", "x2", "x3"]


def test_get_random_matches():
    port = LinearGaussianBayesianNetwork.get_random(n_nodes=6, seed=3)
    ref = JaxLGBN.get_random(n_nodes=6, seed=3)
    assert port.check_model()
    assert list(port.nodes()) == list(ref.nodes()) and set(port.edges()) == set(ref.edges())
    for got, want in zip(lgbn_tuples(port), lgbn_tuples(ref)):
        assert got[:2] == want[:2] and got[3] == want[3]
        assert np.array_equal(got[2], want[2])
    cpds = port.get_random_cpds(seed=1)
    assert [c.variable for c in cpds] == list(port.nodes())
    assert port.get_random_cpds(seed=1, inplace=True) is port


def test_model_surface():
    model = chain_lgbn()
    assert model.check_model()
    assert model.get_cpds("x2").evidence == ["x1"] and len(model.get_cpds()) == 3
    copy = model.copy()
    assert copy.get_cpds("x3") == model.get_cpds("x3")
    assert copy.get_cpds("x3") is not model.get_cpds("x3")
    copy.remove_cpds("x3")
    assert copy.get_cpds("x3") is None and model.get_cpds("x3") is not None
    with pytest.raises(ValueError, match="No CPD associated"):
        copy.check_model()
    with pytest.raises(ValueError, match="Only LinearGaussianCPD"):
        model.add_cpds("x1")
    with pytest.raises(ValueError, match="not in the model"):
        model.add_cpds(LinearGaussianCPD("y", [0], 1))
    with pytest.raises(ValueError, match="not present"):
        model.get_cpds("y")
    wrong = LinearGaussianBayesianNetwork([("a", "b")])
    wrong.add_cpds(LinearGaussianCPD("a", [0], 1), LinearGaussianCPD("b", [0], 1))
    with pytest.raises(ValueError, match="proper parents"):
        wrong.check_model()
    with pytest.raises(ValueError, match="Cardinality"):
        model.get_cardinality("x1")
    with pytest.raises(NotImplementedError):
        model.to_markov_model()
    with pytest.raises(NotImplementedError):
        model.is_imap(None)
    with pytest.raises(ValueError, match="missing in the data"):
        model.fit(pd.DataFrame({"x1": [0.0]}))
    with pytest.raises(ValueError, match="estimator"):
        model.fit(pd.DataFrame(), estimator="bayes")
    surgery = model._do_surgery({"x2": 2.0})
    assert sorted(surgery.nodes()) == ["x1", "x3"]
    np.testing.assert_allclose(surgery.get_cpds("x3").beta, [2.0])


def test_model_strings_wait_for_the_parser():
    for kwargs in ({"lavaan_str": "y ~ x"}, {"dagitty_str": "dag { x -> y }"}):
        with pytest.raises(NotImplementedError, match="utils/parser.py"):
            LinearGaussianBayesianNetwork(**kwargs)


def test_cpd_matches():
    port = LinearGaussianCPD("y", [0.5, 2.0, -1.0], 1.5, evidence=["a", "b"])
    ref = JaxCPD("y", [0.5, 2.0, -1.0], 1.5, evidence=["a", "b"])
    assert str(port) == str(ref) and repr(port) == repr(ref)
    assert port.variance == ref.variance and port.scope() == ref.scope()
    assert port == LinearGaussianCPD("y", [0.5, -1.0, 2.0], 1.5, evidence=["b", "a"])
    assert port != LinearGaussianCPD("y", [0.5, 2.0, -1.0], 1.0, evidence=["a", "b"])
    assert port.copy() == port and port.is_valid_cpd()
    a, b = LinearGaussianCPD.get_random("y", ["a"], seed=4), JaxCPD.get_random("y", ["a"], seed=4)
    assert np.array_equal(a.beta, b.beta) and a.std == b.std
    with pytest.raises(ValueError, match="positive"):
        LinearGaussianCPD("y", [0], -1.0)
    with pytest.raises(ValueError, match="len\\(evidence\\)\\+1"):
        LinearGaussianCPD("y", [0, 1], 1.0)


@pytest.mark.parametrize("name", sorted(GAUSSIAN_MODELS))
def test_gaussian_example_model_parameters_match(name):
    port, ref = get_example_model(name), jax_example(name)
    assert list(port.nodes()) == list(ref.nodes()) and list(port.edges()) == list(ref.edges())
    assert port.check_model()
    for got, want in zip(lgbn_tuples(port), lgbn_tuples(ref)):
        assert got[:2] == want[:2] and got[3] == want[3]
        assert np.array_equal(got[2], want[2])
    variables, mean, cov = port.joint_gaussian()
    assert np.isfinite(mean).all() and np.linalg.eigvalsh(cov).min() > 0
    assert len(variables) == {"ecoli70": 46, "arth150": 107, "magic-irri": 64,
                              "magic-niab": 44}[name]
