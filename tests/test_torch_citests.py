"""The port's conditional-independence tests against pgmpy_tpu on the CPU.

Both packages get the same seeded frames.  The discrete tests build their
contingency tensors from the same integer counts and evaluate the same
float64 expressions, so statistic and p-value agree to 1e-12 relative and the
degrees of freedom are equal, NaN and inf included (the literal Cressie-Read
``0 * inf``, mod-log-likelihood's ``O = 0``, an all-degenerate conditional
test).  The residual tests are host numpy float64 in both packages (1e-10).
"""

import numpy as np
import pandas as pd
import pytest
from sklearn.linear_model import LinearRegression

import _torch_parity  # noqa: F401  (puts the port on the CPU)
import pgmpy_tpu.estimators.citests as jax_ci
from _golden_data import (
    PILLAI_CASES,
    LinearPillaiClassifier,
    LinearPillaiRegressor,
    standalone_gaussian_frame,
    standalone_mixed_frame,
)
from pgmpy_tpu.independencies import Independencies as JaxIndependencies
from pgmpy_tpu_torch.config import config
from pgmpy_tpu_torch.estimators import citests
from pgmpy_tpu_torch.estimators.base import _CodedData
from pgmpy_tpu_torch.independencies import Independencies

LAMBDAS = ["pearson", "log-likelihood", "freeman-tukey", "mod-log-likelihood", "neyman",
           "cressie-read", 0.5]
EXACT = dict(rtol=1e-12, atol=0)
FACTORIES = {"classifier_factory": LinearPillaiClassifier,
             "regressor_factory": LinearPillaiRegressor}


def _frame(kind):
    """Six discrete columns from one numpy seed.  ``nan``: missing values in
    three columns; ``yates``: X and Y binary, so every slice with both states
    observed is 2x2 (Yates); ``degenerate``: X is constant in some Z slices,
    and in ``all_degenerate`` X is a function of Z (every slice degenerate)."""
    rng = np.random.default_rng({"plain": 0, "nan": 1, "yates": 2, "degenerate": 3,
                                 "all_degenerate": 4}[kind])
    n = 600
    z1 = rng.integers(0, 3, n)
    z2 = rng.integers(0, 2, n)
    card = 2 if kind == "yates" else 3
    x = np.where(rng.random(n) < 0.7, z1 % card, rng.integers(0, card, n))
    y = np.where(rng.random(n) < 0.6, (x + z2) % card, rng.integers(0, card, n))
    if kind == "degenerate":
        x = np.where(z1 == 0, 0, x)
    if kind == "all_degenerate":
        x = (z1 + z2) % 3
    # a sparse column: zero rows and columns inside slices
    w = np.where(rng.random(n) < 0.9, 0, rng.integers(1, 4, n))
    v = rng.integers(0, 4, n)
    df = pd.DataFrame({"X": x, "Y": y, "Z1": z1, "Z2": z2, "W": w, "V": v}).astype(float)
    if kind == "nan":
        for col in ("X", "Z1", "W"):
            df.loc[rng.random(n) < 0.08, col] = np.nan
    return df


FRAMES = ["plain", "nan", "yates", "degenerate", "all_degenerate"]
TRIPLES = [("X", "Y", []), ("X", "Y", ["Z1"]), ("X", "Y", ["Z1", "Z2"]),
           ("W", "V", ["Z1"]), ("X", "W", ["Z2", "V"])]


@pytest.fixture(scope="module", params=FRAMES)
def frame(request):
    return _frame(request.param)


def _assert_same(got, want):
    stat, p, dof = got
    assert dof == want[2] and isinstance(dof, int)
    np.testing.assert_allclose([stat, p], [want[0], want[1]], **EXACT)


@pytest.mark.parametrize("lam", LAMBDAS, ids=str)
def test_power_divergence_matches_jax(frame, lam):
    for x, y, z in TRIPLES:
        got = citests.power_divergence(x, y, z, frame, boolean=False, lambda_=lam)
        want = jax_ci.power_divergence(x, y, z, frame, boolean=False, lambda_=lam)
        _assert_same(got, want)
        assert citests.power_divergence(x, y, z, frame, lambda_=lam, significance_level=0.05) \
            == jax_ci.power_divergence(x, y, z, frame, lambda_=lam, significance_level=0.05)


@pytest.mark.parametrize("name", ["chi_square", "g_sq", "log_likelihood",
                                  "modified_log_likelihood"])
def test_named_tests_match_jax(frame, name):
    for x, y, z in TRIPLES:
        got = getattr(citests, name)(x, y, z, frame, boolean=False)
        _assert_same(got, getattr(jax_ci, name)(x, y, z, frame, boolean=False))


def test_degenerate_conventions():
    """An all-degenerate conditional test has p = NaN (the edge stays); an
    unconditional test of a constant column has p = 1 and dof 0."""
    df = _frame("all_degenerate")
    stat, p, dof = citests.chi_square("X", "Y", ["Z1", "Z2"], df, boolean=False)
    assert (stat, dof) == (0.0, 0) and np.isnan(p)
    assert citests.chi_square("X", "Y", ["Z1", "Z2"], df) is False
    const = df.assign(X=1.0)
    assert citests.chi_square("X", "Y", [], const, boolean=False) == (0.0, 1.0, 0)


@pytest.mark.parametrize("lam", LAMBDAS, ids=str)
def test_batch_equals_single_calls(frame, lam):
    triples = TRIPLES + [TRIPLES[1], ("Y", "X", ["Z1"])]  # a duplicate spec
    coded = _CodedData(frame)
    batch = citests.power_divergence_batch(triples, lambda_=lam, coded=coded)
    assert coded.n_dispatches == 1
    jax_batch = jax_ci.power_divergence_batch(triples, data=frame, lambda_=lam)
    for (x, y, z), got, want in zip(triples, batch, jax_batch):
        single = citests.power_divergence(x, y, z, frame, boolean=False, lambda_=lam)
        assert got[2] == single[2]
        np.testing.assert_array_equal(got[:2], single[:2])
        _assert_same(got, want)


def test_batch_of_nothing_launches_nothing(frame):
    coded = _CodedData(frame)
    assert citests.power_divergence_batch([], coded=coded) == []
    assert coded.n_dispatches == 0
    with pytest.raises(ValueError, match="data or coded"):
        citests.power_divergence_batch([("X", "Y", [])])


def test_the_frame_cache_is_the_ports_own_and_keyed_on_the_device():
    """A frame coded by pgmpy_tpu first is coded again by the port, under its
    own attribute, per device; an entry for another device is not used."""
    df = _frame("plain")
    jax_ci.chi_square("X", "Y", ["Z1"], df)
    assert "_pgmpy_tpu_coded" in df.__dict__
    bogus = object()
    df.__dict__["_pgmpy_tpu_torch_coded"] = {"cuda:0": bogus, "cuda": bogus}
    got = citests.chi_square("X", "Y", ["Z1"], df, boolean=False)
    cache = df.__dict__["_pgmpy_tpu_torch_coded"]
    assert isinstance(cache[str(config.DEVICE)], _CodedData)
    assert cache["cuda"] is bogus
    _assert_same(got, jax_ci.chi_square("X", "Y", ["Z1"], df, boolean=False))
    # the cached copy serves the next call without coding the frame again
    coded = cache[str(config.DEVICE)]
    citests.power_divergence_batch([("X", "Y", ["Z2"])], data=df)
    assert cache[str(config.DEVICE)] is coded and coded.n_dispatches == 2


@pytest.fixture(scope="module")
def gauss_df():
    return standalone_gaussian_frame(800, seed=2027)


@pytest.fixture(scope="module")
def mixed_df():
    return standalone_mixed_frame(500, seed=2028)


RESIDUAL_TRIPLES = [("A", "B", []), ("A", "D", ["B", "C"]), ("C", "F", ["A"]),
                    ("E", "F", ["D", "B", "C"])]


@pytest.mark.parametrize("x, y, z", RESIDUAL_TRIPLES)
def test_pearsonr_and_gcm_match_jax(gauss_df, x, y, z):
    np.testing.assert_allclose(citests.pearsonr(x, y, z, gauss_df, boolean=False),
                               jax_ci.pearsonr(x, y, z, gauss_df, boolean=False),
                               rtol=1e-10, atol=1e-300)
    np.testing.assert_allclose(citests.gcm(x, y, z, gauss_df, boolean=False),
                               jax_ci.gcm(x, y, z, gauss_df, boolean=False),
                               rtol=1e-10, atol=1e-300)
    reg = LinearRegression()
    np.testing.assert_allclose(citests.gcm(x, y, z, gauss_df, boolean=False, regressor=reg),
                               jax_ci.gcm(x, y, z, gauss_df, boolean=False, regressor=reg),
                               rtol=1e-10, atol=1e-300)
    assert citests.pearsonr(x, y, z, gauss_df) == jax_ci.pearsonr(x, y, z, gauss_df)


@pytest.mark.parametrize("x, y, z", PILLAI_CASES)
def test_pillai_trace_matches_jax(mixed_df, x, y, z):
    got = citests.pillai_trace(x, y, z, mixed_df, boolean=False, **FACTORIES)
    want = jax_ci.pillai_trace(x, y, z, mixed_df, boolean=False, **FACTORIES)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-300)
    assert citests.pillai_trace(x, y, z, mixed_df, **FACTORIES) == \
        jax_ci.pillai_trace(x, y, z, mixed_df, **FACTORIES)


def test_pillai_trace_needs_a_frame():
    with pytest.raises(ValueError, match="pandas.DataFrame"):
        citests.pillai_trace("a", "b", [], np.zeros((3, 2)))


def test_independence_match():
    spec = (["A"], ["B"], ["C"])
    port, ref = Independencies(spec), JaxIndependencies(spec)
    for x, y, z in [("A", "B", ["C"]), ("A", "B", []), ("B", "A", ["C"])]:
        assert citests.independence_match(x, y, z, independencies=port) == \
            jax_ci.independence_match(x, y, z, independencies=ref)
    with pytest.raises(ValueError, match="independencies"):
        citests.independence_match("A", "B", [])


def test_get_callable_ci_test(gauss_df, mixed_df):
    discrete = _frame("plain").astype(int)
    assert citests.get_callable_ci_test(None, discrete) is citests.chi_square
    assert citests.get_callable_ci_test(None, gauss_df) is citests.pearsonr
    assert citests.get_callable_ci_test(None, mixed_df) is citests.pillai_trace
    for name in ("chi_square", "g_sq", "log_likelihood", "modified_log_likelihood", "pearsonr",
                 "gcm", "independence_match"):
        assert citests.get_callable_ci_test(name) is getattr(citests, name)
    assert citests.get_callable_ci_test("pillai") is citests.pillai_trace
    fn = lambda *a, **k: True  # noqa: E731
    assert citests.get_callable_ci_test(fn) is fn
    with pytest.raises(ValueError, match="Unknown ci_test"):
        citests.get_callable_ci_test("nope")
    with pytest.raises(ValueError, match="data is None"):
        citests.get_callable_ci_test(None)
    with pytest.raises(ValueError, match="string or callable"):
        citests.get_callable_ci_test(3)


def test_p_value_is_scipys_chi2_sf():
    """``_pd_result`` calls ``special.chdtrc``, the function ``chi2.sf``
    evaluates: equal to the bit, boundaries included."""
    from scipy import special, stats

    rng = np.random.default_rng(0)
    stats_ = np.concatenate([rng.random(500) * 100, [0.0, np.inf, np.nan, 1e-300, 1e5]])
    dofs = rng.integers(1, 200, len(stats_))
    got = np.array([special.chdtrc(d, x) for x, d in zip(stats_, dofs)])
    want = np.array([stats.chi2.sf(x, d) for x, d in zip(stats_, dofs)])
    np.testing.assert_array_equal(got, want)
