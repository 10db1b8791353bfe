"""The functional lane of the port against pgmpy_tpu on the CPU.

Distributions: every ``log_prob`` against the JAX package's at equal inputs
(rtol 1e-5, float32), Uniform's ``-inf`` outside its support and
Categorical's ``TINY`` clamp included; every ``sample`` by its first two
moments within 5 standard errors, and equal seeds give equal draws (the
gamma draws ride on the private ``torch._standard_gamma(..., generator=)``,
pinned here).  ``FunctionalCPD`` draws and scores all rows in one call on
the parent columns; the JAX package loops over rows, so draws are compared
by distribution and ``log_prob`` at rtol 1e-5.

``FunctionalBayesianNetwork``: the cases of ``tests/test_round4_parity.py``
and ``tests/test_longtail.py`` run against the port; the SVI fit matches
``pgmpy_tpu`` step for step over 50 steps at the default optimizer (both
record the parameters their loss sees); ``constraints.positive`` selects the
softplus parametrisation in the port and not in the JAX package; the MCMC
flattening follows ``jax.flatten_util.ravel_pytree``'s order;
``log_likelihood`` at parameters carried across with
``functional_params_from_numpy`` matches at rtol 1e-5.
"""

import math

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from torch.distributions import constraints

import _torch_parity  # noqa: F401  (puts the port on the CPU)
import pgmpy_tpu.factors.distributions as jd
import pgmpy_tpu_torch.factors.distributions as td
from pgmpy_tpu.factors import hybrid as jax_hybrid
from pgmpy_tpu.models import FunctionalBayesianNetwork as JaxFBN
from pgmpy_tpu_torch.config import TINY, as_tensor, config
from pgmpy_tpu_torch.factors import FunctionalCPD, clear_param_store, get_param_store, param
from pgmpy_tpu_torch.factors import hybrid
from pgmpy_tpu_torch.models import FunctionalBayesianNetwork
from pgmpy_tpu_torch.models.functional_bn import _ravel_pytree
from pgmpy_tpu_torch.utils.interop import functional_params_from_numpy
from pgmpy_tpu_torch.utils.mathext import seeded_generator

N_DRAWS = 20_000


@pytest.fixture(autouse=True)
def empty_stores():
    clear_param_store()
    jax_hybrid.clear_param_store()
    yield
    clear_param_store()
    jax_hybrid.clear_param_store()


# (name, parameters, support sampler for log_prob inputs, mean, variance)
CASES = [
    ("Normal", (1.5, 2.0), lambda r, n: r.normal(1.5, 2.0, n), 1.5, 4.0),
    ("LogNormal", (0.2, 0.5), lambda r, n: r.lognormal(0.2, 0.5, n),
     math.exp(0.2 + 0.125), (math.exp(0.25) - 1) * math.exp(0.4 + 0.25)),
    ("Exponential", (2.0,), lambda r, n: r.exponential(0.5, n), 0.5, 0.25),
    ("Gamma", (3.0, 2.0), lambda r, n: r.gamma(3.0, 0.5, n), 1.5, 0.75),
    ("Beta", (2.0, 5.0), lambda r, n: r.beta(2.0, 5.0, n), 2 / 7, 10 / (49 * 8)),
    ("Categorical", ([0.2, 0.5, 0.3],), lambda r, n: r.integers(0, 3, n), 1.1, 0.49),
    ("Uniform", (-1.0, 3.0), lambda r, n: r.uniform(-2.0, 4.0, n), 1.0, 16 / 12),
    ("HalfNormal", (2.0,), lambda r, n: np.abs(r.normal(0, 2.0, n)),
     2.0 * math.sqrt(2 / math.pi), 4.0 * (1 - 2 / math.pi)),
]


@pytest.mark.parametrize("name, args, support, mean, var", CASES, ids=[c[0] for c in CASES])
def test_log_prob_matches_jax(name, args, support, mean, var):
    x = support(np.random.default_rng(0), 257).astype(np.float32)
    want = np.asarray(getattr(jd, name)(*args).log_prob(jnp.asarray(x)))
    got = getattr(td, name)(*args).log_prob(as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if name == "Uniform":
        assert np.isneginf(got[(x < -1) | (x > 3)]).all() and (x < -1).any()


def test_log_prob_broadcasts_tensor_parameters_like_jax():
    rng = np.random.default_rng(1)
    loc, scale = rng.normal(size=64), rng.uniform(0.5, 2.0, 64)
    a, b = rng.uniform(1, 4, 64), rng.uniform(1, 4, 64)
    x, u = rng.normal(size=64), rng.uniform(0.01, 0.99, 64)
    pairs = [
        (jd.Normal(loc, scale).log_prob(x), td.Normal(loc, scale).log_prob(x)),
        (jd.Gamma(a, b).log_prob(u), td.Gamma(a, b).log_prob(u)),
        (jd.Beta(a, b).log_prob(u), td.Beta(a, b).log_prob(u)),
        (jd.LogNormal(loc, scale).log_prob(u), td.LogNormal(loc, scale).log_prob(u)),
    ]
    # Gamma's and Beta's log-densities sum lgamma terms of up to ~10 that
    # cancel to ~1, and torch's lgamma is not XLA's: allow 8 float32 ulps of
    # the largest term
    atol = 8 * np.finfo(np.float32).eps * 10
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=atol)


def test_categorical_clamps_at_tiny():
    probs = [0.2, 0.0, 0.8]
    x = np.array([0, 1, 2, 1])
    want = np.asarray(jd.Categorical(probs).log_prob(jnp.asarray(x)))
    got = td.Categorical(probs).log_prob(as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[1] == np.float32(math.log(np.float32(TINY)))
    draws = td.Categorical(probs).sample(seeded_generator(0), (N_DRAWS,))
    assert not (draws == 1).any()


@pytest.mark.parametrize("name, args, support, mean, var", CASES, ids=[c[0] for c in CASES])
def test_sample_moments_and_seeds(name, args, support, mean, var):
    dist = getattr(td, name)(*args)
    draws = dist.sample(seeded_generator(3), (N_DRAWS,)).double().numpy()
    assert draws.shape == (N_DRAWS,)
    se_mean = math.sqrt(var / N_DRAWS)
    assert abs(draws.mean() - mean) < 5 * se_mean
    centred = draws - draws.mean()
    se_var = math.sqrt((np.mean(centred**4) - np.var(draws) ** 2) / N_DRAWS)
    assert abs(np.var(draws) - var) < 5 * se_var
    again = dist.sample(seeded_generator(3), (N_DRAWS,))
    assert torch.equal(again, dist.sample(seeded_generator(3), (N_DRAWS,)))
    assert not torch.equal(again, dist.sample(seeded_generator(4), (N_DRAWS,)))


def test_standard_gamma_takes_the_generator():
    """``torch._standard_gamma`` is private: pin that it draws from the
    generator it is given (equal seeds, equal draws; the global stream is
    left alone)."""
    conc = torch.full((1000,), 2.5, dtype=config.DTYPE)
    state = torch.random.get_rng_state()
    a = torch._standard_gamma(conc, generator=torch.Generator().manual_seed(11))
    b = torch._standard_gamma(conc, generator=torch.Generator().manual_seed(11))
    assert torch.equal(a, b)
    assert torch.equal(state, torch.random.get_rng_state())


def two_node_frame(n=400, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.5, 1.0, n)
    return pd.DataFrame({"x": x, "y": rng.normal(2.0 * x + 1.0, 0.5)})


def test_functional_cpd_sample_matches_jax_by_distribution():
    frame = two_node_frame()
    jax_cpd = jax_hybrid.FunctionalCPD(
        "y", lambda p: jd.Normal(2.0 * p["x"] + 1.0, 0.5), parents=["x"])
    port_cpd = FunctionalCPD("y", lambda p: td.Normal(2.0 * p["x"] + 1.0, 0.5), parents=["x"])
    n = len(frame)
    residuals = []
    for cpd in (jax_cpd, port_cpd):
        draws = cpd.sample(n, parent_sample=frame[["x"]], seed=7)
        assert draws.shape == (n,)
        residuals.append(draws - 2.0 * frame["x"].to_numpy() - 1.0)
    for r in residuals:
        assert abs(r.mean()) < 5 * 0.5 / math.sqrt(n)
        assert abs(r.std() - 0.5) < 5 * 0.5 / math.sqrt(2 * n)
    assert abs(residuals[0].mean() - residuals[1].mean()) < 5 * 0.5 * math.sqrt(2 / n)
    assert np.array_equal(port_cpd.sample(n, parent_sample=frame[["x"]], seed=7),
                          port_cpd.sample(n, parent_sample=frame[["x"]], seed=7))
    root = FunctionalCPD("x", lambda p: td.Normal(0.0, 1.0))
    assert root.sample(1000, seed=1).shape == (1000,)
    with pytest.raises(ValueError, match="parent_sample must be provided"):
        port_cpd.sample(5)
    with pytest.raises(ValueError, match="n_samples rows"):
        port_cpd.sample(5, parent_sample=frame[["x"]])


def test_functional_cpd_log_prob_matches_jax_loop():
    frame = two_node_frame(n=200)
    values, parents = frame["y"].to_numpy(), {"x": frame["x"].to_numpy()}
    want = jax_hybrid.FunctionalCPD(
        "y", lambda p: jd.Normal(2.0 * p["x"] + 1.0, 0.5), parents=["x"]).log_prob(values, parents)
    got = FunctionalCPD(
        "y", lambda p: td.Normal(2.0 * p["x"] + 1.0, 0.5), parents=["x"]).log_prob(values, parents)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    want_root = jax_hybrid.FunctionalCPD("x", lambda p: jd.Normal(0.5, 1.0)).log_prob(parents["x"])
    got_root = FunctionalCPD("x", lambda p: td.Normal(0.5, 1.0)).log_prob(parents["x"])
    np.testing.assert_allclose(got_root, want_root, rtol=1e-5)
    with pytest.raises(ValueError, match="callable"):
        FunctionalCPD("x", 3)


def test_param_store_modes():
    st = hybrid._PARAM_STORE
    assert isinstance(param("a", 1.5), torch.Tensor) and float(param("a", 1.5)) == 1.5
    with pytest.raises(KeyError, match="no stored value"):
        param("b")
    st.mode = "collect"
    try:
        got = param("c", [1.0, 2.0], constraint="positive")
        assert got.device == config.DEVICE and got.dtype == config.DTYPE
        assert param("c", [9.0, 9.0]) is got  # the first init wins
        with pytest.raises(ValueError, match="needs an init"):
            param("d")
    finally:
        st.mode = None
    assert st.constraints["c"] == "positive"
    leaf = torch.zeros(2, requires_grad=True)
    st.mode, st.values = "apply", {"c": leaf * 2}
    try:
        assert param("c", 5.0).requires_grad
    finally:
        st.mode, st.values = None, {}
    st.values["c"] = torch.tensor([3.0, 4.0])
    assert param("c", 0.0).tolist() == [3.0, 4.0]
    assert set(get_param_store()) == {"c"}
    clear_param_store()
    assert get_param_store() == {} and st.inits == {}


def svi_cpds(pkg, positive="positive"):
    dist, cpd_cls, par = (jd, jax_hybrid.FunctionalCPD, jax_hybrid.param) if pkg == "jax" else (
        td, FunctionalCPD, param)
    return [
        cpd_cls("x1", lambda p: dist.Normal(par("x1_mu", 1.0),
                                            par("x1_sigma", 1.0, constraint=positive))),
        cpd_cls("x2", lambda p: dist.Normal(par("x2_inter", 1.0) + p["x1"],
                                            par("x2_sigma", 1.0, constraint=positive)),
                parents=["x1"]),
    ]


def svi_model(pkg="port", positive="positive"):
    model = (JaxFBN if pkg == "jax" else FunctionalBayesianNetwork)([("x1", "x2")])
    model.add_cpds(*svi_cpds(pkg, positive))
    return model


def svi_frame(n=5000):
    rng = np.random.default_rng(0)
    x1 = rng.normal(0.2, 0.8, size=n)
    return pd.DataFrame({"x1": x1, "x2": rng.normal(0.6 + x1, 1.0)})


def test_svi_recovers_parameters():
    params = svi_model().fit(svi_frame(), estimator="SVI", num_steps=400)
    assert float(params["x1_mu"]) == pytest.approx(0.2, abs=0.05)
    assert float(params["x1_sigma"]) == pytest.approx(0.8, abs=0.05)
    assert float(params["x2_inter"]) == pytest.approx(0.6, abs=0.05)
    assert float(params["x2_sigma"]) == pytest.approx(1.0, abs=0.05)
    df = svi_model().simulate(n_samples=4000, seed=1)  # the store holds the fit
    assert df["x1"].mean() == pytest.approx(0.2, abs=0.07)
    assert set(get_param_store()) == set(params)


def test_svi_input_validation():
    model = svi_model()
    data = pd.DataFrame({"x1": [0.0], "x2": [0.0]})
    with pytest.raises(ValueError, match="estimator"):
        model.fit(data, estimator="nope")
    with pytest.raises(ValueError, match="num_steps"):
        model.fit(data, num_steps=2.5)
    with pytest.raises(ValueError, match="pandas"):
        model.fit([[1, 2]])
    with pytest.raises(ValueError, match="column for the node"):
        model.fit(data[["x1"]])
    with pytest.raises(ValueError, match="optimizer"):
        model.fit(data, optimizer=3, num_steps=1)
    bare = FunctionalBayesianNetwork([("x1", "x2")])
    bare.add_cpds(FunctionalCPD("x1", lambda p: td.Normal(0.0, 1.0)),
                  FunctionalCPD("x2", lambda p: td.Normal(p["x1"], 1.0), parents=["x1"]))
    with pytest.raises(ValueError, match="No learnable parameters"):
        bare.fit(data, num_steps=1)


def recorded_svi(pkg, frame, steps, positive="positive"):
    """The parameters each step's loss saw, (steps, 4), and the fit."""
    names = ["x1_mu", "x1_sigma", "x2_inter", "x2_sigma"]
    seen = []
    model = svi_model(pkg, positive)
    if pkg == "jax":
        store = jax_hybrid._PARAM_STORE

        def record(*values):
            seen.append([float(v) for v in values])

        for cpd in model.get_cpds():
            fn = cpd.fn

            def watched(p, fn=fn):
                if store.mode == "apply":
                    jax.debug.callback(record, *[store.values[n] for n in names], ordered=True)
                return fn(p)

            cpd.fn = watched
    else:
        store = hybrid._PARAM_STORE
        for cpd in model.get_cpds():
            fn = cpd.fn

            def watched(p, fn=fn):
                if store.mode == "apply":
                    seen.append([float(store.values[n].detach()) for n in names])
                return fn(p)

            cpd.fn = watched
    fitted = model.fit(frame, estimator="SVI", num_steps=steps)
    # each step calls both CPD functions: keep one record per step
    return np.asarray(seen[::2]), {n: float(fitted[n]) for n in names}


def test_svi_matches_jax_step_for_step():
    frame = svi_frame()
    port_seen, port_fit = recorded_svi("port", frame, 50)
    jax_seen, jax_fit = recorded_svi("jax", frame, 50)
    assert port_seen.shape == jax_seen.shape == (50, 4)
    np.testing.assert_allclose(port_seen, jax_seen, rtol=1e-4)
    np.testing.assert_allclose(list(port_fit.values()), list(jax_fit.values()), rtol=1e-4)


def test_svi_with_a_torch_optimizer():
    frame = svi_frame(1000)
    adam = svi_model().fit(frame, num_steps=20, optimizer={"lr": 0.05})
    clear_param_store()
    same = svi_model().fit(frame, num_steps=20,
                           optimizer=lambda p: torch.optim.Adam(p, lr=0.05, eps=1e-8))
    for n in adam:
        assert torch.equal(adam[n], same[n])
    clear_param_store()
    sgd = svi_model().fit(frame, num_steps=5,
                          optimizer=lambda p: torch.optim.SGD(p, lr=1e-5))
    assert all(torch.isfinite(v).all() for v in sgd.values())


def test_positive_constraint_object_selects_softplus():
    """``constraints.positive`` names no "positive" in its string form
    (``GreaterThan(lower_bound=0.0)``): the JAX package optimises such a
    scale unconstrained, equal to its fit with no constraint; the port
    treats it as ``"positive"``."""
    assert str(constraints.positive) == "GreaterThan(lower_bound=0.0)"
    frame = svi_frame(1000)
    steps = 30
    _, jax_object = recorded_svi("jax", frame, steps, positive=constraints.positive)
    jax_hybrid.clear_param_store()
    _, jax_none = recorded_svi("jax", frame, steps, positive=None)
    jax_hybrid.clear_param_store()
    _, jax_string = recorded_svi("jax", frame, steps, positive="positive")
    assert jax_object == jax_none
    assert jax_object != jax_string
    _, port_object = recorded_svi("port", frame, steps, positive=constraints.positive)
    clear_param_store()
    _, port_greater = recorded_svi("port", frame, steps, positive=constraints.greater_than(0.0))
    clear_param_store()
    _, port_string = recorded_svi("port", frame, steps, positive="positive")
    assert port_object == port_greater == port_string
    np.testing.assert_allclose(list(port_string.values()), list(jax_string.values()), rtol=1e-4)
    assert not FunctionalBayesianNetwork._is_positive_constraint(constraints.greater_than(1.0))
    assert not FunctionalBayesianNetwork._is_positive_constraint(None)


def test_mcmc_posterior_matches_conjugate():
    rng = np.random.default_rng(0)
    xs = rng.normal(1.5, 1.0, size=100)
    model = FunctionalBayesianNetwork()
    model.add_node("x")
    model.add_cpds(FunctionalCPD(
        "x", lambda priors, parents=None: td.Normal(priors["mu"], priors["sigma"])))
    post = model.fit(
        pd.DataFrame({"x": xs}), estimator="MCMC",
        prior_fn=lambda: {"mu": td.Normal(0.0, 1.0), "sigma": td.HalfNormal(5.0)},
        num_steps=400, seed=0,
    )
    n, xbar = len(xs), xs.mean()
    assert post["mu"].shape == post["sigma"].shape == (400,)
    assert post["mu"].mean() == pytest.approx(n * xbar / (n + 1), abs=0.15)
    assert post["sigma"].mean() == pytest.approx(xs.std(), abs=0.15)
    assert (post["sigma"] > 0).all()
    with pytest.raises(ValueError, match="prior_fn"):
        model.fit(pd.DataFrame({"x": xs}), estimator="MCMC", num_steps=5)


def test_mcmc_interval_support():
    rng = np.random.default_rng(2)
    ys = (rng.random(200) < 0.3).astype(float)
    model = FunctionalBayesianNetwork()
    model.add_node("y")
    model.add_cpds(FunctionalCPD(
        "y", lambda priors, parents=None: td.Categorical(
            torch.stack([1 - priors["p"], priors["p"]]))))
    post = model.fit(pd.DataFrame({"y": ys}), estimator="MCMC",
                     prior_fn=lambda: {"p": td.Beta(1.0, 1.0)}, num_steps=200, seed=1,
                     mcmc_kwargs={"warmup_steps": 100})
    # Beta(1 + k, 1 + n - k) posterior
    k, n = ys.sum(), len(ys)
    assert ((post["p"] > 0) & (post["p"] < 1)).all()
    assert post["p"].mean() == pytest.approx((1 + k) / (2 + n), abs=0.05)


def test_simulate_do_and_virtual():
    model = FunctionalBayesianNetwork([("x", "y")])
    model.add_cpds(
        FunctionalCPD("x", lambda p: td.Normal(0.0, 1.0)),
        FunctionalCPD("y", lambda p: td.Normal(p["x"] + 1.0, 0.5), parents=["x"]),
    )
    df = model.simulate(n_samples=2000, do={"x": 5.0}, seed=0)
    assert (df["x"] == 5.0).all()
    assert df["y"].mean() == pytest.approx(6.0, abs=0.1)
    df2 = model.simulate(
        n_samples=2000, virtual_intervention=[FunctionalCPD("x", lambda p: td.Normal(10.0, 0.1))],
        seed=1)
    assert df2["x"].mean() == pytest.approx(10.0, abs=0.05)
    assert model.simulate(50, seed=3).equals(model.simulate(50, seed=3))
    with pytest.raises(ValueError, match="unconditional"):
        model.simulate(n_samples=5, virtual_intervention=[
            FunctionalCPD("y", lambda p: td.Normal(p["x"], 1), parents=["x"])])
    with pytest.raises(ValueError, match="same node"):
        model.simulate(n_samples=5, do={"x": 1.0},
                       virtual_intervention=[FunctionalCPD("x", lambda p: td.Normal(0, 1))])
    with pytest.raises(ValueError, match="not in the model"):
        model.simulate(n_samples=5, do={"z": 1.0})
    with pytest.raises(ValueError, match="list of FunctionalCPD"):
        model.simulate(n_samples=5, virtual_intervention=[3])


def test_simulate_and_loglik():
    fbn = FunctionalBayesianNetwork([("x", "y"), ("c", "y")])
    fbn.add_cpds(
        FunctionalCPD("x", lambda p: td.Normal(0.0, 1.0)),
        FunctionalCPD("c", lambda p: td.Categorical([0.3, 0.7])),
        FunctionalCPD("y", lambda p: td.Normal(2.0 * p["x"] + p["c"], 0.5), parents=["x", "c"]),
    )
    df = fbn.simulate(n_samples=2000, seed=0)
    assert df.shape == (2000, 3) and df["c"].dtype == np.int64
    slope = np.polyfit(df["x"], df["y"] - df["c"], 1)[0]
    assert slope == pytest.approx(2.0, abs=0.1)
    assert df["c"].mean() == pytest.approx(0.7, abs=5 * math.sqrt(0.21 / 2000))
    assert np.isfinite(fbn.log_likelihood(df.iloc[:50]))


def test_point_fit():
    rng = np.random.default_rng(0)
    n = 3000
    x = rng.normal(size=n)
    data = pd.DataFrame({"x": x, "y": 1.7 * x + rng.normal(size=n) * 0.5})
    fbn = FunctionalBayesianNetwork([("x", "y")])

    def make_cpds(params):
        return {
            "x": lambda pv: td.Normal(params["mu_x"], torch.exp(params["log_sx"])),
            "y": lambda pv: td.Normal(params["slope"] * pv["x"], torch.exp(params["log_sy"])),
        }

    params = fbn.fit(data, make_cpds,
                     init_params={"mu_x": 0.0, "log_sx": 0.0, "slope": 0.0, "log_sy": 0.0},
                     max_iter=1500)
    assert float(params["slope"]) == pytest.approx(1.7, abs=0.05)
    assert float(torch.exp(params["log_sy"])) == pytest.approx(0.5, abs=0.05)
    # the fitted functions are the model's CPDs now
    assert np.isfinite(fbn.log_likelihood(data.iloc[:100]))


def test_ravel_order_matches_jax():
    tree = {"zeta": np.array([[1.0, 2.0], [3.0, 4.0]]), "alpha": [5.0, np.array([6.0, 7.0])],
            "mid": {"b": 8.0, "a": np.array([9.0])}}
    want, jax_unravel = jax.flatten_util.ravel_pytree(tree)
    got, unravel = _ravel_pytree(tree)
    np.testing.assert_array_equal(got, np.asarray(want, dtype=np.float64))
    back = unravel(np.arange(got.size, dtype=np.float64))
    jax_back = jax_unravel(jnp.arange(got.size, dtype=jnp.float32))
    assert list(back) == list(jax_back) == ["alpha", "mid", "zeta"]
    for port_leaf, jax_leaf in zip(jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(lambda t: np.asarray(t), back,
                                   is_leaf=lambda t: isinstance(t, torch.Tensor))),
            jax.tree_util.tree_leaves(jax_back)):
        np.testing.assert_array_equal(port_leaf, np.asarray(jax_leaf))


def test_fit_mcmc_columns_follow_the_flattening():
    rng = np.random.default_rng(4)
    data = pd.DataFrame({"x": rng.normal(2.0, 0.5, 300)})
    fbn = FunctionalBayesianNetwork()
    fbn.add_node("x")

    def make_cpds(params):
        return {"x": lambda pv: td.Normal(params["z_mu"], torch.exp(params["a_logs"][0]))}

    samples, unravel = fbn.fit_mcmc(data, make_cpds,
                                    init_params={"z_mu": 0.0, "a_logs": [0.0]},
                                    num_samples=150, num_adapt=100, seed=0)
    assert samples.shape == (150, 2)
    # column 0 is a_logs (sorted first), column 1 z_mu
    assert samples[:, 1].mean() == pytest.approx(2.0, abs=0.1)
    assert np.exp(samples[:, 0]).mean() == pytest.approx(0.5, abs=0.1)
    tree = unravel(samples[-1])
    assert float(tree["z_mu"]) == pytest.approx(samples[-1, 1], rel=1e-6)


def test_log_likelihood_at_jax_parameters():
    frame = svi_frame(2000)
    jax_model = svi_model("jax")
    fitted = jax_model.fit(frame, estimator="SVI", num_steps=60)
    params = {k: np.asarray(v) for k, v in fitted.items()}
    port_model = svi_model()
    tensors = functional_params_from_numpy(params)
    assert set(get_param_store()) == set(params)
    assert all(t.dtype == config.DTYPE and t.device == config.DEVICE for t in tensors.values())
    np.testing.assert_allclose(port_model.log_likelihood(frame), jax_model.log_likelihood(frame),
                               rtol=1e-5)
    for node in ("x1", "x2"):
        parents = {p: frame[p].to_numpy() for p in port_model.get_cpds(node).parents}
        np.testing.assert_allclose(
            port_model.get_cpds(node).log_prob(frame[node].to_numpy(), parents),
            jax_model.get_cpds(node).log_prob(frame[node].to_numpy(), parents), rtol=1e-5)


def test_copy():
    model = svi_model()
    model.latents = {"x1"}
    other = model.copy()
    assert isinstance(other, FunctionalBayesianNetwork)
    assert set(other.edges()) == set(model.edges()) and other.latents == {"x1"}
    assert [c.fn for c in other.get_cpds()] == [c.fn for c in model.get_cpds()]
    assert other.get_cpds("x1") is not model.get_cpds("x1")
    with pytest.raises(ValueError, match="Only FunctionalCPD"):
        other.add_cpds("x1")
    other.remove_cpds("x1")
    with pytest.raises(ValueError, match="No CPD"):
        other.check_model()
    assert model.check_model()
