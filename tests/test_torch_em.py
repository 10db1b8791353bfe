"""ExpectationMaximization of the port against pgmpy_tpu and a numpy oracle.

The same frames (the shared numpy ancestral sampler) and the same initial
CPDs go through both packages.  The E-step's weights are held to a numpy
float64 oracle, missing codes included; whole fits to the JAX package's on the
v4 golden's configuration and on ALARM with a root latent; and the options
(smoothing, uniform init, missing data without a latent, the E-step's chunks)
to their definitions."""

import numpy as np
import pandas as pd
import pytest

from pgmpy_tpu.estimators import ExpectationMaximization as JaxEM
from pgmpy_tpu.factors import TabularCPD as JaxCPD
from pgmpy_tpu.models import DiscreteBayesianNetwork as JaxBN
from pgmpy_tpu.utils import get_example_model as jax_example

from _golden_data import em_init_values, standalone_sample
from _torch_parity import np_values
from pgmpy_tpu_torch.config import TINY
from pgmpy_tpu_torch.estimators import ExpectationMaximization
from pgmpy_tpu_torch.estimators import em as em_module
from pgmpy_tpu_torch.factors import TabularCPD
from pgmpy_tpu_torch.models import DiscreteBayesianNetwork

V4_EM = {"network": "cancer", "latent": "Smoker", "n_rows": 1500, "data_seed": 2029,
         "init_seed": 77, "max_iter": 8}


def by_variable(cpds):
    return {str(c.variable): c for c in cpds}


def assert_cpds_close(port_cpds, jax_cpds, atol):
    port, ref = by_variable(port_cpds), by_variable(jax_cpds)
    assert sorted(port) == sorted(ref)
    for var, cpd in ref.items():
        assert port[var].variables == cpd.variables, var
        assert port[var].state_names == cpd.state_names, var
        np.testing.assert_allclose(np_values(port[var].get_values()),
                                   np_values(cpd.get_values()), atol=atol, err_msg=var)


def fixed_init(cls, model, latent, seed):
    """The v4 golden's initial CPDs (``em_init_values``) in ``cls``."""
    spec = []
    for var in sorted(model.nodes(), key=str):
        parents = sorted(model.get_parents(var), key=str)
        spec.append((var, 2, [(p, 2) for p in parents]))
    values = em_init_values(spec, seed=seed)
    return {
        var: cls(
            var, card, values[var],
            evidence=[p for p, _ in parents] or None,
            evidence_card=[pc for _, pc in parents] or None,
            state_names={
                v: sorted(model.get_cpds(v).state_names[v], key=str) if v != latent else [0, 1]
                for v in [var] + [p for p, _ in parents]
            },
        )
        for var, card, parents in spec
    }


@pytest.fixture(scope="module")
def cancer():
    model = jax_example(V4_EM["network"])
    frame = standalone_sample(model, V4_EM["n_rows"], seed=V4_EM["data_seed"])
    return model, frame.drop(columns=[V4_EM["latent"]])


def test_v4_configuration_matches_jax(cancer, monkeypatch):
    model, frame = cancer
    launches = []
    count_specs = em_module._CodedData._count_specs

    def counted(coded, *args, **kwargs):
        launches.append(coded.n)
        return count_specs(coded, *args, **kwargs)

    monkeypatch.setattr(em_module._CodedData, "_count_specs", counted)
    latent, edges = V4_EM["latent"], list(model.edges())
    kwargs = dict(latent_card={latent: 2}, max_iter=V4_EM["max_iter"], atol=1e-12, seed=0,
                  show_progress=False)
    ref = JaxEM(JaxBN(edges, latents={latent}), frame).get_parameters(
        init_cpds=fixed_init(JaxCPD, model, latent, V4_EM["init_seed"]), **kwargs)
    port = ExpectationMaximization(DiscreteBayesianNetwork(edges, latents={latent}), frame)
    got = port.get_parameters(
        init_cpds=fixed_init(TabularCPD, model, latent, V4_EM["init_seed"]), **kwargs)
    assert_cpds_close(got, ref, atol=1e-5)
    # one weighted count launch per iteration, over the expanded rows
    assert launches == [2 * len(frame)] * V4_EM["max_iter"]


def test_alarm_root_latent_seeded_random_init_matches_jax():
    model = jax_example("alarm")
    latent, edges = "LVFAILURE", list(model.edges())
    frame = standalone_sample(model, 2000, seed=7).drop(columns=[latent])
    kwargs = dict(latent_card={latent: 2}, max_iter=6, seed=3, init_cpds="random",
                  show_progress=False)
    ref = JaxEM(JaxBN(edges, latents={latent}), frame).get_parameters(**kwargs)
    got = ExpectationMaximization(DiscreteBayesianNetwork(edges, latents={latent}),
                                  frame).get_parameters(**kwargs)
    assert_cpds_close(got, ref, atol=1e-4)


def test_seeded_random_init_draws_the_jax_packages_cpds(cancer):
    """``init_cpds="random"`` draws each node's CPD from a seed taken from
    one ``default_rng(seed)`` stream, nodes in sorted order, as the JAX
    package does: the same seed gives the same starting tables."""
    model, frame = cancer
    latent = V4_EM["latent"]
    port = ExpectationMaximization(
        DiscreteBayesianNetwork(list(model.edges()), latents={latent}), frame)
    _, cards, names = port._program({latent: 3})
    drawn = port._initial_cpds("random", 11, cards, names)
    rng = np.random.default_rng(11)
    for var in sorted(model.nodes(), key=str):
        parents = sorted(model.get_parents(var), key=str)
        want = JaxCPD.get_random(
            var, evidence=parents or None, cardinality={v: cards[v] for v in [var] + parents},
            state_names={v: names[v] for v in [var] + parents}, seed=int(rng.integers(2**31)))
        np.testing.assert_allclose(np_values(drawn[var].get_values()),
                                   np_values(want.get_values()), atol=0, rtol=0)


def e_step_oracle(cpds, frame, latent, latent_card, var_order):
    """Posterior weights of the latent's states per row, numpy float64, a
    node's term left out where its code or a parent's code is missing."""
    names = {v: list(cpds[v].state_names[v]) for v in var_order}
    n = frame.shape[0]
    lp = np.zeros((n, latent_card))
    for k in range(latent_card):
        for v in var_order:
            cpd = cpds[v]
            table = np_values(cpd.values)  # (card, *parent cards)
            scope = list(cpd.variables)
            codes, valid = [], np.ones(n, dtype=bool)
            for u in scope:
                if u == latent:
                    codes.append(np.full(n, k))
                else:
                    c = frame[u].map({s: i for i, s in enumerate(names[u])}).to_numpy()
                    valid &= ~np.isnan(c.astype(float))
                    codes.append(np.where(np.isnan(c.astype(float)), 0, c).astype(int))
            term = np.log(np.maximum(table[tuple(codes)], TINY))
            lp[:, k] += np.where(valid, term, 0.0)
    lp -= lp.max(axis=1, keepdims=True)
    w = np.exp(lp)
    return w / w.sum(axis=1, keepdims=True)


def test_e_step_weights_against_numpy_with_missing_codes(cancer):
    model, frame = cancer
    frame = frame.copy().astype(object)
    rng = np.random.default_rng(5)
    for col in frame.columns:
        frame.loc[rng.random(len(frame)) < 0.1, col] = np.nan
    latent, edges = V4_EM["latent"], list(model.edges())
    est = ExpectationMaximization(DiscreteBayesianNetwork(edges, latents={latent}), frame)
    program, cards, names = est._program({latent: 3})
    init = est._initial_cpds("random", 4, cards, names)
    weights = np_values(program.e_step(program.flat_of(init))).reshape(-1, 3)
    want = e_step_oracle(init, frame, latent, 3, program.var_order)
    np.testing.assert_allclose(weights, want, atol=1e-6)


def jax_and_port(frame, edges, latents, **kwargs):
    ref = JaxEM(JaxBN(edges, latents=set(latents)), frame).get_parameters(**kwargs)
    got = ExpectationMaximization(DiscreteBayesianNetwork(edges, latents=set(latents)),
                                  frame).get_parameters(**kwargs)
    return got, ref


@pytest.mark.parametrize("option", ["smoothing", "uniform"])
def test_options_match_jax(cancer, option):
    model, frame = cancer
    kwargs = dict(latent_card={"Smoker": 2}, max_iter=5, seed=1, show_progress=False)
    if option == "smoothing":
        kwargs.update(apply_smoothing=True, init_cpds="random")
    else:
        kwargs.update(init_cpds="uniform")
    got, ref = jax_and_port(frame, list(model.edges()), ["Smoker"], **kwargs)
    assert_cpds_close(got, ref, atol=1e-5)


def test_missing_data_without_a_latent_matches_jax():
    model = jax_example("asia")
    frame = standalone_sample(model, 1200, seed=2).astype(object)
    rng = np.random.default_rng(8)
    for col in ("smoke", "lung", "xray"):
        frame.loc[rng.random(len(frame)) < 0.2, col] = np.nan
    got, ref = jax_and_port(frame, list(model.edges()), [], max_iter=4, seed=0,
                            show_progress=False)
    assert_cpds_close(got, ref, atol=1e-5)


def test_batch_size_leaves_the_result_unchanged(cancer, monkeypatch):
    model, frame = cancer
    kwargs = dict(latent_card={"Smoker": 2}, max_iter=4, seed=6, init_cpds="random",
                  show_progress=False)

    def fit(batch_size):
        est = ExpectationMaximization(
            DiscreteBayesianNetwork(list(model.edges()), latents={"Smoker"}), frame)
        cpds = est.get_parameters(batch_size=batch_size, **kwargs)
        return cpds, est._program({"Smoker": 2}, batch_size)[0].chunk_rows

    whole, rows = fit(1000)
    assert rows >= len(frame)  # one chunk: the expanded rows fit the budget
    monkeypatch.setattr(em_module, "_budget_bytes", lambda device: 1)
    for batch_size in (1, 7, 1000):
        chunked, rows = fit(batch_size)
        assert rows == batch_size
        for a, b in zip(whole, chunked):
            np.testing.assert_allclose(np_values(a.get_values()), np_values(b.get_values()),
                                       atol=1e-6)


def test_user_cpds_with_other_evidence_order_are_aligned():
    """An initial CPD whose evidence is not in sorted order is read by name
    (the JAX package reads its columns as if sorted)."""
    model = DiscreteBayesianNetwork([("a", "c"), ("b", "c")], latents={"b"})
    rng = np.random.default_rng(0)
    frame = pd.DataFrame({"a": rng.integers(0, 2, 400), "c": rng.integers(0, 2, 400)})
    sorted_cpd = TabularCPD.get_random("c", evidence=["a", "b"], seed=1,
                                       state_names={"c": [0, 1], "a": [0, 1], "b": [0, 1]})
    values = np_values(sorted_cpd.values).transpose(0, 2, 1).reshape(2, 4)
    swapped = TabularCPD("c", 2, values, evidence=["b", "a"], evidence_card=[2, 2],
                         state_names={"c": [0, 1], "a": [0, 1], "b": [0, 1]})
    fits = [
        ExpectationMaximization(model, frame).get_parameters(
            init_cpds={"c": cpd}, max_iter=3, seed=2, show_progress=False)
        for cpd in (sorted_cpd, swapped)
    ]
    for a, b in zip(*fits):
        np.testing.assert_allclose(np_values(a.get_values()), np_values(b.get_values()),
                                   atol=1e-6)
