"""The ancestral sampler, ``simulate`` and ApproxInference of the port.

The two packages draw from different random streams, so samples are compared
by distribution: frequencies lie within five standard errors (plus 1e-4) of
the exact VariableElimination answer.  Where nothing is random (0/1 CPDs with
the roots clamped or observed) the codes are EQUAL in both packages and the
likelihood weights agree at 1e-5."""

import numpy as np
import pandas as pd
import pytest
import torch

from pgmpy_tpu.sampling import BayesianModelSampling as JaxSampling
from pgmpy_tpu.sampling.core import CompiledAncestralSampler as JaxSampler

from _torch_parity import np_values, random_bn_pair
from pgmpy_tpu_torch.config import config
from pgmpy_tpu_torch.factors import State, TabularCPD
from pgmpy_tpu_torch.inference import ApproxInference, VariableElimination
from pgmpy_tpu_torch.models import DiscreteBayesianNetwork
from pgmpy_tpu_torch.sampling import (BayesianModelInference, BayesianModelSampling,
                                      CompiledAncestralSampler)
from pgmpy_tpu_torch.sampling.core import onehot_table_rows
from pgmpy_tpu_torch.utils import mathext

N = 20_000
SEEDS = [0, 1, 2]


@pytest.fixture(scope="module")
def pairs():
    return {seed: random_bn_pair(40 + seed, n_nodes=6 + 2 * seed) for seed in SEEDS}


def _within_mc_error(freq, p, n):
    return np.abs(freq - p) <= 5 * np.sqrt(p * (1 - p) / n) + 1e-4


def _frequencies(df, var, states, weights=None):
    codes = pd.Categorical(df[var], categories=states).codes
    assert (codes >= 0).all()
    weights = np.ones(len(df)) if weights is None else weights
    return np.bincount(codes, weights=weights, minlength=len(states)) / weights.sum()


def _assert_marginals(df, model, evidence=None, n=None, weights=None):
    ve = VariableElimination(model)
    n = len(df) if n is None else n
    for var in model.nodes():
        if evidence and var in evidence:
            assert (df[var] == evidence[var]).all()
            continue
        p = np_values(ve.query([var], evidence=evidence).values)
        freq = _frequencies(df, var, model.states[var], weights)
        assert _within_mc_error(freq, p, n).all(), (var, freq, p)


# ---------------------------------------------------------------------- #
# nothing random: equal codes in both packages
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", SEEDS)
def test_deterministic_network_gives_equal_codes(seed):
    port, ref = random_bn_pair(60 + seed, n_nodes=8, deterministic=True)
    got_sampler, want_sampler = CompiledAncestralSampler(port), JaxSampler(ref)
    assert got_sampler.variables == want_sampler.variables
    roots = [v for v in got_sampler.variables if not port.get_parents(v)]
    rng = np.random.default_rng(seed)
    clamp = {v: int(rng.integers(0, len(port.states[v]))) for v in roots}
    got = got_sampler.forward(64, seed=seed, clamp=clamp)
    want = np.asarray(want_sampler.forward(64, seed=seed + 5, clamp=clamp))
    assert got.dtype == torch.int8 and want.dtype == np.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got == got[0]).all()  # one deterministic row, repeated

    # per-row partial samples on the roots, no clamp
    partial = np.full((32, len(got_sampler.variables)), -1, dtype=np.int32)
    for v in roots:
        partial[:, got_sampler.var_index[v]] = rng.integers(0, len(port.states[v]), 32)
    got = got_sampler.forward(32, seed=1, partial=partial)
    want = np.asarray(want_sampler.forward(32, seed=2, partial=partial))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_deterministic_network_gives_equal_likelihood_weights(seed):
    port, ref = random_bn_pair(60 + seed, n_nodes=8, deterministic=True)
    got_sampler, want_sampler = CompiledAncestralSampler(port), JaxSampler(ref)
    rng = np.random.default_rng(seed)
    roots = [v for v in got_sampler.variables if not port.get_parents(v)]
    evidence = {v: int(rng.integers(0, len(port.states[v]))) for v in roots}
    # evidence on two inner nodes too: their weight is log 1 or the log clamp
    for v in [u for u in got_sampler.variables if u not in roots][:2]:
        evidence[v] = int(rng.integers(0, len(port.states[v])))
    got_codes, got_logw = got_sampler.likelihood_weighted(16, evidence, seed=seed)
    want_codes, want_logw = want_sampler.likelihood_weighted(16, evidence, seed=seed + 9)
    np.testing.assert_array_equal(got_codes.numpy(), np.asarray(want_codes))
    np.testing.assert_allclose(np_values(got_logw), np_values(want_logw), rtol=1e-5, atol=1e-5)
    assert got_logw.dtype == config.DTYPE


# ---------------------------------------------------------------------- #
# by distribution
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", SEEDS)
def test_simulate_marginals_match_exact_answers(pairs, seed):
    port, _ = pairs[seed]
    df = port.simulate(N, seed=seed, show_progress=False)
    assert df.shape == (N, len(port.nodes()))
    assert all(isinstance(df[c].dtype, pd.CategoricalDtype) for c in df.columns)
    assert list(df[sorted(port.nodes())[0]].cat.categories) == port.states[sorted(port.nodes())[0]]
    _assert_marginals(df, port)


def test_pairwise_frequencies_match_exact_joint(pairs):
    port, _ = pairs[1]
    df = port.simulate(N, seed=3, show_progress=False)
    child = next(v for v in sorted(port.nodes()) if port.get_parents(v))
    parent = port.get_parents(child)[0]
    joint = np_values(VariableElimination(port).query([parent, child]).values)
    counts = pd.crosstab(
        pd.Categorical(df[parent], categories=port.states[parent]),
        pd.Categorical(df[child], categories=port.states[child]), dropna=False).to_numpy() / N
    assert _within_mc_error(counts, joint, N).all()


def test_same_seed_same_frame(pairs):
    port, _ = pairs[0]
    a = port.simulate(500, seed=11, show_progress=False)
    assert a.equals(port.simulate(500, seed=11, show_progress=False))
    assert not a.equals(port.simulate(500, seed=12, show_progress=False))
    sampler = CompiledAncestralSampler(port)
    assert torch.equal(sampler.forward(500, seed=4), sampler.forward(500, seed=4))
    assert sampler.forward(500).shape == (500, len(port.nodes()))  # seed None draws one
    lw = sampler.likelihood_weighted(100, {sampler.variables[-1]: 0}, seed=2)
    again = sampler.likelihood_weighted(100, {sampler.variables[-1]: 0}, seed=2)
    assert torch.equal(lw[0], again[0]) and torch.equal(lw[1], again[1])


def test_the_global_generator_is_left_alone(pairs):
    port, _ = pairs[0]
    torch.manual_seed(123)
    expected = torch.rand(3)
    torch.manual_seed(123)
    port.simulate(200, seed=1, show_progress=False)
    CompiledAncestralSampler(port).rejection(50, {sorted(port.nodes())[-1]: 0}, seed=2)
    assert torch.equal(torch.rand(3), expected)


@pytest.mark.parametrize("seed", SEEDS)
def test_evidence_by_rejection(pairs, seed):
    port, _ = pairs[seed]
    nodes = list(CompiledAncestralSampler(port).variables)
    root, leaf = nodes[0], nodes[-1]
    evidence = {root: port.states[root][0], leaf: port.states[leaf][1]}
    df = port.simulate(N // 2, evidence=evidence, seed=seed, show_progress=False)
    assert len(df) == N // 2
    _assert_marginals(df, port, evidence=evidence)


@pytest.mark.parametrize("seed", SEEDS)
def test_likelihood_weighted_sample(pairs, seed):
    port, _ = pairs[seed]
    nodes = list(CompiledAncestralSampler(port).variables)
    evidence = {nodes[-1]: port.states[nodes[-1]][0], nodes[1]: port.states[nodes[1]][1]}
    df = BayesianModelSampling(port).likelihood_weighted_sample(
        evidence=[State(v, s) for v, s in evidence.items()], size=N, seed=seed)
    weights = df["_weight"].to_numpy()
    assert (weights > 0).all()
    # effective sample size of the weighted estimate
    ess = weights.sum() ** 2 / (weights ** 2).sum()
    _assert_marginals(df, port, evidence=evidence, n=ess, weights=weights)
    # the mean weight estimates P(evidence)
    p_ev = port.get_state_probability(evidence)
    assert weights.mean() == pytest.approx(p_ev, rel=0.1)


def test_do_intervention(pairs):
    port, _ = pairs[1]
    node = next(v for v in sorted(port.nodes()) if port.get_parents(v) and port.get_children(v))
    state = port.states[node][1]
    df = port.simulate(N // 2, do={node: state}, seed=5, show_progress=False)
    assert (df[node] == state).all()
    mutilated = port.do([node])
    _assert_marginals(df, mutilated, evidence={node: state})
    with pytest.raises(ValueError, match="both do and evidence"):
        port.simulate(10, do={node: state}, evidence={node: state}, show_progress=False)
    with pytest.raises(ValueError, match="Do state"):
        port.simulate(10, do={node: "nope"}, show_progress=False)
    with pytest.raises(ValueError, match="Evidence state"):
        port.simulate(10, evidence={node: "nope"}, show_progress=False)


def test_virtual_evidence_and_intervention(pairs):
    port, _ = pairs[0]
    nodes = list(CompiledAncestralSampler(port).variables)
    soft = nodes[-1]
    card = len(port.states[soft])
    lik = np.linspace(0.15, 0.9, card).reshape(card, 1)
    virt = TabularCPD(soft, card, lik, state_names={soft: port.states[soft]})
    df = port.simulate(N // 2, virtual_evidence=[virt], seed=6, show_progress=False)
    assert not [c for c in df.columns if str(c).startswith("__")]
    ve = VariableElimination(port)
    for var in (soft, nodes[0]):
        p = np_values(ve.query([var], virtual_evidence=[virt]).values)
        assert _within_mc_error(_frequencies(df, var, port.states[var]), p, len(df)).all()
    # a virtual intervention cuts the node from its parents first
    df = port.simulate(N // 2, virtual_intervention=[virt], seed=7, show_progress=False)
    cut = port.do([soft])
    prior = np_values(cut.get_cpds(soft).values).ravel() * lik.ravel()
    assert _within_mc_error(_frequencies(df, soft, port.states[soft]),
                            prior / prior.sum(), len(df)).all()


def test_partial_samples(pairs):
    port, _ = pairs[2]
    sampler = BayesianModelSampling(port)
    order = sampler.topological_order
    fixed = next(v for v in order if port.get_children(v))
    rng = np.random.default_rng(0)
    given = [port.states[fixed][i] for i in rng.integers(0, len(port.states[fixed]), N // 2)]
    df = port.simulate(N // 2, partial_samples=pd.DataFrame({fixed: given}), seed=8,
                       show_progress=False)
    assert df[fixed].tolist() == given
    child = port.get_children(fixed)[0]
    ve = VariableElimination(port)
    for state in port.states[fixed]:
        rows = df[df[fixed] == state]
        p = np_values(ve.query([child], evidence={fixed: state}).values)
        assert _within_mc_error(_frequencies(rows, child, port.states[child]), p, len(rows)).all()
    with pytest.raises(ValueError, match="partial_samples.shape"):
        sampler.forward_sample(size=5, partial_samples=pd.DataFrame({fixed: given[:4]}))


def test_missing_prob(pairs):
    port, _ = pairs[0]
    nodes = list(CompiledAncestralSampler(port).variables)
    target, cause = nodes[-1], nodes[0]
    card = len(port.states[cause])
    rates = np.linspace(0.1, 0.6, card)
    miss = TabularCPD(target + "*", 2, np.vstack([1 - rates, rates]), evidence=[cause],
                      evidence_card=[card],
                      state_names={target + "*": [0, 1], cause: port.states[cause]})
    df = port.simulate(N // 2, missing_prob=miss, seed=9, return_full=True, show_progress=False)
    assert target + "*" not in df.columns and target + "_full" in df.columns
    for state, rate in zip(port.states[cause], rates):
        rows = df[df[cause] == state]
        assert abs(rows[target].isna().mean() - rate) <= 5 * np.sqrt(rate * (1 - rate) / len(rows))
    assert not df[target + "_full"].isna().any()
    with pytest.raises(ValueError, match=r"end with \*"):
        port.simulate(10, missing_prob=TabularCPD(target, 2, [[0.5], [0.5]]), show_progress=False)


def test_latents_are_dropped_unless_asked_for():
    model = DiscreteBayesianNetwork([("h", "x"), ("h", "y")], latents=["h"])
    model.add_cpds(
        TabularCPD("h", 2, [[0.5], [0.5]]),
        TabularCPD("x", 2, [[0.9, 0.2], [0.1, 0.8]], evidence=["h"], evidence_card=[2]),
        TabularCPD("y", 2, [[0.7, 0.1], [0.3, 0.9]], evidence=["h"], evidence_card=[2]))
    assert sorted(model.simulate(20, seed=0, show_progress=False).columns) == ["x", "y"]
    assert sorted(model.simulate(20, seed=0, include_latents=True,
                                 show_progress=False).columns) == ["h", "x", "y"]


def test_rejection_gives_up_on_impossible_evidence():
    model = DiscreteBayesianNetwork([("a", "b")])
    model.add_cpds(
        TabularCPD("a", 2, [[0.5], [0.5]]),
        TabularCPD("b", 2, [[1.0, 1.0], [0.0, 0.0]], evidence=["a"], evidence_card=[2]))
    sampler = CompiledAncestralSampler(model)
    with pytest.raises(ValueError, match="Rejection sampling failed"):
        sampler.rejection(10, {"b": 1}, seed=0, max_batches=3)
    # root evidence alone is clamped, no rejection
    codes = sampler.rejection(100, {"a": 1}, seed=0)
    assert codes.shape == (100, 2) and (codes[:, sampler.var_index["a"]] == 1).all()
    # a rare state of a non-root node: the batch grows to the acceptance rate
    model = DiscreteBayesianNetwork([("a", "b")])
    model.add_cpds(
        TabularCPD("a", 2, [[0.5], [0.5]]),
        TabularCPD("b", 2, [[0.98, 0.9], [0.02, 0.1]], evidence=["a"], evidence_card=[2]))
    sampler = CompiledAncestralSampler(model)
    codes = sampler.rejection(2000, {"b": 1}, seed=1, batch_size=1024)
    assert codes.shape == (2000, 2) and (codes[:, sampler.var_index["b"]] == 1).all()
    share = float((codes[:, sampler.var_index["a"]] == 1).double().mean())
    p = 0.05 / 0.06
    assert abs(share - p) <= 5 * np.sqrt(p * (1 - p) / 2000)


def test_code_dtype_follows_the_largest_cardinality():
    small = DiscreteBayesianNetwork()
    small.add_node("a")
    small.add_cpds(TabularCPD("a", 127, np.full((127, 1), 1 / 127)))
    wide = DiscreteBayesianNetwork()
    wide.add_node("a")
    wide.add_cpds(TabularCPD("a", 128, np.full((128, 1), 1 / 128)))
    assert CompiledAncestralSampler(small).forward(300, seed=0).dtype == torch.int8
    codes = CompiledAncestralSampler(wide).forward(3000, seed=0)
    assert codes.dtype == torch.int32
    assert int(codes.max()) == 127 and int(codes.min()) == 0
    assert codes.device == config.DEVICE
    df = CompiledAncestralSampler(wide).to_dataframe(codes)
    assert df["a"].cat.codes.max() == 127


def test_zero_probability_states_are_never_drawn():
    model = DiscreteBayesianNetwork([("a", "b")])
    model.add_cpds(
        TabularCPD("a", 3, [[0.0], [1.0], [0.0]]),
        TabularCPD("b", 3, [[0.0, 0.5, 0.0], [0.0, 0.0, 1.0], [1.0, 0.5, 0.0]],
                   evidence=["a"], evidence_card=[3]))
    codes = CompiledAncestralSampler(model).forward(200_000, seed=0)
    assert (codes[:, 0] == 1).all()
    assert set(codes[:, 1].unique().tolist()) == {0, 2}


def test_sampler_is_cached_on_the_model(pairs):
    port, _ = pairs[0]
    first = BayesianModelSampling(port).sampler
    assert BayesianModelSampling(port).sampler is first
    port.add_cpds(port.get_cpds(sorted(port.nodes())[0]).copy())
    assert BayesianModelSampling(port).sampler is not first
    assert BayesianModelInference is CompiledAncestralSampler
    with pytest.raises(TypeError):
        BayesianModelSampling(object())


def test_host_side_reduce_tables_match(pairs):
    port, ref = pairs[2]
    got_sampler, want_sampler = BayesianModelSampling(port), JaxSampling(ref)
    node = next(v for v in sorted(port.nodes()) if len(port.get_parents(v)) >= 2)
    got, want = got_sampler.pre_compute_reduce(node), want_sampler.pre_compute_reduce(node)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=1e-7)
    parents = port.get_cpds(node).variables[1:]
    got_idx, got_w = got_sampler.pre_compute_reduce_maps(node, evidence=parents[:1])
    want_idx, want_w = want_sampler.pre_compute_reduce_maps(node, evidence=parents[:1])
    assert {k: int(v) for k, v in got_idx.items()} == {k: int(v) for k, v in want_idx.items()}
    for key in want_w:
        np.testing.assert_allclose(got_w[key], want_w[key], atol=1e-7)


def test_onehot_table_rows_is_a_row_gather():
    table = torch.arange(12.0).reshape(4, 3)
    idx = torch.tensor([3, 0, 0, 2])
    assert torch.equal(onehot_table_rows(table, idx, 4), table[idx])
    assert torch.equal(onehot_table_rows(table, idx, 4, max_rows=1, max_elems=1), table[idx])


# ---------------------------------------------------------------------- #
# ApproxInference and mathext ride on the sampler
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", SEEDS)
def test_approx_inference(pairs, seed):
    port, _ = pairs[seed]
    nodes = list(CompiledAncestralSampler(port).variables)
    evidence = {nodes[0]: port.states[nodes[0]][0]}
    query = [nodes[-1], nodes[-2]]
    approx, ve = ApproxInference(port), VariableElimination(port)
    got = approx.query(query, n_samples=N, evidence=evidence, seed=seed, show_progress=False)
    want = ve.query(query, evidence=evidence)
    assert got.variables == want.variables and got.state_names == want.state_names
    assert _within_mc_error(np_values(got.values), np_values(want.values), N).all()
    marg = approx.query(query, n_samples=N, seed=seed, joint=False, show_progress=False)
    for var in query:
        assert _within_mc_error(np_values(marg[var].values),
                                np_values(ve.query([var]).values), N).all()
    samples = port.simulate(N, seed=seed, show_progress=False)
    assert approx.map_query(query[:1], samples=samples) == ve.map_query(query[:1])
    with pytest.raises(ValueError, match="list of strings"):
        approx.get_distribution(samples, query[0])


def test_approx_inference_rejects_other_models():
    class DynamicBayesianNetwork:
        pass

    with pytest.raises(NotImplementedError, match="dynamic_bn"):
        ApproxInference(DynamicBayesianNetwork())
    from pgmpy_tpu_torch.models import DiscreteMarkovNetwork

    with pytest.raises(ValueError, match="DiscreteBayesianNetwork"):
        ApproxInference(DiscreteMarkovNetwork())


def test_mathext_host_helpers():
    from pgmpy_tpu.utils import mathext as jax_mathext

    arrays = [np.array([1, 2, 3]), np.array([4, 5]), np.array([6, 7])]
    np.testing.assert_array_equal(mathext.cartesian(arrays), jax_mathext.cartesian(arrays))
    assert list(mathext.powerset("abc")) == list(jax_mathext.powerset("abc"))
    assert mathext.State("a", 1) == ("a", 1)


def test_mathext_categorical_draws():
    values = np.array(["x", "y", "z"])
    weights = np.array([0.2, 0.0, 0.8])
    draws = mathext.sample_discrete(values, weights, size=N, seed=1)
    assert draws.shape == (N,) and "y" not in set(draws)
    assert abs((draws == "z").mean() - 0.8) <= 5 * np.sqrt(0.16 / N)
    np.testing.assert_array_equal(draws, mathext.sample_discrete(values, weights, size=N, seed=1))
    rows = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, 2.0, 0.0]])
    assert mathext.sample_discrete(values, rows, seed=0).tolist() == ["x", "z", "y"]
    table = {0: [1.0, 0.0, 0.0], 7: [0.0, 0.5, 0.5]}
    picks = mathext.sample_discrete_maps(values, np.array([0, 7, 7, 0] * 500), table, seed=2)
    assert (picks[0::4] == "x").all() and (picks[3::4] == "x").all()
    assert set(picks[1::4]) == {"y", "z"}
    gen = mathext.seeded_generator(5)
    assert gen.device == config.DEVICE
    assert isinstance(mathext.seeded_generator(None), torch.Generator)
