"""VariableElimination of the port against pgmpy_tpu on identical networks.

Posteriors agree at rtol 1e-5 / atol 1e-6 in float32.  In float64 the port is
held to 1e-12 against a numpy enumeration of the full joint (the JAX package
stays in float32 in this process).  Random DAGs of 6-10 nodes with
cardinalities 2-4 come from a numpy seed; ALARM is used once."""

import numpy as np
import pytest
import torch

from pgmpy_tpu.factors import DiscreteFactor as JaxFactor
from pgmpy_tpu.factors import TabularCPD as JaxCPD
from pgmpy_tpu.inference import BeliefPropagation as JaxBP
from pgmpy_tpu.inference import VariableElimination as JaxVE
from pgmpy_tpu.models import DiscreteMarkovNetwork as JaxMN
from pgmpy_tpu.utils import get_example_model as jax_example

from _torch_parity import (aligned, assert_factor_close, brute_force_posterior, np_values,
                           random_bn_pair, random_bn_tables, to_port)
from pgmpy_tpu_torch.config import config
from pgmpy_tpu_torch.factors import DiscreteFactor, TabularCPD
from pgmpy_tpu_torch.inference import BeliefPropagation, VariableElimination
from pgmpy_tpu_torch.inference.ve import (MinFill, MinNeighbors, MinWeight, WeightedMinFill,
                                          _GatherPlan)
from pgmpy_tpu_torch.models import DiscreteMarkovNetwork
from pgmpy_tpu_torch.utils.interop import bn_from_numpy

TOL = dict(rtol=1e-5, atol=1e-6)
SEEDS = [0, 1, 2]
HEURISTICS = ["MinFill", "MinNeighbors", "MinWeight", "WeightedMinFill"]


@pytest.fixture(scope="module")
def pairs():
    return {seed: random_bn_pair(seed, n_nodes=6 + 2 * seed) for seed in SEEDS}


def _case(port, seed):
    """(query variables, evidence) of a network: two queries, two observed."""
    rng = np.random.default_rng(100 + seed)
    nodes = sorted(port.nodes())
    picked = [nodes[i] for i in rng.permutation(len(nodes))[:4]]
    evidence = {v: port.states[v][int(rng.integers(0, len(port.states[v])))] for v in picked[2:]}
    return picked[:2], evidence


@pytest.mark.parametrize("seed", SEEDS)
def test_fused_query(pairs, seed):
    port, ref = pairs[seed]
    variables, evidence = _case(port, seed)
    got = VariableElimination(port).query(variables, evidence=evidence)
    want = JaxVE(ref).query(variables, evidence=evidence)
    assert got.variables == want.variables
    assert_factor_close(got, want, **TOL)
    np.testing.assert_allclose(np_values(got.values),
                               brute_force_posterior(ref, variables, evidence), **TOL)
    # no evidence at all
    assert_factor_close(VariableElimination(port).query(variables),
                        JaxVE(ref).query(variables), **TOL)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("order", HEURISTICS + ["explicit"])
def test_staged_query(pairs, seed, order):
    port, ref = pairs[seed]
    variables, evidence = _case(port, seed)
    if order == "explicit":
        order = sorted(set(port.nodes()) - set(variables) - set(evidence), reverse=True)
    got = VariableElimination(port).query(variables, evidence=evidence, elimination_order=order)
    want = JaxVE(ref).query(variables, evidence=evidence, elimination_order=order)
    assert_factor_close(got, want, **TOL)
    np.testing.assert_allclose(np_values(got.values),
                               brute_force_posterior(ref, variables, evidence), **TOL)


@pytest.mark.parametrize("heuristic", [MinFill, MinNeighbors, MinWeight, WeightedMinFill])
def test_elimination_orders_match(pairs, heuristic):
    import pgmpy_tpu.inference.ve as jax_ve

    port, ref = pairs[2]
    assert heuristic(port).get_elimination_order() == getattr(
        jax_ve, heuristic.__name__)(ref).get_elimination_order()
    node = sorted(port.nodes())[3]
    assert heuristic(port).cost(node) == getattr(jax_ve, heuristic.__name__)(ref).cost(node)
    assert sorted(map(sorted, heuristic(port).fill_in_edges(node))) == sorted(
        map(sorted, getattr(jax_ve, heuristic.__name__)(ref).fill_in_edges(node)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("order", ["greedy", "MinFill"])
def test_query_marginals(pairs, seed, order):
    port, ref = pairs[seed]
    variables, evidence = _case(port, seed)
    got = VariableElimination(port).query(variables, evidence=evidence, joint=False,
                                          elimination_order=order)
    want = JaxVE(ref).query(variables, evidence=evidence, joint=False, elimination_order=order)
    assert set(got) == set(want) == set(variables)
    for var in variables:
        assert_factor_close(got[var], want[var], **TOL)


@pytest.mark.parametrize("seed", SEEDS)
def test_virtual_evidence(pairs, seed):
    port, ref = pairs[seed]
    variables, evidence = _case(port, seed)
    soft = sorted(set(port.nodes()) - set(variables) - set(evidence))[0]
    card = len(port.states[soft])
    lik = np.linspace(0.2, 0.9, card).reshape(card, 1)
    names = {soft: list(port.states[soft])}
    got = VariableElimination(port).query(
        variables, evidence=evidence,
        virtual_evidence=[TabularCPD(soft, card, lik, state_names=names)])
    want = JaxVE(ref).query(
        variables, evidence=evidence,
        virtual_evidence=[JaxCPD(soft, card, lik, state_names=names)])
    assert_factor_close(got, want, **TOL)


@pytest.mark.parametrize("seed", SEEDS)
def test_query_batch(pairs, seed):
    port, ref = pairs[seed]
    variables, evidence = _case(port, seed)
    rng = np.random.default_rng(seed)
    rows = {v: [port.states[v][i] for i in rng.integers(0, len(port.states[v]), 50)]
            for v in evidence}
    got, names = VariableElimination(port).query_batch(variables, rows)
    want, want_names = JaxVE(ref).query_batch(variables, rows)
    assert names == want_names
    assert tuple(got.shape) == tuple(np.shape(want))
    np.testing.assert_allclose(np_values(got), np_values(want), **TOL)
    # integer codes are accepted like names
    coded = {v: [port.states[v].index(s) for s in col] for v, col in rows.items()}
    again, _ = VariableElimination(port).query_batch(variables, coded)
    assert torch.equal(again, got)


@pytest.mark.parametrize("seed", SEEDS)
def test_query_batch_all_but_one_observed(pairs, seed):
    """The predict shape: every variable but the query is observed, so most
    CPDs have their whole scope observed and drop out of the contraction."""
    port, ref = pairs[seed]
    nodes = sorted(port.nodes())
    target = nodes[len(nodes) // 2]
    rng = np.random.default_rng(seed)
    rows = {v: [port.states[v][i] for i in rng.integers(0, len(port.states[v]), 40)]
            for v in nodes if v != target}
    got, _ = VariableElimination(port).query_batch([target], rows)
    want, _ = JaxVE(ref).query_batch([target], rows)
    np.testing.assert_allclose(np_values(got), np_values(want), **TOL)


def test_query_batch_with_pruned_evidence(pairs):
    """Evidence d-separated from the query is pruned: every row has one answer."""
    port, ref = to_port(jax_example("asia")), jax_example("asia")
    rows = {"asia": ["yes", "no", "yes"]}
    got, _ = VariableElimination(port).query_batch(["smoke"], rows)
    want, _ = JaxVE(ref).query_batch(["smoke"], rows)
    assert tuple(got.shape) == (3, 2)
    np.testing.assert_allclose(np_values(got), np_values(want), **TOL)


def test_out_of_range_codes_raise_on_the_host(pairs):
    port, _ = pairs[0]
    variables, evidence = _case(port, 0)
    ve = VariableElimination(port)
    var = next(iter(evidence))
    card = len(port.states[var])
    for bad in (card, -1, "no such state", 1.5):
        with pytest.raises(ValueError, match="not valid"):
            ve.query(variables, evidence={**evidence, var: bad})
        with pytest.raises(ValueError, match="not valid"):
            ve.query_batch(variables, {v: [s, bad if v == var else s]
                                       for v, s in evidence.items()})


@pytest.mark.parametrize("seed", SEEDS)
def test_max_marginal_and_map_query(pairs, seed):
    port, ref = pairs[seed]
    variables, evidence = _case(port, seed)
    got = VariableElimination(port).max_marginal(variables, evidence=evidence)
    want = JaxVE(ref).max_marginal(variables, evidence=evidence)
    np.testing.assert_allclose(got, want, **TOL)
    assert VariableElimination(port).max_marginal(evidence=evidence) == pytest.approx(
        JaxVE(ref).max_marginal(evidence=evidence), rel=1e-5)
    for order in ("greedy", "MinFill"):
        assert VariableElimination(port).map_query(
            variables, evidence=evidence, elimination_order=order) == JaxVE(ref).map_query(
            variables, evidence=evidence, elimination_order=order)
    # variables=None: all non-evidence variables
    small_port, small_ref = to_port(jax_example("cancer")), jax_example("cancer")
    assert VariableElimination(small_port).map_query(evidence={"Xray": "positive"}) == JaxVE(
        small_ref).map_query(evidence={"Xray": "positive"})


@pytest.mark.parametrize("seed", SEEDS)
def test_induced_graph_and_width(pairs, seed):
    port, ref = pairs[seed]
    order = sorted(port.nodes())
    got, want = VariableElimination(port), JaxVE(ref)
    assert got.induced_width(order) == want.induced_width(order)
    assert sorted(map(sorted, got.induced_graph(order).edges())) == sorted(
        map(sorted, want.induced_graph(order).edges()))
    with pytest.raises(ValueError):
        got.induced_graph(order[:-1])


def test_argument_errors(pairs):
    port, _ = pairs[0]
    variables, evidence = _case(port, 0)
    ve = VariableElimination(port)
    with pytest.raises(ValueError, match="both"):
        ve.query(variables, evidence={variables[0]: 0})
    with pytest.raises(ValueError, match="Elimination order"):
        ve.query(variables, evidence=evidence, elimination_order=[variables[0]])
    with pytest.raises(ValueError, match="requires evidence"):
        ve.query_batch(variables, {})
    with pytest.raises(ValueError, match="both"):
        ve.map_query(variables, evidence={variables[0]: 0})
    with pytest.raises(ValueError):
        MinFill(DiscreteMarkovNetwork())


def test_alarm_queries():
    ref = jax_example("alarm")
    port = to_port(ref)
    cases = [
        (["HISTORY"], {"CVP": "LOW", "HR": "HIGH"}),
        (["LVFAILURE", "STROKEVOLUME"], {"BP": "LOW"}),
        (["KINKEDTUBE"], {"VENTLUNG": "ZERO", "PRESS": "HIGH", "SAO2": "LOW"}),
    ]
    ve, bp, jax_ve = VariableElimination(port), BeliefPropagation(port), JaxVE(ref)
    for variables, evidence in cases:
        got = ve.query(variables, evidence=evidence)
        assert_factor_close(got, jax_ve.query(variables, evidence=evidence), **TOL)
        assert_factor_close(got, bp.query(variables, evidence=evidence), **TOL)
        staged = ve.query(variables, evidence=evidence, elimination_order="MinFill")
        assert_factor_close(staged, got, **TOL)


@pytest.mark.parametrize("seed", SEEDS)
def test_ve_equals_bp_in_the_port(pairs, seed):
    port, _ = pairs[seed]
    variables, evidence = _case(port, seed)
    ve, bp = VariableElimination(port), BeliefPropagation(port)
    assert_factor_close(ve.query(variables, evidence=evidence),
                        bp.query(variables, evidence=evidence), **TOL)
    rows = {v: [s] * 3 for v, s in evidence.items()}
    np.testing.assert_allclose(np_values(ve.query_batch(variables, rows)[0]),
                               np_values(bp.query_batch(variables, rows)[0]), **TOL)
    assert ve.map_query(variables, evidence=evidence) == bp.map_query(variables, evidence=evidence)


# ---------------------------------------------------------------------- #
# float64: the whole path stays float64
# ---------------------------------------------------------------------- #
@pytest.fixture
def float64():
    config.set_dtype(torch.float64)
    try:
        yield
    finally:
        config.set_dtype(torch.float32)


@pytest.mark.parametrize("seed", SEEDS)
def test_float64_queries_against_enumeration(float64, seed):
    # built from the float64 tables while the port's dtype is float64
    names, edges, tuples = random_bn_tables(seed, n_nodes=6 + seed)
    port = bn_from_numpy(edges, tuples, nodes=names)
    variables, evidence = _case(port, seed)
    want = brute_force_posterior(port, variables, evidence)
    ve = VariableElimination(port)
    for order in ("greedy", "MinFill", "WeightedMinFill"):
        got = ve.query(variables, evidence=evidence, elimination_order=order)
        assert got.values.dtype == torch.float64
        np.testing.assert_allclose(np_values(got.values), want, rtol=0, atol=1e-12)
    rows = {v: [s, s] for v, s in evidence.items()}
    batch, _ = ve.query_batch(variables, rows)
    assert batch.dtype == torch.float64
    np.testing.assert_allclose(np_values(batch[1]), want, rtol=0, atol=1e-12)
    bp = BeliefPropagation(port).query(variables, evidence=evidence)
    np.testing.assert_allclose(np_values(bp.values), want, rtol=0, atol=1e-12)


# ---------------------------------------------------------------------- #
# BP queries on models that are not Bayesian networks ride on VE
# ---------------------------------------------------------------------- #
def _markov_pair(seed):
    rng = np.random.default_rng(seed)
    scopes = [("a", "b"), ("b", "c"), ("c", "d"), ("b", "d"), ("d", "e")]
    cards = {"a": 2, "b": 3, "c": 2, "d": 4, "e": 2}
    port, ref = DiscreteMarkovNetwork(scopes), JaxMN(scopes)
    for scope in scopes:
        values = rng.random([cards[v] for v in scope]) + 0.1
        port.add_factors(DiscreteFactor(list(scope), [cards[v] for v in scope], values))
        ref.add_factors(JaxFactor(list(scope), [cards[v] for v in scope], values))
    return port, ref


@pytest.mark.parametrize("kind", ["markov_network", "junction_tree"])
def test_bp_query_on_undirected_models(kind):
    port, ref = _markov_pair(3)
    if kind == "junction_tree":
        port, ref = port.to_junction_tree(), ref.to_junction_tree()
    port_bp, jax_bp = BeliefPropagation(port), JaxBP(ref)
    for variables, evidence in [(["a"], {"d": 2}), (["c", "e"], {"a": 1}), (["b"], None)]:
        got = port_bp.query(variables, evidence=evidence)
        want = jax_bp.query(variables, evidence=evidence)
        assert set(got.variables) == set(want.variables)
        np.testing.assert_allclose(aligned(got, want.variables), np_values(want.values), **TOL)
    got = port_bp.query(["c", "e"], evidence={"a": 1}, joint=False)
    want = jax_bp.query(["c", "e"], evidence={"a": 1}, joint=False)
    for var in ("c", "e"):
        np.testing.assert_allclose(np_values(got[var].normalize(inplace=False).values),
                                   np_values(want[var].normalize(inplace=False).values), **TOL)
    assert port_bp.map_query(["b", "c"], evidence={"e": 0}) == jax_bp.map_query(
        ["b", "c"], evidence={"e": 0})


def test_ve_on_a_markov_network():
    port, ref = _markov_pair(5)
    got = VariableElimination(port).query(["a", "e"], evidence={"c": 1})
    want = JaxVE(ref).query(["a", "e"], evidence={"c": 1})
    np.testing.assert_allclose(aligned(got, want.variables), np_values(want.values), **TOL)
    # no query variables: the unnormalized product of all factors
    full = VariableElimination(port)._variable_elimination([], "marginalize")
    full_ref = JaxVE(ref)._variable_elimination([], "marginalize")
    np.testing.assert_allclose(aligned(full, full_ref.variables), np_values(full_ref.values),
                               rtol=1e-5)


# ---------------------------------------------------------------------- #
# the per-row gather of observed axes
# ---------------------------------------------------------------------- #
GATHER_CASES = {
    "first": ["p0"],
    "last": ["p3"],
    "child_axis": ["x"],
    "adjacent": ["p1", "p2"],
    "adjacent_leading": ["x", "p0"],
    "split": ["p0", "p2"],
    "split_ends": ["x", "p3"],
    "three_of_five": ["p0", "p1", "p3"],
    "whole_scope": ["x", "p0", "p1", "p2", "p3"],
}


@pytest.mark.parametrize("case", sorted(GATHER_CASES))
def test_gather_plan_puts_the_batch_axis_first(case):
    """Whatever the positions of the observed axes in a CPD's scope, the
    gathered operand is ``(n, *free axes in scope order)``."""
    observed = GATHER_CASES[case]
    scope = ["x", "p0", "p1", "p2", "p3"]
    shape = (3, 2, 4, 2, 3)
    rng = np.random.default_rng(7)
    values = rng.random(shape)
    ev_pos = {v: k for k, v in enumerate(sorted(observed, reverse=True))}
    table, columns, strides = _GatherPlan.table_of(torch.from_numpy(values), scope, ev_pos)
    n = 17
    codes = np.stack([rng.integers(0, shape[scope.index(v)], n)
                      for v in sorted(observed, reverse=True)], axis=1)
    plan = _GatherPlan([table], [columns], [strides], len(observed))
    (got,) = plan.rows(torch.from_numpy(codes))
    free = [v for v in scope if v not in observed]
    assert tuple(got.shape) == (n,) + tuple(shape[scope.index(v)] for v in free)
    for i in range(n):
        index = tuple(codes[i, ev_pos[v]] if v in ev_pos else slice(None) for v in scope)
        np.testing.assert_array_equal(got[i].numpy(), values[index])


def test_gather_plan_pads_short_scopes():
    """Tables with different numbers of observed axes share one index tensor."""
    rng = np.random.default_rng(8)
    a, b = rng.random((2, 3, 4)), rng.random((3, 5))
    ev_pos = {"u": 0, "v": 1, "w": 2}
    ta = _GatherPlan.table_of(torch.from_numpy(a), ["u", "f", "w"], ev_pos)
    tb = _GatherPlan.table_of(torch.from_numpy(b), ["v", "g"], ev_pos)
    plan = _GatherPlan([ta[0], tb[0]], [ta[1], tb[1]], [ta[2], tb[2]], 3)
    codes = np.stack([rng.integers(0, 2, 9), rng.integers(0, 3, 9), rng.integers(0, 4, 9)], axis=1)
    got_a, got_b = plan.rows(torch.from_numpy(codes))
    for i, (u, v, w) in enumerate(codes):
        np.testing.assert_array_equal(got_a[i].numpy(), a[u, :, w])
        np.testing.assert_array_equal(got_b[i].numpy(), b[v])


def test_query_batch_with_evidence_axes_everywhere():
    """A five-variable CPD queried with its observed axes first, last,
    adjacent and split, against the JAX package and the enumeration."""
    port, ref = random_bn_pair(11, n_nodes=7, edge_prob=0.9, max_parents=4)
    nodes = sorted(port.nodes())
    rng = np.random.default_rng(11)
    child = "X6"
    parents = list(port.get_cpds(child).variables[1:])
    assert len(parents) == 4
    for observed in ([parents[0]], [parents[-1]], parents[1:3], [parents[0], parents[2]],
                     [child] + parents):
        query = [v for v in nodes if v not in observed][:2]
        rows = {v: [port.states[v][i] for i in rng.integers(0, len(port.states[v]), 12)]
                for v in observed}
        got, _ = VariableElimination(port).query_batch(query, rows)
        want, _ = JaxVE(ref).query_batch(query, rows)
        np.testing.assert_allclose(np_values(got), np_values(want), **TOL)
        row0 = brute_force_posterior(ref, query, {v: col[0] for v, col in rows.items()})
        np.testing.assert_allclose(np_values(got[0]), row0, **TOL)


def test_programs_are_cached_per_signature_and_live_on_the_device(pairs):
    port, _ = pairs[1]
    variables, evidence = _case(port, 1)
    ve = VariableElimination(port)
    ve.query(variables, evidence=evidence)
    prog = ve._get_compiled_query(variables, sorted(evidence, key=str))
    other = {v: port.states[v][0] for v in evidence}
    VariableElimination(port).query(variables, evidence=other)
    assert VariableElimination(port)._get_compiled_query(
        variables, sorted(evidence, key=str)) is prog
    assert all(a.device == config.DEVICE for a in prog._arrays)
    assert prog.largest_intermediate() >= int(np.prod(prog.cards))
    # a model edit throws the programs away
    cpd = port.get_cpds(variables[0])
    port.add_cpds(cpd.copy())
    assert VariableElimination(port)._get_compiled_query(
        variables, sorted(evidence, key=str)) is not prog
