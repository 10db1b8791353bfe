"""The port's score-based structure searches against pgmpy_tpu on the CPU.

Both packages get the same seeded frames and must learn the same edge set:
their count tables are the same integers and their scores the same float64
expressions, so every greedy decision agrees.  The launch odometer
(``_CodedData.n_dispatches``) must rise by exactly one per hill-climb
iteration that has uncached specs.
"""

import itertools

import networkx as nx
import numpy as np
import pandas as pd
import pytest

import _torch_parity  # noqa: F401  (puts the port on the CPU)
import pgmpy_tpu.estimators as jax_est
from pgmpy_tpu.base import DAG as JaxDAG
from pgmpy_tpu_torch.base import DAG
from pgmpy_tpu_torch.estimators import (
    BDeu,
    ExhaustiveSearch,
    ExpertKnowledge,
    HillClimbSearch,
    ScoreCache,
    TreeSearch,
    get_scoring_method,
)
from pgmpy_tpu_torch.estimators import tree_search
from pgmpy_tpu_torch.estimators.tree_search import pairwise_mutual_info


def edges(dag):
    return sorted((str(u), str(v)) for u, v in dag.edges())


@pytest.fixture(scope="module")
def df():
    """Seven columns with a planted structure: A -> B -> D <- C, D -> E,
    F a noisy copy of A, G independent."""
    rng = np.random.default_rng(3)
    n = 1500
    a = rng.integers(0, 3, n)
    b = (a + rng.integers(0, 2, n)) % 3
    c = rng.integers(0, 2, n)
    d = (b + c + (rng.random(n) < 0.1)) % 3
    e = np.where(rng.random(n) < 0.85, d, rng.integers(0, 3, n))
    f = np.where(rng.random(n) < 0.8, a, rng.integers(0, 3, n))
    g = rng.integers(0, 2, n)
    return pd.DataFrame({"A": a, "B": b, "C": c, "D": d, "E": e, "F": f, "G": g}).astype(str)


HILL_CLIMB_CASES = {
    "k2": dict(scoring_method="k2"),
    "bdeu": dict(scoring_method="bdeu"),
    "bic-d": dict(scoring_method="bic-d"),
    "bds": dict(scoring_method="bds"),
    "default_score": dict(),
    "max_indegree_1": dict(scoring_method="bic-d", max_indegree=1),
    "black_list": dict(scoring_method="bic-d", black_list=[("A", "B"), ("B", "A"), ("D", "E")]),
    "white_list": dict(scoring_method="bic-d",
                       white_list=[("A", "B"), ("B", "D"), ("C", "D"), ("E", "D"), ("A", "F")]),
    "fixed_edges": dict(scoring_method="k2", fixed_edges=[("G", "A"), ("E", "C")]),
    "tabu_1_max_iter_4": dict(scoring_method="bic-d", tabu_length=1, max_iter=4),
    "epsilon": dict(scoring_method="bic-d", epsilon=40.0),
}


@pytest.mark.parametrize("case", sorted(HILL_CLIMB_CASES))
def test_hill_climb_matches_jax(df, case):
    kwargs = HILL_CLIMB_CASES[case]
    got = HillClimbSearch(df).estimate(show_progress=False, **kwargs)
    want = jax_est.HillClimbSearch(df).estimate(show_progress=False, **kwargs)
    assert isinstance(got, DAG) and nx.is_directed_acyclic_graph(got)
    assert edges(got) == edges(want)
    assert sorted(got.nodes()) == sorted(df.columns)
    if case == "max_indegree_1":
        assert max(dict(got.in_degree()).values()) <= 1
    if case == "fixed_edges":
        assert got.has_edge("G", "A") and got.has_edge("E", "C")


def test_hill_climb_start_dag(df):
    def start(cls):
        dag = cls([("E", "D"), ("G", "C")])
        dag.add_nodes_from(df.columns)
        return dag

    got = HillClimbSearch(df).estimate(scoring_method="bic-d", start_dag=start(DAG),
                                       show_progress=False)
    want = jax_est.HillClimbSearch(df).estimate(scoring_method="bic-d", start_dag=start(JaxDAG),
                                                show_progress=False)
    assert edges(got) == edges(want)
    with pytest.raises(ValueError):
        HillClimbSearch(df).estimate(start_dag=DAG([("A", "B")]), show_progress=False)
    with pytest.raises(ValueError):
        HillClimbSearch(df).estimate(fixed_edges=[("A", "B"), ("B", "A")], show_progress=False)


EXPERT_CASES = {
    "required_and_forbidden": dict(required_edges=[("G", "E")], forbidden_edges=[("A", "B"), ("B", "A")]),
    "tiers": dict(temporal_order=[["D", "E"], ["B", "C", "G"], ["A", "F"]]),
    "search_space": dict(search_space=[("A", "B"), ("B", "D"), ("D", "E"), ("F", "A"), ("C", "D")]),
}


@pytest.mark.parametrize("case", sorted(EXPERT_CASES))
def test_hill_climb_with_expert_knowledge(df, case):
    got = HillClimbSearch(df).estimate(
        scoring_method="bic-d", expert_knowledge=ExpertKnowledge(**EXPERT_CASES[case]),
        show_progress=False)
    want = jax_est.HillClimbSearch(df).estimate(
        scoring_method="bic-d", expert_knowledge=jax_est.ExpertKnowledge(**EXPERT_CASES[case]),
        show_progress=False)
    assert edges(got) == edges(want)
    if case == "tiers":  # no edge from a later tier into an earlier one
        tier = {v: i for i, vs in enumerate(EXPERT_CASES[case]["temporal_order"]) for v in vs}
        assert all(tier[u] <= tier[v] for u, v in got.edges())
    if case == "required_and_forbidden":
        assert got.has_edge("G", "E") and not got.has_edge("A", "B") and not got.has_edge("B", "A")


def test_expert_knowledge_rejects_conflicts():
    with pytest.raises(ValueError):
        ExpertKnowledge(forbidden_edges=[("A", "B")], required_edges=[("A", "B")])
    with pytest.raises(ValueError):
        ExpertKnowledge(temporal_order=[["A"], ["A", "B"]])
    knowledge = ExpertKnowledge(temporal_order=[["A"], ["B"]])
    with pytest.raises(ValueError):
        knowledge._validate_temporal_order(["A", "B", "C"])
    black, white = ExpertKnowledge(search_space=[("A", "B")]).limit_search_space(["A", "B", "C"])
    assert white == {("A", "B")} and len(black) == 5


def test_one_dispatch_per_iteration_with_uncached_specs(df, monkeypatch):
    """``n_dispatches`` rises by exactly one in every iteration whose dry run
    finds a spec the cache does not hold, and by none otherwise."""
    scorer = BDeu(df)
    per_iteration = []
    real_prime = ScoreCache.prime

    def counting_prime(self, specs):
        uncached = {(v, tuple(sorted(ps, key=str))) for v, ps in specs} - set(self._cache.keys())
        before = scorer._coded.n_dispatches
        real_prime(self, specs)
        per_iteration.append((bool(uncached), scorer._coded.n_dispatches - before))

    monkeypatch.setattr(ScoreCache, "prime", counting_prime)
    before = scorer._coded.n_dispatches
    dag = HillClimbSearch(df).estimate(scoring_method=scorer, show_progress=False)
    assert len(per_iteration) >= 4
    assert all(used == (1 if uncached else 0) for uncached, used in per_iteration), per_iteration
    # nothing outside prime dispatched: the real pass ran on a warm cache
    assert scorer._coded.n_dispatches - before == sum(used for _, used in per_iteration)
    assert per_iteration[0] == (True, 1)
    assert edges(dag) == edges(jax_est.HillClimbSearch(df).estimate(
        scoring_method=jax_est.BDeu(df), show_progress=False))


def test_batched_and_unbatched_take_the_same_trajectory(df, monkeypatch):
    batched = HillClimbSearch(df).estimate(scoring_method="bic-d", show_progress=False)
    monkeypatch.setattr(ScoreCache, "prime", lambda self, specs: None)
    scorer, _ = get_scoring_method("bic-d", df)
    unbatched = HillClimbSearch(df).estimate(scoring_method=scorer, show_progress=False)
    assert edges(batched) == edges(unbatched)
    assert scorer._coded.n_dispatches > 30  # one count call per candidate


def test_hill_climb_without_cache(df):
    got = HillClimbSearch(df[["A", "B", "C", "D"]], use_cache=False).estimate(
        scoring_method="k2", show_progress=False)
    want = jax_est.HillClimbSearch(df[["A", "B", "C", "D"]], use_cache=False).estimate(
        scoring_method="k2", show_progress=False)
    assert edges(got) == edges(want)


def test_legal_operations_break_ties_in_sorted_order(df):
    """Additions are enumerated in the order of the data's columns, so equal
    score deltas pick the same operation in every process."""
    search = HillClimbSearch(df[["A", "B", "C"]])
    dag = DAG()
    dag.add_nodes_from(["A", "B", "C"])
    ops = [op for op, _ in search._legal_operations(
        dag, lambda v, ps: 0.0, lambda op: 0.0, [], None, set(),
        set(itertools.permutations("ABC", 2)), set())]
    assert ops == [("+", e) for e in itertools.permutations("ABC", 2)]


# --------------------------------------------------------------------------- #
# TreeSearch
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("root", [None, "D"])
def test_chow_liu_matches_jax(df, root):
    got = TreeSearch(df, root_node=root).estimate(estimator_type="chow-liu", show_progress=False)
    want = jax_est.TreeSearch(df, root_node=root).estimate(estimator_type="chow-liu",
                                                           show_progress=False)
    assert edges(got) == edges(want)
    assert len(got.edges()) == len(df.columns) - 1 and nx.is_tree(got.to_undirected())


@pytest.mark.parametrize("class_node, root", [("G", None), ("C", "E")])
def test_tan_matches_jax(df, class_node, root):
    got = TreeSearch(df, root_node=root).estimate(estimator_type="tan", class_node=class_node,
                                                  show_progress=False)
    want = jax_est.TreeSearch(df, root_node=root).estimate(
        estimator_type="tan", class_node=class_node, show_progress=False)
    assert edges(got) == edges(want)
    assert all(got.has_edge(class_node, v) for v in df.columns if v != class_node)


@pytest.mark.parametrize("condition", [None, "C"])
def test_mutual_information_matches_jax_per_pair_route(df, condition):
    """The vectorised mutual information over the flat count tensor against
    the JAX package's per-pair ``_mutual_info``: 1e-12."""
    variables = [v for v in df.columns if v != condition]
    port = TreeSearch(df)
    got = port._mi_matrix(variables, condition)
    want = jax_est.TreeSearch(df)._mi_matrix(variables, condition)
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    assert port._coded.n_dispatches == 1
    assert set(port.timings) == {"specs_s", "launch_s", "readback_s", "mutual_info_s"}


def test_pairwise_mutual_info_against_the_per_table_function():
    """Tables of different shapes, one empty, one with an empty slice."""
    rng = np.random.default_rng(0)
    shapes = [(2, 3), (4, 2), (3, 3), (2, 2)]
    for cz in (1, 3):
        tables = [rng.integers(0, 9, (cx, cy, cz)).astype(np.float64) for cx, cy in shapes]
        tables[2][:] = 0  # no rows at all
        tables[1][:, :, 0] = 0  # one empty slice
        flat = np.concatenate([t.ravel() for t in tables])
        got = pairwise_mutual_info(flat, [s[0] for s in shapes], [s[1] for s in shapes], cz)
        want = []
        for t in tables:
            total = t.sum()
            want.append(sum(t[:, :, k].sum() / total * tree_search._mutual_info(t[:, :, k])
                            for k in range(cz) if t[:, :, k].sum() > 0) if total else 0.0)
        np.testing.assert_allclose(got, want, atol=1e-14)
    assert pairwise_mutual_info(np.zeros(0), [], []).shape == (0,)


def test_pair_tables_are_one_count_call(df, monkeypatch):
    from pgmpy_tpu_torch.estimators import base

    calls = []
    real = base.table_counts
    monkeypatch.setattr(base, "table_counts",
                        lambda *a, **k: calls.append(len(a[2])) or real(*a, **k))
    search = TreeSearch(df)
    flat, table, i, j = search._pair_tables(list(df.columns))
    assert calls == [21] and len(table) == 21  # 7 * 6 / 2 pairs, one call
    # each table equals a crosstab of the two columns
    for s in (0, 9, 20):
        a, b = df.columns[i[s]], df.columns[j[s]]
        want = pd.crosstab(df[a], df[b]).to_numpy()
        got = flat[table.offsets[s] : table.offsets[s] + table.sizes[s]].numpy()
        np.testing.assert_array_equal(got.reshape(want.shape), want)


def test_tree_search_bad_arguments(df):
    with pytest.raises(ValueError):
        TreeSearch(df, root_node="nope")
    with pytest.raises(ValueError):
        TreeSearch(df).estimate(estimator_type="forest")
    with pytest.raises(ValueError):
        TreeSearch(df).estimate(estimator_type="tan")
    with pytest.raises(ValueError):
        TreeSearch(df).estimate(estimator_type="tan", class_node="nope")
    with pytest.raises(ValueError):
        TreeSearch(df, root_node="A").estimate(estimator_type="tan", class_node="A")


# --------------------------------------------------------------------------- #
# ExhaustiveSearch
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("method", [None, "k2", "bdeu"])
def test_exhaustive_search_matches_jax(df, method):
    sub = df[["A", "B", "C", "D"]]
    search = ExhaustiveSearch(sub, scoring_method=method)
    got = search.estimate()
    want = jax_est.ExhaustiveSearch(sub, scoring_method=method).estimate()
    assert edges(got) == edges(want)
    # 4 * 2**3 local scores, all primed by one count call
    assert search.scoring_method.base_scorer._coded.n_dispatches == 1
    assert len(search.scoring_method._cache) == 32


def test_exhaustive_search_enumerates_every_dag(df):
    search = ExhaustiveSearch(df[["A", "B", "C"]])
    dags = list(search.all_dags())
    assert len(dags) == 25  # the number of labelled DAGs on 3 nodes
    scores = search.all_scores()
    assert len(scores) == 25 and scores == sorted(scores, key=lambda t: t[0])
    want = jax_est.ExhaustiveSearch(df[["A", "B", "C"]]).all_scores()
    np.testing.assert_allclose([s for s, _ in scores], [s for s, _ in want], rtol=1e-10)
