"""Constraint-based structure learning of the port against pgmpy_tpu on the CPU.

``PDAG`` (Meek's rules, ``to_dag``), ``DAG.to_pdag``, PC (skeleton,
separating sets, PDAG and DAG for every variant, with and without expert
knowledge), MMHC, GES and ``DAG.edge_strength``.  Both packages get the same
seeded frames; their CI statistics and scores are the same float64
expressions over the same integer counts, so every decision agrees and the
learned graphs must be equal.  PC must make exactly one count launch
(``_CodedData.n_dispatches``) per non-empty conditioning-set level.
"""

import functools
import itertools

import networkx as nx
import numpy as np
import pandas as pd
import pytest

import _torch_parity  # noqa: F401  (puts the port on the CPU)
import pgmpy_tpu.estimators as jax_est
import pgmpy_tpu.estimators.citests as jax_ci
from _golden_data import (
    EDGE_STRENGTH_DAG,
    LinearPillaiClassifier,
    LinearPillaiRegressor,
    standalone_mixed_frame,
    standalone_sample,
)
from pgmpy_tpu.base import DAG as JaxDAG
from pgmpy_tpu.base import PDAG as JaxPDAG
from pgmpy_tpu.utils import get_example_model as jax_example
from pgmpy_tpu_torch.base import DAG, PDAG
from pgmpy_tpu_torch.estimators import (
    GES,
    PC,
    BaseConstraintEstimator,
    BDeu,
    ExpertKnowledge,
    MmhcEstimator,
    ScoreCache,
    citests,
)


def edges(graph):
    return sorted((str(u), str(v)) for u, v in graph.edges())


def pdag_parts(pdag):
    return (sorted(map(tuple, pdag.directed_edges)),
            sorted(tuple(sorted(e)) for e in pdag.undirected_edges))


# --------------------------------------------------------------------------- #
# PDAG
# --------------------------------------------------------------------------- #
def random_pdag_edges(seed, n=7, p=0.4):
    """(directed, undirected) edge lists of a random acyclic PDAG from a numpy
    seed: a random DAG over N0..N{n-1} with each edge kept directed or made
    undirected by a coin."""
    rng = np.random.default_rng(seed)
    names = [f"N{i}" for i in range(n)]
    directed, undirected = [], []
    for i, j in itertools.combinations(range(n), 2):
        if rng.random() < p:
            (directed if rng.random() < 0.5 else undirected).append((names[i], names[j]))
    return names, directed, undirected


@pytest.mark.parametrize("apply_r4", [False, True])
@pytest.mark.parametrize("seed", range(12))
def test_meeks_rules_and_to_dag_match_jax(seed, apply_r4):
    names, directed, undirected = random_pdag_edges(seed)
    port, ref = PDAG(directed, undirected), JaxPDAG(directed, undirected)
    port.add_nodes_from(names)
    ref.add_nodes_from(names)
    got, want = port.apply_meeks_rules(apply_r4=apply_r4), ref.apply_meeks_rules(apply_r4=apply_r4)
    assert pdag_parts(got) == pdag_parts(want)
    assert pdag_parts(port) == pdag_parts(ref)  # not in place
    dag, ref_dag = got.to_dag(), want.to_dag()
    assert isinstance(dag, DAG) and nx.is_directed_acyclic_graph(dag)
    assert edges(dag) == edges(ref_dag)
    assert set(dag.nodes()) == set(names)


MEEK_CASES = {
    # R1: a -> b - c, a and c not adjacent  =>  b -> c
    "R1": ([("a", "b")], [("b", "c")], False, [("a", "b"), ("b", "c")]),
    # R2: a -> b -> c and a - c  =>  a -> c
    "R2": ([("a", "b"), ("b", "c")], [("a", "c")], False, [("a", "b"), ("a", "c"), ("b", "c")]),
    # R3: a - {b, c, d}, b -> d <- c, b and c not adjacent  =>  a -> d
    "R3": ([("b", "d"), ("c", "d")], [("a", "b"), ("a", "c"), ("a", "d")], False,
           [("a", "d"), ("b", "d"), ("c", "d")]),
    # R4: d -> c -> b, a - {b, c, d}, b and d not adjacent  =>  a -> b
    "R4": ([("d", "c"), ("c", "b")], [("a", "b"), ("a", "c"), ("a", "d")], True,
           [("a", "b"), ("c", "b"), ("d", "c")]),
}


@pytest.mark.parametrize("rule", sorted(MEEK_CASES))
def test_each_meek_rule(rule):
    directed, undirected, apply_r4, must = MEEK_CASES[rule]
    got = PDAG(directed, undirected).apply_meeks_rules(apply_r4=apply_r4)
    want = JaxPDAG(directed, undirected).apply_meeks_rules(apply_r4=apply_r4)
    assert pdag_parts(got) == pdag_parts(want)
    assert set(must) <= set(got.directed_edges)
    port = PDAG(directed, undirected)
    assert port.apply_meeks_rules(apply_r4=apply_r4, inplace=True) is None
    assert pdag_parts(port) == pdag_parts(got)


def test_pdag_equality_hash_copy_and_errors():
    a = PDAG([("a", "b")], [("b", "c")], latents=["c"])
    b = PDAG([("a", "b")], [("c", "b")], latents=["c"])
    assert a == b and hash(a) == hash(b)
    assert a.copy() == a and a.copy() is not a
    assert a != PDAG([("a", "b"), ("b", "c")], [], latents=["c"])
    assert a != PDAG([("a", "b")], [("b", "c")])
    assert a != "not a pdag"
    assert a.has_undirected_edge("c", "b") and a.has_directed_edge("a", "b")
    assert a.all_neighbors("b") == {"a", "c"} and a.directed_parents("b") == {"a"}
    with pytest.raises(ValueError, match="both directions"):
        PDAG([("a", "b"), ("b", "a")])
    with pytest.raises(ValueError, match="No undirected edge"):
        a.orient_undirected_edge("a", "b")
    ref = JaxPDAG([("a", "b")], [("b", "c")], latents=["c"])
    assert pdag_parts(a.orient_undirected_edge("c", "b")) == \
        pdag_parts(ref.orient_undirected_edge("c", "b"))


def test_to_dag_without_a_faithful_extension():
    """A 4-cycle of undirected edges has no extension without a new
    v-structure: both packages orient what is left the same way."""
    cycle = [("a", "b"), ("b", "c"), ("c", "d"), ("d", "a")]
    got, want = PDAG([], cycle).to_dag(), JaxPDAG([], cycle).to_dag()
    assert edges(got) == edges(want)


@pytest.mark.parametrize("name", ["asia", "alarm", "sachs", "child"])
def test_dag_to_pdag_matches_jax(name):
    model_edges = list(jax_example(name).edges())
    got, want = DAG(model_edges).to_pdag(), JaxDAG(model_edges).to_pdag()
    assert isinstance(got, PDAG)
    assert pdag_parts(got) == pdag_parts(want)


@pytest.mark.parametrize("seed", range(6))
def test_random_dag_to_pdag_matches_jax(seed):
    names, directed, undirected = random_pdag_edges(100 + seed, n=8, p=0.45)
    dag_edges = directed + undirected
    got, want = DAG(dag_edges).to_pdag(), JaxDAG(dag_edges).to_pdag()
    assert pdag_parts(got) == pdag_parts(want)
    # a CPDAG extends to a DAG of the same equivalence class
    assert DAG(dag_edges).is_iequivalent(got.to_dag())


# --------------------------------------------------------------------------- #
# PC
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def df():
    """Seven columns with a planted structure: A -> B -> D <- C, D -> E,
    F a noisy copy of A, G independent."""
    rng = np.random.default_rng(3)
    n = 3000
    a = rng.integers(0, 3, n)
    b = (a + rng.integers(0, 2, n)) % 3
    c = rng.integers(0, 2, n)
    d = (b + c + (rng.random(n) < 0.1)) % 3
    e = np.where(rng.random(n) < 0.85, d, rng.integers(0, 3, n))
    f = np.where(rng.random(n) < 0.8, a, rng.integers(0, 3, n))
    g = rng.integers(0, 2, n)
    return pd.DataFrame({"A": a, "B": b, "C": c, "D": d, "E": e, "F": f, "G": g}).astype(str)


@pytest.fixture(scope="module")
def alarm_df():
    return standalone_sample(jax_example("alarm"), 1500, seed=7)


KNOWLEDGE = {
    "none": None,
    "forbidden": dict(forbidden_edges=[("B", "D"), ("D", "B"), ("F", "A")]),
    "required": dict(required_edges=[("E", "D"), ("A", "F")]),
    "temporal": dict(temporal_order=[["A", "C", "G"], ["B", "F"], ["D"], ["E"]]),
}


def knowledge(case, package):
    spec = KNOWLEDGE[case]
    if spec is None:
        return None
    return (ExpertKnowledge if package == "port" else jax_est.ExpertKnowledge)(**spec)


def skeleton_parts(skel, sepsets):
    return (sorted(tuple(sorted(e)) for e in skel.edges()),
            {tuple(sorted(k)): tuple(v) for k, v in sepsets.items()})


@pytest.mark.parametrize("variant", ["stable", "orig", "parallel"])
def test_pc_skeleton_and_sepsets_match_jax(df, variant):
    got = PC(df).build_skeleton(ci_test="chi_square", variant=variant, max_cond_vars=3)
    want = jax_est.PC(df).build_skeleton(ci_test="chi_square", variant=variant, max_cond_vars=3)
    assert skeleton_parts(*got) == skeleton_parts(*want)


@pytest.mark.parametrize("enforce", [False, True])
@pytest.mark.parametrize("case", sorted(KNOWLEDGE))
@pytest.mark.parametrize("variant", ["stable", "orig", "parallel"])
def test_pc_matches_jax(df, variant, case, enforce):
    kwargs = dict(variant=variant, ci_test="chi_square", significance_level=0.01,
                  max_cond_vars=3, enforce_expert_knowledge=enforce, show_progress=False)
    got = PC(df).estimate(return_type="pdag", expert_knowledge=knowledge(case, "port"), **kwargs)
    want = jax_est.PC(df).estimate(return_type="pdag", expert_knowledge=knowledge(case, "jax"),
                                   **kwargs)
    assert isinstance(got, PDAG)
    assert pdag_parts(got) == pdag_parts(want)
    got = PC(df).estimate(return_type="dag", expert_knowledge=knowledge(case, "port"), **kwargs)
    want = jax_est.PC(df).estimate(return_type="dag", expert_knowledge=knowledge(case, "jax"),
                                   **kwargs)
    assert isinstance(got, DAG) and edges(got) == edges(want)


@pytest.mark.parametrize("ci_test", ["g_sq", "modified_log_likelihood", "power_divergence"])
def test_pc_other_batched_tests_match_jax(df, ci_test):
    extra = {"lambda_": "freeman-tukey"} if ci_test == "power_divergence" else {}
    port_test = getattr(citests, ci_test) if ci_test == "power_divergence" else ci_test
    jax_test = getattr(jax_ci, ci_test) if ci_test == "power_divergence" else ci_test
    est = PC(df)
    got = est.build_skeleton(ci_test=port_test, max_cond_vars=3, **extra)
    want = jax_est.PC(df).build_skeleton(ci_test=jax_test, max_cond_vars=3, **extra)
    assert skeleton_parts(*got) == skeleton_parts(*want)
    assert est._coded.n_dispatches >= 2  # the batched path ran


def test_pc_one_launch_per_nonempty_level_and_equal_to_the_per_test_path(alarm_df, monkeypatch):
    """The batched path makes one count launch per conditioning-set level that
    has a test; a wrapped ``chi_square`` takes the per-test path (the registry
    is keyed on the function itself) and learns the same skeleton and
    separating sets."""
    levels = set()

    def wrapped(X, Y, Z, data, **kwargs):
        levels.add(len(Z))
        return citests.chi_square(X, Y, Z, data, **kwargs)

    est = PC(alarm_df)
    batches = []
    real_batch = citests.power_divergence_batch

    def counting_batch(triples, *args, **kwargs):
        batches.append(len(triples))
        return real_batch(triples, *args, **kwargs)

    monkeypatch.setattr(citests, "power_divergence_batch", counting_batch)
    batched = est.build_skeleton(ci_test="chi_square", max_cond_vars=4, significance_level=0.01)
    monkeypatch.setattr(citests, "power_divergence_batch", real_batch)
    per_test_est = PC(alarm_df)
    per_test = per_test_est.build_skeleton(ci_test=wrapped, max_cond_vars=4, significance_level=0.01)
    nonempty = sum(1 for n in batches if n)
    assert nonempty == len(levels) >= 3
    assert est._coded.n_dispatches == nonempty
    assert per_test_est._coded.n_dispatches == 0  # the per-test path counts through the frame
    assert skeleton_parts(*batched) == skeleton_parts(*per_test)
    want = jax_est.PC(alarm_df).build_skeleton(ci_test="chi_square", max_cond_vars=4,
                                               significance_level=0.01)
    assert skeleton_parts(*batched) == skeleton_parts(*want)


def test_pc_from_independencies_and_errors():
    from pgmpy_tpu.independencies import Independencies as JaxIndependencies
    from pgmpy_tpu_torch.independencies import Independencies

    spec = (["B", "C"], ["A", ["B", "C"], "D"])
    port = PC(independencies=Independencies(*spec).closure()).estimate(
        ci_test="independence_match", show_progress=False)
    ref = jax_est.PC(independencies=JaxIndependencies(*spec).closure()).estimate(
        ci_test="independence_match", show_progress=False)
    assert edges(port) == edges(ref) == [("B", "D"), ("C", "D"), ("D", "A")]
    with pytest.raises(ValueError, match="variant"):
        PC(independencies=Independencies(*spec)).estimate(variant="bad")
    with pytest.raises(ValueError, match="return_type"):
        PC(independencies=Independencies(*spec).closure()).estimate(
            ci_test="independence_match", return_type="bad")
    with pytest.raises(ValueError, match="data or independencies"):
        BaseConstraintEstimator().build_skeleton()
    assert PC.skeleton_to_pdag is PC.orient_colliders


# --------------------------------------------------------------------------- #
# MMHC and GES
# --------------------------------------------------------------------------- #
def test_mmhc_matches_jax(df):
    est, ref = MmhcEstimator(df), jax_est.MmhcEstimator(df)
    skel, ref_skel = est.mmpc(significance_level=0.01), ref.mmpc(significance_level=0.01)
    assert sorted(map(sorted, skel.edges())) == sorted(map(sorted, ref_skel.edges()))
    got, want = est.estimate(significance_level=0.01), ref.estimate(significance_level=0.01)
    assert edges(got) == edges(want)
    got = MmhcEstimator(df).estimate(scoring_method="bic-d", tabu_length=2)
    assert edges(got) == edges(jax_est.MmhcEstimator(df).estimate(scoring_method="bic-d",
                                                                   tabu_length=2))


def test_mmhc_forward_iteration_is_one_launch(df):
    est = MmhcEstimator(df)
    before = est._coded.n_dispatches
    pvals = est._pvalues_batch("A", ["B", "C", "D"], ["E", "F"])
    assert est._coded.n_dispatches - before == 1
    assert [len(p) for p in pvals.values()] == [4, 4, 4]
    single = citests.chi_square("A", "C", ["F"], df, boolean=False)[1]
    assert pvals["C"][2] == single  # powerset order: (), (E,), (F,), (E, F)
    assert est._min_assoc("A", "C", ["E", "F"]) == min(1 - p for p in pvals["C"])


GES_CASES = {
    "bic-d": dict(scoring_method="bic-d"),
    "bdeu": dict(scoring_method="bdeu"),
    "k2_min_improvement": dict(scoring_method="k2", min_improvement=5.0),
    "forbidden": dict(scoring_method="bic-d", knowledge="forbidden"),
    "required": dict(scoring_method="bic-d", knowledge="required"),
    "temporal": dict(scoring_method="bic-d", knowledge="temporal"),
    "search_space": dict(scoring_method="bic-d", knowledge="search_space"),
}


@pytest.mark.parametrize("case", sorted(GES_CASES))
def test_ges_matches_jax(df, case):
    kwargs = dict(GES_CASES[case])
    name = kwargs.pop("knowledge", None)
    if name == "search_space":
        space = [("A", "B"), ("B", "D"), ("C", "D"), ("D", "E"), ("A", "F"), ("E", "G")]
        port_k, jax_k = ExpertKnowledge(search_space=space), jax_est.ExpertKnowledge(search_space=space)
    elif name:
        port_k, jax_k = knowledge(name, "port"), knowledge(name, "jax")
    else:
        port_k = jax_k = None
    got = GES(df).estimate(expert_knowledge=port_k, **kwargs)
    want = jax_est.GES(df).estimate(expert_knowledge=jax_k, **kwargs)
    assert isinstance(got, DAG) and edges(got) == edges(want)


def test_ges_launches_and_prime_disabled_trajectory(df, monkeypatch):
    scorer = BDeu(df)
    primed = []
    real_prime = ScoreCache.prime

    def counting_prime(self, specs):
        keys = {(v, tuple(sorted(ps, key=str))) for v, ps in specs}
        primed.append(len(keys - set(self._cache.keys())))
        real_prime(self, specs)

    monkeypatch.setattr(ScoreCache, "prime", counting_prime)
    dag = GES(df).estimate(scoring_method=scorer)
    assert scorer._coded.n_dispatches == sum(1 for n in primed if n) > 0
    monkeypatch.setattr(ScoreCache, "prime", lambda self, specs: None)
    unprimed = GES(df).estimate(scoring_method=BDeu(df))
    assert edges(dag) == edges(unprimed)


# --------------------------------------------------------------------------- #
# DAG.edge_strength
# --------------------------------------------------------------------------- #
def test_edge_strength_matches_jax(monkeypatch):
    factories = dict(classifier_factory=LinearPillaiClassifier,
                     regressor_factory=LinearPillaiRegressor)
    monkeypatch.setattr(citests, "pillai_trace", functools.partial(citests.pillai_trace, **factories))
    monkeypatch.setattr(jax_ci, "pillai_trace", functools.partial(jax_ci.pillai_trace, **factories))
    frame = standalone_mixed_frame(400, seed=11)
    dag, ref = DAG(EDGE_STRENGTH_DAG, latents=[]), JaxDAG(EDGE_STRENGTH_DAG)
    got, want = dag.edge_strength(frame), ref.edge_strength(frame)
    assert set(got) == set(want)
    for edge, value in got.items():
        assert value == pytest.approx(want[edge], rel=1e-10, abs=1e-12)
        assert dag.edges[edge]["strength"] == value
    one = EDGE_STRENGTH_DAG[0]
    assert set(DAG(EDGE_STRENGTH_DAG).edge_strength(frame, edges=one)) == {one}
    latent = DAG(EDGE_STRENGTH_DAG, latents=[one[0]])
    assert one not in latent.edge_strength(frame)
