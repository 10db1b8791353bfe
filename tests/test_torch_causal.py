"""The causal lane of the port against pgmpy_tpu on the CPU.

Graphs (``ADMG``, ``AncestralBase`` / ``MAG``), identification
(``Adjustment``, ``Frontdoor``, the backdoor / frontdoor / IV machinery of
``CausalInference``), the lavaan and dagitty parsers and the twelve dagitty
teaching DAGs are host code: each case runs in both packages and the outputs
must be EQUAL.  The cases are those of ``tests/test_mag_deep.py``,
``tests/test_lgbn_sem_causal_deep.py`` and ``tests/test_causal_metrics.py``
plus seeded random ADMGs and MAGs.

``CausalInference.query`` answers the combinations of the adjustment set in
one ``query_batch``; it is held to the JAX package's per-combination loop at
rtol 1e-5 / atol 1e-6 (float32), and in float64 to the truncated
factorisation of a numpy enumeration at 1e-12.  ``LinearEstimator``,
``estimate_ate``, ``NaiveAdjustmentRegressor`` and the shared minimum-norm
solve are float64 on both sides (rtol 1e-9).
"""

import importlib
import itertools
import os
import re
from types import SimpleNamespace

import networkx as nx
import numpy as np
import pandas as pd
import pytest
import torch

import _torch_parity  # noqa: F401  (puts the port on the CPU)
from _torch_parity import np_values, random_bn_tables
from pgmpy_tpu_torch.config import config
from pgmpy_tpu_torch.ops.lstsq import lstsq
from pgmpy_tpu_torch.utils.interop import bn_from_numpy
from pgmpy_tpu_torch.utils.utils import _EXAMPLE_DIR, DAG_MODELS


def package(name):
    base = importlib.import_module(f"{name}.base")
    ident = importlib.import_module(f"{name}.identification")
    models = importlib.import_module(f"{name}.models")
    return SimpleNamespace(
        ADMG=base.ADMG, MAG=base.MAG, AncestralBase=base.AncestralBase, DAG=base.DAG,
        UndirectedGraph=base.UndirectedGraph, Adjustment=ident.Adjustment,
        Frontdoor=ident.Frontdoor,
        CausalInference=importlib.import_module(f"{name}.inference.causal").CausalInference,
        BN=models.DiscreteBayesianNetwork, LGBN=models.LinearGaussianBayesianNetwork,
        parser=importlib.import_module(f"{name}.utils.parser"),
        example=importlib.import_module(f"{name}.utils").get_example_model,
        prediction=importlib.import_module(f"{name}.prediction"),
        LinearEstimator=importlib.import_module(f"{name}.inference.linear_model").LinearEstimator,
    )


JAX, PORT = package("pgmpy_tpu"), package("pgmpy_tpu_torch")


def outcome(case, pkg):
    """What ``case(pkg)`` returns, or the name of the exception it raises."""
    try:
        return case(pkg)
    except Exception as err:  # noqa: BLE001  (the exception IS the outcome)
        return ("raises", type(err).__name__)


def marks(g):
    return sorted((tuple(sorted((u, v))), tuple(sorted(d["marks"].items())))
                  for u, v, d in g.edges(data=True))


def edges(g):
    return sorted((str(u), str(v)) for u, v in g.edges())


# --------------------------------------------------------------------------- #
# graph cases (tests/test_mag_deep.py and the causal tests), equal outputs
# --------------------------------------------------------------------------- #
def _marks_case(p):
    g = p.AncestralBase()
    g.add_edge("A", "B", "-", ">")
    g.add_edge("A", "D", ">", ">")
    return marks(g)


def _adjacency_case(p):
    g = p.AncestralBase(ebunch=[("A", "B", "-", ">"), ("B", "C", ">", "-")])
    M, idx = g.adjacency_matrix
    g2 = p.AncestralBase()
    g2.adjacency_matrix = M
    return M.tolist(), idx, g2.adjacency_matrix[0].tolist(), marks(g2)


def _navigation_case(p):
    g = p.AncestralBase(ebunch=[("A", "B", "-", ">"), ("C", "B", "-", ">"), ("B", "D", "-", ">"),
                                ("B", "E", ">", ">")])
    return (g.get_parents("B"), g.get_children("B"), g.get_spouses("B"), g.get_neighbors("B"),
            g.get_neighbors("B", u_type=">", v_type=">"), g.get_neighbors("Z"))


def _ancestry_case(p):
    g = p.AncestralBase(ebunch=[("A", "B", "-", ">"), ("B", "C", "-", ">"), ("C", "D", "-", ">"),
                                ("E", "C", "-", ">"), ("A", "F", "o", "o"), ("F", "G", "o", "o")])
    return (g.get_ancestors("D"), g.get_ancestors("A"), g.get_descendants("A"),
            g.get_reachable_nodes("A", v_type=">"),
            g.get_reachable_nodes("A", u_type="o", v_type="o"))


def _eq_copy_case(p):
    g = p.AncestralBase(ebunch=[("A", "B", "-", ">")], latents={"A"},
                        roles={"exposure": ["A"]})
    h = g.copy()
    same = g == h
    h.add_edge("B", "C", "-", ">")
    return same, g == h, g == 3, h.get_role_dict(), h.latents


def _mag_constructors_case(p):
    mag = p.MAG(directed_ebunch=[("a", "b")], bidirected_ebunch=[("b", "c")],
                undirected_ebunch=[("d", "e")])
    return (mag.is_ancestral(), mag.directed_edge_list(), mag.bidirected_edge_list(),
            mag.undirected_edge_list(), marks(mag))


def _collider_case(p):
    mag = p.MAG()
    mag.add_edge("X", "Z", "-", ">")
    mag.add_edge("Y", "Z", "-", ">")
    mag.add_edge("Y", "W", "-", ">")
    return mag._is_collider("X", "Z", "Y"), mag._is_collider("Z", "Y", "W")


def _inducing_case(p):
    a = p.MAG()
    a.add_edge("X", "L", "-", ">")
    a.add_edge("Y", "L", "-", ">")
    a.latents = {"L"}
    b = p.MAG()
    b.add_edge("X", "M", "-", ">")
    b.add_edge("M", "Y", "-", ">")
    return (a.has_inducing_path("X", "Y", a.latents), a.has_inducing_path("X", "Y", set()),
            b.has_inducing_path("X", "Y", set()), b.has_inducing_path("X", "M", set()))


def _visible_case(p):
    mag = p.MAG(ebunch=[("A", "D", "-", ">"), ("B", "C", "-", ">"), ("X", "A", "-", ">")])
    return [mag.is_visible_edge(u, v) for u, v in
            (("A", "D"), ("B", "C"), ("X", "A"), ("D", "A"), ("A", "C"))]


def _lower_case(p):
    mag = p.MAG()
    mag.add_edge("A", "B", "-", ">")
    mag.add_edge("A", "C", "-", ">")
    mag.add_edge("C", "B", "-", ">")
    mag.add_edge("B", "C", ">", ">")
    new = mag.lower_manipulation({"A"})
    return marks(new), marks(mag)


def _upper_case(p):
    mag = p.MAG()
    mag.add_edge("X", "Y", ">", "-")
    mag.add_edge("Z", "X", ">", "-")
    mag.add_edge("A", "X", "-", ">")
    new = mag.upper_manipulation({"X"})
    mag.upper_manipulation({"X"}, inplace=True)
    return marks(new), marks(mag)


def _mseparation_case(p):
    mag = p.MAG(ebunch=[("X", "M", "-", ">"), ("M", "Y", "-", ">")])
    mag2 = p.MAG(ebunch=[("X", "Y", ">", ">")])
    mag3 = p.MAG(ebunch=[("X", "S", "-", "-"), ("S", "Y", "-", "-")])
    return (mag.is_mseparated("X", "Y"), mag.is_mseparated("X", "Y", ["M"]),
            mag2.is_mseparated("X", "Y"), mag3.is_mseparated("X", "Y"),
            mag3.is_mseparated("X", "Y", ["S"]))


def _ancestral_maximal_case(p):
    bad = p.MAG()
    bad.add_edge("a", "b", "-", ">")
    bad.add_edge("a", "c", ">", ">")
    bad.add_edge("b", "c", "-", ">")
    cyclic = p.MAG(directed_ebunch=[("a", "b"), ("b", "c"), ("c", "a")])
    chain = p.MAG(ebunch=[("X", "M", "-", ">"), ("M", "Y", "-", ">")])
    return bad.is_ancestral(), cyclic.is_ancestral(), chain.is_maximal(), chain.is_ancestral()


def _admg_case(p):
    admg = p.ADMG(directed_ebunch=[("A", "B"), ("B", "C")],
                  bidirected_ebunch=[("A", "C"), ("C", "D")], latents=["D"])
    dag = admg.to_canonical_dag()
    copy = admg.copy()
    return (admg.get_parents("B"), admg.get_spouses("C"), sorted(map(sorted, admg.districts())),
            sorted(admg.district("A")), edges(dag), sorted(dag.latents),
            admg.is_mseparated("A", "C", ["B"]), admg.m_separations(),
            sorted(copy.bidirected_edges, key=sorted), edges(copy))


def _admg_cycle_case(p):
    return p.ADMG(directed_ebunch=[("A", "B"), ("B", "A")])


def _backdoor_games_case(p):
    out = []
    for ebunch, latents, x, y, sets in [
        ([("X", "A"), ("A", "Y"), ("X", "Y")], [], "X", "Y", [[]]),
        ([("Z", "X"), ("Z", "Y"), ("X", "Y")], [], "X", "Y", [[], ["Z"]]),
        ([("X", "C"), ("Y", "C"), ("X", "Y")], [], "X", "Y", [[], ["C"]]),
        ([("U1", "Z"), ("U2", "Z"), ("U1", "X"), ("U2", "Y"), ("X", "Y")], ["U1", "U2"], "X",
         "Y", [[], ["Z"]]),
    ]:
        ci = p.CausalInference(p.BN(ebunch, latents=set(latents)))
        out.append([ci.is_valid_backdoor_adjustment_set(x, y, Z=s) for s in sets])
        out.append(outcome(lambda _: ci.get_all_backdoor_adjustment_sets(x, y), p))
        out.append(ci.get_minimal_adjustment_set(x, y))
        out.append(ci.is_valid_adjustment_set(x, y, []))
    return out


def _frontdoor_case(p):
    ci = p.CausalInference(p.BN([("X", "M"), ("M", "Y"), ("U", "X"), ("U", "Y")],
                                latents={"U"}))
    smoking = p.CausalInference(p.DAG(
        [("u", "smoking"), ("u", "cancer"), ("smoking", "tar"), ("tar", "cancer")],
        latents=["u"]))
    return (ci.is_valid_frontdoor_adjustment_set("X", "Y", Z=["M"]),
            ci.is_valid_frontdoor_adjustment_set("X", "Y", Z="M"),
            ci.get_all_frontdoor_adjustment_sets("X", "Y"),
            smoking.get_all_frontdoor_adjustment_sets("smoking", "cancer"),
            outcome(lambda _: smoking.get_all_backdoor_adjustment_sets("smoking", "cancer"), p),
            edges(smoking.get_proper_backdoor_graph(["smoking"], ["cancer"])))


def _iv_case(p):
    out = []
    for ebunch, latents in [
        ([("I", "X"), ("X", "Y"), ("U", "X"), ("U", "Y")], ["U"]),
        ([("I", "X"), ("X", "Y"), ("U", "X"), ("U", "Y"), ("W", "I"), ("W", "Y")], ["U"]),
        ([("I", "X"), ("I", "Y"), ("X", "Y"), ("U", "X"), ("U", "Y")], ["U"]),
        ([("i", "x"), ("u", "x"), ("u", "y"), ("x", "y")], ["u"]),
    ]:
        ci = p.CausalInference(p.BN(ebunch, latents=set(latents)))
        x, y = ("X", "Y") if "X" in ci.dag else ("x", "y")
        out.append(outcome(lambda _: ci.get_ivs(x, y), p))
        out.append(outcome(lambda _: ci.get_conditional_ivs(x, y), p))
        out.append(outcome(lambda _: ci.get_total_conditional_ivs(x, y), p))
        out.append(outcome(lambda _: ci.identification_method(x, y), p))
    return out


def _identification_case(p):
    out = []
    for ebunch, latents, roles in [
        ([("x1", "y1"), ("x1", "z1"), ("z1", "z2"), ("z2", "x2"), ("y2", "z2")], [],
         {"exposure": "x1", "outcome": "y1"}),
        ([("z", "x"), ("z", "y"), ("x", "y")], [], {"exposure": "x", "outcome": "y"}),
        ([("w", "z"), ("z", "x"), ("z", "y"), ("x", "y")], [], {"exposure": "x", "outcome": "y"}),
        ([("u", "x"), ("u", "y"), ("x", "y")], ["u"], {"exposure": "x", "outcome": "y"}),
        ([("u", "s"), ("u", "c"), ("s", "t"), ("t", "c")], ["u"],
         {"exposure": "s", "outcome": "c"}),
        ([("x1", "y"), ("x2", "y")], [], {"exposure": ["x1", "x2"], "outcome": "y"}),
        ([("a", "b")], [], {}),
    ]:
        dag = p.DAG(ebunch, latents=latents, roles=roles)
        for strategy in (p.Adjustment("minimal"), p.Adjustment("all"),
                         p.Adjustment("minimal_variance"), p.Frontdoor(), p.Frontdoor("all")):
            res = outcome(lambda _: strategy.identify(dag), p)
            if res[0] != "raises":
                graphs, success = res
                graphs = graphs if isinstance(graphs, list) else [graphs]
                res = (success, [g.get_role_dict() for g in graphs])
            out.append(res)
        out.append(outcome(lambda _: p.Adjustment().validate(dag), p))
    out.append(outcome(lambda _: p.Adjustment("nonsense"), p))
    out.append(outcome(lambda _: p.Adjustment().identify(p.UndirectedGraph([("a", "b")])), p))
    return out


GRAPH_CASES = {
    "ancestral_marks": _marks_case,
    "ancestral_invalid_mark": lambda p: p.AncestralBase().add_edge("A", "B", "-", "x"),
    "ancestral_self_loop": lambda p: p.AncestralBase().add_edge("A", "A", "-", ">"),
    "ancestral_circle_marks": lambda p: marks(p.AncestralBase(ebunch=[("C", "D", "o", "o")])),
    "ancestral_adjacency_roundtrip": _adjacency_case,
    "ancestral_navigation": _navigation_case,
    "ancestral_ancestry": _ancestry_case,
    "ancestral_eq_copy": _eq_copy_case,
    "mag_circle_rejected": lambda p: p.MAG(ebunch=[("A", "B", "o", ">")]),
    "mag_constructors": _mag_constructors_case,
    "mag_collider": _collider_case,
    "mag_inducing_paths": _inducing_case,
    "mag_visible_edges": _visible_case,
    "mag_lower_manipulation": _lower_case,
    "mag_upper_manipulation": _upper_case,
    "mag_mseparation": _mseparation_case,
    "mag_ancestral_maximal": _ancestral_maximal_case,
    "admg": _admg_case,
    "admg_cycle_rejected": _admg_cycle_case,
    "backdoor_games": _backdoor_games_case,
    "frontdoor": _frontdoor_case,
    "instrumental_variables": _iv_case,
    "identification_strategies": _identification_case,
}


@pytest.mark.parametrize("name", sorted(GRAPH_CASES))
def test_graph_case(name):
    want = outcome(GRAPH_CASES[name], JAX)
    assert outcome(GRAPH_CASES[name], PORT) == want


def random_mixed_edges(seed, n=8):
    """(directed, bidirected) edges of a random acyclic mixed graph over
    N0..N{n-1}: a random DAG plus a few bidirected edges between
    non-adjacent pairs, each kept only if no endpoint is an ancestor of the
    other (so the graph stays ancestral)."""
    rng = np.random.default_rng(seed)
    names = [f"N{i}" for i in range(n)]
    directed = [(names[i], names[j]) for i in range(n) for j in range(i + 1, n)
                if rng.random() < 0.3]
    dag = nx.DiGraph(directed)
    dag.add_nodes_from(names)
    bidirected = []
    for i, j in rng.permutation([(i, j) for i in range(n) for j in range(i + 1, n)])[:6]:
        u, v = names[i], names[j]
        if dag.has_edge(u, v) or nx.has_path(dag, u, v) or nx.has_path(dag, v, u):
            continue
        bidirected.append((u, v))
    return names, directed, bidirected


def _random_mag_outputs(p, seed):
    names, directed, bidirected = random_mixed_edges(seed)
    mag = p.MAG(directed_ebunch=directed, bidirected_ebunch=bidirected)
    mag.add_nodes_from(names)
    rng = np.random.default_rng(seed + 100)
    triples = [(names[a], names[b], [names[c] for c in rng.choice(8, size=2, replace=False)
                                     if c not in (a, b)])
               for a, b in rng.choice(8, size=(12, 2)) if a != b]
    dag, selection = mag.to_canonical_dag()
    X = {names[int(rng.integers(8))]}
    return (
        mag.is_ancestral(),
        [mag.has_inducing_path(u, v, set(names[:3])) for u, v in itertools.combinations(names, 2)],
        [mag.is_visible_edge(u, v) for u, v in mag.directed_edge_list()],
        marks(mag.lower_manipulation(X)), marks(mag.upper_manipulation(X)),
        edges(dag), sorted(dag.latents), selection,
        [mag.is_mseparated(x, y, z) for x, y, z in triples],
    )


def _random_admg_outputs(p, seed):
    names, directed, bidirected = random_mixed_edges(seed)
    admg = p.ADMG(directed_ebunch=directed, bidirected_ebunch=bidirected)
    admg.add_nodes_from(names)
    rng = np.random.default_rng(seed + 200)
    conds = [[names[c] for c in rng.choice(8, size=int(rng.integers(0, 4)), replace=False)]
             for _ in range(10)]
    return (admg.m_separations(), sorted(map(sorted, admg.districts())),
            [admg.is_mseparated(x, y, [c for c in z if c not in (x, y)])
             for (x, y), z in zip(itertools.combinations(names, 2), conds)],
            edges(admg.to_canonical_dag()), [admg.get_spouses(n) for n in names])


@pytest.mark.parametrize("seed", range(4))
def test_random_mag(seed):
    assert _random_mag_outputs(PORT, seed) == _random_mag_outputs(JAX, seed)


@pytest.mark.parametrize("seed", range(4))
def test_random_admg(seed):
    assert _random_admg_outputs(PORT, seed) == _random_admg_outputs(JAX, seed)


# --------------------------------------------------------------------------- #
# the parser and the teaching DAGs
# --------------------------------------------------------------------------- #
LAVAAN = [
    "y ~ x1 + x2\nx2 ~ x1",
    "f =~ i1 + 0.7*i2 + i3  # measurement\ny ~ f + z ! comment\nz ~~ y\n",
    ["dem60 =~ y1 + y2", "dem60 ~ ind60", "", "ind60 =~ x1"],
]
DAGITTY = [
    "dag { x -> y; u [latent]; u -> x; u -> y }",
    'dag {\n"a b" [exposure,pos="1,2"]\nc [outcome]\n"a b" -> m -> c\nc <- z -> m\n}',
    "dag { a -> b -> c <- d; a <-> d }",
    ["dag {", "x [unobserved]", "x -> y", "}"],
]


def test_parsers():
    for text in LAVAAN:
        got = PORT.parser.parse_lavaan(text)
        assert got == JAX.parser.parse_lavaan(text)
        assert edges(PORT.DAG(lavaan_str=text)) == edges(JAX.DAG(lavaan_str=text))
    for text in DAGITTY:
        got = PORT.parser.parse_dagitty(text)
        assert got == JAX.parser.parse_dagitty(text)
        port, ref = PORT.DAG(dagitty_str=text), JAX.DAG(dagitty_str=text)
        assert edges(port) == edges(ref) and port.latents == ref.latents
    text = "\n".join(LAVAAN[1:2])
    assert edges(PORT.DAG.from_lavaan(string=text)) == edges(JAX.DAG.from_lavaan(string=text))
    lgbn = PORT.LGBN(lavaan_str=LAVAAN[0])
    assert edges(lgbn) == edges(JAX.LGBN(lavaan_str=LAVAAN[0]))


def teaching_dag(p, name):
    """A teaching DAG with its exposure and outcome roles, read from the
    dagitty file's node attributes (the parser reads latents only)."""
    with open(os.path.join(_EXAMPLE_DIR, f"{name}.txt")) as fh:
        text = fh.read()
    roles = {r: re.search(r"^(\S+) \[" + r, text, re.M).group(1) for r in ("exposure", "outcome")}
    return p.example(name).with_role("exposure", [roles["exposure"]], inplace=False) \
        .with_role("outcome", [roles["outcome"]], inplace=False)


def _teaching_outputs(p, name):
    dag = teaching_dag(p, name)
    x, y = dag.get_role("exposure")[0], dag.get_role("outcome")[0]
    ci = p.CausalInference(dag)
    small = len(set(dag.observed) - {x, y}) <= 7
    out = [edges(dag), sorted(dag.latents),
           [(s, g.get_role_dict()) for g, s in [p.Adjustment("minimal")(dag)]],
           ci.get_minimal_adjustment_set(x, y),
           outcome(lambda _: p.Adjustment("minimal_variance")(dag)[1], p)]
    if small:  # power-set enumerations: only where they end quickly
        found, success = p.Adjustment("all")(dag)
        out += [success, sorted(map(sorted, (g.get_role("adjustment") for g in found)))
                if success else None]
        found, success = p.Frontdoor("all")(dag)
        out += [success, outcome(lambda _: ci.get_all_backdoor_adjustment_sets(x, y), p),
                ci.get_all_frontdoor_adjustment_sets(x, y)]
    return out


@pytest.mark.parametrize("name", sorted(DAG_MODELS))
def test_teaching_dag(name):
    assert _teaching_outputs(PORT, name) == _teaching_outputs(JAX, name)


# --------------------------------------------------------------------------- #
# do-queries
# --------------------------------------------------------------------------- #
def assert_factor_equal(port, ref, rtol=1e-5, atol=1e-6):
    assert list(port.variables) == list(ref.variables)
    for v in ref.variables:
        assert list(port.state_names[v]) == list(ref.state_names[v])
    np.testing.assert_allclose(np_values(port.values), np_values(ref.values), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def alarm_pair():
    return PORT.example("alarm"), JAX.example("alarm")


ALARM_QUERIES = [
    dict(variables=["BP"], do={"CATECHOL": "HIGH"}),
    dict(variables=["BP", "HR"], do={"CATECHOL": "NORMAL"}, evidence={"TPR": "LOW"}),
    dict(variables=["BP"], do={"CATECHOL": "HIGH"}, evidence={"HRBP": "HIGH"}),
    dict(variables=["BP"], do={"CATECHOL": "HIGH"},
         evidence={"SAO2": "NORMAL", "CVP": "LOW"}),
    dict(variables=["HRBP"], do={"CATECHOL": "HIGH", "TPR": "HIGH"}),
]


@pytest.mark.parametrize("algo", ["ve", "bp"])
@pytest.mark.parametrize("case", range(len(ALARM_QUERIES)))
def test_alarm_do_query(alarm_pair, case, algo):
    """Evidence inside the adjustment set pins it, evidence outside only
    weighs it; two do variables, one a parent of the other."""
    port, ref = alarm_pair
    q = ALARM_QUERIES[case]
    got = PORT.CausalInference(port).query(inference_algo=algo, **q)
    assert_factor_equal(got, JAX.CausalInference(ref).query(inference_algo=algo, **q))


def test_alarm_do_query_is_one_batched_query(alarm_pair, monkeypatch):
    from pgmpy_tpu_torch.inference.ve import VariableElimination

    calls = []
    original = VariableElimination._query_batch_masked

    def counted(self, variables, evidence):
        calls.append(len(next(iter(evidence.values()))))
        return original(self, variables, evidence)

    monkeypatch.setattr(VariableElimination, "_query_batch_masked", counted)
    port, _ = alarm_pair
    assert sorted(port.get_parents("CATECHOL")) == ["ARTCO2", "INSUFFANESTH", "SAO2", "TPR"]
    PORT.CausalInference(port).query(["BP"], do={"CATECHOL": "HIGH"})
    assert calls == [54]


def zero_combination_model(pkg_bn, cpd_cls):
    """W -> X <- Z -> Y <- X: P(X = x1 | Z = z0, W = w0) = 0, so the
    combination (w0, z0) of do(X = x1) has positive weight and inner evidence
    of probability 0."""
    model = pkg_bn([("W", "X"), ("Z", "X"), ("Z", "Y"), ("X", "Y")])
    model.add_cpds(
        cpd_cls("W", 2, [[0.4], [0.6]]),
        cpd_cls("Z", 2, [[0.3], [0.7]]),
        cpd_cls("X", 2, [[1.0, 0.6, 0.5, 0.2], [0.0, 0.4, 0.5, 0.8]], evidence=["W", "Z"],
                evidence_card=[2, 2]),
        cpd_cls("Y", 2, [[0.9, 0.5, 0.4, 0.1], [0.1, 0.5, 0.6, 0.9]], evidence=["X", "Z"],
                evidence_card=[2, 2]),
    )
    return model


@pytest.mark.parametrize("algo", ["ve", "bp"])
def test_zero_probability_combination(algo):
    from pgmpy_tpu.factors import TabularCPD as JaxCPD
    from pgmpy_tpu_torch.factors import TabularCPD
    from pgmpy_tpu_torch.inference import BeliefPropagation, VariableElimination

    port = zero_combination_model(PORT.BN, TabularCPD)
    ref = zero_combination_model(JAX.BN, JaxCPD)
    for do in ({"X": 1}, {"X": 0}):
        want = JAX.CausalInference(ref).query(["Y"], do=do, inference_algo=algo)
        got = PORT.CausalInference(port).query(["Y"], do=do, inference_algo=algo)
        loop_cls = type("Loop", ({"ve": VariableElimination, "bp": BeliefPropagation}[algo],),
                        {"query_batch": None})
        loop = PORT.CausalInference(port).query(["Y"], do=do, inference_algo=loop_cls)
        assert np.isnan(np_values(want.values)).all() == (do == {"X": 1})
        for factor in (got, loop):
            same_nan = np.isnan(np_values(factor.values)) == np.isnan(np_values(want.values))
            assert same_nan.all()
            assert_factor_equal(factor, want)


def test_query_edge_cases():
    from pgmpy_tpu.factors import TabularCPD as JaxCPD
    from pgmpy_tpu_torch.factors import TabularCPD

    port = zero_combination_model(PORT.BN, TabularCPD)
    ref = zero_combination_model(JAX.BN, JaxCPD)
    for kwargs in (dict(variables=["Y"]), dict(variables=["Y"], evidence={"X": 0}),
                   dict(variables=["X"], do={"W": 0}), dict(variables=["Y"], do={"X": 0},
                                                            adjustment_set=["Z"]),
                   dict(variables=["Y"], do={"X": 0}, evidence={"Z": 1, "W": 0})):
        assert_factor_equal(PORT.CausalInference(port).query(**kwargs),
                            JAX.CausalInference(ref).query(**kwargs))
    for bad in (dict(variables="Y", do={"X": 0}), dict(variables=["Y"], do={"X": 0},
                                                       inference_algo="nonsense"),
                dict(variables=["Z"], do={"X": 0})):
        assert (outcome(lambda p: p.CausalInference(port if p is PORT else ref).query(**bad),
                        PORT) == outcome(lambda p: p.CausalInference(
                            port if p is PORT else ref).query(**bad), JAX))
    latent = [outcome(lambda q: q.CausalInference(q.BN([("U", "X"), ("X", "Y")], latents={"U"}))
                      .query(["Y"], do={"X": 0}), p) for p in (PORT, JAX)]
    assert latent[0] == latent[1]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_do_query_is_the_truncated_factorisation_in_float64(seed):
    """P(Y | do(X = x)) with the adjustment set X's parents is the
    truncated factorisation: X's CPD replaced by a point mass on x, summed
    over every other variable (numpy einsum over the joint)."""
    names, edge_list, tables = random_bn_tables(seed, n_nodes=7)
    config.set_dtype(torch.float64)
    try:
        model = bn_from_numpy(edge_list, tables, nodes=names)
        do_var = next(v for v in names[2:] if len(model.get_parents(v)) >= 2)
        target = names[-1] if names[-1] != do_var else names[-2]
        states = model.states[do_var]
        ci = PORT.CausalInference(model)
        for k, state in enumerate(states):
            got = ci.query([target], do={do_var: state})
            letters = {v: chr(ord("a") + i) for i, v in enumerate(names)}
            operands, subs = [], []
            for cpd in model.get_cpds():
                if cpd.variable == do_var:
                    delta = np.zeros(len(states))
                    delta[k] = 1.0
                    operands.append(delta)
                    subs.append(letters[do_var])
                else:
                    operands.append(np_values(cpd.values))
                    subs.append("".join(letters[v] for v in cpd.variables))
            want = np.einsum(",".join(subs) + "->" + letters[target], *operands)
            assert got.values.dtype == torch.float64
            np.testing.assert_allclose(np_values(got.values), want / want.sum(), rtol=0,
                                       atol=1e-12)
    finally:
        config.set_dtype(torch.float32)


@pytest.mark.slow
def test_munin_do_query_batched_against_the_loop():
    from pgmpy_tpu_torch.inference import BeliefPropagation

    munin = PORT.example("munin")
    do_var = "R_LNLW_APB_MUSIZE"
    child = sorted(munin.get_children(do_var))[0]
    state = munin.states[do_var][1]
    ci = PORT.CausalInference(munin)
    got = ci.query([child], do={do_var: state}, inference_algo="bp")
    loop_cls = type("Loop", (BeliefPropagation,), {"query_batch": None})
    want = ci.query([child], do={do_var: state}, inference_algo=loop_cls)
    assert_factor_equal(got, want)


# --------------------------------------------------------------------------- #
# linear estimators and the shared solve
# --------------------------------------------------------------------------- #
def confounded_frame(seed=0, n=4000):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=n)
    w = rng.normal(size=n)
    x = 0.8 * z + 0.3 * w + 0.5 * rng.normal(size=n)
    m = 0.9 * x + 0.5 * rng.normal(size=n)
    y = 2.0 * m + 1.5 * z + 0.5 * rng.normal(size=n)
    return pd.DataFrame({"x": x, "y": y, "z": z, "w": w, "m": m})


ATE_EDGES = [("z", "x"), ("z", "y"), ("w", "x"), ("x", "m"), ("m", "y")]


@pytest.mark.parametrize("strategy", ["smallest", "all", frozenset({"z"})])
def test_estimate_ate(strategy):
    df = confounded_frame()
    got = PORT.CausalInference(PORT.DAG(ATE_EDGES)).estimate_ate(
        "x", "y", df, estimand_strategy=strategy)
    want = JAX.CausalInference(JAX.DAG(ATE_EDGES)).estimate_ate(
        "x", "y", df, estimand_strategy=strategy)
    assert got == pytest.approx(want, rel=1e-9)
    for bad in (dict(estimator_type="nonsense"), dict(estimand_strategy="best"),
                dict(estimand_strategy=frozenset({"m"}))):
        assert outcome(lambda p: p.CausalInference(p.DAG(ATE_EDGES)).estimate_ate(
            "x", "y", df, **bad), PORT) == outcome(
            lambda p: p.CausalInference(p.DAG(ATE_EDGES)).estimate_ate("x", "y", df, **bad), JAX)


@pytest.mark.parametrize("missing", ["none", "drop", "raise"])
def test_linear_estimator(missing):
    df = confounded_frame(seed=1)
    if missing != "none":
        df.loc[[3, 17], "z"] = np.nan
    outs = []
    for p in (PORT, JAX):
        res = outcome(lambda q: q.LinearEstimator(None).fit("x", "y", Z=["z", "w"], data=df,
                                                            missing=missing).summary(), p)
        outs.append(res)
    if isinstance(outs[1], tuple):  # both raise
        assert outs[0] == outs[1]
        return
    got, want = outs
    assert got["ate"] == pytest.approx(want["ate"], rel=1e-9)
    np.testing.assert_allclose(got["coef"], want["coef"], rtol=1e-9)
    assert got["resid_std"] == pytest.approx(want["resid_std"], rel=1e-9)


def test_naive_adjustment_regressor():
    from sklearn.linear_model import Ridge

    df = confounded_frame(seed=2)
    weights = np.random.default_rng(3).uniform(0.5, 2.0, len(df))
    roles = {"exposure": "x", "outcome": "y", "adjustment": ["z"], "pretreatment": ["w"]}
    X, y = df.drop(columns=["y"]), df["y"]
    for estimator in (None, Ridge(alpha=0.5)):
        fitted = []
        for p in (PORT, JAX):
            reg = p.prediction.NaiveAdjustmentRegressor(
                causal_graph=p.DAG(ATE_EDGES, roles=roles), estimator=estimator)
            reg.fit(X, y, sample_weight=weights)
            fitted.append((reg.feature_columns_, reg.predict(X.iloc[:50]),
                           reg.score(X, y, sample_weight=weights), reg.explanation_,
                           list(reg.get_feature_names_out())))
        (cols, pred, score, text, names), (w_cols, w_pred, w_score, w_text, w_names) = fitted
        assert cols == w_cols and text == w_text and names == w_names
        np.testing.assert_allclose(pred, w_pred, rtol=1e-9)
        assert score == pytest.approx(w_score, rel=1e-9)
    reg = PORT.prediction.NaiveAdjustmentRegressor(causal_graph=PORT.DAG(ATE_EDGES, roles=roles))
    reg.fit(X, y)
    with pytest.raises(ValueError, match="Missing required columns"):
        reg.predict(X.drop(columns=["z"]))


@pytest.mark.parametrize("shape, rank", [((50, 4), 4), ((50, 4), 2), ((3, 6), 3), ((3, 6), 2)])
def test_lstsq_is_the_minimum_norm_solution(shape, rank):
    import jax.numpy as jnp

    rng = np.random.default_rng(sum(shape) + rank)
    a = rng.normal(size=(shape[0], rank)) @ rng.normal(size=(rank, shape[1]))
    b = rng.normal(size=(shape[0], 2))
    got = lstsq(a, b)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.linalg.lstsq(a, b, rcond=None)[0], rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(lstsq(a, b[:, 0]).numpy(), got[:, 0].numpy(), rtol=1e-12)
    want32 = np.asarray(jnp.linalg.lstsq(jnp.asarray(a), jnp.asarray(b))[0])
    np.testing.assert_allclose(got.numpy(), want32, rtol=1e-3, atol=1e-4)
