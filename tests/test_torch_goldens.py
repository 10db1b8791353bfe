"""The reference-pgmpy goldens against the port.

``reference_goldens_v2.json`` and ``reference_goldens_extras.json`` hold
outputs of the reference pgmpy library.  Their posterior, MAP and
virtual-evidence cases run here through the port's VariableElimination and
BeliefPropagation at the tolerance the JAX package's own golden tests use
(atol 2e-6); the Bayesian-estimator goldens run through the port's
``BayesianEstimator`` on the exact frame the reference saw.

The goldens of the score-based structure searches and of the temporal classes
run through the port too, with the assertions of the JAX package's golden
tests: ``reference_goldens_v4.json`` (Gaussian and conditional-Gaussian
scores, HillClimbSearch, TreeSearch, ExhaustiveSearch), ``_v5`` (structure
scores of whole networks, ``DynamicBayesianNetwork.fit``), ``_v7``
(``get_constant_bn``) and the DBN inference cases of ``_extras``."""

import filecmp
import json
import os

import numpy as np
import pytest

from _golden_data import (
    DBN_2TBN_EDGES,
    GAUSSIAN_FRAME_EDGES,
    standalone_dbn_frame,
    standalone_gaussian_frame,
    standalone_mixed_frame,
    standalone_sample,
)
from _torch_parity import np_values
from pgmpy_tpu_torch import estimators
from pgmpy_tpu_torch.base import DAG
from pgmpy_tpu_torch.estimators import (
    BayesianEstimator,
    ExhaustiveSearch,
    HillClimbSearch,
    TreeSearch,
    get_scoring_method,
)
from pgmpy_tpu_torch.factors import TabularCPD
from pgmpy_tpu_torch.inference import BeliefPropagation, DBNInference, VariableElimination
from pgmpy_tpu_torch.models import DynamicBayesianNetwork, LinearGaussianBayesianNetwork
from pgmpy_tpu_torch.utils import get_example_model
from pgmpy_tpu_torch.utils.utils import _EXAMPLE_DIR, DISCRETE_MODELS, GAUSSIAN_MODELS

HERE = os.path.dirname(os.path.abspath(__file__))
with open(os.path.join(HERE, "reference_goldens_v2.json")) as fh:
    V2 = json.load(fh)
with open(os.path.join(HERE, "reference_goldens_extras.json")) as fh:
    EXTRAS = json.load(fh)
with open(os.path.join(HERE, "reference_goldens_v4.json")) as fh:
    V4 = json.load(fh)
with open(os.path.join(HERE, "reference_goldens_v5.json")) as fh:
    V5 = json.load(fh)
with open(os.path.join(HERE, "reference_goldens_v7.json")) as fh:
    V7 = json.load(fh)

ENGINES = {"ve": VariableElimination, "bp": BeliefPropagation}


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("name", sorted(V2))
def test_v2_posteriors(name, engine):
    infer = ENGINES[engine](get_example_model(name))
    for case in V2[name]["bp_queries"]:
        phi = infer.query([case["variable"]], evidence=case["evidence"], show_progress=False)
        assert [str(s) for s in phi.state_names[case["variable"]]] == case["states"]
        np.testing.assert_allclose(np_values(phi.values), np.asarray(case["values"]),
                                   atol=2e-6, err_msg=str(case))


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("name", sorted(V2))
def test_v2_map_queries(name, engine):
    infer = ENGINES[engine](get_example_model(name))
    for case in V2[name]["bp_queries"]:
        got = infer.map_query([case["variable"]], evidence=case["evidence"], show_progress=False)
        assert str(got[case["variable"]]) == case["map"], case


@pytest.mark.parametrize("name", sorted(V2))
def test_v2_staged_elimination(name):
    """The same posteriors through the staged loop (MinFill order)."""
    infer = VariableElimination(get_example_model(name))
    for case in V2[name]["bp_queries"]:
        phi = infer.query([case["variable"]], evidence=case["evidence"],
                          elimination_order="MinFill", show_progress=False)
        np.testing.assert_allclose(np_values(phi.values), np.asarray(case["values"]),
                                   atol=2e-6, err_msg=str(case))


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_extras_virtual_evidence(engine):
    entry = EXTRAS["virtual_evidence"]
    model = get_example_model(entry["network"])
    virt = TabularCPD(
        entry["virtual"]["variable"], 2, [[v] for v in entry["virtual"]["values"]],
        state_names={entry["virtual"]["variable"]: entry["virtual"]["states"]},
    )
    infer = ENGINES[engine](model)
    for case in entry["cases"]:
        phi = infer.query([case["variable"]], evidence=case["evidence"] or None,
                          virtual_evidence=[virt], show_progress=False)
        assert [str(s) for s in phi.state_names[case["variable"]]] == case["states"]
        np.testing.assert_allclose(np_values(phi.values), np.asarray(case["values"]),
                                   atol=2e-6, err_msg=f"{engine}: {case}")


@pytest.mark.parametrize("name", sorted(EXTRAS["bayesian_estimator"]))
def test_extras_bayesian_estimator(name):
    entry = EXTRAS["bayesian_estimator"][name]
    model = get_example_model(name)
    df = standalone_sample(model, entry["n_rows"], seed=entry["data_seed"])
    estimator = BayesianEstimator(model, df)
    for node, want in entry["cpds"].items():
        bdeu = estimator.estimate_cpd(node, prior_type="BDeu", equivalent_sample_size=10)
        assert [str(v) for v in bdeu.variables[1:]] == want["evidence"]
        np.testing.assert_allclose(bdeu.get_values().astype(np.float64).ravel(),
                                   np.asarray(want["bdeu"]), atol=2e-6, err_msg=node)
        k2 = estimator.estimate_cpd(node, prior_type="K2")
        np.testing.assert_allclose(k2.get_values().astype(np.float64).ravel(),
                                   np.asarray(want["k2"]), atol=2e-6, err_msg=node)


@pytest.mark.parametrize("name", sorted(DISCRETE_MODELS) + sorted(GAUSSIAN_MODELS))
def test_example_network_is_a_copy_of_the_jax_packages(name):
    """The port ships its own example networks, discrete and Gaussian: each
    file is byte-identical to the JAX package's."""
    file = f"{name}.bif.gz" if name in DISCRETE_MODELS else f"{name}.json"
    mine = os.path.join(_EXAMPLE_DIR, file)
    theirs = os.path.join(os.path.dirname(HERE), "pgmpy_tpu", "utils", "example_models", file)
    assert os.path.dirname(mine).endswith(os.path.join("pgmpy_tpu_torch", "utils", "example_models"))
    assert filecmp.cmp(mine, theirs, shallow=False)


# --------------------------------------------------------------------------- #
# score-based structure search (v4, v5)
# --------------------------------------------------------------------------- #
def dag_edges(graph):
    return sorted([str(u), str(v)] for u, v in graph.edges())


def assert_search_parity(dag, golden_edges, df, scorer_cls):
    """The reference's HillClimb enumerates additions from a hash-ordered
    set, so score-equivalent orientations flip between its runs: the
    skeleton must match, and the learned DAG must score exactly as well as
    the reference's under the port's scorer."""
    skeleton = {frozenset((str(u), str(v))) for u, v in dag.edges()}
    assert skeleton == {frozenset(e) for e in golden_edges}
    scorer = scorer_cls(df)

    def total(edge_list):
        graph = DAG()
        graph.add_nodes_from(df.columns)
        graph.add_edges_from(edge_list)
        return sum(scorer.local_score(n, list(graph.predecessors(n))) for n in graph.nodes())

    assert total(dag.edges()) == pytest.approx(total([tuple(e) for e in golden_edges]), rel=1e-9)


@pytest.fixture(scope="module")
def gauss_df():
    return standalone_gaussian_frame(V4["gauss"]["n_rows"], seed=2027)


@pytest.fixture(scope="module")
def mixed_df():
    return standalone_mixed_frame(V4["condgauss"]["n_rows"], seed=2028)


@pytest.mark.parametrize("cls, key", [("LogLikelihoodGauss", "ll_g"), ("BICGauss", "bic_g"),
                                      ("AICGauss", "aic_g")])
def test_v4_gaussian_scores(gauss_df, cls, key):
    scorer = getattr(estimators, cls)(gauss_df)
    for case in V4["gauss"]["scores"]:
        assert scorer.local_score(case["variable"], case["parents"]) == pytest.approx(
            case[key], rel=1e-9), case


@pytest.mark.parametrize("cls, key", [("LogLikelihoodCondGauss", "ll_cg"),
                                      ("BICCondGauss", "bic_cg"), ("AICCondGauss", "aic_cg")])
def test_v4_conditional_gaussian_scores(mixed_df, cls, key):
    scorer = getattr(estimators, cls)(mixed_df)
    for case in V4["condgauss"]["scores"]:
        assert scorer.local_score(case["variable"], case["parents"]) == pytest.approx(
            case[key], rel=1e-9), case


def test_v4_hillclimb_bic_gauss(gauss_df):
    dag = HillClimbSearch(gauss_df).estimate(scoring_method="bic-g", show_progress=False)
    assert_search_parity(dag, V4["gauss"]["hillclimb_bicg_edges"], gauss_df, estimators.BICGauss)


def test_v4_hillclimb_bic_conditional_gauss(mixed_df):
    dag = HillClimbSearch(mixed_df).estimate(scoring_method="bic-cg", show_progress=False)
    assert_search_parity(dag, V4["condgauss"]["hillclimb_biccg_edges"], mixed_df,
                         estimators.BICCondGauss)


@pytest.fixture(scope="module", params=sorted(V4["discrete_search"]))
def search_net(request):
    golden = V4["discrete_search"][request.param]
    model = get_example_model(request.param)
    return golden, standalone_sample(model, golden["n_rows"], seed=2026)


def test_v4_hillclimb(search_net):
    golden, df = search_net
    dag = HillClimbSearch(df).estimate(scoring_method="bic-d", show_progress=False)
    assert_search_parity(dag, golden["hillclimb_bic_edges"], df, estimators.BIC)
    dag = HillClimbSearch(df).estimate(scoring_method="k2", show_progress=False)
    assert_search_parity(dag, golden["hillclimb_k2_edges"], df, estimators.K2)


def test_v4_chow_liu_and_tan(search_net):
    golden, df = search_net
    tree = TreeSearch(df, root_node=golden["chow_liu_root"]).estimate(
        estimator_type="chow-liu", show_progress=False)
    assert dag_edges(tree) == golden["chow_liu_edges"]
    tan = TreeSearch(df, root_node=golden["tan_root"]).estimate(
        estimator_type="tan", class_node=golden["tan_class"], show_progress=False)
    assert dag_edges(tan) == golden["tan_edges"]


def test_v4_exhaustive(search_net):
    golden, df = search_net
    if "exhaustive_edges" not in golden:
        pytest.skip("exhaustive search has no golden for this network")
    best = ExhaustiveSearch(df[golden["exhaustive_cols"]], use_cache=False).estimate()
    assert dag_edges(best) == golden["exhaustive_edges"]


@pytest.mark.parametrize("name", ["asia", "cancer"])
def test_v5_structure_scores(name):
    """``metrics.structure_score`` is ``scorer.score(model)``; the metrics
    module is outside the port so far, the scorers are not."""
    golden = V5["metrics"][name]
    model = get_example_model(name)
    df = standalone_sample(model, golden["n_rows"], seed=golden["data_seed"])
    for method in ["k2", "bdeu", "bds", "bic-d", "aic-d"]:
        scorer, _ = get_scoring_method(method, df, use_cache=False)
        assert float(scorer.score(model)) == pytest.approx(
            golden[f"structure_score_{method}"], rel=1e-9), method


def test_v5_gaussian_structure_scores():
    golden = V5["metrics"]["gaussian_frame"]
    df = standalone_gaussian_frame(2000, seed=2027)
    model = LinearGaussianBayesianNetwork(GAUSSIAN_FRAME_EDGES)
    for method in ["ll-g", "bic-g", "aic-g"]:
        scorer, _ = get_scoring_method(method, df, use_cache=False)
        assert float(scorer.score(model)) == pytest.approx(
            golden[f"structure_score_{method}"], rel=1e-9), method


# --------------------------------------------------------------------------- #
# the temporal classes (v5, v7, extras)
# --------------------------------------------------------------------------- #
def test_v5_dbn_fit():
    golden = V5["dbn_fit"]
    df = standalone_dbn_frame(golden["n_rows"], golden["n_slices"], seed=golden["seed"])
    dbn = DynamicBayesianNetwork(DBN_2TBN_EDGES)
    dbn.fit(df)
    ours = {(str(c.variable[0]), int(c.variable[1])): c for c in dbn.get_cpds()}
    assert len(ours) == len(golden["cpds"])
    for want in golden["cpds"]:
        cpd = ours[tuple(want["variable"])]
        ev_ours = [(str(v[0]), int(v[1])) for v in cpd.variables[1:]]
        ev_gold = [tuple(v) for v in want["evidence"]]
        assert sorted(map(str, ev_ours)) == sorted(map(str, ev_gold))
        values = np.asarray(want["values_2d"], dtype=np.float64)
        card = values.shape[0]
        cards = [len(want["state_names"][str(tuple(v))]) for v in want["evidence"]]
        full = np.transpose(values.reshape([card] + cards),
                            [0] + [1 + ev_gold.index(e) for e in ev_ours])
        # the port's tables are float32
        np.testing.assert_allclose(cpd.get_values().astype(np.float64), full.reshape(card, -1),
                                   atol=1e-6, err_msg=str(want["variable"]))


def test_v7_dbn_constant_bn():
    dbn = DynamicBayesianNetwork(DBN_2TBN_EDGES)
    dbn.fit(standalone_dbn_frame(1200, n_slices=3, seed=44))
    for t_key, want in V7["dbn_constant_bn"].items():
        unrolled = dbn.get_constant_bn(t_slice=int(t_key[1:]))
        assert sorted(map(str, unrolled.nodes())) == want["nodes"], t_key
        assert dag_edges(unrolled) == want["edges"], t_key
        for var, golden in want["cpds"].items():
            cpd = unrolled.get_cpds(var)
            assert [str(v) for v in cpd.variables[1:]] == golden["evidence"], (t_key, var)
            np.testing.assert_allclose(cpd.get_values().astype(np.float64),
                                       np.asarray(golden["values"], dtype=np.float64),
                                       atol=1e-6, err_msg=f"{t_key}/{var}")


def extras_dbn():
    dbn = DynamicBayesianNetwork()
    dbn.add_edges_from([(("Z", 0), ("X", 0)), (("Z", 0), ("Z", 1))])
    dbn.add_cpds(
        TabularCPD(("Z", 0), 2, [[0.7], [0.3]]),
        TabularCPD(("X", 0), 2, [[0.9, 0.2], [0.1, 0.8]], evidence=[("Z", 0)], evidence_card=[2]),
        TabularCPD(("Z", 1), 2, [[0.8, 0.3], [0.2, 0.7]], evidence=[("Z", 0)], evidence_card=[2]),
    )
    dbn.initialize_initial_state()
    return dbn


@pytest.mark.parametrize("method, query, evidence, key", [
    ("forward_inference", ("Z", 2), {("X", 0): 0, ("X", 1): 1, ("X", 2): 0}, "forward_z2"),
    ("backward_inference", ("Z", 0), {("X", 0): 0, ("X", 1): 1}, "backward_z0"),
])
def test_extras_dbn_inference(method, query, evidence, key):
    result = getattr(DBNInference(extras_dbn()), method)([query], evidence=evidence)
    np.testing.assert_allclose(np_values(result[query].values),
                               np.asarray(EXTRAS["dbn"][key]), atol=1e-6)


def test_extras_dbn_forward_scan():
    """The same filtered posterior through the device loop."""
    got = DBNInference(extras_dbn()).forward_scan(
        ["Z"], evidence={("X", 0): 0, ("X", 1): 1, ("X", 2): 0}, n_time_slices=3)
    np.testing.assert_allclose(got[("Z", 2)], np.asarray(EXTRAS["dbn"]["forward_z2"]), atol=1e-6)
