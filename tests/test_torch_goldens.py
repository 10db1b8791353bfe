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
(``get_constant_bn``) and the DBN inference cases of ``_extras``.

The constraint-based lane and the metrics run the goldens of the JAX
package's tests with their assertions and tolerances: the CI tests and
dataset log-probability of ``_v2``, all of ``_v3`` (PC skeleton and
separating sets, ``correlation_score``, ``fisher_c``, ``implied_cis``),
GES, MMHC and the residual CI tests of ``_v4``, ``log_likelihood_score`` and
SHD of ``_v5``, ``pillai_trace`` and ``edge_strength`` of ``_v6`` and
``DAG.to_pdag`` of ``_v7``.

The latent-variable lane and loopy inference run EM with a fixed init and
Mplp's MAP of ``_v4``, ``NoisyORCPD`` of ``_v5``, and the JPD, discretize,
``fit_update`` and partition-function suites of ``_v7``."""

import filecmp
import json
import os

import numpy as np
import pytest

from _golden_data import (
    DBN_2TBN_EDGES,
    EDGE_STRENGTH_DAG,
    LinearPillaiClassifier,
    LinearPillaiRegressor,
    GAUSSIAN_FRAME_EDGES,
    em_init_values,
    mplp_grid_spec,
    standalone_dbn_frame,
    standalone_gaussian_frame,
    standalone_mixed_frame,
    standalone_sample,
    standalone_sample_jpd,
)
from _torch_parity import np_values
from pgmpy_tpu_torch import estimators
from pgmpy_tpu_torch.base import DAG
from pgmpy_tpu_torch.estimators import (
    GES,
    PC,
    BayesianEstimator,
    ExhaustiveSearch,
    HillClimbSearch,
    MmhcEstimator,
    TreeSearch,
    get_scoring_method,
)
from pgmpy_tpu_torch.estimators import citests
from pgmpy_tpu_torch.estimators.citests import chi_square, g_sq, gcm, pearsonr, pillai_trace
from pgmpy_tpu_torch.factors import TabularCPD
from pgmpy_tpu_torch.inference import BeliefPropagation, DBNInference, VariableElimination
from pgmpy_tpu_torch.metrics import (
    SHD,
    BayesianModelProbability,
    correlation_score,
    fisher_c,
    implied_cis,
    log_likelihood_score,
    structure_score,
)
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
with open(os.path.join(HERE, "reference_goldens_v3.json")) as fh:
    V3 = json.load(fh)
with open(os.path.join(HERE, "reference_goldens_v6.json")) as fh:
    V6 = json.load(fh)

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
    golden = V5["metrics"][name]
    model = get_example_model(name)
    df = standalone_sample(model, golden["n_rows"], seed=golden["data_seed"])
    for method in ["k2", "bdeu", "bds", "bic-d", "aic-d"]:
        scorer, _ = get_scoring_method(method, df, use_cache=False)
        assert float(scorer.score(model)) == pytest.approx(
            golden[f"structure_score_{method}"], rel=1e-9), method
        assert structure_score(model, df, scoring_method=method) == pytest.approx(
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


# --------------------------------------------------------------------------- #
# constraint-based structure learning, CI tests and metrics (v2-v7)
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def v2_cases():
    out = {}
    for name in sorted(V2):
        model = get_example_model(name)
        out[name] = (model, standalone_sample(model, V2[name]["n_rows"], seed=V2[name]["data_seed"]))
    return out


@pytest.mark.parametrize("name", sorted(V2))
def test_v2_ci_tests(v2_cases, name):
    model, df = v2_cases[name]
    for case in V2[name]["ci_tests"]:
        chi, p, dof = chi_square(case["x"], case["y"], case["z"], df, boolean=False)
        assert dof == case["dof"], case
        assert chi == pytest.approx(case["chi"], rel=1e-6, abs=1e-9), case
        assert p == pytest.approx(case["p"], abs=1e-9), case
        g, gp, _ = g_sq(case["x"], case["y"], case["z"], df, boolean=False)
        assert g == pytest.approx(case["g"], rel=1e-6, abs=1e-9), case
        assert gp == pytest.approx(case["g_p"], abs=1e-9), case


@pytest.mark.parametrize("name", sorted(V2))
def test_v2_logprob_sum(v2_cases, name):
    model, df = v2_cases[name]
    got = float(np.sum(BayesianModelProbability(model).score(df)))
    assert got == pytest.approx(V2[name]["logprob_sum"], rel=1e-5)


@pytest.fixture(scope="module")
def v3_cases():
    out = {}
    for name in sorted(V3):
        model = get_example_model(name)
        out[name] = (model, standalone_sample(model, V3[name]["n_rows"], seed=V3[name]["data_seed"]))
    return out


@pytest.mark.parametrize("name", sorted(V3))
def test_v3_pc_skeleton_identical(v3_cases, name):
    model, df = v3_cases[name]
    skel, _ = PC(df).build_skeleton(ci_test="chi_square", significance_level=0.01)
    got = sorted(sorted([str(u), str(v)]) for u, v in skel.edges())
    assert got == V3[name]["pc_skeleton"]


@pytest.mark.parametrize("name", sorted(V3))
def test_v3_pc_sepsets_valid(v3_cases, name):
    """The set of separated pairs is the reference's, and every recorded
    separating set renders its pair independent at the PC threshold (the
    exact set recorded depends on edge-visit order in the reference)."""
    model, df = v3_cases[name]
    _, sepsets = PC(df).build_skeleton(ci_test="chi_square", significance_level=0.01)
    got_pairs = {tuple(sorted([str(u), str(v)])) for u, v in sepsets}
    want = {tuple(e["pair"]): e["sep"] for e in V3[name]["pc_sepsets"]}
    assert got_pairs == set(want)
    for (u, v), sep in sepsets.items():
        out = chi_square(u, v, sorted(sep, key=str), df, boolean=False)
        assert out[1] >= 0.01, (u, v, sep, out)


@pytest.mark.parametrize("name", sorted(V3))
def test_v3_correlation_score(v3_cases, name):
    model, df = v3_cases[name]
    got = correlation_score(model, df, test="chi_square", significance_level=0.05)
    assert got == pytest.approx(V3[name]["correlation_score"], abs=1e-9)


@pytest.mark.parametrize("name", sorted(V3))
def test_v3_fisher_c(v3_cases, name):
    model, df = v3_cases[name]
    got = fisher_c(model, df, ci_test=chi_square, show_progress=False)
    assert got == pytest.approx(V3[name]["fisher_c"], abs=1e-7)


@pytest.mark.parametrize("name", sorted(V3))
def test_v3_implied_cis(v3_cases, name):
    model, df = v3_cases[name]
    cis = implied_cis(model, df, ci_test=chi_square, show_progress=False)
    got = {(str(r["u"]), str(r["v"])): (sorted(str(c) for c in r["cond_vars"]),
                                        float(r["p-value"])) for _, r in cis.iterrows()}
    want_pairs = {frozenset((e["u"], e["v"])) for e in V3[name]["implied_cis"]}
    assert {frozenset(k) for k in got} == want_pairs
    for e in V3[name]["implied_cis"]:
        cond, p = got.get((e["u"], e["v"])) or got[(e["v"], e["u"])]
        parents = set(map(str, model.get_parents(e["u"]))) | set(map(str, model.get_parents(e["v"])))
        assert set(cond) <= parents, e
        assert not model.is_dconnected(e["u"], e["v"], observed=list(cond)), e
        if cond == e["cond"]:
            assert p == pytest.approx(e["p"], abs=1e-9), e


def test_v4_ges(search_net):
    golden, df = search_net
    dag = GES(df).estimate(scoring_method="bic-d")
    assert dag_edges(dag) == golden["ges_edges"]


def test_v4_mmhc(search_net):
    """The reference's mmpc breaks 1 - p ties in hash order, so no exact
    skeleton golden exists: the port's mmpc is deterministic across calls and
    the whole search scores at least the reference run's BDeu."""
    golden, df = search_net
    est = MmhcEstimator(df)
    skel = est.mmpc(significance_level=0.01)
    skel2 = MmhcEstimator(df).mmpc(significance_level=0.01)
    assert sorted(map(sorted, skel.edges())) == sorted(map(sorted, skel2.edges()))
    dag = est.estimate(significance_level=0.01)
    scorer = estimators.BDeu(df, equivalent_sample_size=10)

    def total(edge_list):
        graph = DAG()
        graph.add_nodes_from(df.columns)
        graph.add_edges_from(edge_list)
        return sum(scorer.local_score(n, list(graph.predecessors(n))) for n in graph.nodes())

    assert total(dag.edges()) >= total(map(tuple, golden["mmhc_edges"])) - 1e-6


def test_v4_pearsonr_gcm(gauss_df):
    for case in V4["gauss"]["ci_tests"]:
        x, y, z = case["x"], case["y"], case["z"]
        assert np.allclose(pearsonr(x, y, z, gauss_df, boolean=False), case["pearsonr"],
                           rtol=1e-8, atol=1e-12)
        assert np.allclose(gcm(x, y, z, gauss_df, boolean=False), case["gcm"],
                           rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("name", ["asia", "cancer"])
def test_v5_log_likelihood_score(name):
    golden = V5["metrics"][name]
    model = get_example_model(name)
    df = standalone_sample(model, golden["n_rows"], seed=golden["data_seed"])
    assert log_likelihood_score(model, df) == pytest.approx(golden["log_likelihood_score"],
                                                            rel=1e-6)


def test_v5_shd():
    for case in V5["metrics"]["shd"]:
        nodes = sorted({n for e in case["true"] + case["est"] for n in e})
        true, est = DAG(), DAG()
        true.add_nodes_from(nodes)
        true.add_edges_from(map(tuple, case["true"]))
        est.add_nodes_from(nodes)
        est.add_edges_from(map(tuple, case["est"]))
        assert int(SHD(true, est)) == case["shd"]


PILLAI_FACTORIES = {"classifier_factory": LinearPillaiClassifier,
                    "regressor_factory": LinearPillaiRegressor}


@pytest.fixture(scope="module")
def v6_mixed_df():
    return standalone_mixed_frame(V6["meta"]["n_rows"], V6["meta"]["seed"])


@pytest.mark.parametrize("case", V6["pillai"],
                         ids=lambda c: f"{c['X']}-{c['Y']}|{','.join(c['Z'])}")
def test_v6_pillai_coef_and_p(v6_mixed_df, case):
    coef, p = pillai_trace(case["X"], case["Y"], case["Z"], v6_mixed_df, boolean=False,
                           **PILLAI_FACTORIES)
    assert coef == pytest.approx(case["coef"], rel=1e-6, abs=1e-9)
    assert p == pytest.approx(case["p"], rel=1e-5, abs=1e-9)


def test_v6_pillai_boolean_contract(v6_mixed_df):
    case = V6["pillai"][0]
    flag = pillai_trace(case["X"], case["Y"], case["Z"], v6_mixed_df, boolean=True,
                        significance_level=0.05, **PILLAI_FACTORIES)
    assert flag == (case["p"] >= 0.05)


def test_v6_edge_strengths(v6_mixed_df, monkeypatch):
    import functools

    monkeypatch.setattr(citests, "pillai_trace",
                        functools.partial(citests.pillai_trace, **PILLAI_FACTORIES))
    dag = DAG(EDGE_STRENGTH_DAG)
    strengths = dag.edge_strength(v6_mixed_df)
    want = V6["edge_strength"]
    assert {f"{u}->{v}" for u, v in strengths} == set(want)
    for (u, v), s in strengths.items():
        assert s == pytest.approx(want[f"{u}->{v}"], rel=1e-6, abs=1e-9), (u, v)
        assert dag.edges[(u, v)]["strength"] == s


@pytest.mark.parametrize("name", sorted(V7["to_pdag"]))
def test_v7_cpdag_edges(name):
    pdag = DAG(get_example_model(name).edges()).to_pdag()
    directed, undirected, seen = [], [], set()
    edge_set = set(pdag.edges())
    for u, v in edge_set:
        if (v, u) in edge_set:
            if (v, u) not in seen:
                undirected.append(sorted([str(u), str(v)]))
                seen.add((u, v))
        else:
            directed.append([str(u), str(v)])
    assert sorted(directed) == V7["to_pdag"][name]["directed"], name
    assert sorted(undirected) == V7["to_pdag"][name]["undirected"], name


# --------------------------------------------------------------------------- #
# the latent-variable lane and loopy inference
# --------------------------------------------------------------------------- #
def test_v4_em_fixed_init():
    from pgmpy_tpu_torch.estimators import ExpectationMaximization
    from pgmpy_tpu_torch.models import DiscreteBayesianNetwork

    g = V4["em"]
    model = get_example_model(g["network"])
    df = standalone_sample(model, g["n_rows"], seed=g["data_seed"]).drop(columns=[g["latent"]])
    latent = g["latent"]
    bn = DiscreteBayesianNetwork(list(model.edges()), latents={latent})
    spec = [(var, 2, [(p, 2) for p in sorted(bn.get_parents(var), key=str)])
            for var in sorted(bn.nodes(), key=str)]
    init_vals = em_init_values(spec, seed=g["init_seed"])
    init_cpds = {
        var: TabularCPD(
            var, card, init_vals[var],
            evidence=[p for p, _ in parents] or None,
            evidence_card=[pc for _, pc in parents] or None,
            state_names={
                v: sorted(model.get_cpds(v).state_names[v], key=str) if v != latent else [0, 1]
                for v in [var] + [p for p, _ in parents]
            },
        )
        for var, card, parents in spec
    }
    cpds = ExpectationMaximization(bn, df).get_parameters(
        latent_card={latent: 2}, max_iter=g["max_iter"], atol=1e-12, seed=0,
        init_cpds=init_cpds, show_progress=False)
    ours = {str(c.variable): c for c in cpds}
    for gc in g["cpds"]:
        cpd = ours[gc["variable"]]
        ev_ours = [str(e) for e in cpd.variables[1:]]
        assert sorted(ev_ours) == sorted(gc["evidence"])
        var = gc["variable"]
        g_states = {k: [str(x) for x in v] for k, v in gc["state_names"].items()}
        card = len(g_states[var])
        arr = np.asarray(gc["values_2d"], dtype=np.float64).reshape(
            [card] + [len(g_states[e]) for e in gc["evidence"]])
        arr = np.transpose(arr, [0] + [1 + gc["evidence"].index(e) for e in ev_ours])
        our_states = {str(v): [str(x) for x in cpd.state_names[v]] for v in cpd.variables}
        index = [[g_states[var].index(x) for x in our_states[var]]] + [
            [g_states[e].index(x) for x in our_states[e]] for e in ev_ours]
        arr = arr[np.ix_(*index)]
        np.testing.assert_allclose(np_values(cpd.get_values()), arr.reshape(card, -1),
                                   atol=1e-4, err_msg=var)


def test_v4_mplp_map_query():
    import itertools

    from pgmpy_tpu_torch.inference import Mplp
    from pgmpy_tpu_torch.utils.interop import markov_network_from_numpy

    g = V4["mplp"]
    nodes, edges, unary, pairwise = mplp_grid_spec(g["rows"], g["cols"], seed=g["seed"])
    scopes = [[n] for n in nodes] + [list(e) for e in edges]
    tables = [unary[n] for n in nodes] + [pairwise[e] for e in edges]
    mplp = Mplp(markov_network_from_numpy(scopes, {n: 2 for n in nodes}, tables))
    assignment = {str(k): int(v) for k, v in mplp.map_query().items()}

    def energy(assign):
        return sum(np.log(unary[n][assign[n]]) for n in nodes) + sum(
            np.log(pairwise[(u, v)][assign[u], assign[v]]) for u, v in edges)

    best = max(energy(dict(zip(nodes, vals)))
               for vals in itertools.product([0, 1], repeat=len(nodes)))
    ref_energy = energy({k: int(v) for k, v in g["assignment"].items()})
    assert energy(assignment) >= ref_energy - 1e-9
    assert energy(assignment) == pytest.approx(best, abs=1e-9)
    assert float(mplp.get_integrality_gap()) == pytest.approx(g["integrality_gap"], abs=1e-6)


def test_v5_noisy_or_values():
    from pgmpy_tpu_torch.factors import NoisyORCPD

    for case in V5["noisy_or"]:
        cpd = NoisyORCPD(case["variable"], case["prob_values"], evidence=case["evidence"])
        np.testing.assert_allclose(np_values(cpd.get_values()), case["values_2d"], atol=1e-12)
        for v in cpd.variables:
            assert [str(x) for x in cpd.state_names[v]] == case["state_names"][str(v)]


def v7_jpd(variables, cards, values):
    from pgmpy_tpu_torch.factors import JointProbabilityDistribution

    return JointProbabilityDistribution(variables, cards, np.asarray(values))


def test_v7_jpd_minimal_imap_reference_semantics():
    g = V7["jpd"]
    jpd = v7_jpd(["A", "B", "C"], [2, 3, 2], g["values"])
    for order_key, want in g["minimal_imap_edges"].items():
        if order_key == "uniform_ABC":
            dist, order = v7_jpd(["A", "B", "C"], [2, 3, 2], np.ones(12) / 12), ["A", "B", "C"]
        elif order_key == "partial_ABC":
            ab = np.array([[0.30, 0.10, 0.05], [0.05, 0.15, 0.35]])
            c = np.array([0.4, 0.6])
            dist = v7_jpd(["A", "B", "C"], [2, 3, 2], np.einsum("ab,c->abc", ab, c).ravel())
            order = ["A", "B", "C"]
        else:
            dist, order = jpd, list(order_key)
        got = sorted([str(u), str(v)] for u, v in dist.minimal_imap(order).edges())
        assert got == want, order_key


def test_v7_jpd_is_imap():
    from pgmpy_tpu_torch.models import DiscreteBayesianNetwork

    g = V7["jpd"]
    jpd = v7_jpd(["A", "B", "C"], [2, 3, 2], g["values"])
    bn = DiscreteBayesianNetwork([("A", "B"), ("A", "C"), ("B", "C")])
    bn.fit(standalone_sample_jpd(jpd, 4000, seed=5))
    assert jpd.is_imap(bn) == g["is_imap_full_bn"]


def test_v7_discretize_rounding_and_quantile():
    from pgmpy_tpu_torch.utils import discretize

    g = V7["discretize"]
    gdf = standalone_gaussian_frame(g["n_rows"], seed=g["seed"])
    for method in ["rounding", "quantile"]:
        disc = discretize(gdf, cardinality={c: 4 for c in gdf.columns}, method=method)
        for c in gdf.columns:
            assert [str(x) for x in disc[c].tolist()] == g[method][c], (method, c)


def test_v7_dataset_type():
    from pgmpy_tpu_torch.utils import get_dataset_type

    assert str(get_dataset_type(standalone_mixed_frame(50, seed=42))) == \
        V7["discretize"]["dataset_type"]


def test_v7_fit_update_dirichlet():
    g = V7["fit_update"]
    model = get_example_model("asia")
    model.fit_update(standalone_sample(model, g["n_rows"], seed=g["seed"]),
                     n_prev_samples=g["n_prev_samples"])
    for var, want in g["cpds"].items():
        cpd = model.get_cpds(var)
        assert [str(v) for v in cpd.variables[1:]] == want["evidence"], var
        np.testing.assert_allclose(np_values(cpd.get_values()),
                                   np.asarray(want["values"], dtype=np.float64), atol=1e-10,
                                   err_msg=var)


def test_v7_markov_network_partition_function():
    from pgmpy_tpu_torch.utils.interop import markov_network_from_numpy

    nodes, edges, unary, pairwise = mplp_grid_spec(3, 3, seed=17)
    scopes = [[n] for n in nodes] + [list(e) for e in edges]
    tables = [unary[n] for n in nodes] + [pairwise[e] for e in edges]
    mn = markov_network_from_numpy(scopes, {n: 2 for n in nodes}, tables)
    assert float(mn.get_partition_function()) == pytest.approx(
        V7["markov_network"]["partition_function"], rel=1e-5)


def test_v7_factor_graph_partition_function():
    """At the JAX suite's 1e-9 the tables must be float64: float32 tables
    round each entry by up to 6e-8 (the JAX package meets 1e-9 only because
    its float32 total happens to round to within 1e-10 of the answer)."""
    import torch

    from pgmpy_tpu_torch.config import config
    from pgmpy_tpu_torch.utils.interop import factor_graph_from_numpy

    nodes, edges, unary, pairwise = mplp_grid_spec(2, 3, seed=23)
    config.set_dtype(torch.float64)
    try:
        fg = factor_graph_from_numpy([list(e) for e in edges], {n: 2 for n in nodes},
                                     [pairwise[e] for e in edges])
        z = float(fg.get_partition_function())
    finally:
        config.set_dtype(torch.float32)
    assert z == pytest.approx(V7["markov_network"]["fg_partition_function"], rel=1e-9)
