"""The port's temporal lane against pgmpy_tpu on the CPU.

``DynamicNode`` / ``DynamicBayesianNetwork`` are host code: the structure
tests of ``tests/test_dbn_deep.py`` run here against the port.  The inference
paths (``forward_inference``, ``forward_scan``, ``backward_inference``,
``query``) get a seeded 3-variable 2-TBN over 6 slices whose tables both
packages hold as the same float32 numbers (``dbn_from_numpy``): 1e-5 in
float32, and 1e-10 against a numpy float64 forward recursion over the joint
slice state under ``config.set_dtype(float64)`` (the JAX package stays float32
in the test process).  ``fit`` is compared on a frame the JAX package
simulated, 1e-6.
"""

import itertools

import numpy as np
import pandas as pd
import pytest
import torch

from _torch_parity import np_values
from pgmpy_tpu.factors import TabularCPD as JaxCPD
from pgmpy_tpu.inference import DBNInference as JaxDBNInference
from pgmpy_tpu.models import DynamicBayesianNetwork as JaxDBN
from pgmpy_tpu_torch.config import config
from pgmpy_tpu_torch.factors import TabularCPD
from pgmpy_tpu_torch.inference import ApproxInference, DBNInference
from pgmpy_tpu_torch.models import DynamicBayesianNetwork, DynamicNode
from pgmpy_tpu_torch.utils.interop import dbn_from_numpy

N_SLICES = 6


# --------------------------------------------------------------------------- #
# structure: host code
# --------------------------------------------------------------------------- #
class TestDynamicNode:
    def test_tuple_protocol(self):
        n = DynamicNode("X", 0)
        assert n[0] == "X" and n[1] == 0
        assert len(n) == 2
        assert tuple(n) == ("X", 0)
        assert n.to_tuple() == ("X", 0)

    def test_equality_with_plain_tuple(self):
        assert DynamicNode("X", 0) == ("X", 0)
        assert hash(DynamicNode("X", 0)) == hash(("X", 0))
        assert DynamicNode("X", 0) != ("X", 1)
        assert DynamicNode("X", 0) != 3

    def test_one_graph_node_for_tuple_and_dynamic_node(self):
        dbn = DynamicBayesianNetwork()
        dbn.add_edge(DynamicNode("A", 0), DynamicNode("B", 0))
        dbn.add_edge(("A", 0), ("A", 1))
        assert sorted(dbn.nodes()) == [("A", 0), ("A", 1), ("B", 0), ("B", 1)]

    def test_ordering(self):
        assert DynamicNode("A", 0) < DynamicNode("A", 1)
        assert DynamicNode("A", 0) <= ("A", 0)

    def test_str(self):
        assert "X" in str(DynamicNode("X", 0))


class TestEdgeContract:
    def test_intra_edge_mirrored(self):
        dbn = DynamicBayesianNetwork()
        dbn.add_edge(("A", 0), ("B", 0))
        assert dbn.has_edge(("A", 0), ("B", 0))
        assert dbn.has_edge(("A", 1), ("B", 1))

    def test_inter_edge_normalized_to_0_1(self):
        dbn = DynamicBayesianNetwork()
        dbn.add_edge(("A", 3), ("A", 4))
        assert dbn.has_edge(("A", 0), ("A", 1))

    @pytest.mark.parametrize("edge, error", [
        ((("A", 1), ("A", 0)), NotImplementedError),
        ((("A", 0), ("A", 2)), ValueError),
        (("A", "B"), ValueError),
        ((("A", 0), ("A", 0)), ValueError),
    ], ids=["backward", "two_slices", "malformed", "self_loop"])
    def test_edge_rejected(self, edge, error):
        dbn = DynamicBayesianNetwork()
        with pytest.raises(error):
            dbn.add_edge(*edge)

    def test_loop_rejected(self):
        dbn = DynamicBayesianNetwork([(("A", 0), ("B", 0))])
        with pytest.raises(ValueError):
            dbn.add_edge(("B", 0), ("A", 0))

    def test_intra_inter_accessors(self):
        dbn = DynamicBayesianNetwork()
        dbn.add_edges_from([(("Z", 0), ("X", 0)), (("Z", 0), ("Z", 1))])
        assert set(dbn.get_intra_edges(0)) == {(("Z", 0), ("X", 0))}
        assert set(dbn.get_intra_edges(1)) == {(("Z", 1), ("X", 1))}
        assert set(dbn.get_inter_edges()) == {(("Z", 0), ("Z", 1))}
        assert dbn.get_interface_nodes(0) == [("Z", 0)]
        with pytest.raises(ValueError):
            dbn.get_intra_edges(-1)

    def test_slice_nodes(self):
        dbn = DynamicBayesianNetwork()
        dbn.add_edges_from([(("A", 0), ("B", 0)), (("A", 0), ("A", 1))])
        assert set(dbn.get_slice_nodes(1)) == {("A", 1), ("B", 1)}


def _hmm_dbn():
    dbn = DynamicBayesianNetwork()
    dbn.add_edges_from([(("Z", 0), ("X", 0)), (("Z", 0), ("Z", 1)),
                        (("Z", 1), ("X", 1))])
    dbn.add_cpds(
        TabularCPD(("Z", 0), 2, [[0.6], [0.4]]),
        TabularCPD(("X", 0), 2, [[0.9, 0.3], [0.1, 0.7]],
                   evidence=[("Z", 0)], evidence_card=[2]),
        TabularCPD(("Z", 1), 2, [[0.75, 0.25], [0.25, 0.75]],
                   evidence=[("Z", 0)], evidence_card=[2]),
        TabularCPD(("X", 1), 2, [[0.9, 0.3], [0.1, 0.7]],
                   evidence=[("Z", 1)], evidence_card=[2]))
    dbn.initialize_initial_state()
    return dbn


class TestStateAndUnroll:
    def test_initialize_fills_missing(self):
        dbn = DynamicBayesianNetwork()
        dbn.add_edges_from([(("Z", 0), ("X", 0)), (("Z", 0), ("Z", 1))])
        dbn.add_cpds(
            TabularCPD(("Z", 0), 2, [[0.6], [0.4]]),
            TabularCPD(("X", 0), 2, [[0.9, 0.3], [0.1, 0.7]],
                       evidence=[("Z", 0)], evidence_card=[2]),
            TabularCPD(("Z", 1), 2, [[0.75, 0.25], [0.25, 0.75]],
                       evidence=[("Z", 0)], evidence_card=[2]))
        dbn.initialize_initial_state()
        assert dbn.check_model()
        np.testing.assert_allclose(dbn.get_cpds(("X", 1)).get_values(), [[0.9, 0.3], [0.1, 0.7]])
        assert dbn.get_cpds(("X", 1)).variables[1:] == [("Z", 1)]

    def test_check_model_missing_cpd(self):
        dbn = DynamicBayesianNetwork([(("Z", 0), ("Z", 1))])
        dbn.add_cpds(TabularCPD(("Z", 0), 2, [[0.6], [0.4]]))
        with pytest.raises(ValueError):
            dbn.check_model()

    def test_add_cpds_rejects(self):
        dbn = DynamicBayesianNetwork([(("Z", 0), ("Z", 1))])
        with pytest.raises(ValueError):
            dbn.add_cpds("not a cpd")
        with pytest.raises(ValueError):
            dbn.add_cpds(TabularCPD(("Q", 0), 2, [[0.6], [0.4]]))

    def test_get_and_remove_cpds(self):
        dbn = _hmm_dbn()
        assert {tuple(c.variable) for c in dbn.get_cpds(time_slice=1)} == {("Z", 1), ("X", 1)}
        dbn.remove_cpds(("X", 1))
        assert dbn.get_cpds(("X", 1)) is None and len(dbn.get_cpds()) == 3
        with pytest.raises(ValueError):
            dbn.get_cpds(("Q", 0))

    def test_get_constant_bn_values(self):
        bn = _hmm_dbn().get_constant_bn()
        np.testing.assert_allclose(
            np.asarray(bn.get_cpds("Z_1").get_values(), dtype=np.float64),
            [[0.75, 0.25], [0.25, 0.75]])
        assert set(bn.edges()) == {("Z_0", "X_0"), ("Z_0", "Z_1"), ("Z_1", "X_1")}
        assert bn.check_model()

    def test_get_constant_bn_offset(self):
        bn = _hmm_dbn().get_constant_bn(t_slice=3)
        assert ("Z_3", "Z_4") in bn.edges()

    def test_moralize(self):
        moral = _hmm_dbn().moralize()
        assert moral.has_edge(("Z", 0), ("X", 0))

    def test_copy_independent(self):
        dbn = _hmm_dbn()
        clone = dbn.copy()
        clone.add_edge(("X", 0), ("X", 1))
        assert not dbn.has_edge(("X", 0), ("X", 1))
        assert len(clone.get_cpds()) == len(dbn.get_cpds())

    def test_get_markov_blanket(self):
        mb = _hmm_dbn().get_markov_blanket(("Z", 1))
        assert ("Z", 0) in mb and ("X", 1) in mb

    def test_states(self):
        assert _hmm_dbn().states[("Z", 1)] == [0, 1]


class TestTupleNodeSurface:
    """Inherited DAG methods accept (name, slice) tuples and DynamicNodes."""

    def _student(self):
        dbn = DynamicBayesianNetwork()
        dbn.add_edges_from([(("D", 0), ("G", 0)), (("I", 0), ("G", 0)),
                            (("D", 0), ("D", 1)), (("I", 0), ("I", 1))])
        return dbn

    @pytest.mark.parametrize("node", [("D", 0), DynamicNode("D", 0)], ids=["tuple", "DynamicNode"])
    def test_active_trail_nodes_single(self, node):
        at = self._student().active_trail_nodes(node)
        assert at[("D", 0)] == {("D", 0), ("D", 1), ("G", 0), ("G", 1)}

    def test_active_trail_nodes_observed_single(self):
        at = self._student().active_trail_nodes(("D", 0), observed=("G", 0))
        assert ("I", 0) in at[("D", 0)]

    def test_active_trail_nodes_list(self):
        at = self._student().active_trail_nodes([("D", 0), ("I", 0)], observed=[("G", 0)])
        assert set(at) == {("D", 0), ("I", 0)}

    def test_is_dconnected_tuple_nodes(self):
        dbn = self._student()
        assert dbn.is_dconnected(("D", 0), ("G", 1))
        assert not dbn.is_dconnected(("D", 0), ("I", 0))
        assert dbn.is_dconnected(("D", 0), ("I", 0), observed=[("G", 0)])

    def test_ancestral_graph_tuple_nodes(self):
        an = self._student().get_ancestral_graph([("G", 0)])
        assert set(an.nodes()) == {("D", 0), ("I", 0), ("G", 0)}

    def test_do_single_tuple_node(self):
        intervened = self._student().do(("G", 0))
        assert list(intervened.predecessors(("G", 0))) == []
        assert ("D", 0) in intervened.nodes()

    def test_local_independencies_tuple_node(self):
        ind = self._student().local_independencies(("D", 0))
        assert len(ind.get_assertions()) == 1


# --------------------------------------------------------------------------- #
# a seeded 2-TBN held by both packages
# --------------------------------------------------------------------------- #
EDGES = [
    (("A", 0), ("B", 0)), (("B", 0), ("C", 0)),
    (("A", 0), ("A", 1)), (("B", 0), ("B", 1)), (("A", 0), ("C", 1)),
]
CARDS = {"A": 2, "B": 3, "C": 2}
PARENTS = {
    ("A", 0): [], ("B", 0): [("A", 0)], ("C", 0): [("B", 0)],
    ("A", 1): [("A", 0)], ("B", 1): [("A", 1), ("B", 0)], ("C", 1): [("A", 0), ("B", 1)],
}
STATES = {"A": ["a0", "a1"], "B": ["b0", "b1", "b2"], "C": ["c0", "c1"]}


def seeded_tables(seed=11):
    """CPD tuples of the 2-TBN above, rounded to float32 so that both packages
    hold the same numbers."""
    rng = np.random.default_rng(seed)
    tuples = []
    for node, parents in PARENTS.items():
        n_cols = int(np.prod([CARDS[p[0]] for p in parents])) if parents else 1
        values = rng.dirichlet(np.ones(CARDS[node[0]]) * 1.5, size=n_cols).T
        values = values.astype(np.float32).astype(np.float64)
        tuples.append((node, CARDS[node[0]], values, parents, [CARDS[p[0]] for p in parents],
                       {v: STATES[v[0]] for v in [node] + parents}))
    return tuples


@pytest.fixture(scope="module")
def pair():
    tuples = seeded_tables()
    jax_dbn = JaxDBN()
    jax_dbn.add_edges_from(EDGES)
    jax_dbn.add_cpds(*[
        JaxCPD(var, card, values, evidence=ev or None, evidence_card=ec or None, state_names=sn)
        for var, card, values, ev, ec, sn in tuples
    ])
    return dbn_from_numpy(EDGES, tuples), jax_dbn


EVIDENCE = {("C", 0): "c1", ("C", 2): "c0", ("B", 3): "b2", ("C", 5): 1, ("A", 4): "a0"}
# ``forward_inference`` reduces observed variables out of its factors, in
# both packages: it cannot answer for a variable in a slice where it is
# observed, nor carry an observed interface variable (A, B) to the next slice.
# So it gets the evidence on the leaf C alone, and ``forward_scan`` (whose
# deltas have neither limit beyond slice 0) gets all of it.
LEAF_EVIDENCE = {key: state for key, state in EVIDENCE.items() if key[0] == "C"}
SCAN_VARIABLES = ["A", "B"]
FORWARD_QUERIES = sorted({(v, t) for v in CARDS for t in range(N_SLICES)} - set(LEAF_EVIDENCE))


def joint_forward(tuples, evidence, n_slices):
    """Filtered marginals {(name, t): array} by a numpy float64 forward
    recursion over the JOINT state of a slice: an oracle that shares no code
    with either package."""
    names = list(CARDS)
    shape = [CARDS[v] for v in names]
    tables = {var: values.reshape([card] + ec) for var, card, values, _, ec, _ in tuples}

    def slice_prob(t, cur, prev):
        p = 1.0
        for j, v in enumerate(names):
            node = (v, 0 if t == 0 else 1)
            idx = [cur[j]]
            for (pv, pt) in PARENTS[node]:
                k = names.index(pv)
                idx.append(cur[k] if pt == node[1] else prev[k])
            p *= tables[node][tuple(idx)]
        return p

    out = {}
    alpha = None
    for t in range(n_slices):
        new = np.zeros(shape)
        for cur in itertools.product(*[range(c) for c in shape]):
            if t == 0:
                new[cur] = slice_prob(0, cur, None)
            else:
                new[cur] = sum(alpha[prev] * slice_prob(t, cur, prev)
                               for prev in itertools.product(*[range(c) for c in shape]))
        for (v, et), state in evidence.items():
            if et == t:
                code = STATES[v].index(state) if state in STATES[v] else int(state)
                mask = np.zeros(CARDS[v])
                mask[code] = 1.0
                new = new * mask.reshape([-1 if u == v else 1 for u in names])
        alpha = new / new.sum()
        for j, v in enumerate(names):
            out[(v, t)] = alpha.sum(axis=tuple(k for k in range(len(names)) if k != j))
    return out


def test_forward_scan_matches_jax(pair):
    port, jax_dbn = pair
    got = DBNInference(port).forward_scan(SCAN_VARIABLES, EVIDENCE, n_time_slices=N_SLICES)
    want = JaxDBNInference(jax_dbn).forward_scan(SCAN_VARIABLES, EVIDENCE, n_time_slices=N_SLICES)
    assert set(got) == set(want) and len(got) == 2 * N_SLICES
    for key in want:
        np.testing.assert_allclose(got[key], np.asarray(want[key]), atol=1e-5, err_msg=str(key))


def test_forward_inference_matches_jax_and_forward_scan(pair):
    port, jax_dbn = pair
    infer = DBNInference(port)
    got = infer.forward_inference(FORWARD_QUERIES, LEAF_EVIDENCE)
    want = JaxDBNInference(jax_dbn).forward_inference(FORWARD_QUERIES, LEAF_EVIDENCE)
    scan = infer.forward_scan(SCAN_VARIABLES, LEAF_EVIDENCE, n_time_slices=N_SLICES)
    for key in FORWARD_QUERIES:
        assert got[key].variables == [key]
        assert got[key].state_names[key] == STATES[key[0]]
        np.testing.assert_allclose(np_values(got[key].values), np_values(want[key].values),
                                   atol=1e-5, err_msg=str(key))
        if key[0] in SCAN_VARIABLES:
            np.testing.assert_allclose(np_values(got[key].values), scan[key], atol=1e-5)


@pytest.mark.parametrize("method", ["backward_inference", "query"])
def test_smoothing_matches_jax(pair, method):
    port, jax_dbn = pair
    variables = [("A", 1), ("B", 2), ("C", 4)]
    got = getattr(DBNInference(port), method)(variables, EVIDENCE)
    want = getattr(JaxDBNInference(jax_dbn), method)(variables, EVIDENCE)
    for key in variables:
        assert got[key].variables == [key]
        np.testing.assert_allclose(np_values(got[key].values), np_values(want[key].values),
                                   atol=1e-5, err_msg=str(key))


def test_float64_against_the_joint_recursion():
    """Under ``config.set_dtype(float64)`` the filters agree with a numpy
    float64 recursion over the joint slice state to 1e-10."""
    tuples = seeded_tables()
    oracle = joint_forward(tuples, EVIDENCE, N_SLICES)
    leaf_oracle = joint_forward(tuples, LEAF_EVIDENCE, N_SLICES)
    config.set_dtype(torch.float64)
    try:
        infer = DBNInference(dbn_from_numpy(EDGES, tuples))
        scan = infer.forward_scan(SCAN_VARIABLES, EVIDENCE, n_time_slices=N_SLICES)
        forward = infer.forward_inference(FORWARD_QUERIES, LEAF_EVIDENCE)
    finally:
        config.set_dtype(torch.float32)
    assert len(scan) == 2 * N_SLICES
    for key, got in scan.items():
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, oracle[key], atol=1e-10, err_msg=str(key))
    for key in FORWARD_QUERIES:
        np.testing.assert_allclose(np_values(forward[key].values), leaf_oracle[key], atol=1e-10)


def test_float32_against_the_joint_recursion(pair):
    oracle = joint_forward(seeded_tables(), EVIDENCE, N_SLICES)
    scan = DBNInference(pair[0]).forward_scan(SCAN_VARIABLES, EVIDENCE, n_time_slices=N_SLICES)
    for key, got in scan.items():
        np.testing.assert_allclose(got, oracle[key], atol=1e-5, err_msg=str(key))


def test_forward_scan_evidence_rules(pair):
    infer = DBNInference(pair[0])
    base = infer.forward_scan(["A"], {("C", 2): "c0"}, n_time_slices=4)
    # an index in place of a state name
    by_index = infer.forward_scan(["A"], {("C", 2): 0}, n_time_slices=4)
    for key in base:
        np.testing.assert_array_equal(base[key], by_index[key])
    # the default horizon reaches the last evidence slice
    assert max(t for _, t in infer.forward_scan(["A"], {("C", 2): "c0"})) == 2
    with pytest.raises(ValueError):
        infer.forward_scan(["A"], {("C", 2): 7}, n_time_slices=4)
    # a name without a slice-1 variable is ignored at t >= 1, as in the JAX package
    ignored = infer.forward_scan(["A"], {("C", 2): "c0", ("Q", 1): 0}, n_time_slices=4)
    for key in base:
        np.testing.assert_array_equal(base[key], ignored[key])


def test_dbn_inference_rejects_other_models(pair):
    with pytest.raises(ValueError):
        DBNInference(pair[0].get_constant_bn())


def test_approx_inference_raises_the_jax_packages_error(pair):
    from pgmpy_tpu.inference import ApproxInference as JaxApprox

    port, jax_dbn = pair
    with pytest.raises(ValueError) as jax_error:
        JaxApprox(jax_dbn)
    with pytest.raises(ValueError) as port_error:
        ApproxInference(port)
    assert "must be a DiscreteBayesianNetwork" in str(port_error.value)
    assert str(port_error.value).split("Got")[0] == str(jax_error.value).split("Got")[0]


# --------------------------------------------------------------------------- #
# fit and simulate
# --------------------------------------------------------------------------- #
def test_fit_matches_jax_on_a_frame_jax_simulated(pair):
    port, jax_dbn = pair
    df = jax_dbn.simulate(n_samples=1500, n_time_slices=4, seed=3, show_progress=False)
    df = pd.DataFrame({col: np.asarray(df[col]) for col in df.columns})
    jax_fit = JaxDBN()
    jax_fit.add_edges_from(EDGES)
    jax_fit.fit(df)
    port_fit = DynamicBayesianNetwork(EDGES)
    assert port_fit.fit(df) is port_fit
    want = {tuple(c.variable): c for c in jax_fit.get_cpds()}
    assert {tuple(c.variable) for c in port_fit.get_cpds()} == set(want)
    for cpd in port_fit.get_cpds():
        other = want[tuple(cpd.variable)]
        assert [tuple(v) for v in cpd.variables] == [tuple(v) for v in other.variables]
        assert cpd.state_names == other.state_names
        np.testing.assert_allclose(cpd.get_values(), np.asarray(other.get_values()), atol=1e-6)
    assert port_fit.check_model()


def test_fit_makes_one_count_call_per_slice_pair(monkeypatch):
    """Every pair of consecutive slices is one ``table_counts`` call."""
    from pgmpy_tpu_torch.estimators import base

    calls = []
    real = base.table_counts
    monkeypatch.setattr(base, "table_counts",
                        lambda *args, **kwargs: calls.append(len(args[2])) or real(*args, **kwargs))
    df = _hmm_dbn().simulate(n_samples=300, n_time_slices=5, seed=0, show_progress=False)
    learned = DynamicBayesianNetwork([(("Z", 0), ("X", 0)), (("Z", 0), ("Z", 1))])
    learned.fit(df)
    assert calls == [4, 4, 4, 4]  # 4 slice pairs, the 4 CPDs of the 2-TBN in each


@pytest.mark.parametrize("frame, kwargs", [
    (pd.DataFrame({("Z", 1): [0, 1], ("Z", 2): [1, 0]}), {}),
    (pd.DataFrame({("Z", 0): [0, 1], ("Z", 1): [1, 0]}), {"estimator": "EM"}),
    ("not a frame", {}),
], ids=["no_slice_0", "not_mle", "not_a_frame"])
def test_fit_rejects(frame, kwargs):
    learned = DynamicBayesianNetwork([(("Z", 0), ("Z", 1))])
    with pytest.raises(ValueError):
        learned.fit(frame, **kwargs)


def test_simulate_within_mc_error_of_forward_scan(pair):
    port, _ = pair
    n, n_slices = 20_000, 4
    df = port.simulate(n_samples=n, n_time_slices=n_slices, seed=5, show_progress=False)
    assert set(df.columns) == {(v, t) for v in CARDS for t in range(n_slices)}
    exact = DBNInference(port).forward_scan(list(CARDS), None, n_time_slices=n_slices)
    for (v, t), p in exact.items():
        freq = np.array([(df[(v, t)] == s).mean() for s in STATES[v]])
        limit = 5 * np.sqrt(p * (1 - p) / n) + 1e-4
        assert (np.abs(freq - p) <= limit).all(), ((v, t), freq, p)


def test_simulate_same_seed_equal_and_evidence(pair):
    port, _ = pair
    a = port.simulate(n_samples=50, n_time_slices=3, seed=1, show_progress=False)
    b = port.simulate(n_samples=50, n_time_slices=3, seed=1, show_progress=False)
    assert a.equals(b)
    clamped = port.simulate(n_samples=50, n_time_slices=3, seed=1, show_progress=False,
                            evidence={("A", 0): "a1"})
    assert (clamped[("A", 0)] == "a1").all()
