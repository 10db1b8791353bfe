"""The discrete tail of the port against pgmpy_tpu: JointProbabilityDistribution
(and ``DiscreteBayesianNetwork.is_imap``), NoisyORCPD, NaiveBayes,
``discretize``; and the batched-query underflow at a naive Bayes' width,
where the port matches a numpy float64 oracle and the JAX package returns
NaN."""

import numpy as np
import pandas as pd
import pytest

from pgmpy_tpu.factors import JointProbabilityDistribution as JaxJPD
from pgmpy_tpu.factors import NoisyORCPD as JaxNoisyOR
from pgmpy_tpu.factors import TabularCPD as JaxCPD
from pgmpy_tpu.models import DiscreteBayesianNetwork as JaxBN
from pgmpy_tpu.models import NaiveBayes as JaxNaiveBayes
from pgmpy_tpu.utils import discretize as jax_discretize
from pgmpy_tpu.utils import get_example_model as jax_example

from _golden_data import standalone_gaussian_frame, standalone_sample
from _torch_parity import cpd_tuples, np_values
from pgmpy_tpu_torch.estimators import base as estimators_base
from pgmpy_tpu_torch.factors import JointProbabilityDistribution, NoisyORCPD, TabularCPD
from pgmpy_tpu_torch.models import DiscreteBayesianNetwork, NaiveBayes
from pgmpy_tpu_torch.utils import discretize
from pgmpy_tpu_torch.utils.interop import bn_from_numpy


def assertions(independencies):
    return sorted(str(a) for a in independencies.get_assertions())


# --------------------------------------------------------------------------- #
# JointProbabilityDistribution
# --------------------------------------------------------------------------- #
def jpd_values(kind):
    rng = np.random.default_rng(4)
    if kind == "dependent":
        values = rng.random(12) + 0.05
    else:  # A and B dependent, C independent of both
        ab = rng.random((2, 3)) + 0.05
        c = np.array([0.35, 0.65])
        values = np.einsum("ab,c->abc", ab, c).ravel()
    return values / values.sum()


@pytest.fixture(params=["dependent", "partial", "uniform"])
def jpd_pair(request):
    values = np.full(12, 1 / 12) if request.param == "uniform" else jpd_values(request.param)
    return (JointProbabilityDistribution(["A", "B", "C"], [2, 3, 2], values),
            JaxJPD(["A", "B", "C"], [2, 3, 2], values))


def test_jpd_distributions(jpd_pair):
    port, ref = jpd_pair
    for variables in (["A"], ["B", "C"], "C"):
        got = port.marginal_distribution(variables, inplace=False)
        want = ref.marginal_distribution(variables, inplace=False)
        assert got.variables == want.variables
        np.testing.assert_allclose(np_values(got.values), np_values(want.values), atol=1e-6)
    got = port.conditional_distribution([("B", 2), ("C", 0)], inplace=False)
    want = ref.conditional_distribution([("B", 2), ("C", 0)], inplace=False)
    np.testing.assert_allclose(np_values(got.values), np_values(want.values), atol=1e-6)
    assert repr(port).startswith("<Joint Distribution representing P(A:2, B:3, C:2)")


def test_jpd_independence(jpd_pair):
    port, ref = jpd_pair
    cases = [
        (["A"], ["B"], None, False),
        (["A"], ["C"], None, False),
        (["A", "B"], ["C"], None, False),
        (["A"], ["C"], [("B", 1)], False),
        (["A"], ["C"], ["B"], True),
        (["B"], ["C"], ["A"], True),
    ]
    for e1, e2, e3, random_variable in cases:
        assert port.check_independence(e1, e2, e3, random_variable) == \
            ref.check_independence(e1, e2, e3, random_variable), (e1, e2, e3)
    assert assertions(port.get_independencies()) == assertions(ref.get_independencies())
    assert assertions(port.get_independencies([("A", 0)])) == \
        assertions(ref.get_independencies([("A", 0)]))
    for order in (["A", "B", "C"], ["C", "B", "A"], ["B", "A", "C"]):
        assert sorted(port.minimal_imap(order).edges()) == sorted(ref.minimal_imap(order).edges())
    with pytest.raises(TypeError):
        port.check_independence("A", ["B"])


def test_jpd_refuses_values_that_do_not_sum_to_one():
    with pytest.raises(ValueError):
        JointProbabilityDistribution(["A", "B"], [2, 2], [0.3, 0.3, 0.3, 0.3])
    JointProbabilityDistribution(["A", "B"], [2, 2], [0.25, 0.25, 0.25, 0.255])


def joint_table(cpds, variables):
    """The product of the CPD tuples as a numpy array over ``variables``."""
    letters = {v: chr(ord("a") + i) for i, v in enumerate(variables)}
    operands, subscripts = [], []
    for var, card, values, evidence, evidence_card, _ in cpds:
        scope = [var] + list(evidence or [])
        operands.append(np.asarray(values, dtype=np.float64).reshape(
            [card] + list(evidence_card or [])))
        subscripts.append("".join(letters[v] for v in scope))
    return np.einsum(",".join(subscripts) + "->" + "".join(letters[v] for v in variables),
                     *operands)


def asia_without_an_edge(cpds, joint, variables, child="dysp", parent="either"):
    """ASIA's CPDs with ``parent -> child`` removed: the child's CPD becomes
    P(child | remaining parents) from the joint."""
    out = []
    for var, card, values, evidence, evidence_card, names in cpds:
        if var == child:
            keep = [e for e in evidence if e != parent]
            axes = tuple(i for i, v in enumerate(variables) if v not in [child] + keep)
            table = joint.sum(axis=axes)
            order = [v for v in variables if v in [child] + keep]
            table = np.transpose(table, [order.index(v) for v in [child] + keep])
            table = table.reshape(card, -1)
            values = table / table.sum(axis=0, keepdims=True)
            evidence, evidence_card = keep, [2] * len(keep)
            names = {k: v for k, v in names.items() if k != parent}
        out.append((var, card, values, evidence, evidence_card, names))
    return out


def test_is_imap_on_asia_agrees_with_jax():
    asia = jax_example("asia")
    cpds = cpd_tuples(asia)
    variables = sorted(asia.nodes())
    joint = joint_table(cpds, variables)
    assert joint.size == 256
    edges = list(asia.edges())
    cut = asia_without_an_edge(cpds, joint, variables)
    # a JPD's state names are 0..card-1: give the models the same
    cpds, cut = ([(v, c, vals, e, ec, {k: [0, 1] for k in n}) for v, c, vals, e, ec, n in t]
                 for t in (cpds, cut))
    cut_edges = [e for e in edges if e != ("either", "dysp")]
    cards = [2] * len(variables)

    port_jpd = JointProbabilityDistribution(variables, cards, joint.ravel())
    jax_jpd = JaxJPD(variables, cards, joint.ravel())
    for model_edges, model_cpds, want in ((edges, cpds, True), (cut_edges, cut, False)):
        port = bn_from_numpy(model_edges, model_cpds)
        ref = JaxBN()
        ref.add_nodes_from(variables)
        ref.add_edges_from(model_edges)
        ref.add_cpds(*[JaxCPD(v, c, vals, evidence=e or None, evidence_card=ec or None,
                              state_names=n) for v, c, vals, e, ec, n in model_cpds])
        assert port.is_imap(port_jpd) == ref.is_imap(jax_jpd) == want
        assert port_jpd.is_imap(port) == jax_jpd.is_imap(ref) == want
    with pytest.raises(TypeError):
        port_jpd.is_imap(port_jpd)


# --------------------------------------------------------------------------- #
# NoisyORCPD
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("probs, evidence", [
    ([0.8, 0.6], ["flu", "cold"]),
    ([0.1, 0.5, 0.9], ["a", "b", "c"]),
    ([0.0, 1.0, 0.25, 0.7], ["p", "q", "r", "s"]),
])
def test_noisy_or_values(probs, evidence):
    port, ref = NoisyORCPD("x", probs, evidence), JaxNoisyOR("x", probs, evidence)
    np.testing.assert_allclose(np_values(port.get_values()), np_values(ref.get_values()),
                               atol=1e-7)
    assert port.state_names == ref.state_names
    assert port.variables == ref.variables
    with pytest.raises(ValueError):
        NoisyORCPD("x", probs + [0.5], evidence)
    with pytest.raises(ValueError):
        NoisyORCPD("x", [1.5] + probs[1:], evidence)


def test_noisy_or_network_query_matches_closed_form():
    from pgmpy_tpu_torch.inference import VariableElimination

    cpd = NoisyORCPD("fever", [0.8, 0.6], evidence=["flu", "cold"])
    model = DiscreteBayesianNetwork([("flu", "fever"), ("cold", "fever")])
    priors = {"flu": 0.1, "cold": 0.3}
    model.add_cpds(cpd, *[
        TabularCPD(v, 2, [[p], [1 - p]], state_names={v: ["True", "False"]})
        for v, p in priors.items()
    ])
    got = VariableElimination(model).query(["fever"], evidence={"flu": "True"})
    want = 1 - (1 - 0.8) * (1 - 0.6 * priors["cold"])
    np.testing.assert_allclose(np_values(got.values), [want, 1 - want], atol=1e-6)


# --------------------------------------------------------------------------- #
# NaiveBayes
# --------------------------------------------------------------------------- #
def naive_bayes_frame(n_features, n_rows, seed, n_classes=3):
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, n_classes, n_rows)
    data = {"class": cls}
    for j in range(n_features):
        flip = rng.random(n_rows) < 0.3 + 0.4 * rng.random()
        data[f"f{j:03d}"] = np.where(flip, rng.integers(0, 2, n_rows), cls % 2)
    return pd.DataFrame(data)


def test_naive_bayes_structure_matches_jax():
    port = NaiveBayes(["a", "b", "c"], "y")
    ref = JaxNaiveBayes(["a", "b", "c"], "y")
    assert sorted(port.edges()) == sorted(ref.edges())
    for start, observed in (("a", None), ("a", "y"), ("a", ["b"]), ("y", ["c"])):
        assert port.active_trail_nodes(start, observed=observed) == \
            ref.active_trail_nodes(start, observed=observed)
        assert port.is_dconnected(start, "c", observed=observed) == \
            ref.is_dconnected(start, "c", observed=observed)
    for variables in ("a", ["a", "b"], "y"):
        assert assertions(port.local_independencies(variables)) == \
            assertions(ref.local_independencies(variables))
    with pytest.raises(ValueError):
        port.add_edge("a", "b")
    grown = NaiveBayes()
    grown.add_edge("y", "a")
    grown.add_edge("y", "b")
    assert grown.dependent == "y" and grown.features == {"a", "b"}


def test_naive_bayes_fit_and_predict_match_jax(monkeypatch):
    frame = naive_bayes_frame(20, 600, seed=1)
    launches = []
    real = estimators_base.table_counts

    def counting(*args, **kwargs):
        launches.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(estimators_base, "table_counts", counting)
    port, ref = NaiveBayes(), JaxNaiveBayes()
    port.fit(frame, parent_node="class")
    ref.fit(frame, parent_node="class")
    assert len(launches) == 1
    for cpd in ref.get_cpds():
        got = port.get_cpds(cpd.variable)
        assert got.variables == cpd.variables
        np.testing.assert_allclose(np_values(got.get_values()), np_values(cpd.get_values()),
                                   atol=1e-6)
    test_rows = naive_bayes_frame(20, 50, seed=2).drop(columns=["class"])
    assert port.predict(test_rows)["class"].tolist() == ref.predict(test_rows)["class"].tolist()
    np.testing.assert_allclose(port.predict_probability(test_rows).to_numpy(dtype=float),
                               ref.predict_probability(test_rows).to_numpy(dtype=float),
                               atol=1e-5)
    with pytest.raises(ValueError):
        NaiveBayes().fit(frame)
    with pytest.raises(ValueError):
        NaiveBayes().fit(frame, parent_node="absent")


def log_space_oracle(model, rows, target):
    """P(target | every other column) per row, numpy float64 in log space,
    from ``model``'s (port) tables."""
    prior = np_values(model.get_cpds(target).values)
    logp = np.tile(np.log(prior), (len(rows), 1))
    for feature in rows.columns:
        cpd = model.get_cpds(feature)
        table = np_values(cpd.values)  # (feature card, class card)
        codes = rows[feature].map({s: i for i, s in enumerate(cpd.state_names[feature])})
        logp += np.log(table[codes.to_numpy(dtype=int)])
    logp -= logp.max(axis=1, keepdims=True)
    p = np.exp(logp)
    return p / p.sum(axis=1, keepdims=True)


def test_predict_survives_four_hundred_observed_features():
    """400 binary features of a naive Bayes: each row multiplies 400 rows of
    ``P(feature | class)`` near 0.5, which underflows float32.  The JAX
    package returns NaN; the port combines the rows in log space and matches a
    numpy float64 oracle."""
    rng = np.random.default_rng(12)
    features = [f"f{j:03d}" for j in range(400)]
    cpds = [("class", 2, np.array([[0.45], [0.55]]), None, None, {"class": [0, 1]})]
    for f in features:
        p = 0.5 + 0.08 * rng.standard_normal(2).clip(-3, 3)
        cpds.append((f, 2, np.stack([p, 1 - p]), ["class"], [2],
                     {f: [0, 1], "class": [0, 1]}))
    edges = [("class", f) for f in features]
    port = NaiveBayes(features, "class")
    port.add_cpds(*bn_from_numpy(edges, cpds).get_cpds())
    ref = JaxNaiveBayes(features, "class")
    ref.add_cpds(*[JaxCPD(v, c, vals, evidence=e, evidence_card=ec, state_names=n)
                   for v, c, vals, e, ec, n in cpds])
    rows = pd.DataFrame(rng.integers(0, 2, (6, 400)), columns=features)

    want = log_space_oracle(port, rows, "class")
    got = port.predict_probability(rows).to_numpy(dtype=float)
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert np.isnan(ref.predict_probability(rows).to_numpy(dtype=float)).all()


# --------------------------------------------------------------------------- #
# discretize
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("method", ["rounding", "quantile"])
def test_discretize_matches_jax(method):
    frame = standalone_gaussian_frame(300, seed=9)
    cards = {c: 3 + i % 3 for i, c in enumerate(frame.columns)}
    labels = {frame.columns[0]: ["lo", "mid", "hi"]}
    got = discretize(frame, cardinality=cards, labels=labels, method=method)
    want = jax_discretize(frame, cardinality=cards, labels=labels, method=method)
    pd.testing.assert_frame_equal(got, want)
    plain = discretize(frame, cardinality=4, method=method)
    pd.testing.assert_frame_equal(plain, jax_discretize(frame, cardinality=4, method=method))


def test_naive_bayes_fit_on_sampled_asia_columns():
    """``fit`` with the class's own states kept (a frame from the shared
    sampler, string states)."""
    asia = jax_example("asia")
    frame = standalone_sample(asia, 800, seed=3)[["either", "xray", "dysp", "tub"]]
    port, ref = NaiveBayes(), JaxNaiveBayes()
    port.fit(frame, parent_node="either")
    ref.fit(frame, parent_node="either")
    for cpd in ref.get_cpds():
        np.testing.assert_allclose(np_values(port.get_cpds(cpd.variable).get_values()),
                                   np_values(cpd.get_values()), atol=1e-6)
        assert port.get_cpds(cpd.variable).state_names == cpd.state_names
