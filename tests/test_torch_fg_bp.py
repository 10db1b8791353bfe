"""Loopy BP (``BeliefPropagationWithMessagePassing``) of the port against
pgmpy_tpu, mirroring ``tests/test_fg_bp_device.py``.

Both packages get the same factor graphs, built from the same numpy tables.
Beliefs agree within 1e-5 and the flooding rounds are equal.  Where the
packages part on purpose the port is held to an exact answer instead: a star
of 600 leaves (a tree, so BP is exact), whose float32 product of near-uniform
messages underflows in the JAX package; a float64 run against VE at 1e-10;
and an in-place edit of a factor's values."""

import numpy as np
import pytest
import torch

from pgmpy_tpu.factors.discrete import DiscreteFactor as JaxFactor
from pgmpy_tpu.inference.fg_bp import BeliefPropagationWithMessagePassing as JaxLoopy
from pgmpy_tpu.models import FactorGraph as JaxFactorGraph

from _torch_parity import np_values
from pgmpy_tpu_torch.config import config
from pgmpy_tpu_torch.factors import DiscreteFactor
from pgmpy_tpu_torch.inference import BeliefPropagation, VariableElimination
from pgmpy_tpu_torch.inference.fg_bp import BeliefPropagationWithMessagePassing
from pgmpy_tpu_torch.utils.interop import factor_graph_from_numpy, markov_network_from_numpy


def grid_tables(n, seed, coupling=0.2, card=2):
    """An n x n grid MRF: pairwise exp(coupling N(0,1)) tables."""
    rng = np.random.default_rng(seed)
    names = [[f"x{i}_{j}" for j in range(n)] for i in range(n)]
    scopes, tables = [], []
    for i in range(n):
        for j in range(n):
            for di, dj in ((0, 1), (1, 0)):
                i2, j2 = i + di, j + dj
                if i2 < n and j2 < n:
                    scopes.append([names[i][j], names[i2][j2]])
                    tables.append(np.exp(coupling * rng.standard_normal((card, card))))
    return scopes, {v: card for row in names for v in row}, tables


def star_tables(leaves, seed):
    """A hub with ``leaves`` binary leaves, the grid's couplings."""
    rng = np.random.default_rng(seed)
    scopes = [["hub", f"l{i:03d}"] for i in range(leaves)]
    tables = [np.exp(0.2 * rng.standard_normal((2, 2))) for _ in range(leaves)]
    return scopes, {v: 2 for s in scopes for v in s}, tables


def jax_graph(scopes, cards, tables):
    fg = JaxFactorGraph()
    fg.add_nodes_from(list(dict.fromkeys(v for s in scopes for v in s)))
    factors = [JaxFactor(list(s), [cards[v] for v in s], t) for s, t in zip(scopes, tables)]
    fg.add_factors(*factors)
    fg.add_edges_from((v, f) for f in factors for v in f.variables)
    return fg


def both(scopes, cards, tables):
    return (BeliefPropagationWithMessagePassing(factor_graph_from_numpy(scopes, cards, tables)),
            JaxLoopy(jax_graph(scopes, cards, tables)))


def assert_beliefs_close(got, want, atol=1e-5):
    assert sorted(got) == sorted(want)
    for var in want:
        np.testing.assert_allclose(np_values(got[var].values), np_values(want[var].values),
                                   atol=atol, err_msg=str(var))


def test_grid8_beliefs_and_rounds_match_jax():
    port, ref = both(*grid_tables(8, seed=1))
    variables = sorted(port.variables)
    assert_beliefs_close(port.query(variables), ref.query(variables))
    assert port._program.last_rounds == ref._program.last_rounds < 100


def test_grid8_evidence_matches_jax():
    port, ref = both(*grid_tables(8, seed=2))
    evidence = {"x0_0": 0, "x7_3": 1}
    variables = [v for v in sorted(port.variables) if v not in evidence]
    assert_beliefs_close(port.query(variables, evidence=evidence),
                         ref.query(variables, evidence=evidence))
    assert port._program.last_rounds == ref._program.last_rounds


def test_grid8_virtual_evidence_matches_jax():
    scopes, cards, tables = grid_tables(8, seed=1)
    port, ref = both(scopes, cards, tables)
    rng = np.random.default_rng(3)
    picked = ["x1_1", "x4_6", "x6_2"]
    weights = {v: rng.random(2) + 0.2 for v in picked}
    got = port.query(["x3_3", "x7_7"], evidence={"x0_0": 1},
                     virtual_evidence=[DiscreteFactor([v], [2], w) for v, w in weights.items()])
    want = ref.query(["x3_3", "x7_7"], evidence={"x0_0": 1},
                     virtual_evidence=[JaxFactor([v], [2], w) for v, w in weights.items()])
    assert_beliefs_close(got, want)
    assert port._program.last_rounds == ref._program.last_rounds


def test_warm_start_messages_match_jax():
    port, ref = both(*grid_tables(6, seed=4))
    got, port_messages = port.query(["x0_0", "x5_5"], get_messages=True)
    want, jax_messages = ref.query(["x0_0", "x5_5"], get_messages=True)
    assert_beliefs_close(got, want)
    assert sorted(port_messages) == sorted(jax_messages)
    for key, message in jax_messages.items():
        np.testing.assert_allclose(port_messages[key], np.asarray(message), atol=1e-5)
    cold = port._program.last_rounds
    assert cold == ref._program.last_rounds < 100
    # each package warm-started from the other's messages converges at once
    again = port.query(["x2_3"], precomp_messages=jax_messages)
    want = ref.query(["x2_3"], precomp_messages=port_messages)
    assert_beliefs_close(again, want)
    assert port._program.last_rounds <= 2 and ref._program.last_rounds <= 2


def test_mixed_arity_and_cardinality_match_jax():
    rng = np.random.default_rng(13)
    scopes = [["big", "s1"], ["s1", "s2", "s3"], ["a"], ["a", "b", "s2"], ["b"]]
    cards = {"big": 21, "s1": 2, "s2": 3, "s3": 2, "a": 2, "b": 5}
    tables = [rng.random([cards[v] for v in s]) + 0.1 for s in scopes]
    port, ref = both(scopes, cards, tables)
    variables = sorted(cards)
    assert_beliefs_close(port.query(variables), ref.query(variables))
    assert port._program.last_rounds == ref._program.last_rounds
    shapes = [shape for shape, _, _ in port._program._groups]
    assert (32, 2) in shapes and (2, 4, 2) in shapes and (2, 8, 4) in shapes
    got = port.query(["big", "s3"], evidence={"b": 4, "s2": 1})
    want = ref.query(["big", "s3"], evidence={"b": 4, "s2": 1})
    assert_beliefs_close(got, want)


def test_one_program_per_graph_across_evidence():
    port, _ = both(*grid_tables(4, seed=4))
    port.query(["x0_0"])
    program = port._program
    port.query(["x1_1"], evidence={"x3_3": 0})
    port.query(["x2_2"], evidence={"x0_1": 1, "x3_0": 0})
    assert port._program is program


@pytest.mark.parametrize("target", ["hub", "leaf"])
def test_message_helpers_match_jax(target):
    rng = np.random.default_rng(21)
    port, ref = both(*star_tables(5, seed=2))
    messages = [rng.random(2) for _ in range(3)]
    np.testing.assert_allclose(port.calc_variable_node_message("hub", messages),
                               ref.calc_variable_node_message("hub", messages), atol=1e-12)
    np.testing.assert_allclose(port.calc_variable_node_message("hub", messages[:1]),
                               ref.calc_variable_node_message("hub", messages[:1]), atol=1e-12)
    np.testing.assert_allclose(port.calc_variable_node_message("hub", []),
                               ref.calc_variable_node_message("hub", []), atol=1e-12)
    values = rng.random((2, 3, 4)) + 0.1
    variable = "a" if target == "hub" else "c"
    port_factor = DiscreteFactor(["a", "b", "c"], [2, 3, 4], values)
    jax_factor = JaxFactor(["a", "b", "c"], [2, 3, 4], values)
    incoming = [rng.random(k) for k in ((3, 4) if variable == "a" else (2, 3))]
    np.testing.assert_allclose(
        BeliefPropagationWithMessagePassing.calc_factor_node_message(port_factor, incoming, variable),
        JaxLoopy.calc_factor_node_message(jax_factor, incoming, variable), atol=1e-6)
    with pytest.raises(AssertionError):
        BeliefPropagationWithMessagePassing.calc_factor_node_message(port_factor, incoming[:1],
                                                                     variable)


def star_exact(tables, leaves):
    """Exact beliefs of the star, numpy float64 in log space."""
    log_hub = sum(np.log(t.sum(axis=1)) for t in tables)
    hub = np.exp(log_hub - log_hub.max())
    hub /= hub.sum()
    out = {"hub": hub}
    for i in leaves:
        t = tables[i]
        out[f"l{i:03d}"] = (hub[:, None] * t / t.sum(axis=1, keepdims=True)).sum(axis=0)
    return out


def test_star_of_600_leaves_is_exact_where_jax_underflows():
    scopes, cards, tables = star_tables(600, seed=0)
    port, ref = both(scopes, cards, tables)
    variables = ["hub", "l000", "l123", "l599"]
    want = star_exact(tables, [0, 123, 599])
    got = port.query(variables)
    for var in variables:
        np.testing.assert_allclose(np_values(got[var].values), want[var], atol=1e-5)
    leaves = ref.query(["l000", "l123", "l599"])
    for var, phi in leaves.items():
        values = np_values(phi.values)
        assert np.isnan(values).all() or (values == 0).all(), var


@pytest.fixture
def float64():
    config.set_dtype(torch.float64)
    yield
    config.set_dtype(torch.float32)


def test_float64_tree_matches_ve_to_1e10(float64):
    rng = np.random.default_rng(17)
    names = [f"t{i:02d}" for i in range(30)]
    cards = {v: int(rng.integers(2, 5)) for v in names}
    scopes = [[names[int(rng.integers(0, i))], names[i]] for i in range(1, 30)]
    scopes += [["t03"], ["t17"]]
    tables = [rng.random([cards[v] for v in s]) + 0.05 for s in scopes]
    port = BeliefPropagationWithMessagePassing(factor_graph_from_numpy(scopes, cards, tables))
    assert port._program is None or port._program.dtype == torch.float64
    exact = VariableElimination(markov_network_from_numpy(scopes, cards, tables))
    got = port.query(names[1:], evidence={"t00": 1})
    assert port._program.dtype == torch.float64
    for var in names[1:]:
        want = exact.query([var], evidence={"t00": 1}, show_progress=False)
        want = np_values(want.values) / np_values(want.values).sum()
        assert got[var].values.dtype == torch.float64
        np.testing.assert_allclose(np_values(got[var].values), want, atol=1e-10, rtol=0)


def test_in_place_edit_of_values_changes_the_answer():
    scopes, cards, tables = [["a", "b"]], {"a": 2, "b": 2}, [np.array([[2.0, 1.0], [1.0, 3.0]])]
    fg = factor_graph_from_numpy(scopes, cards, tables)
    bp = BeliefPropagationWithMessagePassing(fg)
    first = np_values(bp.query(["b"])["b"].values)
    fg.factors[0].values[0, 0] = 9.0  # in place: no setter runs
    after = np_values(bp.query(["b"])["b"].values)
    np.testing.assert_allclose(after, np.array([10.0, 4.0]) / 14.0, atol=1e-6)
    assert not np.allclose(first, after)
    fg.factors[0].values = torch.ones((2, 2))  # rebinding works as before
    np.testing.assert_allclose(np_values(bp.query(["b"])["b"].values), [0.5, 0.5], atol=1e-6)


def test_grid8_near_exact_vs_junction_tree():
    scopes, cards, tables = grid_tables(8, seed=1)
    loopy = BeliefPropagationWithMessagePassing(factor_graph_from_numpy(scopes, cards, tables))
    exact = BeliefPropagation(markov_network_from_numpy(scopes, cards, tables))
    exact.calibrate()
    got = loopy.query(["x0_0", "x3_4", "x7_7"])
    for var in ("x0_0", "x3_4", "x7_7"):
        want = exact.query([var], show_progress=False)
        np.testing.assert_allclose(np_values(got[var].values), np_values(want.values),
                                   atol=0.02)
