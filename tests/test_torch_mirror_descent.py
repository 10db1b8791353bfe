"""MirrorDescentEstimator of the port against pgmpy_tpu.

Both packages get the same model (built from the same numpy tables) and the
same frame; the fitted count-space clique marginals agree within 1e-4
relative, for L1 and L2, a fixed step and the line search, and a warm start
from an earlier fit."""

import itertools

import numpy as np
import pandas as pd
import pytest

from pgmpy_tpu.estimators import MirrorDescentEstimator as JaxMirrorDescent
from pgmpy_tpu.factors import DiscreteFactor as JaxFactor
from pgmpy_tpu.models import DiscreteMarkovNetwork as JaxMarkov
from pgmpy_tpu.utils import get_example_model as jax_example

from _golden_data import mplp_grid_spec, standalone_sample
from _torch_parity import np_values
from pgmpy_tpu_torch.estimators import MirrorDescentEstimator
from pgmpy_tpu_torch.utils.interop import markov_network_from_numpy


def jax_markov(scopes, cards, tables):
    model = JaxMarkov()
    model.add_nodes_from(list(dict.fromkeys(v for s in scopes for v in s)))
    model.add_edges_from(p for s in scopes for p in itertools.combinations(s, 2))
    model.add_factors(*[JaxFactor(list(s), [cards[v] for v in s], t)
                        for s, t in zip(scopes, tables)])
    return model


def grid_case():
    """A 3 x 3 binary grid and 3,000 rows drawn from its normalised joint."""
    nodes, edges, unary, pairwise = mplp_grid_spec(3, 3, seed=5)
    scopes = [[n] for n in nodes] + [list(e) for e in edges]
    tables = [unary[n] for n in nodes] + [pairwise[e] for e in edges]
    joint = np.ones([2] * len(nodes))
    for scope, table in zip(scopes, tables):
        shape = [2 if v in scope else 1 for v in nodes]
        order = sorted(scope, key=nodes.index)
        t = np.transpose(table, [scope.index(v) for v in order]) if len(scope) > 1 else table
        joint = joint * t.reshape(shape)
    p = joint.ravel() / joint.sum()
    rng = np.random.default_rng(6)
    codes = np.unravel_index(rng.choice(p.size, size=3000, p=p), joint.shape)
    frame = pd.DataFrame(np.stack(codes, axis=1), columns=nodes)
    ones = [np.ones([2] * len(s)) for s in scopes]
    return scopes, {n: 2 for n in nodes}, ones, frame


def asia_case():
    """ASIA's moral graph (one unit factor per CPD scope) and 2,000 rows."""
    asia = jax_example("asia")
    scopes = [[c.variable] + list(c.variables[1:]) for c in asia.get_cpds()]
    cards = {v: 2 for v in asia.nodes()}
    frame = standalone_sample(asia, 2000, seed=8)
    return scopes, cards, [np.ones([2] * len(s)) for s in scopes], frame


CASES = {"grid": grid_case, "asia": asia_case}


def fitted(jt):
    return {frozenset(f.variables): f for f in jt.factors}


def assert_marginals_close(port_jt, jax_jt, rtol=1e-4):
    port, ref = fitted(port_jt), fitted(jax_jt)
    assert set(port) == set(ref)
    for key, want in ref.items():
        got = port[key]
        perm = [got.variables.index(v) for v in want.variables]
        got_values = np.transpose(np_values(got.values), perm)
        np.testing.assert_allclose(got_values, np_values(want.values), rtol=rtol,
                                   atol=rtol * np_values(want.values).max())


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("metric", ["L1", "L2"])
@pytest.mark.parametrize("stepsize", [None, "fixed"])
def test_fit_matches_jax(case, metric, stepsize):
    scopes, cards, tables, frame = CASES[case]()
    step = None if stepsize is None else 0.5 / len(frame)
    kwargs = dict(metric=metric, iterations=40, stepsize=step, show_progress=False)
    port = MirrorDescentEstimator(markov_network_from_numpy(scopes, cards, tables), frame)
    ref = JaxMirrorDescent(jax_markov(scopes, cards, tables), frame)
    assert_marginals_close(port.estimate(**kwargs), ref.estimate(**kwargs))
    # the fitted potentials serve queries through a calibrated BP
    assert port.belief_propagation.clique_beliefs


@pytest.mark.parametrize("case", sorted(CASES))
def test_warm_start_matches_jax(case):
    scopes, cards, tables, frame = CASES[case]()
    port = MirrorDescentEstimator(markov_network_from_numpy(scopes, cards, tables), frame)
    ref = JaxMirrorDescent(jax_markov(scopes, cards, tables), frame)
    for _ in range(2):
        got = port.estimate(iterations=15, show_progress=False)
        want = ref.estimate(iterations=15, show_progress=False)
    assert_marginals_close(got, want)


def test_marginal_subsets_and_errors():
    scopes, cards, tables, frame = grid_case()
    marginals = [("x0_0",), ("x0_0", "x0_1"), ("x1_1", "x2_1")]
    port = MirrorDescentEstimator(markov_network_from_numpy(scopes, cards, tables), frame)
    ref = JaxMirrorDescent(jax_markov(scopes, cards, tables), frame)
    kwargs = dict(marginals=marginals, iterations=30, show_progress=False)
    assert_marginals_close(port.estimate(**kwargs), ref.estimate(**kwargs))
    with pytest.raises(ValueError):
        port.estimate(metric="L3")
    with pytest.raises(ValueError):
        port.estimate(marginals=[("x0_0", "x2_2")])
