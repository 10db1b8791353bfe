"""Mplp of the port against pgmpy_tpu on the binary grids of the v4 golden
(``mplp_grid_spec``): the same numpy tables in both packages give the same MAP
assignment, decoded value and integrality gap, with and without triplet
tightening.  Mplp is host float64 code in both packages."""

import itertools

import numpy as np
import pytest

from pgmpy_tpu.factors import DiscreteFactor as JaxFactor
from pgmpy_tpu.inference.mplp import Mplp as JaxMplp
from pgmpy_tpu.models import DiscreteMarkovNetwork as JaxMarkov

import _torch_parity  # noqa: F401  (the port on the CPU)
from _golden_data import mplp_grid_spec
from pgmpy_tpu_torch.inference import Mplp
from pgmpy_tpu_torch.utils.interop import markov_network_from_numpy


def grid(rows, cols, seed, frustrated=False):
    nodes, edges, unary, pairwise = mplp_grid_spec(rows, cols, seed)
    if frustrated:
        # antiferromagnetic couplings on a grid with diagonals: odd cycles
        rng = np.random.default_rng(seed + 1)
        edges = edges + [(f"x{r}_{c}", f"x{r + 1}_{c + 1}")
                         for r in range(rows - 1) for c in range(cols - 1)]
        pairwise = {e: np.exp(np.array([[-1.0, 1.0], [1.0, -1.0]]) * rng.uniform(0.5, 1.5))
                    for e in edges}
    scopes = [[n] for n in nodes] + [list(e) for e in edges]
    tables = [unary[n] for n in nodes] + [pairwise[e] for e in edges]
    return nodes, scopes, tables


def jax_markov(scopes, tables):
    model = JaxMarkov()
    model.add_nodes_from(list(dict.fromkeys(v for s in scopes for v in s)))
    model.add_edges_from(tuple(s) for s in scopes if len(s) == 2)
    model.add_factors(*[JaxFactor(list(s), [2] * len(s), t) for s, t in zip(scopes, tables)])
    return model


CASES = [(3, 3, 55, False), (4, 4, 7, False), (3, 4, 3, True), (4, 4, 11, True)]


@pytest.mark.parametrize("rows, cols, seed, frustrated", CASES)
@pytest.mark.parametrize("tighten", [True, False])
def test_map_query_matches_jax(rows, cols, seed, frustrated, tighten):
    nodes, scopes, tables = grid(rows, cols, seed, frustrated)
    port = Mplp(markov_network_from_numpy(scopes, {n: 2 for n in nodes}, tables))
    ref = JaxMplp(jax_markov(scopes, tables))
    got = port.map_query(tighten_triplet=tighten)
    want = ref.map_query(tighten_triplet=tighten)
    assert {str(k): int(v) for k, v in got.items()} == {str(k): int(v) for k, v in want.items()}
    assert port.best_decoded_value == pytest.approx(ref.best_decoded_value, abs=1e-9)
    assert port.get_integrality_gap() == pytest.approx(ref.get_integrality_gap(), abs=1e-9)
    assert len(port.triplets) == len(ref.triplets)


def test_map_is_optimal_on_a_small_grid():
    nodes, scopes, tables = grid(3, 3, 55)
    port = Mplp(markov_network_from_numpy(scopes, {n: 2 for n in nodes}, tables))
    got = port.map_query()

    def energy(assign):
        return sum(float(np.log(t[tuple(assign[v] for v in s)])) for s, t in zip(scopes, tables))

    best = max(energy(dict(zip(nodes, vals)))
               for vals in itertools.product([0, 1], repeat=len(nodes)))
    assert energy({k: int(v) for k, v in got.items()}) == pytest.approx(best, abs=1e-9)
    with pytest.raises(NotImplementedError):
        port.query()
