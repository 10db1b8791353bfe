"""GES: greedy equivalence search (forward add / backward delete / flip).

Port of ``pgmpy_tpu/estimators/ges.py`` — three greedy phases with
expert-knowledge gating (forbidden/required edges, temporal tiers, search
space) and a ``min_improvement`` stopping rule.  Each phase iteration primes
the score cache with ALL candidate (variable, parents) specs
(``ScoreCache.prime`` -> ``multi_counts_padded``): one ``table_counts``
launch when any spec is uncached, none otherwise.  The ``nx.has_path``
legality checks stay host code.
"""

import itertools

import networkx as nx
import numpy as np

from pgmpy_tpu_torch.base.dag import DAG
from pgmpy_tpu_torch.estimators.base import StructureEstimator
from pgmpy_tpu_torch.estimators.expert_knowledge import ExpertKnowledge
from pgmpy_tpu_torch.estimators.scores import get_scoring_method


class GES(StructureEstimator):
    def __init__(self, data, use_cache=True, **kwargs):
        self.use_cache = use_cache
        super().__init__(data, **kwargs)

    @staticmethod
    def _legal_edge_additions(model, expert_knowledge):
        edges = []
        for u, v in itertools.combinations(model.nodes(), 2):
            if not (model.has_edge(u, v) or model.has_edge(v, u)):
                if not nx.has_path(model, v, u) and (
                    (u, v) not in expert_knowledge.forbidden_edges
                ):
                    edges.append((u, v))
                if not nx.has_path(model, u, v) and (
                    (v, u) not in expert_knowledge.forbidden_edges
                ):
                    edges.append((v, u))
        return edges

    @staticmethod
    def _legal_edge_removals(model, expert_knowledge):
        return [
            (u, v)
            for u, v in model.edges()
            if (u, v) not in expert_knowledge.required_edges
        ]

    @staticmethod
    def _legal_edge_flips(model, expert_knowledge):
        flips = []
        for u, v in list(model.edges()):
            if (u, v) not in expert_knowledge.required_edges and (
                (v, u) not in expert_knowledge.forbidden_edges
            ):
                model.remove_edge(u, v)
                if not nx.has_path(model, u, v):
                    flips.append((v, u))
                model.add_edge(u, v)
        return flips

    def estimate(
        self,
        scoring_method=None,
        expert_knowledge=None,
        min_improvement=1e-6,
        debug=False,
        **kwargs,
    ):
        scorer, score_cache = get_scoring_method(
            scoring_method, self.data, self.use_cache
        )
        score_fn = score_cache.local_score

        current_model = DAG()
        current_model.add_nodes_from(self.variables)
        if expert_knowledge is None:
            expert_knowledge = ExpertKnowledge()
        if expert_knowledge.search_space:
            expert_knowledge.limit_search_space(self.variables)
        expert_knowledge._orient_temporal_forbidden_edges(
            current_model, only_edges=False
        )

        # forward: greedily add the best edge until no improvement
        while True:
            candidates = self._legal_edge_additions(current_model, expert_knowledge)
            if not candidates:
                break
            score_cache.prime(
                [
                    spec
                    for u, v in candidates
                    for spec in (
                        (v, list(current_model.predecessors(v)) + [u]),
                        (v, list(current_model.predecessors(v))),
                    )
                ]
            )
            deltas = np.array(
                [
                    score_fn(v, list(current_model.predecessors(v)) + [u])
                    - score_fn(v, list(current_model.predecessors(v)))
                    for u, v in candidates
                ]
            )
            if np.all(deltas < min_improvement):
                break
            u, v = candidates[int(np.argmax(deltas))]
            current_model.add_edge(u, v)

        # backward: greedily delete while improving
        while True:
            candidates = self._legal_edge_removals(current_model, expert_knowledge)
            if not candidates:
                break
            score_cache.prime(
                [
                    spec
                    for u, v in candidates
                    for spec in (
                        (v, [p for p in current_model.predecessors(v) if p != u]),
                        (v, list(current_model.predecessors(v))),
                    )
                ]
            )
            deltas = np.array(
                [
                    score_fn(
                        v,
                        [p for p in current_model.predecessors(v) if p != u],
                    )
                    - score_fn(v, list(current_model.predecessors(v)))
                    for u, v in candidates
                ]
            )
            if np.all(deltas < min_improvement):
                break
            u, v = candidates[int(np.argmax(deltas))]
            current_model.remove_edge(u, v)

        # flips: reverse edges while improving
        while True:
            candidates = self._legal_edge_flips(current_model, expert_knowledge)
            if not candidates:
                break
            score_cache.prime(
                [
                    spec
                    for u, v in candidates
                    for spec in (
                        (v, list(current_model.predecessors(v)) + [u]),
                        (v, list(current_model.predecessors(v))),
                        (u, [p for p in current_model.predecessors(u) if p != v]),
                        (u, list(current_model.predecessors(u))),
                    )
                ]
            )
            deltas = []
            for u, v in candidates:
                v_parents = list(current_model.predecessors(v))
                u_parents = list(current_model.predecessors(u))
                deltas.append(
                    (score_fn(v, v_parents + [u]) - score_fn(v, v_parents))
                    + (
                        score_fn(u, [p for p in u_parents if p != v])
                        - score_fn(u, u_parents)
                    )
                )
            deltas = np.array(deltas)
            if np.all(deltas < min_improvement):
                break
            u, v = candidates[int(np.argmax(deltas))]
            current_model.remove_edge(v, u)
            current_model.add_edge(u, v)

        return current_model
