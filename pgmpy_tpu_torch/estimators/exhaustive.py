"""ExhaustiveSearch: score every DAG (practical to ~6 nodes).

Port of ``pgmpy_tpu/estimators/exhaustive.py``.  Every distinct local score
(``n * 2^(n-1)`` of them) is primed in one table-count call before the DAG
enumeration starts.
"""

import itertools

import networkx as nx

from pgmpy_tpu_torch.base.dag import DAG
from pgmpy_tpu_torch.config import logger
from pgmpy_tpu_torch.estimators.base import StructureEstimator
from pgmpy_tpu_torch.estimators.scores import get_scoring_method


class ExhaustiveSearch(StructureEstimator):
    def __init__(self, data, scoring_method=None, use_cache=True, **kwargs):
        super().__init__(data, **kwargs)
        # None auto-selects by dataset type inside get_scoring_method
        # (BIC for discrete — reference StructureScore.py:67-69)
        _, self.scoring_method = get_scoring_method(scoring_method, data, use_cache)

    def all_dags(self, nodes=None):
        """Generate every DAG over ``nodes`` (super-exponential!)."""
        if nodes is None:
            nodes = sorted(self.variables, key=str)
        if len(nodes) > 6:
            logger.warning(
                f"Generating all DAGs of n nodes likely not feasible for n>6! "
                f"Attempting to search through {2 ** (len(nodes) * (len(nodes) - 1))} graphs"
            )
        # EXACT reference enumeration order (ExhaustiveSearch.py:92-93):
        # all forward combinations first, then all reversals — score ties
        # between Markov-equivalent DAGs are broken by first-enumerated,
        # so the order is part of the observable contract
        edges = list(itertools.combinations(nodes, 2))
        edges.extend([(y, x) for x, y in edges])
        for subset_size in range(len(edges) + 1):
            for edge_subset in itertools.combinations(edges, subset_size):
                graph = nx.DiGraph(edge_subset)
                graph.add_nodes_from(nodes)
                if nx.is_directed_acyclic_graph(graph):
                    yield graph

    def all_scores(self):
        """[(score, dag)] for every DAG, sorted ascending."""
        # Prime every possible (node, parent-set) local score in one
        # batched device dispatch up front: the DAG enumeration is
        # super-exponential but the distinct local scores are only
        # n * 2^(n-1), so warming the cache removes ALL per-DAG device
        # work from the loop.
        nodes = sorted(self.variables, key=str)
        if len(nodes) <= 6:
            others = {v: [u for u in nodes if u != v] for v in nodes}
            self.scoring_method.prime(
                [
                    (v, list(ps))
                    for v in nodes
                    for k in range(len(nodes))
                    for ps in itertools.combinations(others[v], k)
                ]
            )
        scored = []
        for dag in self.all_dags():
            score = sum(
                self.scoring_method.local_score(node, list(dag.predecessors(node)))
                for node in dag.nodes()
            )
            scored.append((score, dag))
        scored.sort(key=lambda t: t[0])
        return scored

    def estimate(self):
        best_score, best_dag = max(self.all_scores(), key=lambda t: t[0])
        out = DAG()
        out.add_nodes_from(best_dag.nodes())
        out.add_edges_from(best_dag.edges())
        return out
