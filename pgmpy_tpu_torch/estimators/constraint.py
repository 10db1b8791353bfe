"""Constraint-based skeleton discovery (PC-style).

Port of ``pgmpy_tpu/estimators/constraint.py``.  With a test of the discrete
power-divergence family, the variants ``"stable"`` and ``"parallel"`` freeze
the neighbours at each conditioning-set size and send the whole level to
``power_divergence_batch``: one ``table_counts`` launch per non-empty level
(the port has no chunking), then the per-test loop's first-success order
replayed on the host.  ``"orig"`` and every other test run per pair.
"""

import itertools
from itertools import combinations

import networkx as nx

from pgmpy_tpu_torch.config import logger
from pgmpy_tpu_torch.estimators.base import StructureEstimator
from pgmpy_tpu_torch.estimators.citests import get_callable_ci_test


# sentinel: "this ci_test has no batched path" (None is a real
# lambda_ value in the batch API, so it cannot be the sentinel)
_NOT_BATCHABLE = object()


class BaseConstraintEstimator(StructureEstimator):
    def __init__(self, data=None, independencies=None, **kwargs):
        super().__init__(data=data, independencies=independencies, **kwargs)

    def build_skeleton(
        self,
        ci_test="chi_square",
        max_cond_vars=5,
        significance_level=0.01,
        variant="stable",
        n_jobs=1,
        show_progress=True,
        expert_knowledge=None,
        **kwargs,
    ):
        """Returns (skeleton: nx.Graph, separating_sets: dict)."""
        from pgmpy_tpu_torch.estimators import citests as _ct

        test_fn = get_callable_ci_test(ci_test)
        batch_lambda = _NOT_BATCHABLE
        if self.data is not None:
            variables = list(self.variables)
            test_kwargs = dict(
                data=self.data, boolean=True,
                significance_level=significance_level, **kwargs,
            )
            # discrete power-divergence family -> whole-level batched path
            # (identical results; the statistic is a pure function of the
            # count tensor, and a level's tensors come from one launch).
            # Single registry: citests.BATCHABLE_DISCRETE_TESTS, resolved by
            # function identity (None = caller-supplied lambda_), so a
            # wrapped or monkeypatched test takes the per-test path.
            _by_fn = {
                getattr(_ct, name): lam
                for name, lam in _ct.BATCHABLE_DISCRETE_TESTS.items()
            }
            if test_fn in _by_fn and self._coded is not None:
                batch_lambda = _by_fn[test_fn]
                if batch_lambda is None:
                    batch_lambda = kwargs.get("lambda_", "cressie-read")
        elif self.independencies is not None:
            variables = sorted(self.independencies.get_all_variables(), key=str)
            test_fn = get_callable_ci_test("independence_match")
            test_kwargs = dict(independencies=self.independencies)
        else:
            raise ValueError("Either data or independencies must be specified")

        graph = nx.complete_graph(variables)
        if expert_knowledge is not None:
            for u, v in expert_knowledge.forbidden_edges:
                if graph.has_edge(u, v) and (v, u) in expert_knowledge.forbidden_edges:
                    graph.remove_edge(u, v)

        separating_sets = {}
        lim_neighbors = 0
        while not all(
            len(list(graph.neighbors(var))) < lim_neighbors for var in variables
        ):
            if variant == "orig":
                edges = list(graph.edges())
                for u, v in edges:
                    if not graph.has_edge(u, v):
                        continue
                    for sep_set in itertools.chain(
                        combinations(set(graph.neighbors(u)) - {v}, lim_neighbors),
                        combinations(set(graph.neighbors(v)) - {u}, lim_neighbors),
                    ):
                        if test_fn(u, v, list(sep_set), **test_kwargs):
                            separating_sets[frozenset((u, v))] = sep_set
                            graph.remove_edge(u, v)
                            break
            else:  # "stable" / "parallel": neighbors frozen per level
                neighbors = {node: set(graph[node]) for node in graph.nodes()}
                level_tests = [
                    (
                        u,
                        v,
                        list(
                            itertools.chain(
                                combinations(neighbors[u] - {v}, lim_neighbors),
                                combinations(neighbors[v] - {u}, lim_neighbors),
                            )
                        ),
                    )
                    for u, v in list(graph.edges())
                ]
                if batch_lambda is not _NOT_BATCHABLE:
                    # Whole level in one count launch: neighbors are
                    # frozen, so the full (edge, sepset) candidate list is
                    # known up front and the sequential first-success replay
                    # below is exactly the per-test loop's behavior.
                    from pgmpy_tpu_torch.estimators.citests import power_divergence_batch

                    triples = [
                        (u, v, list(sep_set))
                        for u, v, sep_sets in level_tests
                        for sep_set in sep_sets
                    ]
                    results = iter(
                        power_divergence_batch(
                            triples, lambda_=batch_lambda, coded=self._coded
                        )
                    )
                    for u, v, sep_sets in level_tests:
                        removed = False
                        for sep_set in sep_sets:
                            _, p_value, _ = next(results)
                            # NaN p (all-degenerate slices) keeps the edge,
                            # matching the boolean per-test path
                            if not removed and p_value >= significance_level:
                                separating_sets[frozenset((u, v))] = sep_set
                                if graph.has_edge(u, v):
                                    graph.remove_edge(u, v)
                                removed = True
                    del results
                else:
                    for u, v, sep_sets in level_tests:
                        for sep_set in sep_sets:
                            if test_fn(u, v, list(sep_set), **test_kwargs):
                                separating_sets[frozenset((u, v))] = sep_set
                                if graph.has_edge(u, v):
                                    graph.remove_edge(u, v)
                                break
            lim_neighbors += 1
            if lim_neighbors > max_cond_vars:
                logger.warning(
                    "Reached maximum number of allowed conditional variables. Exiting"
                )
                break
        return graph, separating_sets
