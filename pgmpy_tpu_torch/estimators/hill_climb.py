"""HillClimbSearch: greedy add/remove/flip structure search.

Port of ``pgmpy_tpu/estimators/hill_climb.py``.  Every iteration asks for all
the count tables it will score in ONE ``table_counts`` call
(``ScoreCache.prime``); the scores themselves are host float64 code
(``estimators/scores.py``).
"""

import itertools
from collections import deque

import networkx as nx

from pgmpy_tpu_torch.base.dag import DAG
from pgmpy_tpu_torch.estimators.base import StructureEstimator
from pgmpy_tpu_torch.estimators.scores import get_scoring_method


class HillClimbSearch(StructureEstimator):
    """Greedy structure search (add/remove/flip with a tabu list); every
    iteration's candidate scores are primed in ONE batched device
    dispatch via ``ScoreCache.prime``.

    Examples
    --------
    >>> import numpy as np
    >>> import pandas as pd
    >>> from pgmpy_tpu_torch.estimators import HillClimbSearch
    >>> rng = np.random.default_rng(0)
    >>> a = rng.integers(0, 2, 500)
    >>> b = np.where(rng.random(500) < 0.9, a, 1 - a)  # b copies a
    >>> c = rng.integers(0, 2, 500)                    # independent
    >>> df = pd.DataFrame({"a": a, "b": b, "c": c})
    >>> dag = HillClimbSearch(df).estimate(scoring_method="bic-d",
    ...                                    show_progress=False)
    >>> sorted(map(sorted, dag.edges()))
    [['a', 'b']]
    """

    def __init__(self, data, use_cache=True, **kwargs):
        self.use_cache = use_cache
        super().__init__(data, **kwargs)

    def _legal_operations(
        self, model, score, structure_score, tabu_list, max_indegree,
        black_list, white_list, fixed_edges,
    ):
        tabu_set = set(tabu_list)

        # additions — iterate in sorted order so score ties break
        # deterministically (the reference iterates a python set here,
        # which makes its tie-breaks hash-order dependent across runs)
        present = set(model.edges()) | {(Y, X) for X, Y in model.edges()}
        potential_new_edges = [
            e
            for e in itertools.permutations(self.variables, 2)
            if e not in present
        ]
        # one descendants map per sweep replaces a per-candidate
        # nx.has_path: O(V) BFS traversals instead of O(V^2) path queries
        # (profiled at >half the total HillClimb wall time on ALARM)
        descendants = {n: nx.descendants(model, n) for n in model.nodes()}
        for X, Y in potential_new_edges:
            if X in descendants[Y]:  # X->Y would close a cycle
                continue
            operation = ("+", (X, Y))
            if (
                operation not in tabu_set
                and (X, Y) not in black_list
                and (X, Y) in white_list
            ):
                old_parents = list(model.predecessors(Y))
                new_parents = old_parents + [X]
                if max_indegree is None or len(new_parents) <= max_indegree:
                    score_delta = score(Y, new_parents) - score(Y, old_parents)
                    score_delta += structure_score("+")
                    yield operation, score_delta

        # removals
        for X, Y in model.edges():
            operation = ("-", (X, Y))
            if operation not in tabu_set and (X, Y) not in fixed_edges:
                old_parents = list(model.predecessors(Y))
                new_parents = [p for p in old_parents if p != X]
                score_delta = score(Y, new_parents) - score(Y, old_parents)
                score_delta += structure_score("-")
                yield operation, score_delta

        # flips
        for X, Y in list(model.edges()):
            # flipping is legal only if no OTHER directed path X->...->Y exists
            model.remove_edge(X, Y)
            creates_cycle = nx.has_path(model, X, Y)
            model.add_edge(X, Y)
            if creates_cycle:
                continue
            operation = ("flip", (X, Y))
            if (
                operation not in tabu_set
                and ("flip", (Y, X)) not in tabu_set
                and (X, Y) not in fixed_edges
                and (Y, X) not in black_list
                and (Y, X) in white_list
            ):
                old_X_parents = list(model.predecessors(X))
                old_Y_parents = list(model.predecessors(Y))
                new_X_parents = old_X_parents + [Y]
                new_Y_parents = [p for p in old_Y_parents if p != X]
                if max_indegree is None or len(new_X_parents) <= max_indegree:
                    score_delta = (
                        score(X, new_X_parents)
                        + score(Y, new_Y_parents)
                        - score(X, old_X_parents)
                        - score(Y, old_Y_parents)
                    )
                    score_delta += structure_score("flip")
                    yield operation, score_delta

    def estimate(
        self,
        scoring_method=None,
        start_dag=None,
        fixed_edges=set(),
        tabu_length=100,
        max_indegree=None,
        expert_knowledge=None,
        black_list=None,
        white_list=None,
        epsilon=1e-4,
        max_iter=1e6,
        show_progress=True,
    ):
        scorer, score_cache = get_scoring_method(
            scoring_method, self.data, self.use_cache
        )
        score_fn = score_cache.local_score

        if start_dag is None:
            start_dag = DAG()
            start_dag.add_nodes_from(self.variables)
        elif set(start_dag.nodes()) != set(self.variables):
            raise ValueError(
                "'start_dag' should be a DAG with the same variables as the data set"
            )

        if not hasattr(fixed_edges, "__iter__"):
            raise ValueError("fixed_edges must be an iterable")
        fixed_edges = set(fixed_edges)
        start_dag.add_edges_from(fixed_edges)
        if not nx.is_directed_acyclic_graph(start_dag):
            raise ValueError("fixed_edges creates a cycle in start_dag")

        black_list = set(black_list) if black_list else set()
        white_list = (
            set(white_list)
            if white_list
            else set(itertools.permutations(self.variables, 2))
        )
        if expert_knowledge is not None:
            # reference API (ref HillClimbSearch.py:146,231-246): required
            # edges seed the start DAG, forbidden edges never appear;
            # temporal tiers forbid every later->earlier pair
            expert_knowledge._orient_temporal_forbidden_edges(
                start_dag, only_edges=False
            )
            ek_black, ek_white = expert_knowledge.limit_search_space(
                self.variables
            )
            black_list |= ek_black
            white_list &= ek_white
            fixed_edges = fixed_edges | expert_knowledge.required_edges
            start_dag.add_edges_from(expert_knowledge.required_edges)
            if not nx.is_directed_acyclic_graph(start_dag):
                raise ValueError("required_edges create a cycle in start_dag")
            start_dag.remove_edges_from(expert_knowledge.forbidden_edges)

        tabu_list = deque(maxlen=int(tabu_length))
        current_model = start_dag

        iteration = 0
        while iteration < int(max_iter):
            iteration += 1
            # Phase 1: dry-run the legal-operations generator with a
            # recording score to collect every (variable, parents) it will
            # evaluate, then batch-compute all uncached locals in ONE
            # table-count launch (ScoreCache.prime), so the per-candidate
            # loop below runs against a warm cache: one launch and one
            # readback per iteration instead of one per candidate (the
            # reference fans the candidates out with joblib instead).
            # Legality checks are pure host graph ops, cheap to run twice.
            specs = []

            def _record(var, parents, _specs=specs):
                _specs.append((var, tuple(parents)))
                return 0.0

            for _ in self._legal_operations(
                current_model, _record, lambda op: 0.0, tabu_list,
                max_indegree, black_list, white_list, fixed_edges,
            ):
                pass
            score_cache.prime(specs)

            best_operation, best_score_delta = max(
                self._legal_operations(
                    current_model, score_fn, score_cache.structure_prior_ratio,
                    tabu_list, max_indegree, black_list, white_list, fixed_edges,
                ),
                key=lambda t: t[1],
                default=(None, None),
            )
            if best_operation is None or best_score_delta < epsilon:
                break
            if best_operation[0] == "+":
                current_model.add_edge(*best_operation[1])
                tabu_list.append(("-", best_operation[1]))
            elif best_operation[0] == "-":
                current_model.remove_edge(*best_operation[1])
                tabu_list.append(("+", best_operation[1]))
            else:
                X, Y = best_operation[1]
                current_model.remove_edge(X, Y)
                current_model.add_edge(Y, X)
                tabu_list.append(best_operation)
        return current_model
