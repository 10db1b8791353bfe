"""ExpertInLoop: iterative structure learning with an external
edge-orientation oracle (a human callback or an LLM).

Port of ``pgmpy_tpu/estimators/expert.py``: host code over the port's CI
tests, whose discrete members build their contingency tables with the count
kernel (one ``table_counts`` launch per test).  The orientation transport is
injectable (``orientation_fn``, or ``utils.llm_pairwise_orient`` with a
``completion_fn``), so no network is needed.

One divergence on purpose: the discrete tests of the power-divergence family
return ``(statistic, p_value, dof)``, which the JAX package unpacks into two
names and fails on (its default test for discrete data is ``chi_square``).
Here such a triple becomes ``(effect, p_value)`` with the effect Cramér's V,
``sqrt(statistic / (n (min(|X|, |Y|) - 1)))``, which lies in [0, 1] like the
coefficient that ``pillai_trace`` returns.
"""

import itertools

import networkx as nx
import numpy as np
import pandas as pd

from pgmpy_tpu_torch.base.dag import DAG
from pgmpy_tpu_torch.config import logger
from pgmpy_tpu_torch.estimators.base import StructureEstimator
from pgmpy_tpu_torch.estimators.citests import get_callable_ci_test


class ExpertInLoop(StructureEstimator):
    def __init__(self, data=None, **kwargs):
        super().__init__(data=data, **kwargs)
        self.orientation_cache = set()

    def _effect(self, ci_test, X, Y, Z):
        """``(effect, p_value)`` of one CI test (see the module docstring)."""
        result = ci_test(X=X, Y=Y, Z=Z, data=self.data, boolean=False)
        if len(result) == 3:
            statistic, p_value, _ = result
            k = min(len(self.state_names[X]), len(self.state_names[Y])) - 1
            effect = float(np.sqrt(statistic / (self.data.shape[0] * k))) if k > 0 else 0.0
            return effect, p_value
        return result

    def test_all(self, ci_test, dag):
        """Effect sizes and p-values of every variable pair given the current
        DAG: present edges are tested conditional on the other parents (is
        the edge still needed?), absent pairs conditional on both parent sets
        (should an edge be added?)."""
        ci_test = get_callable_ci_test(ci_test, data=self.data)
        results = []
        for u, v in itertools.combinations(list(dag.nodes()), 2):
            u_parents = set(dag.get_parents(u))
            v_parents = set(dag.get_parents(v))
            if v in u_parents:
                u_parents -= {v}
                edge_present = True
            elif u in v_parents:
                v_parents -= {u}
                edge_present = True
            else:
                edge_present = False
            cond_set = list(u_parents | v_parents)
            effect, p_value = self._effect(ci_test, u, v, cond_set)
            results.append([u, v, cond_set, edge_present, effect, p_value])
        return pd.DataFrame(results, columns=["u", "v", "z", "edge_present", "effect", "p_val"])

    def estimate(
        self,
        pval_threshold=0.05,
        effect_size_threshold=0.05,
        ci_test=None,
        orientation_fn=None,
        orientations=set(),
        expert_knowledge=None,
        use_cache=True,
        show_progress=True,
        orient_fn=None,
        variable_descriptions=None,
        **kwargs,
    ):
        """Drop edges whose conditional effect fell below the thresholds, add
        the strongest unexplained dependence, and ask the oracle for its
        orientation.  ``orientations`` and temporal tiers in
        ``expert_knowledge`` pre-empt the oracle; ``use_cache`` reuses past
        answers.  ``orient_fn(u, v, descriptions)`` is the older callback
        shape."""
        if orient_fn is not None and orientation_fn is None:
            orientation_fn = lambda u, v, **kw: orient_fn(u, v, variable_descriptions)  # noqa: E731
        if orientation_fn is None:
            from pgmpy_tpu_torch.utils.utils import llm_pairwise_orient

            orientation_fn = llm_pairwise_orient
        if variable_descriptions is not None and orient_fn is None:
            kwargs.setdefault("descriptions", variable_descriptions)

        dag = DAG()
        dag.add_nodes_from(list(self.data.columns))
        ci_test = get_callable_ci_test(ci_test, data=self.data)

        blacklisted_edges = []
        if expert_knowledge is not None:
            blacklisted_edges = list(expert_knowledge.forbidden_edges)
            if expert_knowledge.required_edges:
                dag.add_edges_from(expert_knowledge.required_edges)

        while True:
            all_effects = self.test_all(ci_test=ci_test, dag=dag)

            # drop edges the data no longer supports
            edge_effects = all_effects[all_effects.edge_present]
            edge_effects = edge_effects[
                (edge_effects.effect < effect_size_threshold)
                & (edge_effects.p_val > pval_threshold)
            ]
            for rec in edge_effects.loc[:, ("u", "v")].to_records(index=False):
                dag.remove_edge(rec[0], rec[1])

            # candidate additions: absent pairs with a significant dependence
            nonedge_effects = all_effects[~all_effects.edge_present]
            nonedge_effects = nonedge_effects[
                (nonedge_effects.effect >= effect_size_threshold)
                & (nonedge_effects.p_val <= pval_threshold)
            ]
            if blacklisted_edges:
                us = [e[0] for e in blacklisted_edges]
                vs = [e[1] for e in blacklisted_edges]
                nonedge_effects = nonedge_effects.loc[
                    ~(
                        (nonedge_effects.u.isin(us) & nonedge_effects.v.isin(vs))
                        | (nonedge_effects.u.isin(vs) & nonedge_effects.v.isin(us))
                    ),
                    :,
                ]
            if edge_effects.shape[0] == 0 and nonedge_effects.shape[0] == 0:
                break

            selected = nonedge_effects.iloc[nonedge_effects.effect.argmax()]
            u, v = selected.u, selected.v
            # the reference's elif-chain: a temporal-ordering tie leaves the
            # edge undecided (blacklisted) rather than asking the oracle
            if (u, v) in orientations:
                edge_direction = (u, v)
            elif (v, u) in orientations:
                edge_direction = (v, u)
            elif expert_knowledge is not None and expert_knowledge.temporal_ordering:
                u_order = expert_knowledge.temporal_ordering.get(u)
                v_order = expert_knowledge.temporal_ordering.get(v)
                edge_direction = None
                if u_order is not None and v_order is not None and u_order != v_order:
                    edge_direction = (u, v) if u_order < v_order else (v, u)
            elif use_cache and (u, v) in self.orientation_cache:
                edge_direction = (u, v)
            elif use_cache and (v, u) in self.orientation_cache:
                edge_direction = (v, u)
            else:
                edge_direction = orientation_fn(u, v, **kwargs)
                if use_cache and edge_direction is not None:
                    self.orientation_cache.add(edge_direction)
                if show_progress and edge_direction is not None:
                    logger.info(
                        f"Queried for edge orientation between {u} and {v}. "
                        f"Got: {edge_direction[0]} -> {edge_direction[1]}"
                    )

            if edge_direction is None:
                blacklisted_edges.append((u, v))
            elif nx.has_path(dag, edge_direction[1], edge_direction[0]):
                edges_to_remove = self._break_cycle(
                    dag, edge_direction[0], edge_direction[1], ci_test=ci_test,
                    effect_size_threshold=effect_size_threshold, pval_threshold=pval_threshold,
                )
                blacklisted_edges.extend(edges_to_remove)
                dag.remove_edges_from(edges_to_remove)
                dag.add_edges_from([edge_direction])
            else:
                dag.add_edges_from([edge_direction])

        return dag

    def _break_cycle(self, dag, u, v, ci_test, effect_size_threshold, pval_threshold):
        """Adding u->v creates a cycle: re-test every other edge on the
        cycle(s) conditional on the remaining cycle nodes and return the edges
        the data no longer supports."""
        edges_to_remove = []
        temp_dag = dag.copy()
        temp_dag.add_edges_from([(u, v)])
        for cycle in nx.simple_cycles(temp_dag):
            closed = list(cycle) + [cycle[0]]
            for x, y in zip(closed, closed[1:]):
                if not ((x == u) and (y == v)) and temp_dag.has_edge(x, y):
                    Z = list(set(cycle) - {x, y})
                    effect, pvalue = self._effect(ci_test, x, y, Z)
                    if effect < effect_size_threshold and pvalue > pval_threshold:
                        edges_to_remove.append((x, y))
                        logger.info(f"Removing edge: {x} -> {y} to fix cycle")
        return edges_to_remove
