"""PC causal discovery: skeleton -> collider orientation -> Meek rules.

Port of ``pgmpy_tpu/estimators/pc.py``; host code on top of
``BaseConstraintEstimator.build_skeleton``, which runs each level's CI tests
from one count launch.
"""

import networkx as nx

from pgmpy_tpu_torch.base.pdag import PDAG
from pgmpy_tpu_torch.estimators.constraint import BaseConstraintEstimator


class PC(BaseConstraintEstimator):
    """Constraint-based causal discovery (skeleton -> colliders -> Meek
    rules); each conditioning-set level runs its CI tests from one launch of
    the count kernel.

    Examples
    --------
    >>> from pgmpy_tpu_torch.estimators import PC
    >>> from pgmpy_tpu_torch.independencies import Independencies
    >>> ind = Independencies(["B", "C"], ["A", ["B", "C"], "D"])
    >>> ind = ind.closure()
    >>> dag = PC(independencies=ind).estimate(
    ...     ci_test="independence_match", variables=list("ABCD"),
    ...     show_progress=False)
    >>> sorted(dag.edges())
    [('B', 'D'), ('C', 'D'), ('D', 'A')]
    """

    def __init__(self, data=None, independencies=None, **kwargs):
        super().__init__(data=data, independencies=independencies, **kwargs)

    def estimate(
        self,
        variant="stable",
        ci_test="chi_square",
        return_type="dag",
        significance_level=0.01,
        max_cond_vars=5,
        expert_knowledge=None,
        enforce_expert_knowledge=False,
        n_jobs=1,
        show_progress=True,
        **kwargs,
    ):
        if variant not in ("orig", "stable", "parallel"):
            raise ValueError(
                f"variant must be one of: orig, stable, or parallel. Got: {variant}"
            )

        skel, separating_sets = self.build_skeleton(
            ci_test=ci_test,
            max_cond_vars=max_cond_vars,
            significance_level=significance_level,
            variant=variant,
            n_jobs=n_jobs,
            show_progress=show_progress,
            expert_knowledge=expert_knowledge,
            **kwargs,
        )
        if return_type.lower() == "skeleton":
            return skel, separating_sets

        # orientation flow mirrors the reference (PC.py:262-281): temporal
        # tiers gate the collider rule, and the order of Meek rules vs
        # expert-knowledge application depends on whether tiers/enforcement
        # are in play
        temporal_ordering = (
            expert_knowledge.temporal_ordering if expert_knowledge is not None else {}
        )
        pdag = self.orient_colliders(skel, separating_sets, temporal_ordering)
        if expert_knowledge is not None and expert_knowledge.temporal_order:
            pdag = expert_knowledge.apply_expert_knowledge(pdag)
            pdag = pdag.apply_meeks_rules(apply_r4=True)
        elif not enforce_expert_knowledge:
            pdag = pdag.apply_meeks_rules(apply_r4=False)
            if expert_knowledge is not None:
                pdag = expert_knowledge.apply_expert_knowledge(pdag)
            pdag = pdag.apply_meeks_rules(apply_r4=True)
        else:
            pdag = pdag.apply_meeks_rules(apply_r4=False)
            if expert_knowledge is not None:
                pdag = expert_knowledge.apply_expert_knowledge(pdag)

        if self.data is not None:
            pdag.add_nodes_from(set(self.data.columns) - set(pdag.nodes()))

        if return_type.lower() in ("pdag", "cpdag"):
            return pdag
        if return_type.lower() == "dag":
            return pdag.to_dag()
        raise ValueError(
            f"return_type must be one of: dag, pdag, cpdag, or skeleton. Got: {return_type}"
        )

    @staticmethod
    def orient_colliders(skeleton, separating_sets, temporal_ordering=None):
        """Orient unshielded triples X - Z - Y as X -> Z <- Y whenever Z is
        not in sepset(X, Y).  With temporal tiers, a collider at Z is only
        oriented if Z's tier is no earlier than both X's and Y's (reference
        ``PC.py:292-360``)."""
        temporal_ordering = temporal_ordering or {}
        pdag = PDAG(undirected_ebunch=list(skeleton.edges()))
        pdag.add_nodes_from(skeleton.nodes())
        node_pairs = list(nx.non_edges(skeleton))
        for u, v in node_pairs:
            if frozenset((u, v)) not in separating_sets:
                continue
            sep_set = set(separating_sets[frozenset((u, v))])
            for z in set(skeleton.neighbors(u)) & set(skeleton.neighbors(v)):
                if z not in sep_set:
                    if temporal_ordering and not (
                        temporal_ordering[z] >= temporal_ordering[u]
                        and temporal_ordering[z] >= temporal_ordering[v]
                    ):
                        continue
                    if pdag.has_undirected_edge(u, z):
                        pdag.orient_undirected_edge(u, z, inplace=True)
                    if pdag.has_undirected_edge(v, z):
                        pdag.orient_undirected_edge(v, z, inplace=True)
        return pdag

    # reference-compatible alias
    skeleton_to_pdag = orient_colliders
