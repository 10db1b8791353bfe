"""ExpertKnowledge: required/forbidden edges and temporal tiers.

Port of ``pgmpy_tpu/estimators/expert_knowledge.py``; host code.
Temporal tiers do NOT eagerly forbid edges at construction — the reference
derives forbidden directions lazily per graph via
``_orient_temporal_forbidden_edges`` (existing edges only inside
``apply_expert_knowledge``; all cross-tier pairs for score-based searches).
"""

import itertools

from pgmpy_tpu_torch.config import logger


class ExpertKnowledge:
    def __init__(
        self,
        forbidden_edges=None,
        required_edges=None,
        temporal_order=None,
        search_space=None,
        **kwargs,
    ):
        self.forbidden_edges = set(map(tuple, forbidden_edges or []))
        self.required_edges = set(map(tuple, required_edges or []))
        self.temporal_order = [list(t) for t in (temporal_order or [])]
        self.search_space = search_space
        if self.forbidden_edges & self.required_edges:
            raise ValueError(
                f"Edges cannot be both required and forbidden: "
                f"{self.forbidden_edges & self.required_edges}"
            )
        # var -> tier map consumed by PC's collider orientation
        # (ref ExpertKnowledge.py:110-111, PC.py:264)
        self.temporal_ordering = {}
        for tier, vars_ in enumerate(self.temporal_order):
            for v in vars_:
                if v in self.temporal_ordering:
                    raise ValueError(
                        f"Variable {v} present in multiple tiers. Aborting"
                    )
                self.temporal_ordering[v] = tier

    def _validate_temporal_order(self, nodes):
        """Every graph node must have a tier (ref ExpertKnowledge.py:123-146)."""
        if not self.temporal_order:
            return
        missing = set(nodes) - set(self.temporal_ordering)
        if missing:
            raise ValueError(f"Missing nodes in temporal order - {missing}")

    def _orient_temporal_forbidden_edges(self, graph, only_edges=True):
        """Fold tier violations into ``forbidden_edges`` (reference
        ``ExpertKnowledge.py:183-216``): with ``only_edges`` just the graph's
        existing adjacencies are checked; otherwise every cross-tier pair
        (later -> earlier) is forbidden — the mode score-based searches use.
        """
        if not self.temporal_ordering:
            return
        forbidden = []
        if only_edges:
            for node in graph.nodes:
                for neighbor in graph.neighbors(node):
                    if self.temporal_ordering[neighbor] < self.temporal_ordering[node]:
                        forbidden.append((node, neighbor))
        else:
            for tier in range(1, len(self.temporal_order)):
                for node in self.temporal_order[tier]:
                    for lower_tier in range(tier):
                        for lower_node in self.temporal_order[lower_tier]:
                            forbidden.append((node, lower_node))
        self.forbidden_edges |= set(forbidden)

    def apply_expert_knowledge(self, pdag):
        """Orient/restrict a PDAG according to required/forbidden edges and
        temporal tiers.  Conflicts with the learned structure are warned and
        ignored, mirroring the reference (``ExpertKnowledge.py:218-268``)."""
        pdag = pdag.copy()
        self._validate_temporal_order(pdag.nodes())
        self._orient_temporal_forbidden_edges(pdag)

        for u, v in self.forbidden_edges:
            if pdag.has_undirected_edge(u, v):
                pdag.orient_undirected_edge(v, u, inplace=True)
            elif pdag.has_edge(u, v):
                logger.warning(
                    "Specified expert knowledge conflicts with learned "
                    f"structure. Ignoring edge {u}->{v} from forbidden edges."
                )
        for u, v in self.required_edges:
            if pdag.has_undirected_edge(u, v):
                pdag.orient_undirected_edge(u, v, inplace=True)
            elif not pdag.has_edge(u, v):
                logger.warning(
                    "Specified expert knowledge conflicts with learned "
                    f"structure. Ignoring edge {u}->{v} from required edges"
                )
        return pdag

    def limit_search_space(self, data_coulumn_labels):
        """Restrict structure search to ``search_space``: every possible edge
        outside it becomes forbidden (mutates ``forbidden_edges``, reference
        ``ExpertKnowledge.py:270-294`` — param name keeps the reference's
        spelling).  Also returns the (black_list, white_list) pair consumed
        by the score-based searches here."""
        all_edges = set(itertools.permutations(data_coulumn_labels, 2))
        if self.search_space:
            self.forbidden_edges |= all_edges - set(map(tuple, self.search_space))
        white_list = (
            set(map(tuple, self.search_space)) if self.search_space else set(all_edges)
        )
        white_list -= self.forbidden_edges
        white_list |= self.required_edges
        black_list = all_edges - white_list
        return black_list, white_list
