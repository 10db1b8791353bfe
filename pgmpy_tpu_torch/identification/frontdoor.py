"""Frontdoor identification.

Port of ``pgmpy_tpu/identification/frontdoor.py`` (reference:
``pgmpy/identification/frontdoor.py:8-122``); host graph code.
Returns role-annotated graphs: ``identify`` assigns the ``frontdoor`` role
to a satisfying set (or all of them with ``variant='all'``); ``validate``
checks the graph's current ``frontdoor`` role against the three frontdoor
conditions.
"""

import networkx as nx

from pgmpy_tpu_torch.base import DAG
from pgmpy_tpu_torch.identification.adjustment import Adjustment
from pgmpy_tpu_torch.identification.base import BaseIdentification
from pgmpy_tpu_torch.utils.mathext import powerset


class Frontdoor(BaseIdentification):
    def __init__(self, variant=None):
        self.supported_graph_types = (DAG,)
        self.variant = variant

    def _identify(self, causal_graph):
        exposure = causal_graph.get_role("exposure")
        outcome = causal_graph.get_role("outcome")
        possible_frontdoor_vars = (
            set(causal_graph.observed) - set(exposure) - set(outcome)
        )
        valid_frontdoor_graphs = []
        for s in powerset(sorted(possible_frontdoor_vars, key=str)):
            updated = causal_graph.with_role("frontdoor", s, inplace=False)
            if self.validate(updated):
                if self.variant is None:
                    return updated, True
                if self.variant == "all":
                    valid_frontdoor_graphs.append(updated)
        if valid_frontdoor_graphs:
            return valid_frontdoor_graphs, True
        return causal_graph, False

    @staticmethod
    def _is_valid_adjustment_set(causal_graph, X, Y, Z):
        graph = causal_graph.copy()
        for role in ("exposure", "outcome", "adjustment"):
            graph.without_role(role, inplace=True)
        graph.with_role("exposure", X, inplace=True)
        graph.with_role("outcome", Y, inplace=True)
        graph.with_role("adjustment", Z, inplace=True)
        return Adjustment().validate(graph)

    def _validate(self, causal_graph):
        """The graph's ``frontdoor`` role Z must (1) intercept every directed
        exposure->outcome path, (2) have no unblocked backdoor path from
        exposure, (3) have all its backdoor paths to the outcome blocked by
        the exposure (ref ``frontdoor.py:81-122``)."""
        exposure = causal_graph.get_role("exposure")[0]
        outcome = causal_graph.get_role("outcome")[0]
        Z = causal_graph.get_role("frontdoor")

        directed_paths = list(nx.all_simple_paths(causal_graph, exposure, outcome))
        if len(directed_paths) == 0:
            return False

        # 1. Z intercepts all directed paths from X to Y
        if any(not any(zz in path for zz in Z) for path in directed_paths):
            return False

        # 2. no unblocked backdoor path from X to any z
        for zz in Z:
            if not self._is_valid_adjustment_set(
                causal_graph, X=exposure, Y=zz, Z=set()
            ):
                return False

        # 3. all backdoor paths from each z to Y are blocked by X
        for zz in Z:
            if not self._is_valid_adjustment_set(
                causal_graph, X=zz, Y=outcome, Z=[exposure]
            ):
                return False
        return True
