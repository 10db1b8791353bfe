"""Generalized adjustment-set identification.

Port of ``pgmpy_tpu/identification/adjustment.py`` (reference:
``pgmpy/identification/adjustment.py:10-232``); host graph code.
Strategies take a role-annotated graph (exposure/outcome) and return a
copy annotated with the ``adjustment`` role plus a success flag;
``validate`` checks the *given* adjustment role via d-separation of every
exposure parent from the outcomes.
"""

import itertools

import networkx as nx

from pgmpy_tpu_torch.base import ADMG, DAG, MAG, PDAG
from pgmpy_tpu_torch.identification.base import BaseIdentification
from pgmpy_tpu_torch.utils.mathext import powerset


class Adjustment(BaseIdentification):
    """Backdoor-adjustment identification.

    variant='minimal' finds the smallest adjustment set via the proper
    backdoor graph (Perkovic et al.); variant='all' enumerates the powerset
    of non-forbidden ancestors and keeps every set passing the validation
    criterion (ref ``adjustment.py:171-192``).
    """

    def __init__(self, variant="minimal"):
        self.variant = variant
        if variant in ("minimal", "all"):
            self.supported_graph_types = (DAG, PDAG, ADMG, MAG)
        elif variant == "minimal_variance":
            self.supported_graph_types = (DAG, PDAG)
        else:
            raise ValueError(
                f"variant must be 'minimal', 'all' or 'minimal_variance'. Got: {variant}"
            )

    def _get_proper_backdoor_graph(self, causal_graph, inplace=False):
        """Remove the first edge of every proper causal path from exposure
        to outcome (ref ``adjustment.py:62-116``)."""
        model = causal_graph if inplace else causal_graph.copy()
        edges_to_remove = []
        for source in causal_graph.get_role("exposure"):
            for path in nx.all_simple_edge_paths(
                causal_graph, source, causal_graph.get_role("outcome")
            ):
                edges_to_remove.append(path[0])
        model.remove_edges_from(edges_to_remove)
        return model

    def _identify(self, causal_graph):
        if self.variant == "minimal":
            if len(causal_graph.get_role("exposure")) != 1:
                raise NotImplementedError(
                    "Backdoor identification is only implemented for single exposure variable."
                )
            if len(causal_graph.get_role("outcome")) != 1:
                raise NotImplementedError(
                    "Backdoor identification is only implemented for single outcome variable."
                )
            exposure = causal_graph.get_role("exposure")[0]
            outcome = causal_graph.get_role("outcome")[0]
            backdoor_graph = self._get_proper_backdoor_graph(
                causal_graph, inplace=False
            )
            adjustment_set = backdoor_graph.minimal_dseparator(exposure, outcome)
            if adjustment_set is None:
                return causal_graph, False
            return (
                causal_graph.with_role("adjustment", adjustment_set, inplace=False),
                True,
            )

        if self.variant == "minimal_variance":
            # O-set of Henckel, Perkovic & Maathuis (2019) / Witte et al.
            # (2020): O(X, Y, G) = pa(cn(X, Y, G)) \ forb(X, Y, G), the
            # valid adjustment set whose OLS estimator of the total effect
            # has minimal asymptotic variance.  (The reference stubs this
            # variant with NotImplementedError, ``adjustment.py:195-198``.)
            if not isinstance(causal_graph, DAG):
                raise NotImplementedError(
                    "minimal_variance identification is only implemented for DAGs."
                )
            if len(causal_graph.get_role("exposure")) != 1 or len(
                causal_graph.get_role("outcome")
            ) != 1:
                raise NotImplementedError(
                    "minimal_variance identification is only implemented for a "
                    "single exposure and outcome."
                )
            exposure = causal_graph.get_role("exposure")[0]
            outcome = causal_graph.get_role("outcome")[0]

            # cn: nodes (except the exposure) on proper causal paths X -> Y
            descendants_x = nx.descendants(causal_graph, exposure)
            causal_nodes = {
                w
                for w in descendants_x
                if w == outcome or outcome in nx.descendants(causal_graph, w)
            }
            if not causal_nodes:
                return causal_graph, False
            # forb: the exposure and all descendants of causal nodes
            forbidden = {exposure}
            for w in causal_nodes:
                forbidden.add(w)
                forbidden |= nx.descendants(causal_graph, w)
            o_set = set()
            for w in causal_nodes:
                o_set |= set(causal_graph.predecessors(w))
            o_set -= forbidden
            if o_set & set(causal_graph.latents):
                # the optimal set is not fully observed: not usable
                return causal_graph, False
            annotated = causal_graph.with_role("adjustment", o_set, inplace=False)
            return annotated, self._validate(annotated)

        # variant == "all": validated powerset of non-forbidden ancestors
        exposure = causal_graph.get_role("exposure")[0]
        outcome = causal_graph.get_role("outcome")[0]
        ancestors = causal_graph._get_ancestors_of([exposure, outcome])
        # variables on a causal path from exposure to outcome are forbidden
        ancestors -= set(
            itertools.chain(*nx.all_simple_paths(causal_graph, exposure, outcome))
        )
        ancestors -= {exposure, outcome}
        ancestors -= set(causal_graph.latents)

        valid_adj_graphs = []
        for s in powerset(sorted(ancestors, key=str)):
            adj_graph = causal_graph.with_role("adjustment", s, inplace=False)
            if self.validate(causal_graph=adj_graph):
                valid_adj_graphs.append(adj_graph)
        return valid_adj_graphs, len(valid_adj_graphs) > 0

    def _validate(self, causal_graph):
        """Is the graph's CURRENT ``adjustment`` role a valid adjustment
        set?  Every parent of an exposure must be d-separated from every
        outcome given exposures + adjustment (ref ``adjustment.py:193-232``)."""
        exposure = causal_graph.get_role("exposure")
        outcome = causal_graph.get_role("outcome")
        adjustment_vars = causal_graph.get_role("adjustment")
        conditional_vars = list(exposure) + list(adjustment_vars)

        predecessors = set()
        for exposure_var in exposure:
            predecessors.update(causal_graph.predecessors(exposure_var))

        for pred_var in predecessors:
            for outcome_var in outcome:
                if causal_graph.is_dconnected(
                    pred_var, outcome_var, observed=conditional_vars
                ):
                    return False
        return True
