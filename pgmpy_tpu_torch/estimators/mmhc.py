"""MmhcEstimator: MMPC skeleton restriction + hill-climb search.

Port of ``pgmpy_tpu/estimators/mmhc.py``, including the reference's
observable quirks — association is ``1 - p_value`` of the
chi-square test (NOT the statistic), the forward phase's ``>=`` tie rule,
and the backward / symmetry-correction loops that remove from the list
being iterated (which skips the element after each removal).  Every
(candidate, subset) chi-square of a forward iteration comes from ONE launch
of the count kernel (``power_divergence_batch``), not a per-test loop.
"""

import itertools

from pgmpy_tpu_torch.base.undirected import UndirectedGraph
from pgmpy_tpu_torch.estimators.base import StructureEstimator
from pgmpy_tpu_torch.estimators.citests import power_divergence_batch
from pgmpy_tpu_torch.estimators.hill_climb import HillClimbSearch
from pgmpy_tpu_torch.utils.mathext import powerset as _powerset


class MmhcEstimator(StructureEstimator):
    def __init__(self, data, **kwargs):
        super().__init__(data, **kwargs)

    def _pvalues_batch(self, node, candidates, Zs):
        """p-values of chi_square(node, Y | subset) for every candidate Y
        and every subset of Zs — one count launch.  Returns
        {Y: [p in powerset order]}."""
        subsets = [list(s) for s in _powerset(Zs)]
        triples = [(node, Y, s) for Y in candidates for s in subsets]
        results = iter(
            power_divergence_batch(triples, lambda_="pearson", coded=self._coded)
        )
        out = {}
        for Y in candidates:
            out[Y] = [next(results)[1] for _ in subsets]
        return out

    def _min_assoc(self, node, Y, Zs):
        """min over subsets of Zs of (1 - p_value) — reference ``assoc`` /
        ``min_assoc`` (MmhcEstimator.py:171-180)."""
        pvals = self._pvalues_batch(node, [Y], list(Zs))[Y]
        return min(1.0 - p for p in pvals)

    def mmpc(self, significance_level=0.01):
        """Max-min parents-and-children skeleton (reference Algorithm 1&2
        flow, MmhcEstimator.py:195-239)."""
        nodes = list(self.variables)
        neighbors = {}
        for node in nodes:
            neighbors[node] = []

            # Forward phase: reference's max_min_heuristic with the ``>=``
            # rule over the candidate set; all candidates' powerset tests
            # batch into one launch per iteration.  Candidates iterate
            # in sorted order (the reference iterates a hash-ordered set,
            # so its tie-breaks are process-dependent; sorted is our
            # deterministic stand-in — identical whenever 1-p ties don't
            # occur).
            while True:
                candidates = sorted(
                    set(nodes) - set(neighbors[node] + [node]), key=str
                )
                if not candidates:
                    break
                pvals = self._pvalues_batch(node, candidates, neighbors[node])
                max_min_assoc, best_Y = 0.0, None
                for Y in candidates:
                    min_assoc_val = min(1.0 - p for p in pvals[Y])
                    if min_assoc_val >= max_min_assoc:
                        best_Y = Y
                        max_min_assoc = min_assoc_val
                if max_min_assoc > 0:
                    neighbors[node].append(best_Y)
                else:
                    break

            # Backward phase — faithful to the reference's
            # remove-while-iterating semantics (removal skips the next
            # element); each neighbor's powerset of tests is one launch
            i = 0
            while i < len(neighbors[node]):
                neigh = neighbors[node][i]
                other_neighbors = [n for n in neighbors[node] if n != neigh]
                pvals = self._pvalues_batch(node, [neigh], other_neighbors)[neigh]
                if any(p >= significance_level for p in pvals):
                    neighbors[node].remove(neigh)
                i += 1

        # symmetry correction, again with the reference's
        # remove-while-iterating semantics
        for node in nodes:
            i = 0
            while i < len(neighbors[node]):
                neigh = neighbors[node][i]
                if node not in neighbors[neigh]:
                    neighbors[node].remove(neigh)
                i += 1

        skel = UndirectedGraph()
        skel.add_nodes_from(nodes)
        for node in nodes:
            skel.add_edges_from([(node, neigh) for neigh in neighbors[node]])
        return skel

    def estimate(self, scoring_method=None, tabu_length=10, significance_level=0.01):
        from pgmpy_tpu_torch.estimators.expert_knowledge import ExpertKnowledge

        if scoring_method is None:
            scoring_method = "bdeu"
        skel = self.mmpc(significance_level)
        hc = HillClimbSearch(self.data)
        # Reference quirk (MmhcEstimator.py:91-98): forbidden_edges is
        # ``complete_graph.edges() - skel.to_directed().edges()`` — the
        # complete graph lists each pair ONCE in column order, so only
        # THAT direction of a non-skeleton pair is forbidden and hill
        # climb may still add the reverse orientation.  Observable in the
        # search result, so replicated literally.
        forbidden = {
            (u, v)
            for u, v in itertools.combinations(self.variables, 2)
            if not skel.has_edge(u, v)
        }
        return hc.estimate(
            scoring_method=scoring_method,
            expert_knowledge=ExpertKnowledge(forbidden_edges=forbidden),
            tabu_length=tabu_length,
            show_progress=False,
        )
