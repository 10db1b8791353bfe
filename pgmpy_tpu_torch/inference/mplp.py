"""Mplp: MAP inference via generalized max-product linear programming
(GMPLP) dual decomposition with triplet-cluster tightening.

Port of ``pgmpy_tpu/inference/mplp.py``, which is host numpy code there too:
the same float64 message updates, in the same order, on the port's
``DiscreteMarkovNetwork`` and ``Inference``, with the factor tables copied to
the host once.  A node's incoming messages and an edge's triplet messages are
found through index lists kept beside them, where the JAX package scans every
message and every triplet for each (quadratic in the graph's size).  Two message
families (both vectorized max-reductions over the potential tensors):

* edge->node (Globerson & Jaakkola 2007):
  ``lambda_{e->i} = -(1-1/|e|) delta_i^{-e} + (1/|e|) max_{x_e \\ x_i}
  [theta_e + sum_{j!=i} delta_j^{-e}]``
* triplet->edge (Sontag et al. 2008 tightening): frustrated triangles join
  as zero-potential clusters passing ``lambda_{c->e}(x_e) = -b_e^{-c} +
  (1/3) max_{x_c ~ x_e} sum_e' b_{e'}^{-c}`` — this is what actually
  tightens the pairwise LP (node-intersection clusters provably cannot).
"""

import itertools

import numpy as np

from pgmpy_tpu_torch.config import to_numpy
from pgmpy_tpu_torch.inference.base import Inference
from pgmpy_tpu_torch.models.markov_network import DiscreteMarkovNetwork


class Mplp(Inference):
    def __init__(self, model):
        if not isinstance(model, DiscreteMarkovNetwork):
            raise TypeError("Only DiscreteMarkovNetwork is supported")
        super().__init__(model)
        self.model = model
        self.cardinality = model.get_cardinality()

        # node fields theta_i and clusters (scope, theta tensor)
        self.theta_i = {
            node: np.zeros(self.cardinality[node]) for node in model.nodes()
        }
        self.clusters = []  # list of (scope tuple, theta ndarray)
        for factor in model.get_factors():
            scope = tuple(factor.scope())
            log_vals = np.log(
                np.maximum(np.asarray(to_numpy(factor.values), dtype=np.float64), 1e-300)
            )
            if len(scope) == 1:
                self.theta_i[scope[0]] = self.theta_i[scope[0]] + log_vals
            else:
                self.clusters.append((scope, log_vals))

        # deterministic symmetry-breaking jitter: degenerate MAP problems
        # (e.g. frustrated cycles) have flat node beliefs that defeat
        # independent-argmax decoding; a ~1e-7 tilt selects one optimum
        rng = np.random.default_rng(0)
        for node in sorted(self.theta_i, key=str):
            self.theta_i[node] = self.theta_i[node] + rng.uniform(
                0, 1e-7, size=self.theta_i[node].shape
            )

        # messages lambda_{cluster_idx -> node}
        self.messages = {}
        for ci, (scope, _) in enumerate(self.clusters):
            for node in scope:
                self.messages[(ci, node)] = np.zeros(self.cardinality[node])
        # per node its message keys, and per edge cluster its (triplet,
        # position) pairs, each in the order the sums below take them: the
        # order of the JAX package's scans over all messages and triplets
        self._node_keys = {node: [] for node in self.theta_i}
        for key in self.messages:
            self._node_keys[key[1]].append(key)
        self._edge_triplets = {ci: [] for ci in range(len(self.clusters))}

        # triplet clusters added by tightening: (nodes, [edge cluster idx],
        # [lambda_{c->e} arrays in each edge's axis order])
        self.triplets = []

        self.best_assignment = None
        self.best_decoded_value = -np.inf
        self.dual_gap = np.inf

    class Cluster:
        """A cluster of variables with its log potential (the reference's
        inner class)."""

        def __init__(self, intersection_set_variables, cluster_potential):
            self.cluster_variables = frozenset(cluster_potential.variables)
            self.cluster_potential = cluster_potential.copy()
            self.intersection_sets_for_cluster_c = [
                intersect.intersection(self.cluster_variables)
                for intersect in intersection_set_variables
                if intersect.intersection(self.cluster_variables)
            ]

    def query(self):
        raise NotImplementedError("map_query() is the only query method available.")

    def find_triangles(self):
        """All 3-cliques of the model graph."""
        import networkx as nx

        return list(
            filter(lambda x: len(x) == 3, nx.find_cliques(self.model))
        )

    # ------------------------------------------------------------------ #
    def _delta(self, i):
        """delta_i = theta_i + sum of incoming cluster messages."""
        b = self.theta_i[i].copy()
        for key in self._node_keys[i]:
            b = b + self.messages[key]
        return b

    def _edge_theta_eff(self, ci):
        """Edge potential plus incoming triplet->edge messages."""
        out = self.clusters[ci][1]
        for ti, m in self._edge_triplets[ci]:
            out = out + self.triplets[ti][2][m]
        return out

    def _update_cluster(self, ci):
        scope, _ = self.clusters[ci]
        theta = self._edge_theta_eff(ci)
        size = len(scope)
        deltas_minus = [
            self._delta(node) - self.messages[(ci, node)] for node in scope
        ]
        # accumulate theta + sum_j delta_j^{-c} as a full cluster tensor
        total = theta.copy()
        for k, d in enumerate(deltas_minus):
            shape = [1] * size
            shape[k] = -1
            total = total + d.reshape(shape)
        for k, node in enumerate(scope):
            axes = tuple(a for a in range(size) if a != k)
            # total folds delta_k in as well; subtract it back so the max is
            # over theta_c + sum_{j != k} delta_j^{-c}
            max_others = (total.max(axis=axes) if axes else total) - deltas_minus[k]
            self.messages[(ci, node)] = (
                -(1.0 - 1.0 / size) * deltas_minus[k] + (1.0 / size) * max_others
            )

    def _update_messages(self):
        for ci in range(len(self.clusters)):
            self._update_cluster(ci)
        for ti in range(len(self.triplets)):
            self._update_triplet(ti)

    def _edge_belief_minus(self, ci, exclude_triplet=None):
        """b_e^{-c}(x_i, x_j) = theta_eff_e (minus the excluded triplet's
        message) + delta_i^{-e} + delta_j^{-e}."""
        scope, _ = self.clusters[ci]
        b = self._edge_theta_eff(ci)
        if exclude_triplet is not None:
            tri_nodes, edge_cis, lambdas = self.triplets[exclude_triplet]
            for m, e_ci in enumerate(edge_cis):
                if e_ci == ci:
                    b = b - lambdas[m]
        for k, node in enumerate(scope):
            shape = [1] * len(scope)
            shape[k] = -1
            b = b + (self._delta(node) - self.messages[(ci, node)]).reshape(shape)
        return b

    def _update_triplet(self, ti):
        """Sontag et al. triplet->edge block update:
        lambda_{c->e} = -b_e^{-c} + (1/3) max_{x_c ~ x_e} sum_e' b_{e'}^{-c}."""
        tri_nodes, edge_cis, lambdas = self.triplets[ti]
        axis_of = {node: a for a, node in enumerate(tri_nodes)}
        beliefs = []
        joint = 0.0
        cards = tuple(self.cardinality[v] for v in tri_nodes)
        for m, e_ci in enumerate(edge_cis):
            scope, _ = self.clusters[e_ci]
            b = self._edge_belief_minus(e_ci, exclude_triplet=ti)
            beliefs.append((scope, b))
            # broadcast into (i, j, k) layout
            order = sorted(range(len(scope)), key=lambda p: axis_of[scope[p]])
            b_t = np.transpose(b, order)
            shape = [1, 1, 1]
            for p in order:
                shape[axis_of[scope[p]]] = b.shape[p]
            joint = joint + b_t.reshape(shape)
        new_lambdas = []
        for m, e_ci in enumerate(edge_cis):
            scope, b = beliefs[m]
            other_axes = tuple(
                a for a in range(3) if tri_nodes[a] not in scope
            )
            max_joint = joint.max(axis=other_axes)  # in tri-node order of scope
            # transpose back to the edge's own axis order
            kept = [tri_nodes[a] for a in range(3) if tri_nodes[a] in scope]
            perm = [kept.index(v) for v in scope]
            max_joint = np.transpose(max_joint, perm)
            new_lambdas.append(-b + max_joint / 3.0)
        self.triplets[ti] = (tri_nodes, edge_cis, new_lambdas)

    def _cluster_repar(self, ci):
        """g_c = theta_eff_c - sum_i lambda_{c->i} (reparameterized)."""
        scope, _ = self.clusters[ci]
        g = self._edge_theta_eff(ci).copy()
        for k, node in enumerate(scope):
            shape = [1] * len(scope)
            shape[k] = -1
            g = g - self.messages[(ci, node)].reshape(shape)
        return g

    def _dual_objective(self):
        total = sum(float(np.max(self._delta(i))) for i in self.theta_i)
        for ci in range(len(self.clusters)):
            total += float(np.max(self._cluster_repar(ci)))
        # triplet terms: max_{x_c} of -(sum of outgoing messages)
        for tri_nodes, edge_cis, lambdas in self.triplets:
            axis_of = {node: a for a, node in enumerate(tri_nodes)}
            joint = 0.0
            for m, e_ci in enumerate(edge_cis):
                scope, _ = self.clusters[e_ci]
                lam = lambdas[m]
                order = sorted(range(len(scope)), key=lambda p: axis_of[scope[p]])
                lam_t = np.transpose(lam, order)
                shape = [1, 1, 1]
                for p in order:
                    shape[axis_of[scope[p]]] = lam.shape[p]
                joint = joint - lam_t.reshape(shape)
            total += float(np.max(joint))
        return total

    def _local_decode(self):
        assignment = {i: int(np.argmax(self._delta(i))) for i in self.theta_i}
        value = self._primal_value(assignment)
        if value > self.best_decoded_value:
            self.best_decoded_value = value
            self.best_assignment = assignment
        return assignment

    def _primal_value(self, assignment):
        total = sum(
            float(theta[assignment[i]]) for i, theta in self.theta_i.items()
        )
        for scope, theta in self.clusters:
            idx = tuple(assignment[node] for node in scope)
            total += float(theta[idx])
        return total

    def get_integrality_gap(self):
        """Difference between the dual bound and the best decoded primal."""
        return float(self.dual_gap)

    # ------------------------------------------------------------------ #
    def _candidate_triplets(self):
        """Triplets whose three edges are all existing pairwise clusters."""
        edge_set = {
            frozenset(scope) for scope, _ in self.clusters if len(scope) == 2
        }
        neighbors = {}
        for e in edge_set:
            u, v = tuple(e)
            neighbors.setdefault(u, set()).add(v)
            neighbors.setdefault(v, set()).add(u)
        triplets = set()
        for u in neighbors:
            for v, w in itertools.combinations(sorted(neighbors[u], key=str), 2):
                if frozenset((v, w)) in edge_set:
                    triplets.add(tuple(sorted((u, v, w), key=str)))
        return sorted(triplets)

    def _triplet_score(self, triplet):
        """Sontag et al. guaranteed bound decrease: sum of independent edge
        maxima minus the joint maximum of the reparameterized edges."""
        i, j, k = triplet
        card = {v: self.cardinality[v] for v in triplet}
        joint = np.zeros((card[i], card[j], card[k]))
        indep = 0.0
        for ci, (scope, _) in enumerate(self.clusters):
            if len(scope) == 2 and set(scope) <= set(triplet):
                g = self._cluster_repar(ci)
                indep += float(np.max(g))
                axes_map = {node: triplet.index(node) for node in scope}
                expand = [None, None, None]
                for pos, node in enumerate(scope):
                    expand[axes_map[node]] = pos
                # broadcast g into the (i, j, k) tensor layout
                order = [p for p in expand if p is not None]
                g_t = np.transpose(g, order)
                shape = [
                    card[v] if expand[t] is not None else 1
                    for t, v in enumerate(triplet)
                ]
                joint = joint + g_t.reshape(shape)
        return indep - float(np.max(joint))

    def _tighten_triplet(self, max_triplets=5):
        """Add the highest-scoring triplets as zero-potential clusters."""
        existing = {tuple(t[0]) for t in self.triplets}
        scored = []
        for triplet in self._candidate_triplets():
            if triplet in existing:
                continue
            scored.append((self._triplet_score(triplet), triplet))
        scored.sort(reverse=True)
        edge_index = {
            frozenset(scope): ci
            for ci, (scope, _) in enumerate(self.clusters)
            if len(scope) == 2
        }
        added = 0
        for score, triplet in scored[:max_triplets]:
            if score <= 1e-9:
                continue
            i, j, k = triplet
            edge_cis = [
                edge_index[frozenset(e)]
                for e in [(i, j), (j, k), (i, k)]
            ]
            lambdas = [
                np.zeros(self.clusters[ci][1].shape) for ci in edge_cis
            ]
            for m, ci in enumerate(edge_cis):
                self._edge_triplets[ci].append((len(self.triplets), m))
            self.triplets.append((triplet, edge_cis, lambdas))
            added += 1
        return added

    # ------------------------------------------------------------------ #
    def _run(self, n_iter, dual_threshold, integrality_gap_threshold):
        prev_dual = np.inf
        for _ in range(int(n_iter)):
            self._update_messages()
            dual = self._dual_objective()
            self._local_decode()
            self.dual_gap = dual - self.best_decoded_value
            if abs(prev_dual - dual) < dual_threshold:
                return True
            if self.dual_gap < integrality_gap_threshold:
                return True
            prev_dual = dual
        return False

    def map_query(
        self,
        init_iter=500,
        later_iter=20,
        dual_threshold=0.0002,
        integrality_gap_threshold=0.0002,
        tighten_triplet=True,
        max_triplets=5,
        max_iterations=100,
        prolong=False,
    ):
        """MAP assignment as {variable: state-name}.

        Runs plain GMPLP, then (when the integrality gap remains) repeats:
        add the best-scoring triplet clusters and run ``later_iter`` more
        passes, up to ``max_iterations`` tightening rounds.
        """
        self._run(init_iter, dual_threshold, integrality_gap_threshold)
        if tighten_triplet:
            for _ in range(int(max_iterations)):
                if self.dual_gap < integrality_gap_threshold and not prolong:
                    break
                if self._tighten_triplet(max_triplets=max_triplets) == 0:
                    break
                self._run(later_iter, dual_threshold, integrality_gap_threshold)

        states = self.model.states
        result = {}
        for var, state_no in self.best_assignment.items():
            names = states.get(var)
            result[var] = names[state_no] if names else state_no
        return result
