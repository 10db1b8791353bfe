"""Partially directed acyclic graph (CPDAG) — host side.

Port of ``pgmpy_tpu/base/pdag.py``; host networkx code.  Undirected edges
are stored as arc pairs in both directions inside an ``nx.DiGraph``;
``apply_meeks_rules`` completes orientations; ``to_dag`` extracts a
consistent extension (Dor & Tarsi 1992).
"""

import itertools

import networkx as nx

from pgmpy_tpu_torch.base.roles import GraphRolesMixin
from pgmpy_tpu_torch.config import logger


class PDAG(GraphRolesMixin, nx.DiGraph):
    def __init__(self, directed_ebunch=[], undirected_ebunch=[], latents=[]):
        super().__init__(
            list(directed_ebunch)
            + list(undirected_ebunch)
            + [(v, u) for u, v in undirected_ebunch]
        )
        self.latents = set(latents)
        self.directed_edges = set(directed_ebunch)
        self.undirected_edges = set(undirected_ebunch)
        for u, v in self.directed_edges:
            if (v, u) in self.directed_edges and u != v:
                raise ValueError(
                    f"Edge ({u},{v}) specified as directed in both directions; "
                    "use undirected_ebunch for undirected edges."
                )

    def all_neighbors(self, node):
        return set(itertools.chain(self.predecessors(node), self.successors(node)))

    def directed_children(self, node):
        return {v for v in self.successors(node) if not self.has_edge(v, node)}

    def directed_parents(self, node):
        return {v for v in self.predecessors(node) if not self.has_edge(node, v)}

    def has_directed_edge(self, u, v):
        return self.has_edge(u, v) and not self.has_edge(v, u)

    def has_undirected_edge(self, u, v):
        return self.has_edge(u, v) and self.has_edge(v, u)

    def undirected_neighbors(self, node):
        return {v for v in self.successors(node) if self.has_edge(v, node)}

    def is_adjacent(self, u, v):
        return self.has_edge(u, v) or self.has_edge(v, u)

    def copy(self):
        pdag = PDAG(
            directed_ebunch=list(self.directed_edges),
            undirected_ebunch=list(self.undirected_edges),
            latents=self.latents,
        )
        pdag.add_nodes_from(self.nodes())
        return pdag

    def _directed_graph(self):
        """The sub-DiGraph of only directed arcs."""
        dg = nx.DiGraph()
        dg.add_nodes_from(self.nodes())
        dg.add_edges_from(
            (u, v) for u, v in self.edges() if not self.has_edge(v, u)
        )
        return dg

    def _check_new_unshielded_collider(self, u, v):
        """Would orienting u->v create a new unshielded collider at v?"""
        for parent in self.directed_parents(v):
            if parent != u and not self.is_adjacent(parent, u):
                return True
        return False

    def orient_undirected_edge(self, u, v, inplace=False):
        """Convert u - v into u -> v."""
        pdag = self if inplace else self.copy()
        if not pdag.has_undirected_edge(u, v):
            raise ValueError(f"No undirected edge between {u} and {v}")
        pdag.remove_edge(v, u)
        pdag.undirected_edges.discard((u, v))
        pdag.undirected_edges.discard((v, u))
        pdag.directed_edges.add((u, v))
        if not inplace:
            return pdag

    def apply_meeks_rules(self, apply_r4=False, inplace=False, debug=False):
        """Meek's orientation rules R1-R3 (+R4 optionally) to fixpoint."""
        pdag = self if inplace else self.copy()
        changed = True
        while changed:
            changed = False
            # R1: X -> Y - Z, X,Z non-adjacent  =>  Y -> Z
            # (guarded against creating cycles or new unshielded colliders)
            for y in list(pdag.nodes()):
                for x in pdag.directed_parents(y):
                    for z in list(pdag.undirected_neighbors(y)):
                        if (
                            not pdag.is_adjacent(x, z)
                            and not pdag._check_new_unshielded_collider(y, z)
                            and not nx.has_path(pdag._directed_graph(), z, y)
                        ):
                            pdag.orient_undirected_edge(y, z, inplace=True)
                            changed = True
                            if debug:
                                logger.info(f"R1: {x}->{y}-{z} => {y}->{z}")
            # R2: X -> Z -> Y and X - Y  =>  X -> Y
            for z in list(pdag.nodes()):
                for x in pdag.directed_parents(z):
                    for y in pdag.directed_children(z):
                        if pdag.has_undirected_edge(x, y):
                            pdag.orient_undirected_edge(x, y, inplace=True)
                            changed = True
                            if debug:
                                logger.info(f"R2: {x}->{z}->{y}, {x}-{y} => {x}->{y}")
            # R3: X - {Y,Z,W}, Y -> W and Z -> W  =>  X -> W
            for x in list(pdag.nodes()):
                un_nbs = pdag.undirected_neighbors(x)
                if len(un_nbs) < 3:
                    continue
                for y, z, w in itertools.permutations(un_nbs, 3):
                    if pdag.has_directed_edge(y, w) and pdag.has_directed_edge(z, w):
                        pdag.orient_undirected_edge(x, w, inplace=True)
                        changed = True
                        if debug:
                            logger.info(f"R3: {x}-{{{y},{z},{w}}} => {x}->{w}")
                        break
            # R4: D -> C -> B, A - {B, C or D}, B,D non-adjacent  =>  A -> B
            if apply_r4:
                for c in list(pdag.nodes()):
                    for b in pdag.directed_children(c):
                        for d in pdag.directed_parents(c):
                            if b == d or pdag.is_adjacent(b, d):
                                continue
                            cands = (
                                pdag.undirected_neighbors(b)
                                & pdag.all_neighbors(c)
                                & pdag.undirected_neighbors(d)
                            )
                            for a in cands:
                                pdag.orient_undirected_edge(a, b, inplace=True)
                                changed = True
                                break
        if not inplace:
            return pdag

    def to_dag(self):
        """A consistent DAG extension (Dor & Tarsi): repeatedly sink a node
        whose undirected neighborhood is adjacent to all its neighbors."""
        from pgmpy_tpu_torch.base.dag import DAG

        dag = DAG()
        dag.add_nodes_from(self.nodes())
        dag.add_edges_from(self.directed_edges)
        dag.latents = self.latents

        pdag = self.copy()
        while pdag.number_of_nodes() > 0:
            found = False
            for x in sorted(pdag.nodes(), key=str):
                un_nbs = pdag.undirected_neighbors(x)
                nbs_adjacent = all(
                    pdag.is_adjacent(y, z)
                    for z in pdag.all_neighbors(x)
                    for y in un_nbs
                    if y != z
                )
                if not pdag.directed_children(x) and (not un_nbs or nbs_adjacent):
                    found = True
                    for y in un_nbs:
                        dag.add_edge(y, x)
                    pdag.remove_node(x)
                    break
            if not found:
                logger.warning(
                    "PDAG has no faithful extension (= no oriented DAG with the "
                    "same v-structures as PDAG). Remaining undirected PDAG edges "
                    "oriented arbitrarily."
                )
                for x, y in pdag.edges():
                    if not dag.has_edge(y, x):
                        try:
                            dag.add_edge(x, y)
                        except ValueError:
                            pass
                break
        return dag

    def to_graphviz(self):
        return nx.nx_agraph.to_agraph(self)

    def __eq__(self, other):
        if not isinstance(other, PDAG):
            return False
        return (
            set(self.nodes()) == set(other.nodes())
            and self.directed_edges == set(other.directed_edges)
            and set(map(frozenset, self.undirected_edges))
            == set(map(frozenset, other.undirected_edges))
            and self.latents == other.latents
        )

    def __hash__(self):
        return hash(
            (
                frozenset(self.nodes()),
                frozenset(self.directed_edges),
                frozenset(map(frozenset, self.undirected_edges)),
            )
        )
