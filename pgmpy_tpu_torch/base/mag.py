"""Ancestral graphs with edge marks: AncestralBase and MAG.

Port of ``pgmpy_tpu/base/mag.py`` (reference:
``pgmpy/base/AncestralBase.py:10-608`` and ``MAG.py:8-387``); host code.  Edges are stored on an undirected graph with a
``marks`` attribute ``{u: mark, v: mark}`` where a mark is ``">"``
(arrowhead), ``"-"`` (tail) or ``"o"`` (circle):

- directed  u -> v : ``(u, v, "-", ">")``
- bidirected u <-> v : ``(u, v, ">", ">")``
- undirected u  -  v : ``(u, v, "-", "-")``

m-separation is decided on the canonical DAG (bidirected edge -> latent
confounder, undirected edge -> selection child conditioned on).
"""

import itertools
from collections import deque

import networkx as nx
import numpy as np

from pgmpy_tpu_torch.base.roles import GraphRolesMixin


class AncestralBase(nx.Graph, GraphRolesMixin):
    def __init__(self, ebunch=None, latents=set(), roles=None):
        super().__init__()
        self.valid_marks = {">", "-", "o"}
        if ebunch:
            self.add_edges_from(ebunch)
        self.latents = set(latents)
        for role, variables in (roles or {}).items():
            self.with_role(role, variables, inplace=True)

    # ------------------------------------------------------------------ #
    # construction
    # ------------------------------------------------------------------ #
    def add_edge(self, u, v, u_mark, v_mark):
        """Add an edge with a mark at each endpoint."""
        if u == v:
            raise ValueError("Nodes cannot be the same for an edge.")
        if u_mark not in self.valid_marks or v_mark not in self.valid_marks:
            raise ValueError(f"Marks must be one of {self.valid_marks}.")
        super().add_edge(u, v, marks={u: u_mark, v: v_mark})

    def add_edges_from(self, ebunch):
        for u, v, u_mark, v_mark in ebunch:
            self.add_edge(u, v, u_mark, v_mark)

    # ------------------------------------------------------------------ #
    # adjacency-matrix codec: M[i, j] = mark at j for edge (i, j)
    # ------------------------------------------------------------------ #
    @property
    def adjacency_matrix(self):
        nodes = list(self.nodes)
        node_index = {node: i for i, node in enumerate(nodes)}
        M = np.full((len(nodes), len(nodes)), 0, dtype=object)
        for u, v, data in self.edges(data=True):
            M[node_index[u], node_index[v]] = data["marks"][v]
            M[node_index[v], node_index[u]] = data["marks"][u]
        return M, node_index

    @adjacency_matrix.setter
    def adjacency_matrix(self, value):
        value = np.asarray(value)
        if value.ndim != 2 or value.shape[0] != value.shape[1]:
            raise ValueError("Adjacency matrix must be square (n x n).")
        variables = [f"X_{i}" for i in range(value.shape[0])]
        self.clear()
        for i in range(value.shape[0]):
            for j in range(i + 1, value.shape[0]):
                # value[i, j] = mark at j, value[j, i] = mark at i
                if value[i, j] != 0 and value[j, i] != 0:
                    self.add_edge(
                        variables[i], variables[j], value[j, i], value[i, j]
                    )

    # ------------------------------------------------------------------ #
    # mark-constrained navigation
    # ------------------------------------------------------------------ #
    def get_neighbors(self, node, u_type=None, v_type=None):
        """Neighbors whose connecting edge carries ``u_type`` at ``node``
        and ``v_type`` at the neighbor (None = any)."""
        if node not in self:
            return set()
        out = set()
        for neighbor in nx.all_neighbors(self, node):
            marks = self.edges[node, neighbor]["marks"]
            if (u_type is None or marks[node] == u_type) and (
                v_type is None or marks[neighbor] == v_type
            ):
                out.add(neighbor)
        return out

    def get_parents(self, node):
        """p with p *-> node and tail at p: p -> node."""
        return self.get_neighbors(node, u_type=">", v_type="-")

    def get_children(self, node):
        return self.get_neighbors(node, u_type="-", v_type=">")

    def get_spouses(self, node):
        """Bidirected partners: node <-> s."""
        return self.get_neighbors(node, u_type=">", v_type=">")

    def _closure(self, node, step):
        seen = set()
        queue = deque([node])
        while queue:
            current = queue.popleft()
            if current not in seen:
                seen.add(current)
                queue.extend(step(current))
        return seen

    def get_ancestors(self, node):
        """Reflexive-transitive closure over parents (includes ``node``)."""
        return self._closure(node, self.get_parents)

    def get_descendants(self, node):
        return self._closure(node, self.get_children)

    def get_reachable_nodes(self, node, u_type=None, v_type=None):
        """Closure over mark-constrained neighbor steps."""
        return self._closure(
            node, lambda n: self.get_neighbors(n, u_type=u_type, v_type=v_type)
        )

    # ------------------------------------------------------------------ #
    def __eq__(self, other):
        if not isinstance(other, AncestralBase):
            return False

        def canon(g):
            return {
                (frozenset((u, v)), frozenset(data["marks"].items()))
                for u, v, data in g.edges(data=True)
            }

        return (
            set(self.nodes) == set(other.nodes)
            and canon(self) == canon(other)
            and self.latents == other.latents
            and self.get_role_dict() == other.get_role_dict()
        )

    def __hash__(self):
        return id(self)

    def copy(self):
        new = self.__class__()
        new.add_nodes_from(self.nodes)
        new.add_edges_from(
            (u, v, data["marks"][u], data["marks"][v])
            for u, v, data in self.edges(data=True)
        )
        new.latents = set(self.latents)
        for role, variables in self.get_role_dict().items():
            new.with_role(role, variables, inplace=True)
        return new


def _norm_3bunch(directed_ebunch, bidirected_ebunch, undirected_ebunch):
    """Convert the (directed, bidirected, undirected) triple into mark
    4-tuples (kept for backward compatibility with earlier pgmpy_tpu_torch)."""
    ebunch = [(u, v, "-", ">") for u, v in directed_ebunch or []]
    ebunch += [(u, v, ">", ">") for u, v in bidirected_ebunch or []]
    ebunch += [(u, v, "-", "-") for u, v in undirected_ebunch or []]
    return ebunch


class MAG(AncestralBase):
    """Maximal ancestral graph: directed / bidirected / undirected edges
    only (no circles)."""

    _MAG_MARKS = {("-", ">"), (">", "-"), (">", ">"), ("-", "-")}

    def __init__(
        self,
        ebunch=None,
        latents=set(),
        roles=None,
        directed_ebunch=None,
        bidirected_ebunch=None,
        undirected_ebunch=None,
    ):
        if ebunch is None and (
            directed_ebunch or bidirected_ebunch or undirected_ebunch
        ):
            ebunch = _norm_3bunch(
                directed_ebunch, bidirected_ebunch, undirected_ebunch
            )
        if ebunch:
            for _, _, u_mark, v_mark in ebunch:
                if (u_mark, v_mark) not in self._MAG_MARKS:
                    raise ValueError(
                        f"Invalid edge type ({u_mark}, {v_mark}). MAGs only "
                        "allow directed ('-', '>'), reverse directed "
                        "('>', '-'), bidirected ('>', '>'), and undirected "
                        "('-', '-') edges."
                    )
        super().__init__(ebunch=ebunch, latents=latents, roles=roles)

    # ------------------------------------------------------------------ #
    # edge classification helpers
    # ------------------------------------------------------------------ #
    def directed_edge_list(self):
        return [
            (u, v) if data["marks"][v] == ">" else (v, u)
            for u, v, data in self.edges(data=True)
            if {data["marks"][u], data["marks"][v]} == {"-", ">"}
        ]

    def bidirected_edge_list(self):
        return [
            frozenset((u, v))
            for u, v, data in self.edges(data=True)
            if data["marks"][u] == ">" and data["marks"][v] == ">"
        ]

    def undirected_edge_list(self):
        return [
            frozenset((u, v))
            for u, v, data in self.edges(data=True)
            if data["marks"][u] == "-" and data["marks"][v] == "-"
        ]

    def _is_collider(self, u, c, v):
        """c is a collider on u *-* c *-* v: arrowheads at c on both."""
        if not (self.has_edge(u, c) and self.has_edge(c, v)):
            return False
        return (
            self.edges[u, c]["marks"][c] == ">"
            and self.edges[c, v]["marks"][c] == ">"
        )

    def has_inducing_path(self, u, v, W):
        """True iff SOME path u ... v has every intermediate node a
        collider that is in W or an ancestor of {u, v} (ref MAG.py:140-196;
        a direct edge is trivially inducing)."""
        if self.has_edge(u, v):
            return True
        ancestors_uv = self.get_ancestors(u) | self.get_ancestors(v)
        for path in nx.all_simple_paths(self, source=u, target=v):
            if len(path) <= 2:
                continue
            if all(
                self._is_collider(path[i - 1], path[i], path[i + 1])
                and (path[i] in W or path[i] in ancestors_uv)
                for i in range(1, len(path) - 1)
            ):
                return True
        return False

    def is_visible_edge(self, u, v):
        """u -> v is visible iff some c non-adjacent to v has c *-> u, or a
        collider path into u whose nodes are all parents of v
        (ref MAG.py:197-280)."""
        if not self.has_edge(u, v):
            return False
        marks = self.edges[u, v]["marks"]
        if marks[u] != "-" or marks[v] != ">":
            return False

        neighbors_v = set(self.neighbors(v))
        for c in self.nodes:
            if c in {u, v} or c in neighbors_v:
                continue
            if self.has_edge(c, u) and self.edges[c, u]["marks"][u] == ">":
                return True
            for path in nx.all_simple_paths(self, source=c, target=u):
                if len(path) < 3:
                    continue
                if self.edges[path[-2], u]["marks"][u] != ">":
                    continue
                ok = True
                for i in range(1, len(path) - 1):
                    node = path[i]
                    if not self._is_collider(path[i - 1], node, path[i + 1]):
                        ok = False
                        break
                    if not (
                        self.has_edge(node, v)
                        and self.edges[node, v]["marks"][node] == "-"
                        and self.edges[node, v]["marks"][v] == ">"
                    ):
                        ok = False
                        break
                if ok:
                    return True
        return False

    def lower_manipulation(self, X, inplace=False):
        """Remove visible edges out of X; invisible ones become bidirected
        fill-in edges preserving independencies (ref MAG.py:281-339)."""
        mag = self if inplace else self.copy()
        to_remove, to_change = [], []
        for u in X:
            for v in self.get_neighbors(u, u_type="-", v_type=">"):
                (to_remove if self.is_visible_edge(u, v) else to_change).append(
                    (u, v)
                )
        mag.remove_edges_from(to_change + to_remove)
        for u, v in to_change:
            other = v if u in X else u
            for neighbor in self.neighbors(v):
                if neighbor != other and neighbor not in X:
                    mag.add_edge(other, neighbor, ">", ">")
        return mag

    def upper_manipulation(self, X, inplace=False):
        """Remove every edge with an arrowhead into X (ref MAG.py:340-387)."""
        mag = self if inplace else self.copy()
        to_remove = [
            (u, v)
            for u in X
            for v in self.get_neighbors(u, u_type=">", v_type=None)
        ]
        mag.remove_edges_from(to_remove)
        return mag

    # ------------------------------------------------------------------ #
    # m-separation via the canonical DAG (pgmpy_tpu_torch extension)
    # ------------------------------------------------------------------ #
    def to_canonical_dag(self):
        """Latent confounders for <->, selection children for — edges."""
        from pgmpy_tpu_torch.base.dag import DAG

        dag = DAG()
        dag.add_nodes_from(self.nodes())
        dag.add_edges_from(self.directed_edge_list())
        latents = set(self.latents)
        selection = []
        for edge in self.bidirected_edge_list():
            u, v = tuple(sorted(edge, key=str))
            confounder = f"__u_{u}_{v}"
            dag.add_edge(confounder, u)
            dag.add_edge(confounder, v)
            latents.add(confounder)
        for edge in self.undirected_edge_list():
            u, v = tuple(sorted(edge, key=str))
            sel = f"__s_{u}_{v}"
            dag.add_edge(u, sel)
            dag.add_edge(v, sel)
            selection.append(sel)
        dag.latents = latents
        return dag, selection

    def is_mseparated(self, x, y, z=None):
        dag, selection = self.to_canonical_dag()
        observed = list(z or []) + selection
        return not dag.is_dconnected(x, y, observed=observed)

    def is_ancestral(self):
        """No directed cycles; no node is an ancestor of a bidirected
        spouse."""
        directed = nx.DiGraph(self.directed_edge_list())
        directed.add_nodes_from(self.nodes())
        if not nx.is_directed_acyclic_graph(directed):
            return False
        for edge in self.bidirected_edge_list():
            u, v = tuple(edge)
            if nx.has_path(directed, u, v) or nx.has_path(directed, v, u):
                return False
        return True

    def is_maximal(self):
        """Every non-adjacent pair is m-separable by some subset."""
        nodes = sorted(self.nodes(), key=str)
        for x, y in itertools.combinations(nodes, 2):
            if self.has_edge(x, y):
                continue
            others = [n for n in nodes if n not in (x, y)]
            separable = any(
                self.is_mseparated(x, y, list(sub))
                for r in range(len(others) + 1)
                for sub in itertools.combinations(others, r)
            )
            if not separable:
                return False
        return True
