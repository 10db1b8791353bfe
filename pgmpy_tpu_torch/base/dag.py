"""Directed acyclic graph base class (host-side symbolic layer).

Re-implementation of the reference DAG
(``pgmpy/base/DAG.py:16-1910``) as an ``nx.DiGraph``
subclass.  Graph algebra (d-separation, moralization, ancestral graphs,
CPDAG conversion) stays on host — it compiles to the static structures
(elimination orders, message schedules) that the device kernels consume.
"""

import itertools

import networkx as nx
import numpy as np

from pgmpy_tpu_torch.base.roles import GraphRolesMixin
from pgmpy_tpu_torch.independencies import Independencies


class DAG(GraphRolesMixin, nx.DiGraph):
    """Directed acyclic graph with causal-inference machinery.

    Parameters
    ----------
    ebunch : iterable of (u, v) edges, optional
    latents : iterable, optional
        Nodes to mark as latent.
    lavaan_str / dagitty_str : str, optional
        Build the graph from a lavaan or dagitty model string instead.
    roles : dict, optional
        ``{role: variables}`` annotations (exposure/outcome/...).

    Examples
    --------
    >>> from pgmpy_tpu_torch.base import DAG
    >>> g = DAG([("a", "b"), ("b", "c"), ("d", "c")])
    >>> g.is_dconnected("a", "c")
    True
    >>> g.is_dconnected("a", "d")  # blocked through collider c
    False
    >>> g.is_dconnected("a", "d", observed=["c"])  # ... until c observed
    True
    >>> sorted(g.get_markov_blanket("b"))
    ['a', 'c', 'd']
    >>> sorted(g.do("b").edges())  # sever incoming edges of b
    [('b', 'c'), ('d', 'c')]
    >>> g.get_parents("c")
    ['b', 'd']
    """

    def __init__(self, ebunch=None, latents=[], lavaan_str=None, dagitty_str=None, roles=None):
        if lavaan_str is not None or dagitty_str is not None:
            from pgmpy_tpu_torch.utils.parser import parse_dagitty, parse_lavaan

            if lavaan_str is not None:
                ebunch, latents = parse_lavaan(lavaan_str)
            else:
                ebunch, latents = parse_dagitty(dagitty_str)
        self._init_building = True
        super().__init__(ebunch)
        self._init_building = False
        self.latents = set(latents)
        # role annotations up front (ref DAG.py:156-172)
        if roles is not None:
            if not isinstance(roles, dict):
                raise TypeError("Roles must be provided as a dictionary.")
            for role, variables in roles.items():
                self.with_role(role=role, variables=variables, inplace=True)
        cycles = []
        try:
            cycles = list(nx.find_cycle(self))
        except nx.NetworkXNoCycle:
            pass
        else:
            out_str = "Cycles are not allowed in a DAG."
            out_str += "\nEdges indicating the path taken for a loop: "
            out_str += "".join([f"({u},{v}) " for (u, v) in cycles])
            raise ValueError(out_str)

    @classmethod
    def from_lavaan(cls, string=None, filename=None):
        if filename:
            with open(filename) as f:
                string = f.read()
        if string is None:
            raise ValueError("Either `string` or `filename` must be specified")
        return cls(lavaan_str=string.splitlines())

    @classmethod
    def from_dagitty(cls, string=None, filename=None):
        if filename:
            with open(filename) as f:
                string = f.read()
        if string is None:
            raise ValueError("Either `string` or `filename` must be specified")
        return cls(dagitty_str=string)

    # ------------------------------------------------------------------ #
    # structure edits
    # ------------------------------------------------------------------ #
    def add_node(self, node_for_adding, weight=None, latent=False, **attr):
        node = node_for_adding
        if isinstance(node, tuple) and len(node) == 2 and isinstance(node[1], dict):
            node, attrs = node
            if weight is not None:
                attrs["weight"] = weight
        else:
            attrs = {"weight": weight}
        attrs.update(attr)
        super().add_node(node, **attrs)
        if latent:
            self.with_role("latent", [node], inplace=True)

    def add_nodes_from(self, nodes_for_adding, weights=None, latent=False, **attr):
        nodes = nodes_for_adding
        nodes = list(nodes)
        if isinstance(latent, bool):
            latent = [latent] * len(nodes)
        if weights:
            if len(nodes) != len(weights):
                raise ValueError(
                    "The number of elements in nodes and weights should be equal."
                )
            for node, weight, lat in zip(nodes, weights, latent):
                self.add_node(node, weight=weight, latent=lat, **attr)
        else:
            for node, lat in zip(nodes, latent):
                self.add_node(node, latent=lat, **attr)

    def add_edge(self, u, v, weight=None):
        super().add_edge(u, v, weight=weight)
        # during nx bulk construction the whole-graph cycle check in
        # __init__ covers this (per-edge errors would be wrapped by nx)
        if getattr(self, "_init_building", False):
            return
        if u != v and nx.has_path(self, v, u):
            # adding this edge created a cycle; undo and raise
            self.remove_edge(u, v)
            raise ValueError(f"Loops are not allowed. Adding the edge from ({u}->{v}) forms a loop.")

    def add_edges_from(self, ebunch, weights=None):
        ebunch = list(ebunch)
        if weights:
            if len(ebunch) != len(weights):
                raise ValueError(
                    "The number of elements in ebunch and weights should be equal"
                )
            for edge, weight in zip(ebunch, weights):
                self.add_edge(edge[0], edge[1], weight=weight)
        else:
            for edge in ebunch:
                self.add_edge(edge[0], edge[1])

    # ------------------------------------------------------------------ #
    # neighborhood queries
    # ------------------------------------------------------------------ #
    def get_parents(self, node):
        return list(self.predecessors(node))

    def get_children(self, node):
        return list(self.successors(node))

    def get_leaves(self):
        return [node for node, out in self.out_degree_iter() if out == 0]

    def get_roots(self):
        return [node for node, in_deg in dict(self.in_degree()).items() if in_deg == 0]

    def out_degree_iter(self, nbunch=None, weight=None):
        return iter(self.out_degree(nbunch, weight))

    def in_degree_iter(self, nbunch=None, weight=None):
        return iter(self.in_degree(nbunch, weight))

    def get_markov_blanket(self, node):
        """Parents, children, and children's other parents."""
        children = self.get_children(node)
        blanket_nodes = set(self.get_parents(node)) | set(children)
        for child in children:
            blanket_nodes.update(self.get_parents(child))
        blanket_nodes.discard(node)
        return list(blanket_nodes)

    def get_ancestral_graph(self, nodes):
        return self.subgraph(nodes=self._get_ancestors_of(nodes=list(nodes)))

    def _get_ancestors_of(self, nodes):
        if not isinstance(nodes, (list, tuple, set)):
            nodes = [nodes]
        for node in nodes:
            if node not in self.nodes():
                raise ValueError(f"Node {node} not in graph")
        ancestors = set(nodes)
        for node in nodes:
            ancestors |= nx.ancestors(self, node)
        return ancestors

    # ------------------------------------------------------------------ #
    # moralization / conversions
    # ------------------------------------------------------------------ #
    def moralize(self):
        """Moral (undirected) graph: marry parents, drop directions."""
        from pgmpy_tpu_torch.base.undirected import UndirectedGraph

        moral_graph = UndirectedGraph()
        moral_graph.add_nodes_from(self.nodes())
        moral_graph.add_edges_from(self.to_undirected().edges())
        for node in self.nodes():
            moral_graph.add_edges_from(
                itertools.combinations(self.get_parents(node), 2)
            )
        return moral_graph

    def get_immoralities(self):
        """v-structures X->Z<-Y with X,Y non-adjacent, as {child: [(p1, p2)]}."""
        immoralities = {}
        for node in self.nodes():
            pairs = []
            for p1, p2 in itertools.combinations(sorted(self.predecessors(node)), 2):
                if not self.has_edge(p1, p2) and not self.has_edge(p2, p1):
                    pairs.append((p1, p2))
            if pairs:
                immoralities[node] = pairs
        return immoralities

    def is_iequivalent(self, model):
        """Same skeleton + same immoralities."""
        if not isinstance(model, DAG):
            raise TypeError("model must be an instance of DAG")
        return (
            set(map(frozenset, self.to_undirected().edges()))
            == set(map(frozenset, model.to_undirected().edges()))
        ) and (self.get_immoralities() == model.get_immoralities())

    def to_pdag(self):
        """CPDAG of this DAG: v-structure edges directed, rest undirected,
        completed with Meek's rules."""
        from pgmpy_tpu_torch.base.pdag import PDAG

        directed = set()
        for child, pairs in self.get_immoralities().items():
            for p1, p2 in pairs:
                directed.add((p1, child))
                directed.add((p2, child))
        undirected = [
            (u, v) for u, v in self.edges() if (u, v) not in directed
        ]
        pdag = PDAG(
            directed_ebunch=list(directed),
            undirected_ebunch=undirected,
            latents=self.latents,
        )
        pdag.add_nodes_from(self.nodes())
        pdag.apply_meeks_rules(inplace=True)
        return pdag

    def do(self, nodes, inplace=False):
        """Apply the do-operator: sever incoming edges of ``nodes``."""
        if isinstance(nodes, (str, int)):
            nodes = [nodes]
        for node in nodes:
            if node not in self.nodes():
                raise ValueError(f"Node: {node} is not in the graph.")
        dag = self if inplace else self.copy()
        for node in nodes:
            for parent in list(dag.predecessors(node)):
                dag.remove_edge(parent, node)
        return dag

    # ------------------------------------------------------------------ #
    # independencies / d-separation
    # ------------------------------------------------------------------ #
    def local_independencies(self, variables):
        """X ⟂ nondescendants(X) \\ parents(X) | parents(X)."""
        independencies = Independencies()
        for variable in (
            variables if isinstance(variables, (list, tuple)) else [variables]
        ):
            non_descendents = (
                set(self.nodes())
                - {variable}
                - set(nx.dfs_preorder_nodes(self, variable))
            )
            parents = set(self.get_parents(variable))
            if non_descendents - parents:
                independencies.add_assertions(
                    [variable, non_descendents - parents, parents]
                )
        return independencies

    def get_independencies(self, latex=False, include_latents=False):
        """Pairwise minimal d-separations for all non-adjacent pairs."""
        nodes = set(self.nodes())
        if not include_latents:
            nodes -= self.latents
        independencies = Independencies()
        for x, y in itertools.combinations(nodes, 2):
            if not self.has_edge(x, y) and not self.has_edge(y, x):
                sep = self.minimal_dseparator(x, y, include_latents=include_latents)
                if sep is not None:
                    independencies.add_assertions([x, y, sep])
        independencies = independencies.reduce()
        return independencies.latex_string() if latex else independencies

    def is_dconnected(self, start, end, observed=None, include_latents=False):
        return end in self.active_trail_nodes(
            start, observed=observed, include_latents=include_latents
        )[start]

    def minimal_dseparator(self, start, end, include_latents=False):
        """A minimal separating set between start and end, or None.

        Reference algorithm (ref DAG.py:753-848): start from the union of
        the two nodes' parents (lifting latent parents to their own
        parents), then greedily drop members that are not needed, checking
        d-connection on the ancestral graph.  The result is an
        inclusion-minimal separator drawn from the parent sets — possibly
        larger than the globally smallest separator, matching the
        reference's outputs for implied_cis / adjustment identification.
        """
        if self.has_edge(start, end) or self.has_edge(end, start):
            raise ValueError("No possible separators because start and end are adjacent")
        an_graph = self.get_ancestral_graph([start, end])
        separator = set(
            itertools.chain(self.predecessors(start), self.predecessors(end))
        )
        if not include_latents:
            # replace latent parents by THEIR parents until observed
            while separator & self.latents:
                lifted = separator.copy()
                for u in separator:
                    if u in self.latents:
                        lifted.discard(u)
                        lifted.update(self.predecessors(u))
                separator = lifted
        separator -= {start, end}
        if an_graph.is_dconnected(start, end, observed=separator):
            return None
        minimal_separator = separator.copy()
        # deterministic (sorted) greedy pass; the reference iterates in set
        # order, which only differs on pairs with multiple equally-minimal
        # answers
        for u in sorted(separator, key=str):
            if not an_graph.is_dconnected(
                start, end, observed=minimal_separator - {u}
            ):
                minimal_separator.remove(u)
        return minimal_separator

    def active_trail_nodes(self, variables, observed=None, include_latents=False):
        """Bayes-ball reachability (Koller & Friedman Alg. 3.1): nodes with an
        active trail from each start variable given ``observed``."""
        if observed:
            observed_list = (
                list(observed) if isinstance(observed, (list, tuple, set)) else [observed]
            )
        else:
            observed_list = []
        ancestors = self._get_ancestors_of(observed_list) if observed_list else set()

        active_trails = {}
        for start in variables if isinstance(variables, (list, tuple)) else [variables]:
            visit = {(start, "up")}
            traversed = set()
            active = set()
            while visit:
                node, direction = visit.pop()
                if (node, direction) in traversed:
                    continue
                traversed.add((node, direction))
                if node not in observed_list:
                    active.add(node)
                if direction == "up" and node not in observed_list:
                    visit.update((p, "up") for p in self.predecessors(node))
                    visit.update((c, "down") for c in self.successors(node))
                elif direction == "down":
                    if node not in observed_list:
                        visit.update((c, "down") for c in self.successors(node))
                    if node in ancestors:
                        visit.update((p, "up") for p in self.predecessors(node))
            active_trails[start] = active if include_latents else active - self.latents
        return active_trails

    # ------------------------------------------------------------------ #
    # generation / comparison
    # ------------------------------------------------------------------ #
    @staticmethod
    def get_random(n_nodes=5, edge_prob=0.5, node_names=None, latents=False, seed=None):
        """Random DAG: sample a topological order, then independent edges."""
        gen = np.random.default_rng(seed)
        if node_names is None:
            node_names = [str(i) for i in range(n_nodes)]
        order = list(gen.permutation(n_nodes))
        adj = gen.random((n_nodes, n_nodes)) < edge_prob
        edges = [
            (node_names[order[i]], node_names[order[j]])
            for i in range(n_nodes)
            for j in range(i + 1, n_nodes)
            if adj[i, j]
        ]
        dag = DAG(edges)
        dag.add_nodes_from(node_names)
        if latents:
            n_latents = int(gen.integers(0, n_nodes))
            dag.latents = set(
                gen.choice(node_names, n_latents, replace=False).tolist()
            )
        return dag

    def copy(self):
        dag = DAG()
        dag.add_nodes_from(self.nodes(data=True))
        dag.add_edges_from(self.edges())
        dag.latents = set(self.latents)
        return dag

    def __eq__(self, other):
        if not isinstance(other, DAG):
            return False
        return (
            set(self.nodes()) == set(other.nodes())
            and set(self.edges()) == set(other.edges())
            and self.latents == other.latents
        )

    def __hash__(self):
        return hash(
            (frozenset(self.nodes()), frozenset(self.edges()), frozenset(self.latents))
        )

    def to_lavaan(self):
        lines = []
        for node in sorted(self.nodes(), key=str):
            parents = sorted(self.get_parents(node), key=str)
            if parents:
                lines.append(f"{node} ~ {' + '.join(map(str, parents))}")
        return "\n".join(lines)

    def to_dagitty(self):
        lines = ["dag {"]
        for u, v in sorted(self.edges(), key=str):
            lines.append(f"{u} -> {v}")
        lines.append("}")
        return "\n".join(lines)

    def _check_edge_strengths(self):
        missing = [
            (u, v) for u, v in self.edges() if "strength" not in self.edges[(u, v)]
        ]
        if missing:
            raise ValueError(
                f"Edge strength plotting requested but strengths not found for "
                f"edges: {missing}. Use edge_strength() method to compute "
                "strengths first."
            )

    def to_daft(
        self,
        node_pos="circular",
        latex=True,
        pgm_params={},
        edge_params={},
        node_params={},
        plot_edge_strength=False,
    ):
        """Publication-quality plot object (``daft.PGM``); call its
        ``render()`` to draw.  ``node_pos`` is a networkx layout name or a
        {node: (x, y)} dict (ref ``base/DAG.py:1188-1343``)."""
        try:
            from daft import PGM
        except ImportError as e:
            raise ImportError(
                f"{e}. Package `daft` is required for plotting probabilistic "
                "graphical models. Please install it using: pip install daft-pgm"
            ) from None

        if plot_edge_strength:
            self._check_edge_strengths()

        if isinstance(node_pos, str):
            layouts = {
                "circular": nx.circular_layout,
                "kamada_kawai": nx.kamada_kawai_layout,
                "planar": nx.planar_layout,
                "random": nx.random_layout,
                "shell": nx.shell_layout,
                "spring": nx.spring_layout,
                "spectral": nx.spectral_layout,
                "spiral": nx.spiral_layout,
            }
            if node_pos not in layouts:
                raise ValueError(
                    "Unknown node_pos argument. Please refer docstring for accepted values"
                )
            node_pos = layouts[node_pos](self)
        elif isinstance(node_pos, dict):
            for node in self.nodes():
                if node not in node_pos:
                    raise ValueError(f"No position specified for {node}.")
        else:
            raise ValueError("Argument node_pos not valid. Please refer to the docstring.")

        pgm = PGM(**pgm_params)
        observed_set = set(getattr(self, "observed", self.nodes()))
        for node in self.nodes():
            label = rf"${node}$" if latex else f"{node}"
            pgm.add_node(
                node,
                label,
                node_pos[node][0],
                node_pos[node][1],
                observed=node in observed_set,
                **node_params.get(node, {}),
            )
        for u, v in self.edges():
            extra = dict(edge_params.get((u, v), {}))
            if plot_edge_strength and "label" not in extra:
                extra["label"] = f"{self.edges[(u, v)]['strength']: .3f}"
            pgm.add_edge(u, v, **extra)
        return pgm

    def to_graphviz(self, plot_edge_strength=False):
        """``pygraphviz.AGraph`` of the DAG, with optional edge-strength
        labels (ref ``base/DAG.py:1414-1460``)."""
        if plot_edge_strength:
            self._check_edge_strengths()
        agraph = nx.nx_agraph.to_agraph(self)
        if plot_edge_strength:
            for u, v in self.edges():
                agraph.get_edge(u, v).attr["label"] = (
                    f"{self.edges[(u, v)]['strength']: .3f}"
                )
        return agraph

    def edge_strength(self, data, edges=None):
        """Strength of each edge as the Pillai-trace effect size of the
        residualization-based CI test of (u, v) given v's other parents
        (Ankan & Textor 2023)."""
        from pgmpy_tpu_torch.estimators.citests import pillai_trace

        if edges is None:
            edges = list(self.edges())
        elif isinstance(edges, tuple) and len(edges) == 2 and not isinstance(edges[0], tuple):
            edges = [edges]
        strengths = {}
        skipped = []
        for u, v in edges:
            parents_v = self.get_parents(v)
            # edges touching latent variables can't be tested on observed
            # data (ref DAG.py:1716-1726)
            if (
                u in self.latents
                or v in self.latents
                or any(p in self.latents for p in parents_v)
            ):
                skipped.append((u, v))
                continue
            other_parents = [p for p in parents_v if p != u]
            effect, _ = pillai_trace(u, v, other_parents, data, boolean=False)
            strengths[(u, v)] = effect
            self.edges[(u, v)]["strength"] = effect
        if skipped:
            from pgmpy_tpu_torch.config import logger

            logger.warning(
                f"Skipped computing strengths for edges involving latent "
                f"variables: {skipped}. Use CausalInference class for "
                f"advanced causal effect estimation."
            )
        return strengths

    def validate(self, data, metrics=None, significance_level=0.05, **kwargs):
        """Run model-fit metrics on the DAG + data; returns a DataFrame of
        (metric, value) rows."""
        import pandas as pd

        from pgmpy_tpu_torch.metrics import (
            correlation_score,
            fisher_c,
            implied_cis,
            log_likelihood_score,
            structure_score,
        )

        dispatch = {
            "correlation": lambda m, d: correlation_score(
                m, d, significance_level=significance_level
            ),
            "log-likelihood": log_likelihood_score,
            "aic": lambda m, d: structure_score(m, d, scoring_method="aic-d"),
            "bic": lambda m, d: structure_score(m, d, scoring_method="bic-d"),
            "fisher-c": lambda m, d: fisher_c(
                m, d, ci_test="pillai", show_progress=False
            ),
            "implied-cis": lambda m, d: implied_cis(
                m, d, ci_test="pillai", show_progress=False
            ),
        }
        if metrics is None:
            metrics = ("correlation", "log-likelihood", "bic")
        rows = []
        for metric in metrics:
            fn = dispatch[metric] if isinstance(metric, str) else metric
            name = metric if isinstance(metric, str) else metric.__name__
            try:
                rows.append({"metric": name, "value": fn(self, data)})
            except Exception as e:
                rows.append({"metric": name, "value": f"error: {e}"})
        return pd.DataFrame(rows)
