"""ADMG: acyclic directed mixed graph (directed + bidirected edges).

Port of ``pgmpy_tpu/base/admg.py`` (reference: ``pgmpy/base/ADMG.py:10-608``);
host networkx code.
m-separation is decided on the canonical DAG (each bidirected edge u <-> v
replaced by a fresh latent u <- L_uv -> v), reusing the Bayes-ball kernel.
"""

import itertools

import networkx as nx

from pgmpy_tpu_torch.base.roles import GraphRolesMixin


class ADMG(GraphRolesMixin, nx.DiGraph):
    def __init__(self, directed_ebunch=[], bidirected_ebunch=[], latents=[]):
        super().__init__()
        self.bidirected_edges = set()
        self.add_edges_from(directed_ebunch)
        for u, v in bidirected_ebunch:
            self.add_bidirected_edge(u, v)
        self.latents = set(latents)
        cycles = None
        try:
            cycles = list(nx.find_cycle(self))
        except nx.NetworkXNoCycle:
            pass
        if cycles:
            raise ValueError("Directed part of an ADMG must be acyclic.")

    def add_bidirected_edge(self, u, v):
        self.add_node(u)
        self.add_node(v)
        self.bidirected_edges.add(frozenset((u, v)))

    def get_parents(self, node):
        return list(self.predecessors(node))

    def get_spouses(self, node):
        """Nodes connected by a bidirected edge."""
        out = set()
        for edge in self.bidirected_edges:
            if node in edge:
                out |= set(edge) - {node}
        return out

    def districts(self):
        """Connected components of the bidirected part."""
        bigraph = nx.Graph()
        bigraph.add_nodes_from(self.nodes())
        for edge in self.bidirected_edges:
            u, v = tuple(edge)
            bigraph.add_edge(u, v)
        return [frozenset(c) for c in nx.connected_components(bigraph)]

    def district(self, node):
        for d in self.districts():
            if node in d:
                return d
        return frozenset({node})

    def to_canonical_dag(self):
        """DAG with a fresh latent parent per bidirected edge."""
        from pgmpy_tpu_torch.base.dag import DAG

        dag = DAG()
        dag.add_nodes_from(self.nodes())
        dag.add_edges_from(self.edges())
        latents = set(self.latents)
        for edge in self.bidirected_edges:
            u, v = tuple(sorted(edge, key=str))
            confounder = f"__u_{u}_{v}"
            dag.add_edge(confounder, u)
            dag.add_edge(confounder, v)
            latents.add(confounder)
        dag.latents = latents
        return dag

    def is_mseparated(self, x, y, z=None):
        """m-separation via d-separation on the canonical DAG."""
        dag = self.to_canonical_dag()
        return not dag.is_dconnected(x, y, observed=list(z or []))

    def m_separations(self):
        """All pairwise unconditional m-separations."""
        out = set()
        for x, y in itertools.combinations(sorted(self.nodes(), key=str), 2):
            if self.is_mseparated(x, y, []):
                out.add(frozenset((x, y)))
        return out

    def copy(self):
        admg = ADMG(
            directed_ebunch=list(self.edges()),
            bidirected_ebunch=[tuple(e) for e in self.bidirected_edges],
            latents=set(self.latents),
        )
        admg.add_nodes_from(self.nodes())
        return admg
