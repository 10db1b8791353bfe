"""DynamicBayesianNetwork: 2-TBN over (variable, time_slice) nodes.

Port of ``pgmpy_tpu/models/dynamic_bn.py``; host code throughout.  ``fit``
goes through ``DiscreteBayesianNetwork.fit`` / ``fit_update`` on the unrolled
two-slice network, so every pair of consecutive slices is one table-count
call (``ops/bincount.py:table_counts``).  Simulation unrolls to a constant
network and runs the compiled ancestral sampler on ``config.DEVICE``;
filtering lives in ``inference/dbn.py`` (interface algorithm with carried
interface potentials, constant memory in T).
"""

import itertools
from collections import defaultdict

import networkx as nx
import numpy as np
import pandas as pd

from pgmpy_tpu_torch.base.dag import DAG
from pgmpy_tpu_torch.factors.cpd import TabularCPD


class DynamicNode:
    """(node, time_slice) with tuple semantics."""

    def __init__(self, node, time_slice):
        self.node = node
        self.time_slice = time_slice

    def __getitem__(self, idx):
        return (self.node, self.time_slice)[idx]

    def __len__(self):
        return 2

    def __iter__(self):
        return iter((self.node, self.time_slice))

    def __str__(self):
        return f"({self.node}, {self.time_slice})"

    def __repr__(self):
        return f"<DynamicNode({self.node}, {self.time_slice}) at {hex(id(self))}>"

    def __lt__(self, other):
        return (str(self.node), self.time_slice) < (str(other[0]), other[1])

    def __le__(self, other):
        return self == other or self < other

    def __eq__(self, other):
        try:
            return self.node == other[0] and self.time_slice == other[1]
        except (TypeError, IndexError):
            return False

    def __hash__(self):
        return hash((self.node, self.time_slice))

    def to_tuple(self):
        return (self.node, self.time_slice)


class DynamicBayesianNetwork(DAG):
    """2-TBN dynamic Bayesian network: nodes are ``(name, slice)`` pairs,
    intra-slice edges mirror into slice 1, inter-slice edges carry state
    forward.

    Examples
    --------
    >>> from pgmpy_tpu_torch.factors import TabularCPD
    >>> from pgmpy_tpu_torch.models import DynamicBayesianNetwork
    >>> dbn = DynamicBayesianNetwork()
    >>> dbn.add_edges_from(
    ...     [(("rain", 0), ("umbrella", 0)), (("rain", 0), ("rain", 1))])
    >>> dbn.add_cpds(
    ...     TabularCPD(("rain", 0), 2, [[0.5], [0.5]]),
    ...     TabularCPD(("umbrella", 0), 2, [[0.8, 0.1], [0.2, 0.9]],
    ...                evidence=[("rain", 0)], evidence_card=[2]),
    ...     TabularCPD(("rain", 1), 2, [[0.7, 0.3], [0.3, 0.7]],
    ...                evidence=[("rain", 0)], evidence_card=[2]),
    ...     TabularCPD(("umbrella", 1), 2, [[0.8, 0.1], [0.2, 0.9]],
    ...                evidence=[("rain", 1)], evidence_card=[2]))
    >>> dbn.check_model()
    True
    >>> dbn.get_interface_nodes(0)
    [('rain', 0)]
    >>> df = dbn.simulate(n_samples=50, n_time_slices=3, seed=0,
    ...                   show_progress=False)
    >>> (("rain", 2) in df.columns, len(df))
    (True, 50)
    """

    def __init__(self, ebunch=None):
        super().__init__()
        if ebunch:
            self.add_edges_from(ebunch)
        self.cpds = []
        self.cardinalities = defaultdict(int)

    def add_node(self, node, **attr):
        super().add_node((node, 0), **attr)

    def add_nodes_from(self, nodes, **attr):
        for node in nodes:
            self.add_node(node)

    def _nodes(self):
        """Plain variable names (without time slices)."""
        return list({node[0] for node in super().nodes()})

    def _timeslices(self):
        return sorted({node[1] for node in super().nodes()})

    def add_edge(self, start, end, **kwargs):
        try:
            if len(start) != 2 or len(end) != 2:
                raise ValueError("Nodes must be of type (node, time_slice).")
            int(start[1])
            int(end[1])
        except (TypeError, ValueError):
            raise ValueError("Nodes must be of type (node, time_slice).")
        if start[1] == end[1]:
            start = (start[0], start[1])
            end = (end[0], end[1])
        elif start[1] == end[1] - 1:
            start = (start[0], 0)
            end = (end[0], 1)
        elif start[1] > end[1]:
            raise NotImplementedError(
                "Edges in backward direction are not allowed."
            )
        elif start[1] != end[1]:
            raise ValueError(
                "Edges over multiple time slices is not currently supported"
            )
        start, end = tuple(start), tuple(end)
        if start == end:
            raise ValueError("Self Loops are not allowed")
        if (
            start in super().nodes()
            and end in super().nodes()
            and nx.has_path(self, end, start)
        ):
            raise ValueError(f"Loops are not allowed. Adding the edge from ({start} --> {end}) forms a loop.")
        super(DAG, self).add_edge(start, end, **kwargs)
        # mirror the edge in the other time slice for intra-slice edges
        if start[1] == end[1]:
            other = 1 - start[1] if start[1] in (0, 1) else None
            if other is not None:
                mirrored = ((start[0], other), (end[0], other))
                if not self.has_edge(*mirrored):
                    super(DAG, self).add_edge(*mirrored)

    def add_edges_from(self, ebunch, **kwargs):
        for edge in ebunch:
            self.add_edge(edge[0], edge[1], **kwargs)

    def get_intra_edges(self, time_slice=0):
        if not isinstance(time_slice, int) or time_slice < 0:
            raise ValueError(
                f"The timeslice should be a positive value greater than or equal to zero: ({time_slice})"
            )
        return [
            tuple((x[0], time_slice) for x in edge)
            for edge in self.edges()
            if edge[0][1] == edge[1][1] == 0
        ]

    def get_inter_edges(self):
        return [edge for edge in self.edges() if edge[0][1] != edge[1][1]]

    def get_interface_nodes(self, time_slice=0):
        if not isinstance(time_slice, int) or time_slice < 0:
            raise ValueError(
                f"The timeslice should be a positive value greater than or equal to zero: ({time_slice})"
            )
        return [
            (edge[0][0], time_slice) for edge in self.get_inter_edges()
        ]

    def get_slice_nodes(self, time_slice=0):
        if not isinstance(time_slice, int) or time_slice < 0:
            raise ValueError(
                f"The timeslice should be a positive value greater than or equal to zero: ({time_slice})"
            )
        return [(node, time_slice) for node in self._nodes()]

    def add_cpds(self, *cpds):
        for cpd in cpds:
            if not isinstance(cpd, TabularCPD):
                raise ValueError(f"cpd should be an instance of TabularCPD. Got: {type(cpd)}")
            if set(tuple(v) for v in cpd.variables) - set(super().nodes()):
                raise ValueError("CPD defined on variable not in the model", cpd)
            self.cpds.append(cpd)

    def get_cpds(self, node=None, time_slice=None):
        if node is not None:
            node = tuple(node)
            if node not in super().nodes():
                raise ValueError("Node not present in the model.")
            for cpd in self.cpds:
                if tuple(cpd.variable) == node:
                    return cpd
            return None
        if time_slice is None:
            return self.cpds
        if isinstance(time_slice, int):
            time_slice = [time_slice]
        return [
            cpd for cpd in self.cpds if tuple(cpd.variable)[1] in time_slice
        ]

    def remove_cpds(self, *cpds):
        for cpd in cpds:
            if isinstance(cpd, (tuple, DynamicNode)):
                cpd = self.get_cpds(cpd)
            self.cpds.remove(cpd)

    def check_model(self):
        for node in super().nodes():
            cpd = self.get_cpds(node=node)
            if cpd is None:
                raise ValueError(f"NO CPD associated with {node}")
            evidence = [tuple(v) for v in cpd.variables[1:]]
            parents = [tuple(p) for p in self.get_parents(node)]
            if set(evidence) != set(parents):
                raise ValueError(
                    f"CPD associated with {node} doesn't have proper parents associated with it."
                )
            if not cpd.is_valid_cpd():
                raise ValueError(
                    f"Sum of probabilities of states for node {node} is not equal to 1"
                )
        return True

    def initialize_initial_state(self):
        """Fill CPDs of the mirror slice from the defined slice when
        missing."""
        for cpd in list(self.cpds):
            var, t = tuple(cpd.variable)
            mirror = (var, 1 - t)
            if mirror in super().nodes() and self.get_cpds(node=mirror) is None:
                parents_mirror = [tuple(p) for p in self.get_parents(mirror)]
                parents_here = [(p[0], p[1]) for p in cpd.variables[1:]]
                # only mirror when the parent structure matches across slices
                shifted = [(p[0], p[1] + (1 - 2 * t)) for p in parents_here]
                if set(shifted) == set(parents_mirror):
                    new_cpd = TabularCPD(
                        mirror,
                        cpd.variable_card,
                        cpd.get_values(),
                        evidence=shifted or None,
                        evidence_card=[int(c) for c in cpd.cardinality[1:]] or None,
                        state_names={
                            mirror: cpd.state_names[cpd.variable],
                            **{
                                s: cpd.state_names[p]
                                for s, p in zip(shifted, cpd.variables[1:])
                            },
                        },
                    )
                    self.add_cpds(new_cpd)
        self.check_model()

    def moralize(self):
        from pgmpy_tpu_torch.base.undirected import UndirectedGraph

        moral_graph = UndirectedGraph()
        moral_graph.add_nodes_from(super().nodes())
        moral_graph.add_edges_from(
            (tuple(u), tuple(v)) for u, v in self.to_undirected().edges()
        )
        for node in super().nodes():
            moral_graph.add_edges_from(
                itertools.combinations([tuple(p) for p in self.predecessors(node)], 2)
            )
        return moral_graph

    def get_markov_blanket(self, node):
        return [tuple(n) for n in super().get_markov_blanket(tuple(node))]

    # ------------------------------------------------------------------ #
    # tuple-node handling for inherited DAG methods
    #
    # DBN nodes are plain (name, time_slice) tuples, so DAG's
    # single-vs-list `isinstance(x, (list, tuple))` checks would split a
    # single node into its two elements.  These overrides map single
    # (name, slice)/DynamicNode inputs onto lists of this graph's tuple
    # nodes, mirroring the reference's active_trail_nodes override
    # (ref DynamicBayesianNetwork.py:1036-1054).
    # ------------------------------------------------------------------ #
    @staticmethod
    def _is_single_node(v):
        return isinstance(v, DynamicNode) or (
            isinstance(v, tuple)
            and len(v) == 2
            and isinstance(v[1], (int, np.integer))
        )

    @classmethod
    def _node_list(cls, v):
        if cls._is_single_node(v):
            return [tuple(v)]
        return [tuple(n) for n in v]

    def active_trail_nodes(self, variables, observed=None, include_latents=False):
        variables = self._node_list(variables)
        if observed is not None and len(observed) > 0:
            observed = self._node_list(observed)
        return super().active_trail_nodes(
            variables, observed=observed, include_latents=include_latents
        )

    def local_independencies(self, variables):
        return super().local_independencies(self._node_list(variables))

    def _get_ancestors_of(self, nodes):
        return super()._get_ancestors_of(self._node_list(nodes))

    def do(self, nodes, inplace=False):
        return super().do(self._node_list(nodes), inplace=inplace)

    def get_constant_bn(self, t_slice=0):
        """Unroll the 2-TBN into a flat BN with string names 'var_t'."""
        from pgmpy_tpu_torch.models.discrete_bn import DiscreteBayesianNetwork

        edges = [
            (
                str(u[0]) + "_" + str(u[1] + t_slice),
                str(v[0]) + "_" + str(v[1] + t_slice),
            )
            for u, v in self.edges()
        ]
        new_cpds = []
        for cpd in self.cpds:
            new_vars = [
                str(var[0]) + "_" + str(var[1] + t_slice) for var in cpd.variables
            ]
            new_cpds.append(
                TabularCPD(
                    new_vars[0],
                    cpd.variable_card,
                    cpd.get_values(),
                    evidence=new_vars[1:] or None,
                    evidence_card=[int(c) for c in cpd.cardinality[1:]] or None,
                    state_names={
                        nv: cpd.state_names[v]
                        for nv, v in zip(new_vars, cpd.variables)
                    },
                )
            )
        bn = DiscreteBayesianNetwork(edges)
        bn.add_cpds(*new_cpds)
        return bn

    def fit(self, data, estimator="MLE"):
        """2-TBN MLE from a long time-series DataFrame with (var, t)
        columns."""
        if not isinstance(data, pd.DataFrame):
            raise ValueError(f"data must be a pandas dataframe. Got: {type(data)}")
        if min(data.columns, key=lambda t: t[1])[1] != 0:
            raise ValueError("data column names must start from time slice 0.")
        if estimator not in {"MLE", "mle"}:
            raise ValueError("Only Maximum Likelihood Estimator is supported currently")

        data_copy = data.copy()
        data_copy.columns = [f"{var}_{t}" for (var, t) in data.columns]
        n_samples = data.shape[0]
        const_bn = self.get_constant_bn()
        n_time_slices = max(data.columns, key=lambda t: t[1])[1]

        for t_slice in range(n_time_slices):
            colnames = [f"{node}_{t_slice}" for node in self._nodes()]
            colnames.extend(f"{node}_{t_slice + 1}" for node in self._nodes())
            df_slice = data_copy.loc[:, colnames].copy()
            tuple_colnames = [var.rsplit("_", 1) for var in df_slice.columns]
            df_slice.columns = [
                f"{node}_{int(t) - t_slice}" for node, t in tuple_colnames
            ]
            if t_slice == 0:
                const_bn.fit(df_slice)
            else:
                const_bn.fit_update(df_slice, n_prev_samples=t_slice * n_samples)

        cpds = []
        for cpd in const_bn.cpds:
            var_tuples = [var.rsplit("_", 1) for var in cpd.variables]
            new_vars = [(var, int(t)) for var, t in var_tuples]
            cpds.append(
                TabularCPD(
                    variable=new_vars[0],
                    variable_card=cpd.variable_card,
                    values=cpd.get_values(),
                    evidence=new_vars[1:] or None,
                    evidence_card=[int(c) for c in cpd.cardinality[1:]] or None,
                    state_names=dict(
                        zip(new_vars, [cpd.state_names[v] for v in cpd.variables])
                    ),
                )
            )
        self.cpds = []
        self.add_cpds(*cpds)
        return self

    def simulate(
        self,
        n_samples=10,
        n_time_slices=2,
        do=None,
        evidence=None,
        virtual_evidence=None,
        virtual_intervention=None,
        include_latents=False,
        seed=None,
        show_progress=True,
    ):
        """Unroll ``n_time_slices`` into a constant BN, simulate there, and
        re-index columns back to (var, t)."""
        self.check_model()
        first = self.get_constant_bn(0)
        bn = first
        for t in range(1, n_time_slices - 1):
            shifted = self.get_constant_bn(t)
            for edge in shifted.edges():
                if not bn.has_edge(*edge):
                    bn.add_edge(*edge)
            for cpd in shifted.cpds:
                if bn.get_cpds(cpd.variable) is None:
                    bn.add_cpds(cpd)

        def _translate(d):
            if d is None:
                return None
            if isinstance(d, dict):
                return {f"{k[0]}_{k[1]}": v for k, v in d.items()}
            return d

        samples = bn.simulate(
            n_samples=n_samples,
            do=_translate(do),
            evidence=_translate(evidence),
            include_latents=include_latents,
            seed=seed,
            show_progress=show_progress,
        )
        samples.columns = [
            tuple([c.rsplit("_", 1)[0], int(c.rsplit("_", 1)[1])])
            for c in samples.columns
        ]
        return samples

    @property
    def states(self):
        return {cpd.variable: cpd.state_names[cpd.variable] for cpd in self.cpds}

    def copy(self):
        dbn = DynamicBayesianNetwork()
        dbn.add_nodes_from(self._nodes())
        dbn.add_edges_from(self.edges())
        for cpd in self.cpds:
            dbn.add_cpds(cpd.copy())
        return dbn
