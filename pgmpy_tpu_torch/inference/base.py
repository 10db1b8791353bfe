"""Inference base: query-time model compilation passes (host side).

Parity: ``pgmpy/inference/base.py:19-312``.  Builds the
var->factor index, prunes barren/d-separated nodes, and rewrites virtual
evidence into binary likelihood children — all before anything touches the
device.
"""

from collections import defaultdict
from itertools import chain

import numpy as np

from pgmpy_tpu_torch.config import to_numpy
from pgmpy_tpu_torch.factors.cpd import TabularCPD
from pgmpy_tpu_torch.factors.discrete import DiscreteFactor
from pgmpy_tpu_torch.models.discrete_bn import DiscreteBayesianNetwork
from pgmpy_tpu_torch.models.factor_graph import FactorGraph
from pgmpy_tpu_torch.models.cluster_graph import ClusterGraph
from pgmpy_tpu_torch.models.junction_tree import JunctionTree
from pgmpy_tpu_torch.models.markov_network import DiscreteMarkovNetwork


class Inference:
    def __init__(self, model):
        self.model = model
        model.check_model()
        self._initialize_structures()

    def _initialize_structures(self):
        model = self.model
        if isinstance(model, (JunctionTree, ClusterGraph)):
            self.variables = set(chain(*model.nodes()))
        else:
            self.variables = model.nodes()

        self.cardinality = {}
        self.factors = defaultdict(list)

        if isinstance(model, DiscreteBayesianNetwork):
            self.state_names_map = {}
            for node in model.nodes():
                cpd = model.get_cpds(node)
                self.cardinality[node] = cpd.variable_card
                factor = cpd.to_factor()
                for var in factor.scope():
                    self.factors[var].append(factor)
                self.state_names_map.update(factor.no_to_name)
        elif isinstance(model, (DiscreteMarkovNetwork, FactorGraph, JunctionTree, ClusterGraph)):
            self.cardinality = model.get_cardinality()
            for factor in model.get_factors():
                for var in factor.variables:
                    self.factors[var].append(factor)

    def _prune_bayesian_model(self, variables, evidence):
        """Drop nodes d-separated from the query and outside the ancestral
        closure of {variables, evidence} (Baker & Boult 2013)."""
        evidence = {} if evidence is None else evidence
        variables = (
            list(self.model.nodes()) if len(variables) == 0 else list(variables)
        )

        d_connected = self.model.active_trail_nodes(
            variables=variables, observed=list(evidence.keys()), include_latents=True
        )
        d_connected = set.union(*d_connected.values()).union(evidence.keys())
        bn = self.model.subgraph(d_connected)
        evidence = {var: state for var, state in evidence.items() if var in d_connected}

        # subgraph() returns a plain graph view; rebuild as a model over the
        # ancestral closure
        ancestral_nodes = set()
        query_nodes = list(variables) + list(evidence.keys())
        import networkx as nx

        for node in query_nodes:
            if node in bn:
                ancestral_nodes |= nx.ancestors(bn, node)
                ancestral_nodes.add(node)
        pruned = DiscreteBayesianNetwork()
        pruned.add_nodes_from(ancestral_nodes)
        pruned.add_edges_from(
            (u, v) for u, v in bn.edges() if u in ancestral_nodes and v in ancestral_nodes
        )

        cpds = []
        for var in pruned.nodes():
            cpd = self.model.get_cpds(var)
            scope_diff = set(cpd.scope()) - set(pruned.nodes())
            if not scope_diff:
                cpds.append(cpd)
            else:
                cpds.append(cpd.marginalize(list(scope_diff), inplace=False))
        pruned.cpds = cpds
        pruned.latents = {l for l in self.model.latents if l in ancestral_nodes}
        return pruned, evidence

    def _check_virtual_evidence(self, virtual_evidence):
        for cpd in virtual_evidence:
            if not isinstance(cpd, (TabularCPD, DiscreteFactor)):
                raise ValueError(
                    f"Virtual evidence should be an instance of TabularCPD or "
                    f"DiscreteFactor. Got: {type(cpd)}"
                )
            if len(cpd.variables) > 1:
                raise ValueError(
                    "Virtual evidence should be defined on individual variables. "
                    "Maybe you are looking for soft evidence."
                )
            var = cpd.variables[0]
            if var not in self.model.nodes():
                raise ValueError("Evidence provided for variable which is not in the model")
            if self.model.get_cardinality(var) != int(cpd.cardinality[0]):
                raise ValueError(
                    "The number of states/cardinality for the evidence should be "
                    "same as the number of states/cardinality of the variable in the model"
                )

    def _virtual_evidence(self, virtual_evidence):
        """Attach a binary child per virtual evidence whose state-0 row is the
        likelihood vector; conditioning that child on 0 applies the evidence
        (Mrad et al. 2012)."""
        self._check_virtual_evidence(virtual_evidence)
        bn = attach_virtual_evidence(self.model.copy(), virtual_evidence)
        self.__init__(bn)

    @staticmethod
    def _get_virtual_evidence_var_list(virtual_evidence):
        return [cpd.variables[0] for cpd in virtual_evidence]


def attach_virtual_evidence(model, virtual_evidence):
    """Mutate ``model``: add a binary likelihood child "__<var>" per virtual
    evidence CPD; conditioning the child on state 0 applies the evidence.
    Shared by inference and simulation."""
    for cpd in virtual_evidence:
        var = cpd.variables[0]
        if var not in model.nodes():
            raise ValueError("Evidence provided for variable which is not in the model")
        if len(cpd.variables) > 1:
            raise ValueError(
                "Virtual evidence should be defined on individual variables. "
                "Maybe you are looking for soft evidence."
            )
        if model.get_cardinality(var) != int(cpd.cardinality[0]):
            raise ValueError(
                "The number of states/cardinality for the evidence should be "
                "same as the number of states/cardinality of the variable in the model"
            )
        new_var = "__" + str(var)
        model.add_edge(var, new_var)
        likelihood = to_numpy(cpd.values).astype(np.float64).ravel()
        values = np.vstack([likelihood, 1 - likelihood])
        model.add_cpds(
            TabularCPD(
                variable=new_var,
                variable_card=2,
                values=values,
                evidence=[var],
                evidence_card=[model.get_cardinality(var)],
                state_names={new_var: [0, 1], var: cpd.state_names[var]},
            )
        )
    return model


def evidence_code(var, state, mapping, card):
    """The integer code of one evidence state (a state name, or an index in
    ``[0, card)``).  Raises ``ValueError`` on the host for anything else: an
    out-of-range index would otherwise reach ``one_hot`` or ``index_select``
    on the device."""
    if state in mapping:
        return mapping[state]
    if isinstance(state, (int, np.integer)) and 0 <= state < card:
        return int(state)
    raise ValueError(f"Evidence state {state!r} not valid for {var}")


def evidence_codes(var, states, mapping, card):
    """Codes of a whole column of evidence states, validated like
    :func:`evidence_code`."""
    states = list(states)
    codes = np.asarray([mapping.get(s, -1) for s in states], dtype=np.int64)
    for i in np.flatnonzero(codes < 0):
        codes[i] = evidence_code(var, states[i], mapping, card)
    return codes
