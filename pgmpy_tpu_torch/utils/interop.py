"""Build port models from plain numpy parameters.

A model of either package can be described by its edges and, per CPD, a
tuple ``(variable, card, values, evidence, evidence_card, state_names)``
with ``values`` the 2-D ``(card, prod(evidence_card))`` table (last evidence
variable fastest).  :func:`bn_from_numpy` turns such a description into a
``pgmpy_tpu_torch`` network, so two packages can compute on identical
tables.  A linear-Gaussian network is described per node by
``(variable, parents, beta, std)`` with ``beta`` the intercept followed by one
coefficient per parent; :func:`lgbn_from_numpy` builds it.  A 2-TBN is
described like a discrete network, with ``(name, time_slice)`` pairs for
variables; :func:`dbn_from_numpy` builds it.  An undirected model is
described by its factors: a list of scopes, a {variable: cardinality} dict and
one table per scope (any shape with the scope's number of entries, C-order);
:func:`factor_graph_from_numpy` and :func:`markov_network_from_numpy` build
it.  All take numpy only.
"""

import itertools

from pgmpy_tpu_torch.factors.continuous import LinearGaussianCPD
from pgmpy_tpu_torch.factors.cpd import TabularCPD
from pgmpy_tpu_torch.factors.discrete import DiscreteFactor
from pgmpy_tpu_torch.models.discrete_bn import DiscreteBayesianNetwork
from pgmpy_tpu_torch.models.dynamic_bn import DynamicBayesianNetwork
from pgmpy_tpu_torch.models.factor_graph import FactorGraph
from pgmpy_tpu_torch.models.linear_gaussian_bn import LinearGaussianBayesianNetwork
from pgmpy_tpu_torch.models.markov_network import DiscreteMarkovNetwork


def bn_from_numpy(edges, cpds, nodes=None):
    """A :class:`DiscreteBayesianNetwork` with ``edges`` and the CPDs in
    ``cpds``; ``nodes`` adds nodes without edges (default: every CPD
    variable)."""
    model = DiscreteBayesianNetwork()
    specs = [
        (var, int(card), values, list(evidence or []) or None,
         [int(c) for c in (evidence_card or [])] or None, dict(state_names))
        for var, card, values, evidence, evidence_card, state_names in cpds
    ]
    model.add_nodes_from(nodes if nodes is not None else [s[0] for s in specs])
    model.add_edges_from(edges)
    model.add_cpds(*TabularCPD.batch_build(specs))
    return model


def dbn_from_numpy(edges, cpds):
    """A :class:`DynamicBayesianNetwork` with ``edges`` between
    ``(name, time_slice)`` nodes and one ``TabularCPD`` per entry
    ``(variable, card, values, evidence, evidence_card, state_names)`` of
    ``cpds``, every variable a ``(name, time_slice)`` pair."""
    model = DynamicBayesianNetwork()
    model.add_nodes_from(sorted({var[0] for var, *_ in cpds}, key=str))
    model.add_edges_from(edges)
    model.add_cpds(*[
        TabularCPD(tuple(var), int(card), values,
                   evidence=[tuple(e) for e in evidence or []] or None,
                   evidence_card=[int(c) for c in evidence_card or []] or None,
                   state_names={tuple(k): list(v) for k, v in state_names.items()})
        for var, card, values, evidence, evidence_card, state_names in cpds
    ])
    return model


def lgbn_from_numpy(edges, cpds, nodes=None, latents=()):
    """A :class:`LinearGaussianBayesianNetwork` with ``edges`` and one
    ``LinearGaussianCPD(variable, beta, std, evidence=parents)`` per entry
    ``(variable, parents, beta, std)`` of ``cpds``; ``nodes`` fixes the node
    order (default: the CPDs' order)."""
    model = LinearGaussianBayesianNetwork(latents=set(latents))
    model.add_nodes_from(nodes if nodes is not None else [c[0] for c in cpds])
    model.add_edges_from(edges)
    model.add_cpds(*[
        LinearGaussianCPD(var, beta, std, evidence=list(parents))
        for var, parents, beta, std in cpds
    ])
    return model


def _factors(scopes, cards, tables, state_names):
    """One :class:`DiscreteFactor` per scope, and the variables in the order
    they first appear."""
    factors = [
        DiscreteFactor(list(scope), [int(cards[v]) for v in scope], table,
                       state_names={v: list(state_names[v]) for v in scope} if state_names else {})
        for scope, table in zip(scopes, tables)
    ]
    return factors, list(dict.fromkeys(v for scope in scopes for v in scope))


def factor_graph_from_numpy(scopes, cards, tables, state_names=None):
    """A :class:`FactorGraph` with one factor per ``(scope, table)`` and an
    edge from each factor to every variable of its scope."""
    factors, variables = _factors(scopes, cards, tables, state_names)
    model = FactorGraph()
    model.add_nodes_from(variables)
    model.add_factors(*factors)
    model.add_edges_from((v, f) for f in factors for v in f.variables)
    return model


def markov_network_from_numpy(scopes, cards, tables, state_names=None):
    """A :class:`DiscreteMarkovNetwork` with one factor per ``(scope,
    table)`` and an edge between every two variables of a scope, in scope
    order."""
    factors, variables = _factors(scopes, cards, tables, state_names)
    model = DiscreteMarkovNetwork()
    model.add_nodes_from(variables)
    model.add_edges_from(
        pair for scope in scopes for pair in itertools.combinations(scope, 2)
    )
    model.add_factors(*factors)
    return model
