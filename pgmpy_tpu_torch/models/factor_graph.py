"""FactorGraph: bipartite variable/factor graph.

Parity: ``pgmpy/models/FactorGraph.py:15-518``.  Factor nodes
are the factor objects themselves; variable nodes are their scopes' names.
"""

import itertools
from collections import defaultdict

import numpy as np

from pgmpy_tpu_torch.base.undirected import UndirectedGraph
from pgmpy_tpu_torch.factors.discrete import DiscreteFactor
from pgmpy_tpu_torch.factors.factor_ops import factor_product


class FactorGraph(UndirectedGraph):
    """Bipartite variable/factor graph (factor objects ARE nodes).

    Examples
    --------
    >>> from pgmpy_tpu_torch.factors import DiscreteFactor
    >>> from pgmpy_tpu_torch.models import FactorGraph
    >>> fg = FactorGraph()
    >>> fg.add_nodes_from(["a", "b"])
    >>> f = DiscreteFactor(["a", "b"], [2, 2], [1.0, 2.0, 3.0, 4.0])
    >>> fg.add_factors(f)
    >>> fg.add_edges_from([("a", f), ("b", f)])
    >>> fg.check_model()
    True
    >>> fg.get_variable_nodes()
    ['a', 'b']
    >>> round(float(fg.get_partition_function()), 1)
    10.0
    """

    def __init__(self, ebunch=None):
        super().__init__()
        if ebunch:
            self.add_edges_from(ebunch)
        self.factors = []

    def add_edge(self, u, v, **kwargs):
        if u != v:
            super().add_edge(u, v, **kwargs)
        else:
            raise ValueError("Self loops can not be added")

    def add_factors(self, *factors, replace=False):
        nodes = set(self.nodes())
        for factor in factors:
            if set(factor.variables) - nodes:
                raise ValueError("Factors defined on variable not in the model", factor)
            if replace:
                for existing in list(self.factors):
                    if set(existing.variables) == set(factor.variables):
                        self.remove_factors(existing)
                        self.add_node(factor)
                        self.add_edges_from((var, factor) for var in factor.variables)
            self.factors.append(factor)

    def remove_factors(self, *factors):
        for factor in factors:
            self.factors.remove(factor)
            if factor in self.nodes():
                self.remove_node(factor)

    def get_cardinality(self, node=None):
        cardinalities = defaultdict(int)
        for factor in self.factors:
            for variable, cardinality in zip(factor.scope(), factor.cardinality):
                cardinalities[variable] = int(cardinality)
        if node is not None:
            return cardinalities[node]
        return cardinalities

    def get_variable_nodes(self):
        self.check_model()
        return [
            node for node in self.nodes() if not isinstance(node, DiscreteFactor)
        ]

    def get_factor_nodes(self):
        self.check_model()
        return [node for node in self.nodes() if isinstance(node, DiscreteFactor)]

    def check_model(self):
        variable_nodes = {
            node for node in self.nodes() if not isinstance(node, DiscreteFactor)
        }
        factor_nodes = set(self.nodes()) - variable_nodes
        if len(factor_nodes) != len(self.factors):
            raise ValueError("Factors not associated with all the factor nodes.")
        # bipartite check
        for u, v in self.edges():
            u_is_factor = isinstance(u, DiscreteFactor)
            v_is_factor = isinstance(v, DiscreteFactor)
            if u_is_factor == v_is_factor:
                raise ValueError("Edges can only be between variables and factor nodes.")
        cardinalities = self.get_cardinality()
        if len(variable_nodes) != len(cardinalities):
            raise ValueError("Factors for all the variables not defined.")
        for factor in self.factors:
            for variable, cardinality in zip(factor.scope(), factor.cardinality):
                if cardinalities[variable] != int(cardinality):
                    raise ValueError(
                        "Cardinality of variable in different factors doesn't match."
                    )
        return True

    def to_markov_model(self):
        from pgmpy_tpu_torch.models.markov_network import DiscreteMarkovNetwork

        mm = DiscreteMarkovNetwork()
        variable_nodes = self.get_variable_nodes()
        if len(set(self.nodes()) - set(variable_nodes)) != len(self.factors):
            raise ValueError("Factors not associated with all the factor nodes.")
        mm.add_nodes_from(variable_nodes)
        for factor in self.factors:
            scope = factor.scope()
            mm.add_edges_from(itertools.combinations(scope, 2))
            mm.add_factors(factor)
        return mm

    def to_junction_tree(self):
        return self.to_markov_model().to_junction_tree()

    def get_factors(self, node=None):
        if node is None:
            return self.factors
        if node not in self.get_factor_nodes():
            raise ValueError("Factors are not associated with the corresponding node.")
        return [factor for factor in self.factors if factor == node][0]

    def get_partition_function(self):
        factor = self.factors[0]
        factor = factor_product(
            factor, *[self.factors[i] for i in range(1, len(self.factors))]
        )
        if set(factor.scope()) != set(self.get_variable_nodes()):
            raise ValueError("DiscreteFactor for all the random variables not defined.")
        return float(factor.values.sum())

    def get_point_mass_message(self, variable, observation):
        """Delta message for an observed variable state."""
        cardinality = self.get_cardinality(variable)
        factor = [f for f in self.factors if variable in f.scope()][0]
        state_no = factor.get_state_no(variable, observation) if observation in factor.name_to_no[variable] else observation
        message = np.zeros(cardinality)
        message[state_no] = 1.0
        return message

    def get_uniform_message(self, variable):
        cardinality = self.get_cardinality(variable)
        return np.full(cardinality, 1.0 / cardinality)

    def copy(self):
        copy = FactorGraph()
        copy.add_nodes_from([n for n in self.nodes() if not isinstance(n, DiscreteFactor)])
        for factor in self.factors:
            factor_copy = factor.copy()
            copy.add_node(factor_copy)
            copy.add_edges_from((var, factor_copy) for var in factor_copy.variables)
            copy.add_factors(factor_copy)
        return copy
