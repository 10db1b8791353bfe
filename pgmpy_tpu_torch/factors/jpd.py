"""JointProbabilityDistribution: a normalized factor over all variables.

Port of ``pgmpy_tpu/factors/jpd.py``: host code on the port's
``DiscreteFactor`` (values a tensor on ``config.DEVICE``).  Independence is
decided by factor equality, whose default tolerance follows the values' type
(1e-5 in float32, 1e-8 in float64) as in the JAX package.
"""

import itertools

import torch

from pgmpy_tpu_torch.config import as_tensor
from pgmpy_tpu_torch.factors.discrete import DiscreteFactor
from pgmpy_tpu_torch.independencies import Independencies


class JointProbabilityDistribution(DiscreteFactor):
    def __init__(self, variables, cardinality, values):
        total = float(torch.sum(as_tensor(values, dtype=torch.float64)))
        if abs(total - 1.0) > 0.01 + 1e-5:
            raise ValueError("The probability values doesn't sum to 1.")
        super().__init__(variables, cardinality, values)

    def __repr__(self):
        var_card = ", ".join(
            f"{var}:{int(card)}" for var, card in zip(self.variables, self.cardinality)
        )
        return f"<Joint Distribution representing P({var_card}) at {hex(id(self))}>"

    def __str__(self):
        return self._str(phi_or_p="P")

    def marginal_distribution(self, variables, inplace=True):
        """Marginal P(variables)."""
        variables = [variables] if isinstance(variables, (str, int)) else list(variables)
        return self.marginalize(
            [var for var in self.variables if var not in variables], inplace=inplace
        )

    def _pair_independent(self, var1, var2):
        marg = self.marginal_distribution([var1, var2], inplace=False)
        m1 = self.marginal_distribution([var1], inplace=False)
        m2 = self.marginal_distribution([var2], inplace=False)
        return (m1 * m2) == marg

    def check_independence(self, event1, event2, event3=None, condition_random_variable=False):
        """Test (event1 ⟂ event2 | event3) in this JPD numerically."""
        jpd = self.copy()
        if isinstance(event1, str) or isinstance(event2, str):
            raise TypeError("Event 1 and event 2 should be list or array-like structures")
        if event3:
            if isinstance(event3, str):
                raise TypeError("Event 3 cannot be a string")
            if condition_random_variable:
                # condition on every state of event3 variables
                for variable_states in itertools.product(
                    *[range(int(self.get_cardinality([var])[var])) for var in event3]
                ):
                    conditioned = jpd.conditional_distribution(
                        list(zip(event3, variable_states)), inplace=False
                    )
                    for var1, var2 in itertools.product(event1, event2):
                        if not conditioned._pair_independent(var1, var2):
                            return False
                return True
            jpd.conditional_distribution(event3)
        return all(
            jpd._pair_independent(var1, var2) for var1, var2 in itertools.product(event1, event2)
        )

    def get_independencies(self, condition=None):
        """All pairwise marginal independencies that hold."""
        jpd = self.copy()
        if condition:
            jpd.conditional_distribution(condition)
        independencies = Independencies()
        for var1, var2 in itertools.combinations(jpd.variables, 2):
            if jpd._pair_independent(var1, var2):
                independencies.add_assertions([var1, var2])
        return independencies

    def conditional_distribution(self, values, inplace=True):
        """Condition on [(variable, state-index)] and renormalize."""
        jpd = self if inplace else self.copy()
        jpd.reduce(values, show_warnings=False)
        jpd.normalize()
        if not inplace:
            return jpd

    def copy(self):
        return JointProbabilityDistribution(
            list(self.variables), self.cardinality.copy(), self.values.clone()
        )

    def minimal_imap(self, order):
        """I-map DAG for the given variable order, with the reference's
        literal semantics (goldens v7): an edge ``s -> v`` is added for every
        PROPER predecessor subset ``s`` that renders ``v`` independent of the
        remaining predecessors.  So a fully dependent variable gets no
        parents (no subset certifies), and a fully independent one gets an
        edge from every singleton subset."""
        from pgmpy_tpu_torch.base.dag import DAG

        graph = DAG()
        for variable_index in range(len(order)):
            u = order[:variable_index]
            for r in range(len(u)):
                for subset in itertools.combinations(u, r):
                    if self.check_independence(
                        [order[variable_index]], set(u) - set(subset), subset, True
                    ):
                        graph.add_edges_from(
                            [(variable, order[variable_index]) for variable in subset]
                        )
        return graph

    def is_imap(self, model):
        """Check whether ``model``'s factorization equals this JPD."""
        from pgmpy_tpu_torch.models.discrete_bn import DiscreteBayesianNetwork

        if not isinstance(model, DiscreteBayesianNetwork):
            raise TypeError("model must be an instance of DiscreteBayesianNetwork")
        return self.to_factor() == model_joint_factor(model)

    def to_factor(self):
        return DiscreteFactor(list(self.variables), self.cardinality.copy(), self.values)

    def pmap(self):
        raise NotImplementedError


def model_joint_factor(model):
    """The product of ``model``'s CPDs as one factor."""
    factors = [cpd.to_factor() for cpd in model.get_cpds()]
    product = factors[0]
    for factor in factors[1:]:
        product = product * factor
    return product
