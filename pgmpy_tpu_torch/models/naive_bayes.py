"""NaiveBayes: star-topology Bayesian network.

Port of ``pgmpy_tpu/models/naive_bayes.py``.  ``fit`` is the port's
``DiscreteBayesianNetwork.fit``: every ``(feature, class)`` table comes from
one ``table_counts`` launch.  ``predict`` / ``predict_probability`` go
through ``VariableElimination.query_batch``, which combines the per-row
``P(feature | class)`` rows in log space, so hundreds of observed features do
not underflow.
"""

from pgmpy_tpu_torch.independencies import Independencies
from pgmpy_tpu_torch.models.discrete_bn import DiscreteBayesianNetwork


class NaiveBayes(DiscreteBayesianNetwork):
    def __init__(self, feature_vars=None, dependent_var=None):
        self.dependent = dependent_var
        self.features = set(feature_vars) if feature_vars else set()
        edges = (
            [(dependent_var, feature) for feature in self.features]
            if dependent_var and feature_vars
            else None
        )
        super().__init__(edges)
        if dependent_var:
            self.add_node(dependent_var)

    def add_edge(self, u, v, *args, **kwargs):
        if self.dependent and u != self.dependent:
            raise ValueError(
                f"Model can have only one parent node: {self.dependent}. Got parent: {u}"
            )
        self.dependent = u
        self.features.add(v)
        super().add_edge(u, v, *args, **kwargs)

    def active_trail_nodes(self, start=None, observed=None, include_latents=False, variables=None):
        """Nodes reachable from ``start`` via an active trail.  In a star this
        has a closed form: observing the class node blocks everything,
        otherwise every unobserved node is reachable.  Positional calls
        return a plain set, as the reference does; the inference layer's
        ``variables=`` convention takes the DAG algorithm (a {var: set}
        dict)."""
        if variables is not None or start is None:
            return super().active_trail_nodes(
                variables=variables, observed=observed, include_latents=include_latents
            )
        if observed is None:
            observed = []
        elif isinstance(observed, str):
            observed = [observed]
        if self.dependent in observed:
            # the reference's set(start) would split a multi-character name
            return {start} if isinstance(start, str) else set(start)
        return set(self.nodes()) - set(observed)

    def is_dconnected(self, start, end, observed=None, include_latents=False):
        return end in self.active_trail_nodes(start, observed=observed)

    def local_independencies(self, variables):
        independencies = Independencies()
        for variable in variables if isinstance(variables, (list, tuple)) else [variables]:
            if variable != self.dependent:
                others = self.features - {variable}
                if others:
                    independencies.add_assertions([variable, list(others), [self.dependent]])
        return independencies

    def fit(self, data, parent_node=None, estimator=None, **kwargs):
        if parent_node is None:
            if not self.dependent:
                raise ValueError("parent node must be specified for the model")
            parent_node = self.dependent
        if parent_node not in data.columns:
            raise ValueError(f"Dependent variable: {parent_node} is not present in the data")
        for child_node in data.columns:
            if child_node != parent_node:
                self.add_edge(parent_node, child_node)
        return super().fit(data, estimator=estimator, **kwargs)
