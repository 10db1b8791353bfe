"""BayesianEstimator: Dirichlet / BDeu / K2 priors.

Parity: ``pgmpy/estimators/BayesianEstimator.py:18-264``.
"""

import numpy as np

from pgmpy_tpu_torch.estimators.base import ParameterEstimator
from pgmpy_tpu_torch.factors.cpd import TabularCPD


class BayesianEstimator(ParameterEstimator):
    """CPD estimation with Dirichlet priors (K2 / BDeu / dirichlet),
    computed from the same batched device count kernel as MLE.

    Examples
    --------
    >>> import numpy as np
    >>> import pandas as pd
    >>> from pgmpy_tpu_torch.estimators import BayesianEstimator
    >>> from pgmpy_tpu_torch.models import DiscreteBayesianNetwork
    >>> df = pd.DataFrame({"a": [0, 0, 1, 1], "b": [0, 1, 1, 1]})
    >>> model = DiscreteBayesianNetwork([("a", "b")])
    >>> est = BayesianEstimator(model, df)
    >>> cpd_a = est.estimate_cpd("a", prior_type="K2")  # +1 pseudo-counts
    >>> np.asarray(cpd_a.get_values(), dtype=float).round(2).tolist()
    [[0.5], [0.5]]
    >>> cpd_b = est.estimate_cpd("b", prior_type="BDeu",
    ...                          equivalent_sample_size=4)
    >>> np.asarray(cpd_b.get_values(), dtype=float).round(2).tolist()
    [[0.5, 0.25], [0.5, 0.75]]
    """

    def __init__(self, model, data, **kwargs):
        from pgmpy_tpu_torch.models.discrete_bn import DiscreteBayesianNetwork

        if not isinstance(model, DiscreteBayesianNetwork):
            raise NotImplementedError(
                "Bayesian Parameter Estimation is only implemented for DiscreteBayesianNetwork"
            )
        super().__init__(model, data, **kwargs)

    def get_parameters(
        self, prior_type="BDeu", equivalent_sample_size=5, pseudo_counts=[], n_jobs=1, weighted=False
    ):
        """A TabularCPD per node.  ALL count tables come from one
        ``multi_counts`` call (one kernel launch, one readback); the prior
        and the normalisation are applied per table on the host in f64."""
        nodes = sorted(self.model.nodes(), key=str)
        specs = [(node, sorted(self.model.get_parents(node), key=str)) for node in nodes]
        priors = []
        for node, parents in specs:  # validate every prior before the device call
            node_ess = (equivalent_sample_size[node] if isinstance(equivalent_sample_size, dict)
                        else equivalent_sample_size)
            node_pc = pseudo_counts[node] if isinstance(pseudo_counts, dict) else pseudo_counts
            priors.append(self._pseudo_counts(node, parents, prior_type, node_pc, node_ess))
        tables = self._coded.multi_counts(
            specs, weights=self._coded.weights if weighted else None
        )
        parameters = []
        for (node, parents), prior, counts in zip(specs, priors, tables):
            posterior = counts.astype(np.float64) + prior
            posterior = posterior / posterior.sum(axis=0, keepdims=True)
            parameters.append(self._cpd(node, parents, posterior))
        return parameters

    def _pseudo_counts(self, node, parents, prior_type, pseudo_counts, equivalent_sample_size):
        """The prior's pseudo-count table, (node_card, prod(parent_cards))."""
        node_cardinality = len(self.state_names[node])
        parents_cardinalities = [len(self.state_names[p]) for p in parents]
        cpd_shape = (node_cardinality, int(np.prod(parents_cardinalities)) if parents else 1)

        prior_type = prior_type.lower()
        if prior_type == "k2":
            return np.ones(cpd_shape, dtype=float)
        if prior_type == "bdeu":
            alpha = float(equivalent_sample_size) / (
                node_cardinality * np.prod(parents_cardinalities)
            )
            return np.ones(cpd_shape, dtype=float) * alpha
        if prior_type == "dirichlet":
            pseudo_counts = np.asarray(pseudo_counts, dtype=float)
            if pseudo_counts.size == 1:
                return np.ones(cpd_shape, dtype=float) * pseudo_counts.item()
            if pseudo_counts.shape != cpd_shape:
                raise ValueError(
                    f"The shape of pseudo_counts for the node: {node} must be of shape: {str(cpd_shape)}"
                )
            return pseudo_counts
        raise ValueError("'prior_type' not specified")

    def _cpd(self, node, parents, values):
        return TabularCPD(
            node,
            len(self.state_names[node]),
            values,
            evidence=parents if parents else None,
            evidence_card=[len(self.state_names[p]) for p in parents] or None,
            state_names={v: self.state_names[v] for v in [node] + parents},
        )

    def estimate_cpd(
        self, node, prior_type="BDeu", pseudo_counts=[], equivalent_sample_size=5, weighted=False
    ):
        parents = sorted(self.model.get_parents(node), key=str)
        prior = self._pseudo_counts(node, parents, prior_type, pseudo_counts, equivalent_sample_size)
        counts = self._coded.counts(
            node, parents,
            weights=self._coded.weights if weighted else None,
        ).astype(np.float64)
        cpd = self._cpd(node, parents, counts + prior)
        cpd.normalize()
        return cpd
