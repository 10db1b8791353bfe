"""ApproxInference: sampling-based posterior queries.

Port of ``pgmpy_tpu/inference/approx.py``: ``model.simulate`` draws the
samples on ``config.DEVICE`` and the empirical distribution is a weighted
histogram of the returned frame, built with numpy on the host.
"""

import numpy as np

from pgmpy_tpu_torch.config import to_numpy
from pgmpy_tpu_torch.factors.discrete import DiscreteFactor


class ApproxInference:
    """Sampling-based approximate posteriors: simulate (on device), then
    histogram the draws.

    Examples
    --------
    >>> import numpy as np
    >>> from pgmpy_tpu_torch.factors import TabularCPD
    >>> from pgmpy_tpu_torch.inference import ApproxInference
    >>> from pgmpy_tpu_torch.models import DiscreteBayesianNetwork
    >>> model = DiscreteBayesianNetwork([("rain", "wet")])
    >>> model.add_cpds(
    ...     TabularCPD("rain", 2, [[0.8], [0.2]]),
    ...     TabularCPD("wet", 2, [[0.9, 0.2], [0.1, 0.8]],
    ...                evidence=["rain"], evidence_card=[2]))
    >>> approx = ApproxInference(model)
    >>> phi = approx.query(["wet"], n_samples=50_000, seed=0,
    ...                    show_progress=False)
    >>> phi.values.double().cpu().numpy().round(1).tolist()  # ~[0.76, 0.24]
    [0.8, 0.2]
    """

    def __init__(self, model):
        from pgmpy_tpu_torch.config import not_ported
        from pgmpy_tpu_torch.models.discrete_bn import DiscreteBayesianNetwork

        if type(model).__name__ == "DynamicBayesianNetwork":
            not_ported("ApproxInference on a DynamicBayesianNetwork", "models/dynamic_bn.py")
        model.check_model()
        if not isinstance(model, DiscreteBayesianNetwork):
            raise ValueError(
                f"model must be a DiscreteBayesianNetwork (or DBN). Got: {type(model)}"
            )
        self.model = model

    @staticmethod
    def get_distribution(samples, variables, state_names=None, joint=True):
        """Empirical joint/marginal factor(s) from a sample DataFrame."""
        if isinstance(variables, str):
            raise ValueError(f"variables must be a list of strings. Got: {type(variables)}")

        if state_names is None:
            state_names = {
                var: sorted(samples[var].cat.categories.tolist())
                if hasattr(samples[var], "cat")
                else sorted(samples[var].unique().tolist())
                for var in variables
            }
        cards = [len(state_names[v]) for v in variables]
        codes = np.stack(
            [
                samples[v].map({s: i for i, s in enumerate(state_names[v])}).to_numpy(dtype=np.int64)
                for v in variables
            ],
            axis=1,
        )
        if "_weight" in samples.columns:
            weights = samples["_weight"].to_numpy(dtype=np.float64)
        else:
            weights = np.ones(len(samples))
        flat = np.ravel_multi_index(codes.T, cards)
        counts = np.bincount(flat, weights=weights, minlength=int(np.prod(cards)))
        factor = DiscreteFactor(
            list(variables), cards, counts, state_names=state_names
        ).normalize(inplace=False)
        if joint:
            return factor
        return {
            var: factor.marginalize(
                [v for v in variables if v != var], inplace=False
            )
            for var in variables
        }

    def query(
        self,
        variables,
        n_samples=10000,
        samples=None,
        evidence=None,
        virtual_evidence=None,
        joint=True,
        state_names=None,
        show_progress=True,
        seed=None,
    ):
        """Approximate P(variables | evidence) from ``n_samples`` simulated
        draws (or user-provided ``samples``)."""
        if samples is None:
            samples = self.model.simulate(
                n_samples=n_samples,
                evidence=evidence,
                virtual_evidence=virtual_evidence,
                show_progress=show_progress,
                seed=seed,
            )
        model_states = self.model.states
        if state_names is None:
            state_names = {v: model_states[v] for v in variables if v in model_states}
        return self.get_distribution(
            samples, variables=variables, state_names=state_names, joint=joint
        )

    def map_query(
        self,
        variables,
        n_samples=10000,
        samples=None,
        evidence=None,
        virtual_evidence=None,
        state_names=None,
        show_progress=True,
        seed=None,
    ):
        """Most probable joint state of ``variables`` from the empirical
        distribution."""
        phi = self.query(
            variables,
            n_samples=n_samples,
            samples=samples,
            evidence=evidence,
            virtual_evidence=virtual_evidence,
            joint=True,
            state_names=state_names,
            show_progress=show_progress,
            seed=seed,
        )
        values = to_numpy(phi.values).astype(np.float64)
        idx = np.unravel_index(int(np.argmax(values)), values.shape)
        return {
            var: phi.state_names[var][i] for var, i in zip(phi.variables, idx)
        }
