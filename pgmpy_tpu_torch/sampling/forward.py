"""BayesianModelSampling: forward / rejection / likelihood-weighted sampling.

Port of ``pgmpy_tpu/sampling/forward.py``, on top of the compiled ancestral
sampler (``core.py``).
"""

import numpy as np

from pgmpy_tpu_torch.config import logger, to_numpy
from pgmpy_tpu_torch.sampling.core import CompiledAncestralSampler


class BayesianModelSampling:
    """Forward / rejection / likelihood-weighted sampling on the compiled
    ancestral sampler (one sweep over the topological order draws every
    row of a node at once, on ``config.DEVICE``).

    Examples
    --------
    >>> from pgmpy_tpu_torch.factors import TabularCPD
    >>> from pgmpy_tpu_torch.models import DiscreteBayesianNetwork
    >>> from pgmpy_tpu_torch.sampling import BayesianModelSampling
    >>> model = DiscreteBayesianNetwork([("rain", "wet")])
    >>> model.add_cpds(
    ...     TabularCPD("rain", 2, [[0.8], [0.2]]),
    ...     TabularCPD("wet", 2, [[0.9, 0.2], [0.1, 0.8]],
    ...                evidence=["rain"], evidence_card=[2]))
    >>> sampler = BayesianModelSampling(model)
    >>> df = sampler.forward_sample(size=1000, seed=0, show_progress=False)
    >>> sorted(df.columns), len(df)
    (['rain', 'wet'], 1000)
    >>> from pgmpy_tpu_torch.factors.discrete import State
    >>> lw = sampler.likelihood_weighted_sample(
    ...     evidence=[State("wet", 1)], size=10, seed=0,
    ...     show_progress=False)
    >>> "_weight" in lw.columns
    True
    """

    def __init__(self, model):
        from pgmpy_tpu_torch.models.discrete_bn import DiscreteBayesianNetwork

        if not isinstance(model, DiscreteBayesianNetwork):
            raise TypeError(
                f"Model expected type: DiscreteBayesianNetwork, got type: {type(model)}"
            )
        self.model = model
        # reuse the compiled program across sampler instances; model edits
        # (add_cpds/add_edge/...) and in-place CPD mutations invalidate via
        # the cache token
        token = model._cache_token()
        cached = model.__dict__.get("_compiled_sampler")
        if cached is not None and cached[0] == token:
            self.sampler = cached[1]
        else:
            self.sampler = CompiledAncestralSampler(model)
            model.__dict__["_compiled_sampler"] = (token, self.sampler)
        self.topological_order = self.sampler.variables

    def _evidence_to_codes(self, evidence):
        out = {}
        for item in evidence:
            var, state = item
            names = self.sampler.state_names[var]
            if state in names:
                out[var] = names.index(state)
            elif isinstance(state, (int, np.integer)) and 0 <= state < len(names):
                out[var] = int(state)
            else:
                raise ValueError(f"Evidence state: {state} for {var} doesn't exist")
        return out

    def _partial_to_codes(self, partial_samples, size):
        if partial_samples is None:
            return None
        if partial_samples.shape[0] != size:
            raise ValueError("partial_samples.shape[0] must be equal to size")
        codes = np.full((size, len(self.topological_order)), -1, dtype=np.int32)
        for col in partial_samples.columns:
            if col not in self.sampler.var_index:
                continue
            j = self.sampler.var_index[col]
            names = {s: i for i, s in enumerate(self.sampler.state_names[col])}
            codes[:, j] = partial_samples[col].map(names).fillna(-1).astype(np.int32)
        return codes

    def pre_compute_reduce(self, variable):
        """Reference BayesianModelInference surface."""
        return self.sampler.pre_compute_reduce(variable)

    def pre_compute_reduce_maps(self, variable, evidence=None,
                                state_combinations=None):
        return self.sampler.pre_compute_reduce_maps(
            variable, evidence=evidence, state_combinations=state_combinations
        )

    def forward_sample(
        self,
        size=1,
        include_latents=False,
        seed=None,
        show_progress=True,
        partial_samples=None,
        n_jobs=None,
    ):
        """Draw ``size`` i.i.d. samples from the joint, one device sweep
        over the topological order."""
        partial = self._partial_to_codes(partial_samples, size)
        codes = self.sampler.forward(size, seed=seed, partial=partial)
        return self.sampler.to_dataframe(codes, include_latents=include_latents)

    def rejection_sample(
        self,
        evidence=[],
        size=1,
        include_latents=False,
        seed=None,
        show_progress=True,
        partial_samples=None,
        n_jobs=None,
    ):
        """Exact conditional samples by rejection (root evidence clamped for
        free)."""
        if partial_samples is not None:
            logger.warning("partial_samples are ignored in rejection_sample")
        ev = self._evidence_to_codes(evidence)
        codes = self.sampler.rejection(size, ev, seed=seed)
        return self.sampler.to_dataframe(codes, include_latents=include_latents)

    def likelihood_weighted_sample(
        self,
        evidence=[],
        size=1,
        include_latents=False,
        seed=None,
        show_progress=True,
        n_jobs=None,
    ):
        """Weighted conditional samples: evidence clamped, weight =
        P(evidence | parents), accumulated in the same device sweep."""
        ev = self._evidence_to_codes(evidence)
        codes, logw = self.sampler.likelihood_weighted(size, ev, seed=seed)
        df = self.sampler.to_dataframe(codes, include_latents=include_latents)
        df["_weight"] = np.exp(to_numpy(logw).astype(np.float64))
        return df
