"""BayesianModelProbability: per-row log P(x) under a discrete BN.

Port of ``pgmpy_tpu/metrics/bn_inference.py`` (K13).  The JAX package traces
one program that, for each node, forms the flat parent index of every row and
gathers one entry of the sampler's log table.  Here the sampler's log tables
(``CompiledAncestralSampler._node_specs``, clamped at ``log(max(p, 1e-38))``
as in the JAX package) are concatenated once into one flat vector on
``config.DEVICE``, and the per-row sum is ``ops/table_gather.py``'s
``TableGather`` (shared with the E-step of ``ExpectationMaximization``): per
parent-count group one column gather of the codes, the index arithmetic, one
gather from the flat table and one sum, so a call makes a few kernels per
group instead of several per node.  The codes are uploaded once, column-major;
the per-row sum is in ``config.DTYPE`` on the device, the total in float64 on
the host.
"""

import numpy as np
import pandas as pd
import torch

from pgmpy_tpu_torch.config import config, to_numpy
from pgmpy_tpu_torch.ops.table_gather import TableGather
from pgmpy_tpu_torch.sampling.core import CompiledAncestralSampler


class BayesianModelProbability:
    def __init__(self, model):
        self.model = model
        self.sampler = CompiledAncestralSampler(model)

        specs = self.sampler._node_specs
        sizes = [int(log_table.numel()) for _, _, log_table in specs]
        offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
        self._table = torch.cat([log_table.reshape(-1) for _, _, log_table in specs])
        # a row's entry of node i: offset + code + sum_j parent code * stride * card
        cards = self.sampler.cards
        self._gather = TableGather(
            [(i,) + tuple(parent_idx) for i, (parent_idx, _, _) in enumerate(specs)],
            [(1,) + tuple(s * cards[i] for s in strides)
             for i, (_, strides, _) in enumerate(specs)],
            offsets, int(sum(sizes)), config.DEVICE,
        )

    def _logp(self, codes):
        """(n,) log P(row) in ``config.DTYPE`` on the device, from the
        ``(d, n)`` code matrix ``codes`` (one row per variable, in the
        sampler's order)."""
        return self._gather.row_sums(self._table, codes)

    def pre_compute_reduce(self, variable):
        """Reference BayesianModelInference surface (ref sampling/base.py:38)."""
        return self.sampler.pre_compute_reduce(variable)

    def pre_compute_reduce_maps(self, variable, evidence=None,
                                state_combinations=None):
        return self.sampler.pre_compute_reduce_maps(
            variable, evidence=evidence, state_combinations=state_combinations
        )

    def _encode(self, data):
        """The frame's state codes as one ``(d, n)`` int64 tensor on
        ``config.DEVICE``, one row per variable in the sampler's order.  A
        value outside a variable's states raises ``ValueError``."""
        codes = np.empty((len(self.sampler.variables), data.shape[0]), dtype=np.int64)
        for j, var in enumerate(self.sampler.variables):
            column = pd.Index(self.sampler.state_names[var]).get_indexer(data[var])
            if (column < 0).any():
                raise ValueError(f"Data holds a state of {var} outside its state names, or NaN.")
            codes[j] = column
        return torch.from_numpy(codes).to(config.DEVICE)

    def log_probability(self, data, ordering=None):
        """log P(row) for each row of ``data`` (columns = model variables)."""
        return to_numpy(self._logp(self._encode(data))).astype(np.float64)

    def score(self, data, ordering=None):
        """Total log-likelihood of the data under the model."""
        return float(self.log_probability(data).sum())
