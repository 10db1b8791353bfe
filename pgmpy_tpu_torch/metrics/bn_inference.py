"""BayesianModelProbability: per-row log P(x) under a discrete BN.

Port of ``pgmpy_tpu/metrics/bn_inference.py`` (K13).  The JAX package traces
one program that, for each node, forms the flat parent index of every row and
gathers one entry of the sampler's log table.  Here the sampler's log tables
(``CompiledAncestralSampler._node_specs``, clamped at ``log(max(p, 1e-38))``
as in the JAX package) are concatenated once into one flat vector on
``config.DEVICE``, and the nodes are grouped by their number of parents: per
group one column gather of the codes, the index arithmetic, one gather from
the flat table and one row sum, so a call makes a few kernels per group
instead of several per node.  The codes are uploaded once; the per-row sum is
in ``config.DTYPE`` on the device, the total in float64 on the host.
"""

import numpy as np
import pandas as pd
import torch

from pgmpy_tpu_torch.config import config, to_numpy
from pgmpy_tpu_torch.sampling.core import CompiledAncestralSampler


class BayesianModelProbability:
    def __init__(self, model):
        self.model = model
        self.sampler = CompiledAncestralSampler(model)

        specs = self.sampler._node_specs
        sizes = [int(log_table.numel()) for _, _, log_table in specs]
        offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
        self._table = torch.cat([log_table.reshape(-1) for _, _, log_table in specs])
        # one group per parent count: (node columns, parent columns, the
        # parents' strides scaled by the node's cardinality, table offsets)
        by_count = {}
        for i, (parent_idx, strides, _) in enumerate(specs):
            by_count.setdefault(len(parent_idx), []).append(i)
        def device(a):
            return torch.as_tensor(a, dtype=torch.int64, device=config.DEVICE)

        self._groups = []
        for k, nodes in sorted(by_count.items()):
            parents = np.array([specs[i][0] for i in nodes], dtype=np.int64).reshape(len(nodes), k)
            scale = np.array([[s * self.sampler.cards[i] for s in specs[i][1]] for i in nodes],
                             dtype=np.int64).reshape(len(nodes), k)
            self._groups.append((device(nodes), device(parents.T), device(scale.T),
                                 device(offsets[nodes])))

    def _logp(self, codes):
        """(n,) log P(row) in ``config.DTYPE`` on the device, from the (n, d)
        int64 code matrix ``codes`` (columns in the sampler's order)."""
        lp = torch.zeros(codes.shape[0], dtype=self._table.dtype, device=codes.device)
        for nodes, parents, scale, offsets in self._groups:
            flat = codes.index_select(1, nodes) + offsets
            for j in range(parents.shape[0]):
                flat = flat + codes.index_select(1, parents[j]) * scale[j]
            lp = lp + self._table[flat].sum(dim=1)
        return lp

    def pre_compute_reduce(self, variable):
        """Reference BayesianModelInference surface (ref sampling/base.py:38)."""
        return self.sampler.pre_compute_reduce(variable)

    def pre_compute_reduce_maps(self, variable, evidence=None,
                                state_combinations=None):
        return self.sampler.pre_compute_reduce_maps(
            variable, evidence=evidence, state_combinations=state_combinations
        )

    def _encode(self, data):
        """The frame's state codes as one (n, d) int64 tensor on
        ``config.DEVICE``, columns in the sampler's order.  A value outside a
        variable's states raises ``ValueError``."""
        codes = np.empty((data.shape[0], len(self.sampler.variables)), dtype=np.int64)
        for j, var in enumerate(self.sampler.variables):
            column = pd.Index(self.sampler.state_names[var]).get_indexer(data[var])
            if (column < 0).any():
                raise ValueError(f"Data holds a state of {var} outside its state names, or NaN.")
            codes[:, j] = column
        return torch.from_numpy(codes).to(config.DEVICE)

    def log_probability(self, data, ordering=None):
        """log P(row) for each row of ``data`` (columns = model variables)."""
        return to_numpy(self._logp(self._encode(data))).astype(np.float64)

    def score(self, data, ordering=None):
        """Total log-likelihood of the data under the model."""
        return float(self.log_probability(data).sum())
