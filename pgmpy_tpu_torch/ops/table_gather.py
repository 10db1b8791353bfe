"""Per-row sums of one table entry per node: the gather that K11 and K13 share.

Each node owns a table inside one flat tensor.  A row's entry in node ``i``'s
table is ``offsets[i] + sum_j codes[cols[i][j], row] * strides[i][j]``: the
node's own code and its parents' codes, each times its stride.
``BayesianModelProbability`` (K13) sums the log-CPD entries of every node for
``log P(row)``; ``ExpectationMaximization``'s E-step (K11) sums them over the
rows expanded by the latent states, leaving out a node whose code or a
parent's code is missing (-1).

The nodes are grouped by their number of indexing columns.  Per group one
``index_select`` takes every column the group needs from the column-major
``(n_vars, n_rows)`` code matrix, then the index arithmetic, one gather from
the flat table and a sum over the group's nodes: a few kernels per group, not
per node.
"""

import numpy as np
import torch


class TableGather:
    """``cols[i]`` / ``strides[i]``: the code-matrix rows that index node
    ``i``'s table and their strides; ``offsets[i]``: the table's start in the
    flat tensor of ``total`` entries."""

    def __init__(self, cols, strides, offsets, total, device):
        self.index_dtype = torch.int32 if total < 2**31 else torch.int64
        by_width = {}
        for i, c in enumerate(cols):
            by_width.setdefault(len(c), []).append(i)
        self.groups = []
        for width, nodes in sorted(by_width.items()):
            g_cols = np.array([cols[i] for i in nodes], dtype=np.int64).reshape(len(nodes), width)
            g_strides = np.array([strides[i] for i in nodes], dtype=np.int64).reshape(len(nodes), width)
            self.groups.append((
                torch.as_tensor(g_cols.T.reshape(-1), device=device),
                torch.as_tensor(g_strides.T[:, :, None], dtype=self.index_dtype, device=device),
                torch.as_tensor(np.asarray(offsets, dtype=np.int64)[nodes][:, None],
                                dtype=self.index_dtype, device=device),
            ))

    def row_sums(self, table, codes, missing=False):
        """``(n_rows,)`` sums over the nodes of ``table[entry of the row]`` in
        ``table``'s type, from ``codes`` ``(n_vars, n_rows)`` (any integer
        type; rows of a column-major code matrix).  With ``missing`` a node's
        term is 0 in a row where any of its codes is negative."""
        n = codes.shape[1]
        out = torch.zeros(n, dtype=table.dtype, device=table.device)
        for cols, strides, offsets in self.groups:
            width, m = strides.shape[0], offsets.shape[0]
            g = codes.index_select(0, cols).view(width, m, n)
            if missing:
                valid = (g >= 0).all(dim=0)
                g = g.clamp_min(0)
            flat = (g.to(self.index_dtype) * strides).sum(dim=0, dtype=self.index_dtype) + offsets
            values = table.index_select(0, flat.view(-1)).view(m, n)
            if missing:
                values = torch.where(valid, values, torch.zeros((), dtype=values.dtype,
                                                                device=values.device))
            out += values.sum(dim=0)
        return out
