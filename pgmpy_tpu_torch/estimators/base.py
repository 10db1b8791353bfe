"""Estimator base classes: the learning hot path is a device count kernel.

Port of ``pgmpy_tpu/estimators/base.py``.  The DataFrame is integer-coded
once at construction and copied to ``config.DEVICE``, together with a
column-major, narrow copy that the count kernel reads.  ``counts``,
``multi_counts`` and ``multi_counts_padded`` all describe their tables as a
spec list and make ONE call to ``ops/bincount.py:table_counts`` (the
hand-written CUDA kernel on the GPU, its plain version on the CPU), shared by
MLE and the Bayesian estimator.  Rows with a missing value (code -1) in any
involved column are skipped by the kernel.

Left out from the JAX package, all TPU-only: the int8 upload of the codes,
the one-hot MXU count kernel with its dispatch, the power-of-two shape
buckets of ``multi_counts_padded`` and the chunking of ``multi_counts`` (no
tensor of ``n_specs x n_rows`` elements exists here).
"""

import numpy as np
import pandas as pd
import torch

from pgmpy_tpu_torch.config import as_tensor, config, to_numpy
from pgmpy_tpu_torch.ops.bincount import column_major_codes, table_counts, table_specs


class _CodedData:
    """Integer-coded dataset resident on device.  NaN rows are tracked with
    a per-column validity mask (code -1)."""

    # class-level default: EM builds instances via __new__ (skipping
    # __init__), and `self.n_dispatches += 1` still works — the read falls
    # back to the class attribute, the write lands on the instance
    n_dispatches = 0

    def __init__(self, df, state_names=None, weighted=False):
        self.variables = [c for c in df.columns if c != "_weight"]
        self.n = df.shape[0]
        self.state_names = {}
        codes = np.empty((self.n, len(self.variables)), dtype=np.int32)
        for j, var in enumerate(self.variables):
            col = df[var]
            if state_names and var in state_names:
                names = list(state_names[var])
                observed = set(col.dropna().unique())
                if not observed <= set(names):
                    raise ValueError(
                        f"Data contains unexpected states for variable: {var}."
                    )
            elif isinstance(col.dtype, pd.CategoricalDtype):
                # fast path for categorical input (what simulate() returns):
                # reuse the existing codes and remap through a small
                # permutation instead of re-factorizing 100k+ rows — the
                # hash-based pd.Categorical() below was the dominant cost
                # of MLE fits on large frames.  Semantics identical to the
                # generic path: state names = OBSERVED values, sorted.
                cats = list(col.cat.categories)
                raw = np.asarray(col.cat.codes, dtype=np.int32)  # -1 = NaN
                seen = np.bincount(raw[raw >= 0], minlength=len(cats)) > 0
                observed = [c for c, s in zip(cats, seen) if s]
                try:
                    names = sorted(observed)
                except TypeError:
                    names = sorted(observed, key=str)
                pos = {c: i for i, c in enumerate(names)}
                remap = np.full(len(cats) + 1, -1, dtype=np.int32)
                for i, c in enumerate(cats):
                    if seen[i]:
                        remap[i] = pos[c]
                self.state_names[var] = names
                codes[:, j] = remap[raw]  # raw -1 hits the trailing -1
                continue
            else:
                names = col.dropna().unique().tolist()
                try:
                    names = sorted(names)
                except TypeError:
                    names = sorted(names, key=str)
            self.state_names[var] = names
            # vectorized coding: pd.Categorical maps values -> positions in
            # `names` in C (unknown values and NaN both code to -1); the
            # old per-row python loop cost seconds per million rows
            codes[:, j] = np.asarray(
                pd.Categorical(col, categories=names).codes, dtype=np.int32
            )
        self.codes = torch.from_numpy(codes).to(config.DEVICE)
        self.var_index = {v: j for j, v in enumerate(self.variables)}
        self.cards = {v: len(self.state_names[v]) for v in self.variables}
        self._column_codes()
        # device-dispatch odometer: every counts()/multi_counts() call is
        # one table-count launch.
        self.n_dispatches = 0  # shadow the class default per instance
        if weighted or "_weight" in df.columns:
            self.weights = as_tensor(df["_weight"].to_numpy(dtype=np.float64))
        else:
            self.weights = None

    def _column_codes(self):
        """The kernel's view of ``codes``: column-major, int8 or int16 when
        the cardinalities allow (``ops/bincount.py:column_major_codes``).
        Made once, on the device; ``codes`` itself stays row-major int32."""
        cached = self.__dict__.get("_codes_cm")
        if cached is None:
            cached = column_major_codes(self.codes, max(self.cards.values(), default=0))
            self._codes_cm = cached
        return cached

    def _count_tables(self, specs, weights):
        """One table-count call for ``specs``: the concatenated tables as a
        tensor on the codes' device (int32 without weights), and per spec its
        offset and (var_card, prod(parent_cards)) shape."""
        col_lists, card_lists = [], []
        for variable, parents in specs:
            col_lists.append([self.var_index[variable]] + [self.var_index[p] for p in parents])
            card_lists.append([self.cards[variable]] + [self.cards[p] for p in parents])
        table = table_specs(col_lists, card_lists)
        self.n_dispatches += 1
        flat = table_counts(self._column_codes(), self.n, table, weights)
        shapes = [(cards[0], int(size) // cards[0]) for cards, size in zip(card_lists, table.sizes)]
        return flat, table.offsets, shapes

    @staticmethod
    def _as_float(flat):
        """Host copy of a count vector; integer counts become ``config.DTYPE``."""
        out = to_numpy(flat)
        if not flat.dtype.is_floating_point:
            out = out.astype(np.float64 if config.DTYPE == torch.float64 else np.float32)
        return out

    def counts(self, variable, parents=(), weights=None, device=False):
        """(var_card, prod(parent_cards)) count matrix, device-computed.
        Rows with a NaN in any involved column are dropped.  With
        ``device=True`` the table stays a tensor on ``config.DEVICE``.

        ``weights=None`` means UNWEIGHTED (exact integer counts): a stored
        ``_weight`` column is only used when the caller passes it."""
        flat, _, shapes = self._count_tables([(variable, parents)], weights)
        if device:
            if not flat.dtype.is_floating_point:
                flat = flat.to(config.DTYPE)
            return flat.reshape(shapes[0])
        return self._as_float(flat).reshape(shapes[0])

    def multi_counts(self, specs, weights=None):
        """Count tables for many (variable, parents) specs in ONE kernel
        launch and one readback, whatever the number of specs: the spec list
        goes to the device as a descriptor table, and each block of the
        kernel counts one spec's rows straight from the code matrix.

        Returns a list of (var_card, prod(parent_cards)) float arrays (exact
        integers for unweighted data).
        """
        specs = list(specs)
        if not specs:
            return []
        flat, offsets, shapes = self._count_tables(specs, weights)
        combined = self._as_float(flat)
        return [
            combined[off : off + rows * cols].reshape(rows, cols)
            for off, (rows, cols) in zip(offsets.tolist(), shapes)
        ]

    def multi_counts_padded(self, specs, weights=None):
        """Same as :meth:`multi_counts`.  The JAX package needs a second,
        shape-bucketed kernel for spec lists that change every iteration
        (structure search), so that XLA does not retrace; here the spec list
        is data to one kernel, so both methods share it."""
        return self.multi_counts(specs, weights=weights)


class BaseEstimator:
    def __init__(self, data=None, state_names=None, **kwargs):
        self.data = data
        if data is not None:
            self.variables = [c for c in data.columns if c != "_weight"]
            self._coded = _CodedData(
                data, state_names if isinstance(state_names, dict) else None
            )
            self.state_names = self._coded.state_names
        else:
            self.variables = None
            self._coded = None
            self.state_names = {}

    def _collect_state_names(self, variable):
        return list(self.state_names[variable])

    def state_counts(self, variable, parents=[], weighted=False, reindex=True):
        """Count table as a DataFrame (parity with the reference's shape:
        rows = variable states, columns = parent-state MultiIndex)."""
        parents = list(parents)
        if weighted and "_weight" not in self.data.columns:
            raise ValueError("data must contain a `_weight` column if weighted=True")
        weights = self._coded.weights if weighted else None
        table = self._coded.counts(variable, parents, weights=weights)
        index = pd.Index(self.state_names[variable], name=variable)
        if parents:
            columns = pd.MultiIndex.from_product(
                [self.state_names[p] for p in parents], names=parents
            )
            df = pd.DataFrame(table, index=index, columns=columns)
        else:
            df = pd.DataFrame(table, index=index, columns=[""])
        return df


class ParameterEstimator(BaseEstimator):
    def __init__(self, model, data, **kwargs):
        model_vars = set(model.nodes())
        data_vars = set(c for c in data.columns if c != "_weight")
        if model_vars != data_vars:
            raise ValueError(
                f"variable names of the model must be identical to column names in data. "
                f"Missing in data: {model_vars - data_vars}; extra: {data_vars - model_vars}"
            )
        self.model = model
        super().__init__(data, **kwargs)

    def state_counts(self, variable, weighted=False, **kwargs):
        parents = sorted(self.model.get_parents(variable), key=str)
        return super().state_counts(
            variable, parents=parents, weighted=weighted, **kwargs
        )
