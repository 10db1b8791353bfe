"""Compiled ancestral sampler: the device program behind all forward-style
sampling.

Port of ``pgmpy_tpu/sampling/core.py``.  CPDs are stacked per node as
``(prod(parent_cards), card)`` log-probability tables on ``config.DEVICE``;
one sweep walks the (static) topological order, forms each node's flat
parent-configuration index from its parents' columns, gathers the table rows
and draws all n samples at once (Gumbel-max on noise from ONE explicit
``torch.Generator`` seeded from ``seed``): the batch dimension IS the
vectorization, no host round-trips.  Likelihood weighting accumulates
``log p(evidence | parents)`` in the same sweep.

On a card the sweep is ONE launch of the hand-written kernel of
``csrc/ancestral.cu`` (``ops/ancestral.py``: a block's rows in shared memory,
the nodes of each topological level drawn side by side, Philox noise keyed
on one 64-bit draw from the generator); on the CPU its plain version, a
handful of torch ops per node.  The same seed gives the same
codes on the same device; the CPU's and the GPU's random streams differ.
"""

import itertools

import networkx as nx
import numpy as np
import torch

from pgmpy_tpu_torch.config import config, to_numpy
from pgmpy_tpu_torch.ops import ancestral
from pgmpy_tpu_torch.utils.mathext import seeded_generator


def onehot_table_rows(table, idx, n, max_rows=None, max_elems=None):
    """(n, card) rows of ``table`` selected by ``idx``: a direct row gather.
    The name and the signature are those of the JAX package, whose version
    fetches the rows as a one-hot matrix product where the tile fits;
    ``n``, ``max_rows`` and ``max_elems`` sized that tile and are unused
    here."""
    return table.index_select(0, idx)


class CompiledAncestralSampler:
    """Compile a DiscreteBayesianNetwork into a device sampling program."""

    def __init__(self, model):
        model.check_model()
        self.model = model
        self.variables = list(nx.topological_sort(model))
        self.topological_order = self.variables  # reference-name alias
        self.var_index = {v: i for i, v in enumerate(self.variables)}
        self.cards = [model.get_cardinality(v) for v in self.variables]
        self.cardinality = dict(zip(self.variables, self.cards))
        self.state_names = {
            v: model.get_cpds(v).state_names[v] for v in self.variables
        }

        self._node_specs = []
        for v in self.variables:
            cpd = model.get_cpds(v)
            evidence = cpd.variables[1:]
            parent_idx = tuple(self.var_index[p] for p in evidence)
            parent_cards = tuple(int(c) for c in cpd.cardinality[1:])
            # (prod(parent_cards), card): row = flat parent config
            table = np.asarray(cpd.get_values(), dtype=np.float64).T
            log_table = torch.as_tensor(
                np.log(np.maximum(table, 1e-38)), dtype=config.DTYPE, device=config.DEVICE
            )
            # strides for flat index: C-order over parents (last fastest)
            strides = []
            acc = 1
            for c in reversed(parent_cards):
                strides.append(acc)
                acc *= c
            strides = tuple(reversed(strides))
            self._node_specs.append((parent_idx, strides, log_table))

        # codes are int8 when every cardinality fits: the width pandas keeps
        # for such categorical columns and the width the table-count kernel
        # reads (``ops/bincount.py:column_major_codes``), so a simulated frame
        # stays at one byte per code from the sampler to the fit
        self._out_dtype = (
            torch.int8 if max(self.cards, default=2) < 128 else torch.int32
        )
        self._sweep_tables = ancestral.SweepTables(self._node_specs, self.cards, self._out_dtype)

    # ------------------------------------------------------------------ #
    # reference BayesianModelInference surface: host-side CPD slicing tables
    # used by external callers; the compiled sampler itself never needs them.
    # ------------------------------------------------------------------ #
    def pre_compute_reduce(self, variable):
        """{parent-state tuple (reversed evidence order): reduced values}."""
        cpd = self.model.get_cpds(variable)
        evid = cpd.variables[:0:-1]
        vals = to_numpy(cpd.values).astype(np.float64)
        cached = {}
        for sc in itertools.product(*[range(self.cardinality[v]) for v in evid]):
            index = [slice(None)] * vals.ndim
            for v, s in zip(evid, sc):
                index[cpd.variables.index(v)] = s
            cached[sc] = vals[tuple(index)]
        return cached

    def pre_compute_reduce_maps(self, variable, evidence=None,
                                state_combinations=None):
        """(state-combination -> weight index, weight index -> weight array)
        with non-``evidence`` parents marginalized out."""
        cpd = self.model.get_cpds(variable)
        if evidence is None:
            evidence = [
                v for v in cpd.variables[1:] if v not in self.model.latents
            ]
        if state_combinations is None:
            state_combinations = [
                tuple(sc)
                for sc in itertools.product(
                    *[range(self.cardinality[v]) for v in evidence]
                )
            ]
        vals = to_numpy(cpd.values).astype(np.float64)
        reduce_index = [cpd.variables.index(v) for v in evidence]
        rows = []
        for sc in state_combinations:
            index = [slice(None)] * vals.ndim
            for ax, s in zip(reduce_index, sc):
                index[ax] = s
            reduced = vals[tuple(index)]
            # marginalize every remaining non-child axis
            marg = reduced.reshape(reduced.shape[0], -1).sum(axis=1)
            rows.append(marg / marg.sum())
        weights_list = np.stack(rows)
        unique_weights, weights_indices = np.unique(
            weights_list, axis=0, return_inverse=True
        )
        state_to_index = dict(zip(state_combinations, weights_indices.ravel()))
        index_to_weight = dict(enumerate(unique_weights))
        return state_to_index, index_to_weight

    # ------------------------------------------------------------------ #
    def _sweep(self, n, gen, given=None, partial=None, evidence=None, noise=None):
        """One pass over the topological order; returns (codes, log weights):
        ONE launch of the sweep kernel on a card, the plain version on the
        CPU (``ops/ancestral.py``, where the arguments are described)."""
        return ancestral.sweep(self._sweep_tables, n, gen, given=given, partial=partial,
                               evidence=evidence, noise=noise)

    # ------------------------------------------------------------------ #
    def forward(self, n, seed=None, clamp=None, partial=None):
        """Draw n ancestral samples; returns integer codes (n, d) on
        ``config.DEVICE``: int8 when every cardinality < 128, int32
        otherwise.  Upcast before any stride/flat-index arithmetic on the
        result.

        clamp: {var: state_index} fixed states (roots/do-interventions).
        partial: (n, d) integer array with -1 where sampling is needed.
        """
        gen = seeded_generator(seed)
        given = np.full(len(self.variables), -1, dtype=np.int64)
        if clamp:
            for var, state in clamp.items():
                given[self.var_index[var]] = state
        if partial is not None:
            partial = torch.as_tensor(np.asarray(partial), dtype=torch.int64,
                                      device=config.DEVICE)
        return self._sweep(int(n), gen, given=given, partial=partial)[0]

    def likelihood_weighted(self, n, evidence, seed=None):
        """evidence: {var: state_index}.  Returns (codes, log_weights)."""
        gen = seeded_generator(seed)
        ev = {self.var_index[v]: int(s) for v, s in evidence.items()}
        codes, logw = self._sweep(int(n), gen, evidence=ev)
        if logw is None:
            logw = torch.zeros(int(n), dtype=config.DTYPE, device=config.DEVICE)
        return codes, logw

    def rejection(self, n, evidence, seed=None, batch_size=None, max_batches=1000):
        """Rejection sampling: forward batches, keep rows matching evidence.

        Root evidence is clamped for free (exact); only non-root evidence
        costs rejections.  The match mask and its count are computed on the
        device: one integer per batch comes back to the host, and the kept
        rows stay on the device.
        """
        roots = {
            v: s
            for v, s in evidence.items()
            if not self._node_specs[self.var_index[v]][0]
        }
        rest = {v: s for v, s in evidence.items() if v not in roots}
        rng = np.random.default_rng(seed)
        if not rest:
            return self.forward(
                n, seed=int(rng.integers(2**31)), clamp=roots
            )

        device = config.DEVICE
        check_idx = torch.as_tensor([self.var_index[v] for v in rest], device=device)
        check_val = torch.as_tensor([int(s) for s in rest.values()],
                                    dtype=self._out_dtype, device=device)
        collected = []
        total = 0
        batch = batch_size or max(int(n), 1024)
        for _ in range(max_batches):
            codes = self.forward(batch, seed=int(rng.integers(2**31)), clamp=roots)
            mask = (codes.index_select(1, check_idx) == check_val).all(dim=1)
            hits = int(mask.sum())
            if hits:
                collected.append(codes[mask])
                total += hits
            if total >= n:
                break
            # adapt batch size to the observed acceptance rate
            accept_rate = max(hits / batch, 1e-4)
            batch = int(min(max((n - total) / accept_rate * 1.2, 1024), 2_000_000))
        if total < n:
            raise ValueError(
                f"Rejection sampling failed to collect {n} samples "
                f"(got {total}); evidence probability too low — use "
                "likelihood_weighted_sample instead."
            )
        return torch.cat(collected, dim=0)[:n]

    # ------------------------------------------------------------------ #
    def to_dataframe(self, codes, include_latents=True):
        import pandas as pd

        codes = to_numpy(codes)
        # build the categorical columns directly (one pass, no int
        # DataFrame + per-column reassignment churn)
        keep = [
            v for v in self.variables
            if include_latents or v not in self.model.latents
        ]
        return pd.DataFrame(
            {
                v: pd.Categorical.from_codes(
                    codes[:, self.var_index[v]],
                    categories=self.state_names[v],
                )
                for v in keep
            },
            copy=False,
        )
