"""ExpectationMaximization for latent-variable parameter learning.

Port of ``pgmpy_tpu/estimators/em.py``.  Every row of the data is expanded
over the K joint states of the latent variables for the M-step's weighted
counts.  The expanded code matrix is built on the device from the codes
already there (``repeat_interleave`` of the observed columns, the latent grid
tiled) and never crosses from the host.  Each iteration then runs on the
device:

* the E-step (K11): per row and latent state k the sum over nodes of
  ``log max(P(node | parents), TINY)`` (``ops/table_gather.py:LatentGather``,
  with a node's term left out where its code or a parent's is missing), then
  a softmax over the K states of each row: on a card ONE launch of the
  hand-written kernel (``csrc/table_gather.cu``).  It reads the observed
  codes, not the expanded ones: a node with no latent in scope is summed once
  per row, the others once per state with the latent codes from the grid.
  The logs and their sum are float64: at MUNIN's width a row sums a thousand
  terms, and float32 would leave 1e-4 of error in the weights;
* the M-step: ONE weighted ``table_counts`` launch (K1) for every CPD, the
  smoothing, the zero-column rule and the normalisation, all on the flat
  table vector, and the largest change of any CPD entry.

The host reads one scalar per iteration, the change.  The ``TabularCPD``s are
built once, at the end, as views of the last flat table.

``batch_size`` only bounds the plain E-step's memory on the CPU: the rows
are taken in chunks of at least ``batch_size``, as many as 1 GiB holds (half
the free memory on a card, where the kernel needs no chunks).
"""

import itertools

import numpy as np
import torch

from pgmpy_tpu_torch.config import TINY, config, logger
from pgmpy_tpu_torch.estimators.base import BaseEstimator, ParameterEstimator, _CodedData
from pgmpy_tpu_torch.factors.cpd import TabularCPD
from pgmpy_tpu_torch.ops.bincount import table_specs
from pgmpy_tpu_torch.ops.table_gather import LatentGather

def _budget_bytes(device):
    """Bytes the E-step's temporaries may take per chunk: half the free
    memory of the card, or 1 GiB on the CPU."""
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[0] // 2
    return 1 << 30


class _EMProgram:
    """The device side of one EM fit over the expanded rows.

    ``prob`` is the flat vector of every CPD's table in the layout the count
    kernel writes: per node, ``(card, prod(parent cards))`` row-major with
    the parents in sorted order, one after another in ``var_order``."""

    def __init__(self, obs_coded, var_order, parents, latents, cards, state_names, batch_size):
        device = obs_coded.codes.device
        self.var_order = var_order
        self.parents = parents
        self.cards = cards
        self.state_names = state_names
        self.n = obs_coded.n
        grid = list(itertools.product(*[range(cards[l]) for l in latents]))
        self.K = len(grid)

        # the expanded code matrix, (n * K, len(var_order)), built on the device
        narrow = torch.int8 if max(cards.values()) <= 127 else torch.int32
        observed = [v for v in var_order if v in obs_coded.var_index and v not in latents]
        obs = obs_coded.codes.index_select(
            1, torch.as_tensor([obs_coded.var_index[v] for v in observed], device=device)
        ).to(narrow).repeat_interleave(self.K, dim=0)
        lat = torch.as_tensor(grid, dtype=narrow, device=device).reshape(self.K, len(latents))
        expanded = torch.cat([obs, lat.repeat(self.n, 1)], dim=1)
        position = {v: j for j, v in enumerate(observed + list(latents))}
        perm = torch.as_tensor([position[v] for v in var_order], device=device)
        self.coded = _CodedData.from_codes(expanded.index_select(1, perm), var_order, state_names)
        del obs, expanded

        col = {v: j for j, v in enumerate(var_order)}
        self.specs = table_specs(
            [[col[v]] + [col[p] for p in parents[v]] for v in var_order],
            [[cards[v]] + [cards[p] for p in parents[v]] for v in var_order],
        )
        sizes, offsets = self.specs.sizes, self.specs.offsets
        # the E-step's columns: a variable's column of the observed codes, or
        # -1 - j for latent j (its codes come from the grid)
        source = {v: -1 - j for j, v in enumerate(latents)}
        source.update({v: obs_coded.var_index[v] for v in observed})
        self.obs = obs_coded
        self.gather = LatentGather(
            [[source[var_order[c]] for c in self.specs.cols[s, : self.specs.n_cols[s]]]
             for s in range(len(var_order))],
            [self.specs.strides[s, : self.specs.n_cols[s]] for s in range(len(var_order))],
            offsets, self.specs.total,
            np.asarray(grid, dtype=np.int64).reshape(self.K, len(latents)), device,
        )

        # per entry of ``prob``: its column (one per parent configuration of
        # each node), and the smoothing term 5 / table size
        n_parent_cfg = sizes // np.array([cards[v] for v in var_order])
        col_start = np.concatenate([[0], np.cumsum(n_parent_cfg)[:-1]])
        entry_col = np.concatenate([
            np.tile(np.arange(p), cards[v]) + c0
            for v, p, c0 in zip(var_order, n_parent_cfg, col_start)
        ])
        self.entry_col = torch.as_tensor(entry_col, device=device)
        self.n_cols = int(n_parent_cfg.sum())
        self.col_card = torch.as_tensor(
            np.repeat([cards[v] for v in var_order], n_parent_cfg), dtype=config.DTYPE,
            device=device)
        self.smoothing = torch.as_tensor(np.repeat(5.0 / sizes, sizes), dtype=config.DTYPE,
                                         device=device)

        # E-step chunks of the plain version: rows, at least batch_size; per
        # row and node of a group its codes (int8, int32 and their products)
        # and its index, value and mask, K of them for a latent group
        gather = self.gather
        width_bytes = max(
            [(9 * strides.shape[0] + 17) * offsets_g.shape[0]
             for _, strides, offsets_g in gather.shared.groups]
            + [(9 * data.shape[0] + 17) * data.shape[1] * self.K
               for _, data, _, _ in gather.latent_groups]
        )
        fit = _budget_bytes(device) // max(width_bytes, 1)
        self.chunk_rows = max(int(batch_size), int(fit), 1)

    def flat_of(self, cpds):
        """``prob`` from a dict of ``TabularCPD`` (evidence in any order)."""
        parts = []
        for v in self.var_order:
            cpd = cpds[v]
            values = cpd.values.to(device=self.entry_col.device, dtype=config.DTYPE)
            evidence = list(cpd.variables[1:])
            if evidence != self.parents[v]:
                values = values.permute([0] + [1 + evidence.index(p) for p in self.parents[v]])
            parts.append(values.reshape(-1))
        return torch.cat(parts)

    def e_step(self, prob):
        """``(n * K,)`` posterior weights of the latent states of each row:
        one launch of the E-step kernel on a card (it keeps no temporaries),
        chunks of ``chunk_rows`` rows through the plain version on the CPU."""
        log_table = torch.log(torch.clamp_min(prob, TINY).to(torch.float64))
        codes = self.obs._column_codes()
        weights = []
        chunk = self.n if codes.is_cuda else self.chunk_rows
        for r0 in range(0, self.n, chunk):
            r1 = min(self.n, r0 + chunk)
            weights.append(self.gather.e_step(log_table, codes[:, r0:r1], prob.dtype))
        return weights[0] if len(weights) == 1 else torch.cat(weights)

    def m_step(self, weights, apply_smoothing):
        """The new ``prob`` from one weighted table-count launch."""
        counts = self.coded._count_specs(self.specs, weights).to(config.DTYPE)
        if apply_smoothing:
            # BayesianEstimator's default BDeu prior (ess=5) spread uniformly
            counts = counts + self.smoothing
        col_sum = torch.zeros(self.n_cols, dtype=counts.dtype, device=counts.device)
        col_sum.index_add_(0, self.entry_col, counts)
        empty = col_sum == 0
        counts = torch.where(empty[self.entry_col], torch.ones_like(counts), counts)
        col_sum = torch.where(empty, self.col_card, col_sum)
        return counts / col_sum[self.entry_col]

    def cpds(self, prob):
        """One ``TabularCPD`` per node, each a view of ``prob``."""
        out = []
        for v, part in zip(self.var_order, torch.split(prob, self.specs.sizes.tolist())):
            evidence = self.parents[v]
            shape = [self.cards[v]] + [self.cards[p] for p in evidence]
            out.append(TabularCPD._from_device_values(
                v, self.cards[v], part.view(shape), evidence or None,
                shape[1:] or None, {u: self.state_names[u] for u in [v] + evidence}, True,
            ))
        return out


class ExpectationMaximization(ParameterEstimator):
    """EM for latent-variable CPD estimation: a device E-step over the rows
    expanded by the latent states and one weighted count launch per M-step.

    Examples
    --------
    >>> import numpy as np
    >>> import pandas as pd
    >>> from pgmpy_tpu_torch.estimators import ExpectationMaximization
    >>> from pgmpy_tpu_torch.models import DiscreteBayesianNetwork
    >>> rng = np.random.default_rng(0)
    >>> h = rng.integers(0, 2, 800)
    >>> df = pd.DataFrame({
    ...     "a": np.where(rng.random(800) < 0.9, h, 1 - h),
    ...     "b": np.where(rng.random(800) < 0.9, h, 1 - h)})
    >>> model = DiscreteBayesianNetwork([("h", "a"), ("h", "b")],
    ...                                 latents={"h"})
    >>> cpds = ExpectationMaximization(model, df).get_parameters(
    ...     seed=0, show_progress=False)
    >>> sorted(c.variable for c in cpds)
    ['a', 'b', 'h']
    >>> vals = next(c for c in cpds if c.variable == "a").get_values()
    >>> bool(abs(vals[0, 0] - vals[0, 1]) > 0.5)  # a tracks the latent
    True
    """

    def __init__(self, model, data, **kwargs):
        from pgmpy_tpu_torch.models.discrete_bn import DiscreteBayesianNetwork

        if not isinstance(model, DiscreteBayesianNetwork):
            raise NotImplementedError(
                "Expectation Maximization is only implemented for DiscreteBayesianNetwork"
            )
        self.model_ = model
        self.model = model
        self.data_orig = data
        observed = [c for c in data.columns if c != "_weight"]
        missing_model_vars = set(model.nodes()) - set(observed)
        if missing_model_vars - set(model.latents):
            raise ValueError(
                f"Columns missing for non-latent variables: {missing_model_vars - set(model.latents)}"
            )
        # the observed columns only
        BaseEstimator.__init__(self, data, state_names=kwargs.get("state_names"))

    def _initial_cpds(self, init_cpds, seed, cards, state_names):
        """The starting CPDs: ``init_cpds``'s where given, else uniform or
        ``TabularCPD.get_random`` seeded from one ``default_rng(seed)``
        stream, nodes in sorted order (the JAX package's draws)."""
        rng = np.random.default_rng(seed)
        if isinstance(init_cpds, str):
            if init_cpds not in ("random", "uniform"):
                raise ValueError(
                    "If `init_cpds` is a string, it must be either 'random' "
                    f"or 'uniform'. Got: {init_cpds}"
                )
            init_mode, init_cpds = init_cpds, None
        else:
            init_mode = "random"
        cpds = {}
        for var in sorted(self.model_.nodes(), key=str):
            parents = sorted(self.model_.get_parents(var), key=str)
            names = {v: state_names[v] for v in [var] + parents}
            if init_cpds and var in init_cpds:
                cpds[var] = init_cpds[var]
            elif init_mode == "uniform":
                card = cards[var]
                n_cols = int(np.prod([cards[p] for p in parents])) if parents else 1
                cpds[var] = TabularCPD(
                    var, card, np.full((card, n_cols), 1.0 / card),
                    evidence=parents or None,
                    evidence_card=[cards[p] for p in parents] or None, state_names=names,
                )
            else:
                cpds[var] = TabularCPD.get_random(
                    var, evidence=parents or None,
                    cardinality={v: cards[v] for v in [var] + parents},
                    state_names=names, seed=int(rng.integers(2**31)),
                )
        return cpds

    def _states(self, latent_card=None):
        """(cards, state names) of every variable: the data's for the
        observed ones, ``range(latent_card[v])`` for each latent."""
        state_names = dict(self.state_names)
        for var in self.model_.latents:
            card = 2 if latent_card is None else latent_card[var]
            state_names[var] = list(range(card))
        return {v: len(names) for v, names in state_names.items()}, state_names

    def _program(self, latent_card=None, batch_size=1000):
        """(the device program, cards, state names)."""
        model = self.model_
        cards, state_names = self._states(latent_card)
        var_order = sorted(model.nodes(), key=str)
        parents = {v: sorted(model.get_parents(v), key=str) for v in var_order}
        program = _EMProgram(self._coded, var_order, parents, sorted(model.latents, key=str),
                             cards, state_names, batch_size)
        return program, cards, state_names

    def get_parameters(
        self,
        latent_card=None,
        apply_smoothing=False,
        max_iter=100,
        atol=1e-08,
        n_jobs=1,
        batch_size=1000,
        seed=None,
        init_cpds=None,
        show_progress=True,
    ):
        """EM parameter estimation.  ``apply_smoothing`` adds
        BayesianEstimator's default BDeu prior (ess=5 spread uniformly over
        each CPD table) to the M-step's counts; ``batch_size`` bounds the
        E-step's memory (see the module docstring); ``init_cpds`` is a dict,
        "random" or "uniform"; ``n_jobs`` and ``show_progress`` are accepted
        for the reference's signature."""
        program, cards, state_names = self._program(latent_card, batch_size)
        prob = program.flat_of(self._initial_cpds(init_cpds, seed, cards, state_names))
        delta = None
        for _ in range(int(max_iter)):
            new = program.m_step(program.e_step(prob), apply_smoothing)
            delta = float(torch.max(torch.abs(new - prob)))
            prob = new
            if delta < atol:
                break
        else:
            logger.warning(
                f"EM did not converge within {max_iter} iterations (last delta: {delta})"
            )
        return program.cpds(prob)
