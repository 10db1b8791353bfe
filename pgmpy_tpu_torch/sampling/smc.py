"""SMC particle filtering for DynamicBayesianNetworks.

Port of ``pgmpy_tpu/sampling/smc.py``.  Per time slice: a topological sweep
of categorical draws for the transition model, log-weight accumulation from
the slice's evidence, the weighted marginals of every variable, and
systematic resampling when the effective sample size drops below a
threshold.  All of it runs on ``config.DEVICE``; the effective sample sizes
and the marginals of all slices are stacked there and read once after the
loop.

Divergences from the JAX package, on purpose:

* a host loop over slices takes the place of ``lax.scan``.  A ``scan`` body
  cannot branch, so the JAX step runs the start sweep AND the transition
  sweep at every slice and selects one; here slice 0 runs the start specs and
  every later slice the transition specs: one sweep per slice.  An observed
  variable is set to its state without a draw (the evidence is known on the
  host before the loop).  The choice to resample stays on the device
  (``torch.where(ess < ess_min, resampled, cur)`` with the resample always
  computed), so no slice needs a host read;
* the per-slice marginals are ONE weighted call of the hand-written count
  kernel (``ops/bincount.py:table_counts``, ``d`` one-column specs, weights
  ``softmax(logw)``) instead of ``d`` one-hot matrix products.  The particle
  state is copied once per slice into the layout that kernel reads
  (``(d, ld)`` column-major, ``ld`` a multiple of 16, padding -1, int8 where
  the cardinalities allow); the spec table is built once in ``__init__`` and
  its descriptor is uploaded once, not per slice.  On the CPU the
  same call takes the kernel's plain version;
* draws come from one explicit ``torch.Generator`` per ``filter`` call, so the
  streams differ from the JAX package's: compare by distribution.

Examples
--------
>>> import numpy as np
>>> from pgmpy_tpu_torch.factors import TabularCPD
>>> from pgmpy_tpu_torch.models import DynamicBayesianNetwork
>>> from pgmpy_tpu_torch.sampling.smc import ParticleFilter
>>> dbn = DynamicBayesianNetwork()
>>> dbn.add_edges_from(
...     [(("rain", 0), ("umbrella", 0)), (("rain", 0), ("rain", 1))])
>>> dbn.add_cpds(
...     TabularCPD(("rain", 0), 2, [[0.5], [0.5]]),
...     TabularCPD(("umbrella", 0), 2, [[0.8, 0.1], [0.2, 0.9]],
...                evidence=[("rain", 0)], evidence_card=[2]),
...     TabularCPD(("rain", 1), 2, [[0.7, 0.3], [0.3, 0.7]],
...                evidence=[("rain", 0)], evidence_card=[2]),
...     TabularCPD(("umbrella", 1), 2, [[0.8, 0.1], [0.2, 0.9]],
...                evidence=[("rain", 1)], evidence_card=[2]))
>>> pf = ParticleFilter(dbn, n_particles=8192)
>>> marg, particles, ess = pf.filter(
...     evidence={("umbrella", t): 1 for t in range(5)},
...     n_time_slices=5, seed=0)
>>> m = np.asarray(marg[("rain", 4)], dtype=float)
>>> bool(m[1] / m.sum() > 0.7)  # persistent umbrella => rain likely
True
"""

import networkx as nx
import numpy as np
import torch

from pgmpy_tpu_torch.config import config, to_numpy
from pgmpy_tpu_torch.models.dynamic_bn import DynamicBayesianNetwork
from pgmpy_tpu_torch.ops.bincount import column_major_codes, table_counts, table_specs
from pgmpy_tpu_torch.sampling.core import onehot_table_rows
from pgmpy_tpu_torch.utils.mathext import categorical_draw, seeded_generator


class ParticleFilter:
    def __init__(self, model, n_particles=1024, ess_threshold=0.5):
        if not isinstance(model, DynamicBayesianNetwork):
            raise ValueError(f"model must be a DynamicBayesianNetwork. Got: {type(model)}")
        model.check_model()
        self.model = model
        self.n_particles = int(n_particles)
        self.ess_threshold = float(ess_threshold)

        self.variables = sorted(model._nodes(), key=str)
        self.var_index = {v: i for i, v in enumerate(self.variables)}

        def node_specs(time_slice):
            """Per-node sampling specs in topological order of that slice's
            sub-model; a parent is a (column, is it of the previous slice)
            pair."""
            sub_nodes = {(v, time_slice) for v in self.variables}
            order = [n for n in nx.topological_sort(model) if n in sub_nodes]
            specs = []
            for node in order:
                cpd = model.get_cpds(node=node)
                parents = [tuple(p) for p in cpd.variables[1:]]
                parent_cols = [(self.var_index[p[0]], p[1] != time_slice) for p in parents]
                table = np.asarray(cpd.get_values(), dtype=np.float64).T
                log_table = torch.as_tensor(
                    np.log(np.maximum(table, 1e-38)), dtype=config.DTYPE, device=config.DEVICE
                )
                strides = []
                acc = 1
                for c in reversed([int(c) for c in cpd.cardinality[1:]]):
                    strides.append(acc)
                    acc *= c
                specs.append(
                    (self.var_index[node[0]], parent_cols, tuple(reversed(strides)), log_table)
                )
            return specs

        self._start_specs = node_specs(0)
        self._trans_specs = node_specs(1)
        self.cards = {
            v: model.get_cpds(node=(v, 0)).variable_card for v in self.variables
        }
        self.state_names = {
            v: model.get_cpds(node=(v, 0)).state_names[(v, 0)] for v in self.variables
        }
        # the marginals of a slice as the count kernel sees them: one
        # one-column table per variable, laid end to end
        cards = [self.cards[v] for v in self.variables]
        self._marginal_specs = table_specs([[j] for j in range(len(cards))], [[c] for c in cards])

    def _sweep(self, gen, prev, specs, ev_codes):
        """One slice for all particles.  ``prev``: (d, n) int64 states of the
        previous slice (unused by the start specs).  ``ev_codes``: (d,) host
        ints, -1 = unobserved.  Returns ((d, n) int64 states, (n,) log
        weights)."""
        n = self.n_particles
        device = config.DEVICE
        columns = [None] * len(self.variables)
        logw = torch.zeros(n, dtype=config.DTYPE, device=device)
        for col, parent_cols, strides, log_table in specs:
            if parent_cols:
                flat = None
                for (pcol, is_prev), stride in zip(parent_cols, strides):
                    vals = prev[pcol] if is_prev else columns[pcol]
                    term = vals if stride == 1 else vals * stride
                    flat = term if flat is None else flat + term
                logits = onehot_table_rows(log_table, flat, n)  # (n, card)
            else:
                logits = log_table[0].expand(n, -1)
            code = int(ev_codes[col])
            if code >= 0:
                columns[col] = torch.full((n,), code, dtype=torch.int64, device=device)
                logw = logw + logits[:, code]
            else:
                columns[col] = categorical_draw(logits, gen)
        return torch.stack(columns), logw

    def _systematic_resample(self, particles, logw, offset):
        """``particles`` (d, n) resampled in proportion to ``softmax(logw)``
        at the positions ``(offset + i) / n``; ``offset`` in [0, 1).  The
        running sum and the positions are float64: on a CUDA tensor the scan
        may add in another order from run to run, and a last float32 bit of
        difference can move a position across a boundary, so that one seed
        gives other particles; in float64 that takes a tie to 1e-16."""
        n = self.n_particles
        w = torch.softmax(logw, dim=0).to(torch.float64)
        positions = (offset + torch.arange(n, dtype=torch.float64, device=w.device)) / n
        idx = torch.searchsorted(torch.cumsum(w, dim=0), positions).clamp_(0, n - 1)
        return particles.index_select(1, idx)

    def _evidence_matrix(self, evidence, n_time_slices):
        """(T, d) host codes of the evidence, -1 = unobserved; validated
        here, before anything reaches the device."""
        ev_matrix = np.full((n_time_slices, len(self.variables)), -1, dtype=np.int64)
        for (name, t), state in evidence.items():
            if name not in self.var_index:
                raise ValueError(f"Evidence on {name!r}, which is not a variable of the model")
            if not 0 <= t < n_time_slices:
                raise ValueError(f"Evidence on {(name, t)} lies outside the {n_time_slices} slices")
            names = self.state_names[name]
            code = names.index(state) if state in names else int(state)
            if not 0 <= code < self.cards[name]:
                raise ValueError(f"Evidence state {state!r} not valid for {(name, t)}")
            ev_matrix[t, self.var_index[name]] = code
        return ev_matrix

    def filter(self, evidence=None, n_time_slices=None, seed=0):
        """Run the particle filter.

        evidence: {(name, t): state_name_or_code}.
        Returns ({(name, t): marginal ndarray} of filtered distributions,
        the final particles (n, d), the effective sample size per slice).
        """
        evidence = {tuple(k): v for k, v in (evidence or {}).items()}
        if n_time_slices is None:
            n_time_slices = max([t for _, t in evidence.keys()] + [1]) + 1
        ev_matrix = self._evidence_matrix(evidence, n_time_slices)

        n, d = self.n_particles, len(self.variables)
        device = config.DEVICE
        gen = seeded_generator(seed)
        ess_min = self.ess_threshold * n
        # the count kernel's view of the particles; its padding stays -1
        codes_cm = column_major_codes(
            torch.zeros((n, d), dtype=torch.int64, device=device), max(self.cards.values())
        )
        particles = torch.zeros((d, n), dtype=torch.int64, device=device)
        logw_carry = torch.zeros(n, dtype=config.DTYPE, device=device)
        marginals, ess_rows = [], []
        for t in range(n_time_slices):
            specs = self._start_specs if t == 0 else self._trans_specs
            cur, logw = self._sweep(gen, particles, specs, ev_matrix[t])
            # cumulative log-weights (reset only on resample)
            logw_total = logw_carry + logw
            w = torch.softmax(logw_total, dim=0)
            ess = 1.0 / torch.sum(w * w)
            # per-variable weighted marginals of this slice: one launch
            codes_cm[:, :n] = cur
            marginals.append(table_counts(codes_cm, n, self._marginal_specs, w))
            offset = torch.rand((), generator=gen, dtype=config.DTYPE, device=device)
            resampled = self._systematic_resample(cur, logw_total, offset)
            do_resample = ess < ess_min
            particles = torch.where(do_resample, resampled, cur)
            logw_carry = torch.where(do_resample, torch.zeros_like(logw_total), logw_total)
            ess_rows.append(ess)

        marg_np = np.array(to_numpy(torch.stack(marginals)))  # (T, sum of cards)
        offsets = self._marginal_specs.offsets
        out = {}
        for j, v in enumerate(self.variables):
            block = marg_np[:, offsets[j] : offsets[j] + self.cards[v]]
            for t in range(n_time_slices):
                out[(v, t)] = block[t]
        # narrowed on the device: the copy is (n, d) codes, not (d, n) int64
        final = to_numpy(particles.T.to(codes_cm.dtype)).astype(np.int32)
        return out, final, np.array(to_numpy(torch.stack(ess_rows)))
