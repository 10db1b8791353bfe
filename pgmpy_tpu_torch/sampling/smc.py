"""SMC particle filtering for DynamicBayesianNetworks.

Port of ``pgmpy_tpu/sampling/smc.py``.  Per time slice: a topological sweep
of categorical draws for the transition model, log-weight accumulation from
the slice's evidence, the weighted marginals of every variable, and
systematic resampling when the effective sample size drops below a
threshold.  All of it runs on ``config.DEVICE``; the effective sample sizes
and the marginals of all slices are stacked there and read once after the
loop.

A slice's sweep is ONE launch of the hand-written kernel of
``csrc/ancestral.cu`` on a card (``ops/ancestral.py``: a parent in the
previous slice is a column of the previous particles; the slice's evidence
goes in as per-node modes and its log weights come out of the same launch;
Philox noise keyed on one draw from the call's generator per slice), its
plain version on the CPU.  The particles stay in the layout the count kernel
reads: the sweep writes them column-major ``(d, ld)`` into the matrix the
slice's marginals are counted from, and reads the previous slice there.

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
  ``softmax(logw)``) instead of ``d`` one-hot matrix products, on the
  matrix the sweep wrote (``(d, ld)`` column-major, ``ld`` a multiple of 16,
  padding -1, int8 where the cardinalities allow); the spec table is built
  once in ``__init__`` and its descriptor is uploaded once, not per slice.
  On the CPU the same call takes the kernel's plain version;
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
from pgmpy_tpu_torch.ops import ancestral
from pgmpy_tpu_torch.ops.bincount import _ROW_ALIGN, table_counts, table_specs
from pgmpy_tpu_torch.utils.mathext import seeded_generator


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

        self.cards = {
            v: model.get_cpds(node=(v, 0)).variable_card for v in self.variables
        }
        cards = [self.cards[v] for v in self.variables]
        self._out_dtype = torch.int8 if max(cards) < 128 else torch.int32
        d = len(self.variables)

        def sweep_tables(time_slice):
            """The sweep of one slice (``ops.ancestral.SweepTables``): the
            nodes in topological order of that slice's sub-model, each
            writing its variable's column; a parent in this slice is its
            column, one in the previous slice ``d`` + its column."""
            sub_nodes = {(v, time_slice) for v in self.variables}
            order = [n for n in nx.topological_sort(model) if n in sub_nodes]
            specs = []
            for node in order:
                cpd = model.get_cpds(node=node)
                parents = [tuple(p) for p in cpd.variables[1:]]
                parent_cols = [self.var_index[p[0]] + (d if p[1] != time_slice else 0)
                               for p in parents]
                table = np.asarray(cpd.get_values(), dtype=np.float64).T
                log_table = torch.as_tensor(
                    np.log(np.maximum(table, 1e-38)), dtype=config.DTYPE, device=config.DEVICE
                )
                strides = []
                acc = 1
                for c in reversed([int(c) for c in cpd.cardinality[1:]]):
                    strides.append(acc)
                    acc *= c
                specs.append((tuple(parent_cols), tuple(reversed(strides)), log_table))
            columns = [self.var_index[node[0]] for node in order]
            return ancestral.SweepTables(specs, [cards[c] for c in columns], self._out_dtype,
                                         columns=columns, particle=True)

        self._start_specs = sweep_tables(0)
        self._trans_specs = sweep_tables(1)
        self.state_names = {
            v: model.get_cpds(node=(v, 0)).state_names[(v, 0)] for v in self.variables
        }
        # the marginals of a slice as the count kernel sees them: one
        # one-column table per variable, laid end to end
        self._marginal_specs = table_specs([[j] for j in range(len(cards))], [[c] for c in cards])

    def _code_matrix(self):
        """The ``(d, ld)`` column-major code matrix a slice is written into
        and counted from (``ld`` a multiple of 16, padding -1)."""
        n, d = self.n_particles, len(self.variables)
        ld = -(-n // _ROW_ALIGN) * _ROW_ALIGN
        return torch.full((d, ld), -1, dtype=self._out_dtype, device=config.DEVICE)

    def _sweep(self, gen, prev, specs, ev_codes, out=None):
        """One slice for all particles: ONE launch of the sweep kernel on a
        card, its plain version on the CPU.  ``specs``: the start or the
        transition tables.  ``prev``: (d, >= n) states of the previous slice
        (unused by the start specs).  ``ev_codes``: (d,) host ints, -1 =
        unobserved.  ``out``: the code matrix to write (a new one when None).
        Returns ((d, n) states, a view of ``out``, in the sweep's code type;
        (n,) log weights)."""
        n = self.n_particles
        if out is None:
            out = self._code_matrix()
        evidence = {i: int(ev_codes[c]) for i, c in enumerate(specs.columns) if ev_codes[c] >= 0}
        cur, logw = ancestral.sweep(specs, n, gen, evidence=evidence,
                                    prev=prev if specs.has_prev else None, out=out)
        if logw is None:
            logw = torch.zeros(n, dtype=config.DTYPE, device=out.device)
        return cur, logw

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

        n = self.n_particles
        device = config.DEVICE
        gen = seeded_generator(seed)
        ess_min = self.ess_threshold * n
        # the slice's codes, as the count kernel reads them; its padding stays -1
        codes_cm = self._code_matrix()
        particles = None
        logw_carry = torch.zeros(n, dtype=config.DTYPE, device=device)
        marginals, ess_rows = [], []
        for t in range(n_time_slices):
            specs = self._start_specs if t == 0 else self._trans_specs
            cur, logw = self._sweep(gen, particles, specs, ev_matrix[t], out=codes_cm)
            # cumulative log-weights (reset only on resample)
            logw_total = logw_carry + logw
            w = torch.softmax(logw_total, dim=0)
            ess = 1.0 / torch.sum(w * w)
            # per-variable weighted marginals of this slice: one launch
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
        if particles is None:  # no slice
            particles = torch.zeros((len(self.variables), n), dtype=self._out_dtype, device=device)
        final = to_numpy(particles.T).astype(np.int32)
        return out, final, np.array(to_numpy(torch.stack(ess_rows)))
