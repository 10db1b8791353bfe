"""BeliefPropagationWithMessagePassing: loopy sum-product BP on factor
graphs by a synchronous flooding schedule (K7).

Port of ``pgmpy_tpu/inference/fg_bp.py``.  All factor -> variable messages
live in one ``(n_edges, max_card)`` tensor.  Exact on trees, standard loopy
BP otherwise; evidence, virtual evidence, warm-start messages and the factor
tables are inputs, not constants, so a graph builds its program once.

Where each computation runs:

* the flood (every round until the largest change falls below the tolerance
  or ``max_iter`` rounds): ``ops.loopy.flood``.  On a card, one upload of the
  fixed and initial messages, ONE launch of the hand-written kernel of
  ``csrc/loopy_bp.cu`` and one host read (the round count, for
  ``last_rounds``); on the CPU its plain version, a few torch ops a round and
  one host read of the change a round;
* the index tables (``ops.loopy.FloodPlan``), the fixed and initial
  messages and the result objects: the host;
* the beliefs: a few torch ops on the messages' device, read back once.

Divergences on purpose, each a fault of the JAX package fixed here:

* the variable -> factor message (the product of a variable's other incoming
  messages) and the final beliefs are sums of logs with a per-row maximum
  subtracted, so a hub of hundreds of factors does not underflow to 0 or NaN
  (each message's log is first shifted to a largest entry of 0, so that the
  sum stays small and float32 keeps its precision);
* tables are built in the program's dtype (``config.DTYPE``), not staged
  through float32, so a float64 run is float64 throughout;
* the table cache is keyed on each factor's values tensor (its identity and
  its ``_version`` counter), so an in-place edit of ``f.values`` is seen.
"""

import time

import numpy as np
import torch

from pgmpy_tpu_torch.config import config, to_numpy
from pgmpy_tpu_torch.factors.discrete import DiscreteFactor
from pgmpy_tpu_torch.models.factor_graph import FactorGraph
from pgmpy_tpu_torch.ops.loopy import (FloodPlan, centered_log, flood, flood_round_reference,
                                       log_product)


class _FloodingProgram:
    """Flooding BP on a factor graph: its :class:`~pgmpy_tpu_torch.ops.loopy.FloodPlan`,
    dtype, device, round limit and tolerance.

    Edge ``e`` is the e-th ``(factor, variable)`` incidence in factor order;
    messages are ``(E, C)`` tensors (``C`` the largest cardinality) whose
    entries beyond a variable's cardinality stay zero."""

    def __init__(self, factor_scopes, cardinality, max_iter=100, tol=1e-8, dtype=None):
        self.dtype = dtype or config.DTYPE
        self.device = config.DEVICE
        self.max_iter = int(max_iter)
        self.tol = float(tol)
        # the requested tol (default 1e-8) is below what float32 resolves:
        # the change between rounds plateaus near one ulp of the messages
        self._tol_eff = max(self.tol, 4.0 * torch.finfo(self.dtype).eps)
        self.plan = plan = FloodPlan(factor_scopes, cardinality)
        self.edges, self.var_edges = plan.edges, plan.var_edges
        self.n_edges, self.max_card = plan.n_edges, plan.max_card
        self.cards, self.mask = plan.cards, plan.mask
        self.last_rounds = 0

    @property
    def _groups(self):
        """The plain version's buckets: (padded shape, factors, edge ids)."""
        return self.plan.groups

    def build_tables(self, factor_values):
        """The factor tables (``ops.loopy.FloodTables``: the flat arena, and
        the plain version's padded buckets built from the values at first
        use), in the program's dtype on its device."""
        return self.plan.build_tables(factor_values, self.dtype, self.device)

    def round(self, f2v, log_fixed, tables):
        """One flooding round of the plain version: (new factor -> variable
        messages, the largest change of any entry)."""
        return flood_round_reference(self.plan, f2v, log_fixed, tables)

    def run(self, fixed, f2v_init, tables):
        """Flood until the change falls below the tolerance or ``max_iter``
        rounds (``ops.loopy.flood``).  The fixed and initial messages (host
        arrays) go to the device in one copy; ``last_rounds`` records the
        rounds taken, read back once."""
        staged = torch.from_numpy(np.stack([np.asarray(fixed), np.asarray(f2v_init)]))
        fixed, f2v_init = staged.to(device=self.device, dtype=self.dtype)
        result = flood(self.plan, fixed, f2v_init, tables, self.max_iter, self._tol_eff)
        self.last_rounds = int(result.rounds)
        return result.f2v

    def beliefs(self, f2v, log_fixed_var, variables):
        """``(len(variables), C)`` normalised beliefs: each variable's fixed
        message times all its incoming messages, in log space."""
        width = max(len(self.var_edges[v]) for v in variables)
        idx = np.full((len(variables), width), self.n_edges, dtype=np.int64)
        for i, v in enumerate(variables):
            idx[i, : len(self.var_edges[v])] = self.var_edges[v]
        logs = torch.cat([centered_log(f2v), f2v.new_zeros((1, self.max_card))])
        gathered = logs[torch.from_numpy(idx).to(self.device)]
        return log_product(torch.cat([gathered, log_fixed_var[:, None, :]], dim=1), dim=1)


class BeliefPropagationWithMessagePassing:
    """Loopy (flooding) sum-product BP on a factor graph (see the module
    docstring).

    Examples
    --------
    >>> import numpy as np
    >>> from pgmpy_tpu_torch.factors import DiscreteFactor
    >>> from pgmpy_tpu_torch.inference import BeliefPropagationWithMessagePassing
    >>> from pgmpy_tpu_torch.models import FactorGraph
    >>> fg = FactorGraph()
    >>> fg.add_nodes_from(["a", "b"])
    >>> f = DiscreteFactor(["a", "b"], [2, 2], [2.0, 1.0, 1.0, 3.0])
    >>> fg.add_factors(f)
    >>> fg.add_edges_from([("a", f), ("b", f)])
    >>> bp = BeliefPropagationWithMessagePassing(fg)
    >>> res = bp.query(["b"], evidence={"a": 0})
    >>> np.asarray(res["b"].values, dtype=float).round(3).tolist()
    [0.667, 0.333]
    """

    def __init__(self, model, check_model=True):
        if not isinstance(model, FactorGraph):
            raise TypeError(f"model must be a FactorGraph. Got: {type(model)}")
        if check_model:
            model.check_model()
        self.model = model
        self.variables = model.get_variable_nodes()
        self.factors = list(model.factors)
        self.cardinality = model.get_cardinality()
        # each variable's state names, from the first factor that has them
        self._state_names = {}
        for f in self.factors:
            for var, names in f.state_names.items():
                self._state_names.setdefault(var, names)
        self._program = None
        self._tables = None
        self.timings = {}

    def _message_key(self, fi, var):
        """The reference's message key: ``"[factor variables] -> variable"``."""
        return f"{list(self.factors[fi].variables)} -> {var}"

    def _tables_for(self, program):
        """The flood's tables, rebuilt when a factor's values tensor was
        replaced or edited in place since the last query."""
        current = [f.values for f in self.factors]
        versions = [t._version for t in current]
        cached = self._tables
        if (
            cached is None
            or any(a is not b for a, b in zip(cached[0], current))
            or cached[1] != versions
        ):
            self._tables = cached = (current, versions, program.build_tables(current))
        return cached[2]

    def _flood_inputs(self, fixed_var_messages, max_iter=100, tol=1e-8, precomp_messages=None):
        """``(program, fixed, f2v_init, tables)`` of a flood: the program (built
        once per graph, round limit and tolerance), the ``(E, C)`` fixed and
        initial messages on the host, the cached tables.
        ``fixed_var_messages``: {var: array} evidence / virtual-evidence
        messages multiplied into every variable -> factor message;
        ``precomp_messages``: warm-start messages by reference key."""
        if (
            self._program is None
            or self._program.max_iter != max_iter
            or self._program.tol != tol
        ):
            self._program = _FloodingProgram(
                [list(f.variables) for f in self.factors], self.cardinality,
                max_iter=max_iter, tol=tol,
            )
            self._tables = None
        program = self._program
        tables = self._tables_for(program)

        fixed = program.mask.astype(np.float64)
        for var, message in fixed_var_messages.items():
            rows = program.var_edges.get(var, [])
            fixed[rows, : len(message)] = np.asarray(message, dtype=np.float64)
        f2v_init = program.mask / program.cards[:, None]
        if precomp_messages:
            for e, (fi, var) in enumerate(program.edges):
                key = self._message_key(fi, var)
                if key in precomp_messages:
                    f2v_init[e, : program.cards[e]] = to_numpy(precomp_messages[key])
        return program, fixed, f2v_init, tables

    def calc_variable_node_message(self, variable, incoming_messages):
        """Outgoing variable-node message: the normalised product of the
        incoming messages."""
        if not incoming_messages:
            return np.ones(self.cardinality[variable]) / self.cardinality[variable]
        if len(incoming_messages) == 1:
            return np.asarray(to_numpy(incoming_messages[0]), dtype=np.float64)
        out = np.asarray(to_numpy(incoming_messages[0]), dtype=np.float64)
        for m in incoming_messages[1:]:
            out = out * np.asarray(to_numpy(m), dtype=np.float64)
        return out / out.sum()

    @staticmethod
    def calc_factor_node_message(factor, incoming_messages, target_var):
        """Outgoing factor-node message toward ``target_var``: the factor
        table times the incoming messages (one per other variable, in the
        factor's variable order), the other variables summed out."""
        table = np.asarray(to_numpy(factor.values), dtype=np.float64)
        if len(incoming_messages) != table.ndim - 1:
            raise AssertionError(
                "The number of incoming messages must match the number of "
                "non-target variables in the factor"
            )
        moved = np.moveaxis(table, factor.variables.index(target_var), -1)
        for message in incoming_messages:
            moved = moved * np.asarray(to_numpy(message), dtype=np.float64).reshape(
                -1, *([1] * (moved.ndim - 1))
            )
            moved = moved.sum(axis=0)
        return moved / moved.sum()

    def query(self, variables, evidence=None, virtual_evidence=None,
              get_messages=False, precomp_messages=None):
        """Marginal beliefs of ``variables`` given point-mass evidence and
        virtual-evidence messages.  ``precomp_messages`` reuses the factor ->
        variable messages of an earlier ``get_messages=True`` call.
        ``timings`` keeps the call's host seconds: ``staging_s`` (evidence,
        program, tables, fixed and initial messages), ``flood_s``,
        ``beliefs_s`` (read back) and ``results_s`` (the result objects)."""
        t0 = time.perf_counter()
        evidence = evidence or {}
        if set(variables) & set(evidence):
            raise ValueError(
                "Can't have the same variables in both `variables` and `evidence`. "
                f"Found in both: {set(variables) & set(evidence)}"
            )

        fixed = {}
        for var, state in evidence.items():
            fixed[var] = self.model.get_point_mass_message(var, state)
        for virt in virtual_evidence or []:
            var = virt.variables[0]
            message = np.asarray(to_numpy(virt.values), dtype=np.float64).ravel()
            fixed[var] = fixed.get(var, 1.0) * message

        program, fixed_rows, f2v_init, tables = self._flood_inputs(
            fixed, precomp_messages=precomp_messages)
        t1 = time.perf_counter()
        f2v = program.run(fixed_rows, f2v_init, tables)
        t2 = time.perf_counter()

        variables = list(variables)
        results = {}
        if variables:
            log_fixed = np.zeros((len(variables), program.max_card))
            for i, var in enumerate(variables):
                card = self.cardinality[var]
                log_fixed[i, card:] = -np.inf
                if var in fixed:
                    with np.errstate(divide="ignore"):
                        log_fixed[i, :card] = np.log(fixed[var])
            beliefs = to_numpy(program.beliefs(
                f2v, torch.as_tensor(log_fixed, dtype=f2v.dtype, device=f2v.device), variables))
        t3 = time.perf_counter()
        for i, var in enumerate(variables):
            card = self.cardinality[var]
            names = {var: self._state_names[var]} if var in self._state_names else {}
            results[var] = DiscreteFactor([var], [card], beliefs[i, :card], state_names=names)
        if get_messages:
            out = to_numpy(f2v).astype(np.float64)
            messages = {
                self._message_key(fi, var): out[e, : program.cards[e]]
                for e, (fi, var) in enumerate(program.edges)
            }
        self.timings = {"staging_s": t1 - t0, "flood_s": t2 - t1, "beliefs_s": t3 - t2,
                        "results_s": time.perf_counter() - t3}
        return (results, messages) if get_messages else results
