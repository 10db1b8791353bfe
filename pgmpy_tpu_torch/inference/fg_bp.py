"""BeliefPropagationWithMessagePassing: loopy sum-product BP on factor
graphs by a synchronous flooding schedule (K7).

Port of ``pgmpy_tpu/inference/fg_bp.py``.  All factor -> variable messages
live in one ``(n_edges, max_card)`` tensor; a round updates every edge with a
few batched operations (factors bucketed by their power-of-two padded
shape), and a host loop runs rounds until the largest change falls below the
tolerance, reading that one number per round.  Exact on trees, standard
loopy BP otherwise; evidence, virtual evidence, warm-start messages and the
factor tables are inputs, not constants, so a graph builds its program once.

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

import numpy as np
import torch

from pgmpy_tpu_torch.config import config, to_numpy
from pgmpy_tpu_torch.factors.discrete import DiscreteFactor
from pgmpy_tpu_torch.models.factor_graph import FactorGraph
from pgmpy_tpu_torch.ops.einsum import sum_product


def _normalize(msgs):
    total = torch.sum(msgs, dim=-1, keepdim=True)
    return torch.where(total > 0, msgs / torch.where(total > 0, total, 1.0), msgs)


def _centered_log(msgs):
    """``log`` of each row of ``msgs`` minus the row's largest finite entry:
    a per-row constant, which the normalisation cancels, that keeps a sum of
    hundreds of near-uniform messages' logs near 0 instead of near -400."""
    logs = torch.log(msgs)
    top = torch.amax(logs, dim=-1, keepdim=True)
    return logs - torch.where(torch.isfinite(top), top, torch.zeros_like(top))


def _log_product(logs, dim):
    """``exp`` of the sum of ``logs`` over ``dim`` after subtracting each
    row's finite maximum, normalised over the last axis."""
    total = logs.sum(dim=dim)
    shift = torch.amax(total, dim=-1, keepdim=True)
    shift = torch.where(torch.isfinite(shift), shift, torch.zeros_like(shift))
    return _normalize(torch.exp(total - shift))


class _FloodingProgram:
    """Index tables of flooding BP on a factor graph, and the round loop.

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

        self.edges = []
        edge_id = {}
        for fi, scope in enumerate(factor_scopes):
            for var in scope:
                edge_id[(fi, var)] = len(self.edges)
                self.edges.append((fi, var))
        E = len(self.edges)
        C = max(int(c) for c in cardinality.values())
        self.n_edges, self.max_card = E, C
        self.cards = np.array([int(cardinality[var]) for _, var in self.edges], dtype=np.int64)
        self.mask = np.arange(C)[None, :] < self.cards[:, None]

        # per edge, the other edges into the same variable, padded with E: a
        # row of zeros appended to the log-messages (log 1, the identity)
        self.var_edges = {}
        for e, (_, var) in enumerate(self.edges):
            self.var_edges.setdefault(var, []).append(e)
        D = max(max((len(v) for v in self.var_edges.values()), default=1) - 1, 1)
        nbr = np.full((E, D), E, dtype=np.int64)
        for edges in self.var_edges.values():
            for e in edges:
                others = [e2 for e2 in edges if e2 != e]
                nbr[e, : len(others)] = others
        self._nbr = torch.from_numpy(nbr).to(self.device)

        # factors bucketed by their shape padded per axis to a power of two
        groups = {}
        scope_cards = [tuple(int(cardinality[v]) for v in scope) for scope in factor_scopes]
        for fi, cards in enumerate(scope_cards):
            groups.setdefault(tuple(1 << max(0, (c - 1).bit_length()) for c in cards), []).append(fi)
        self._groups = []
        out_edge_order = []
        for shape in sorted(groups):
            fis = groups[shape]
            eidx = np.array([[edge_id[(fi, v)] for v in factor_scopes[fi]] for fi in fis],
                            dtype=np.int64).reshape(len(fis), len(shape))
            out_edge_order.extend(eidx.T.reshape(-1).tolist())
            self._groups.append((shape, fis, torch.from_numpy(eidx).to(self.device)))
        inv = np.empty(E, dtype=np.int64)
        inv[np.asarray(out_edge_order, dtype=np.int64)] = np.arange(E)
        self._inv_perm = torch.from_numpy(inv).to(self.device)
        self.last_rounds = 0

    def build_tables(self, factor_values):
        """The factor tables in the per-group padded layout, in the program's
        dtype on its device."""
        out = []
        for shape, fis, _ in self._groups:
            rows = []
            for fi in fis:
                vals = torch.as_tensor(factor_values[fi], device=self.device).to(self.dtype)
                pad = []
                for size, full in zip(reversed(vals.shape), reversed(shape)):
                    pad += [0, full - size]
                rows.append(torch.nn.functional.pad(vals, pad) if any(pad) else vals)
            out.append(torch.stack(rows))
        return out

    def round(self, f2v, log_fixed, tables):
        """One flooding round: (new factor -> variable messages, the largest
        change of any entry), in the program's dtype."""
        C = self.max_card
        logs = torch.cat([_centered_log(f2v), f2v.new_zeros((1, C))])
        # variable -> factor: the exclusive product, in log space
        v2f = _log_product(torch.cat([logs[self._nbr], log_fixed[:, None, :]], dim=1), dim=1)
        outs = []
        for (shape, _, eidx), table in zip(self._groups, tables):
            arity = len(shape)
            msgs = v2f[eidx]  # (F, arity, C)
            for k in range(arity):
                operands, axes = [table], [tuple(range(arity + 1))]
                for k2 in range(arity):
                    if k2 != k:
                        m = msgs[:, k2, :]
                        m = m[:, : shape[k2]] if shape[k2] <= C else torch.nn.functional.pad(
                            m, (0, shape[k2] - C))
                        operands.append(m)
                        axes.append((0, k2 + 1))
                out_k = sum_product(axes, (0, k + 1), *operands)
                if shape[k] < C:
                    out_k = torch.nn.functional.pad(out_k, (0, C - shape[k]))
                elif shape[k] > C:
                    out_k = out_k[:, :C]
                outs.append(out_k)
        new_f2v = _normalize(torch.cat(outs)[self._inv_perm])
        return new_f2v, torch.max(torch.abs(new_f2v - f2v))

    def run(self, fixed, f2v_init, tables):
        """Flood until the change falls below the tolerance or ``max_iter``
        rounds; ``last_rounds`` records the rounds taken.  One host read per
        round."""
        mask = torch.from_numpy(self.mask).to(self.device)
        f2v = torch.as_tensor(f2v_init, dtype=self.dtype, device=self.device) * mask
        log_fixed = torch.log(torch.as_tensor(fixed, dtype=self.dtype, device=self.device))
        rounds = 0
        while rounds < self.max_iter:
            f2v, delta = self.round(f2v, log_fixed, tables)
            rounds += 1
            if float(delta) < self._tol_eff:
                break
        self.last_rounds = rounds
        return f2v

    def beliefs(self, f2v, log_fixed_var, variables):
        """``(len(variables), C)`` normalised beliefs: each variable's fixed
        message times all its incoming messages, in log space."""
        width = max(len(self.var_edges[v]) for v in variables)
        idx = np.full((len(variables), width), self.n_edges, dtype=np.int64)
        for i, v in enumerate(variables):
            idx[i, : len(self.var_edges[v])] = self.var_edges[v]
        logs = torch.cat([_centered_log(f2v), f2v.new_zeros((1, self.max_card))])
        gathered = logs[torch.from_numpy(idx).to(self.device)]
        return _log_product(torch.cat([gathered, log_fixed_var[:, None, :]], dim=1), dim=1)


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

    def _message_key(self, fi, var):
        """The reference's message key: ``"[factor variables] -> variable"``."""
        return f"{list(self.factors[fi].variables)} -> {var}"

    def _tables_for(self, program):
        """The padded tables, rebuilt when a factor's values tensor was
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

    def _run_flooding(self, fixed_var_messages, max_iter=100, tol=1e-8, precomp_messages=None):
        """Flood the graph: returns ``(program, f2v)``, the converged
        ``(E, C)`` factor -> variable messages on the device.
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
        return program, program.run(fixed, f2v_init, tables)

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
        variable messages of an earlier ``get_messages=True`` call."""
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

        program, f2v = self._run_flooding(fixed, precomp_messages=precomp_messages)

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
            return results, messages
        return results
