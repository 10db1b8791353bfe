"""VariableElimination: exact posterior queries as planned contractions.

Port of ``pgmpy_tpu/inference/ve.py``.  A host-side planner prunes the model,
maps variables to integer einsum labels and emits contractions over the raw
CPD tensors on ``config.DEVICE``.

Three execution paths, all on the int-label program representation (tensors
plus integer axis tuples, never factor objects):

* **compiled single query**: one program per (query vars, evidence vars)
  signature, cached on the model; evidence enters as state *codes*, turned
  into one-hot operands, so repeated queries with different evidence values
  reuse the program and its cached contraction path.
* **staged elimination**: per-variable label elimination for
  ``max_marginal`` and explicit elimination orders: each step contracts the
  group of live operands containing the label down to the union scope minus
  the label (sum or max reduction).
* **batched queries** (``query_batch``): the observed axes of every CPD are
  gathered out per evidence row (one ``index_select`` per CPD, batch axis
  first), and the whole batch is one contraction with a batch label.

Left out from the JAX package: the routing of small queries to the host's
backend.  Every program here runs on ``config.DEVICE``.
"""

import itertools

import numpy as np
import torch

from pgmpy_tpu_torch.config import config
from pgmpy_tpu_torch.factors.discrete import DiscreteFactor
from pgmpy_tpu_torch.factors.factor_ops import factor_product
from pgmpy_tpu_torch.inference.base import Inference, evidence_code, evidence_codes
from pgmpy_tpu_torch.models.discrete_bn import DiscreteBayesianNetwork
from pgmpy_tpu_torch.ops.einsum import largest_intermediate, make_axis_map, sum_product_planned
from pgmpy_tpu_torch.utils.cache import LRUDict


# ---------------------------------------------------------------------- #
# elimination-order heuristics (host side)
# ---------------------------------------------------------------------- #
class BaseEliminationOrder:
    """Greedy triangulation ordering on the moral graph.

    The graph lives in a boolean adjacency matrix so per-candidate costs are
    vectorized numpy, and eliminating a node *marries its remaining
    neighbors* (the fill-in clique the staged contraction will actually
    create) instead of re-moralizing the shrinking DAG each step.
    Subclasses define the cost of eliminating node ``i`` next.
    """

    def __init__(self, model):
        if not isinstance(model, DiscreteBayesianNetwork):
            raise ValueError("Model should be a DiscreteBayesianNetwork instance")
        self._nodes = list(model.nodes())
        self._idx = {n: i for i, n in enumerate(self._nodes)}
        n = len(self._nodes)
        self._adj = np.zeros((n, n), dtype=bool)
        for u, v in model.moralize().edges():
            i, j = self._idx[u], self._idx[v]
            if i != j:
                self._adj[i, j] = self._adj[j, i] = True
        cards = model.get_cardinality()
        self._card = np.asarray(
            [max(int(cards[node]), 1) for node in self._nodes], dtype=np.float64
        )
        self._alive = np.ones(n, dtype=bool)

    # -- cost interface ------------------------------------------------- #
    def cost(self, node):
        """Cost of eliminating ``node`` next (lower is better)."""
        return self._cost(self._idx[node])

    def _cost(self, i):
        return 0.0

    def _neighbors(self, i):
        return np.flatnonzero(self._adj[i] & self._alive)

    def fill_in_edges(self, node):
        """Edges the elimination of ``node`` would add between its
        currently non-adjacent neighbors."""
        nb = self._neighbors(self._idx[node])
        return [
            (self._nodes[a], self._nodes[b])
            for a, b in itertools.combinations(nb, 2)
            if not self._adj[a, b]
        ]

    def get_elimination_order(self, nodes=None, show_progress=False):
        """Greedily order ``nodes`` (default: all) by repeated min-cost
        elimination with fill-in."""
        if nodes is None:
            nodes = self._nodes
        candidates = {self._idx[n] for n in nodes}
        order = []
        while candidates:
            best = min(candidates, key=lambda i: (self._cost(i), i))
            order.append(self._nodes[best])
            nb = self._neighbors(best)
            if nb.size > 1:
                self._adj[np.ix_(nb, nb)] = True
                self._adj[nb, nb] = False
            self._adj[best, :] = False
            self._adj[:, best] = False
            self._alive[best] = False
            candidates.remove(best)
        return order


class MinNeighbors(BaseEliminationOrder):
    def _cost(self, i):
        return int(self._neighbors(i).size)


class MinWeight(BaseEliminationOrder):
    def _cost(self, i):
        return float(np.prod(self._card[self._neighbors(i)]))


class MinFill(BaseEliminationOrder):
    def _cost(self, i):
        nb = self._neighbors(i)
        if nb.size < 2:
            return 0
        sub = self._adj[np.ix_(nb, nb)]
        iu = np.triu_indices(nb.size, k=1)
        return int((~sub[iu]).sum())


class WeightedMinFill(BaseEliminationOrder):
    def _cost(self, i):
        nb = self._neighbors(i)
        if nb.size < 2:
            return 0.0
        sub = self._adj[np.ix_(nb, nb)]
        weights = np.outer(self._card[nb], self._card[nb])
        iu = np.triu_indices(nb.size, k=1)
        return float((weights[iu] * ~sub[iu]).sum())


_ORDER_HEURISTICS = {
    "weightedminfill": WeightedMinFill,
    "minneighbors": MinNeighbors,
    "minweight": MinWeight,
    "minfill": MinFill,
}


# ---------------------------------------------------------------------- #
# compiled per-signature query programs
# ---------------------------------------------------------------------- #
class _CompiledQuery:
    """One contraction program per (query vars, evidence vars) signature.

    Built once: prune the model for this signature, collect the CPD tensors
    and their int-label axes.  A call turns the evidence state codes into
    one-hot operands and runs the planned contraction, whose path is cached
    on the signature: no host-side pruning, slicing, or path planning per
    call.
    """

    def __init__(self, infer, variables, ev_vars):
        model, kept_evidence = infer._prune_bayesian_model(
            list(variables), {v: 0 for v in ev_vars}
        )
        self.query_vars = list(variables)
        self.ev_vars = list(ev_vars)
        self.kept = [v for v in ev_vars if v in kept_evidence]

        arrays, scopes = [], []
        state_names, cards = {}, {}
        for cpd in model.cpds:
            arrays.append(cpd.values.to(config.DEVICE))
            scopes.append(list(cpd.variables))
            state_names.update(cpd.state_names)
            for var, card in zip(cpd.variables, cpd.cardinality):
                cards[var] = int(card)

        missing = [v for v in variables if v not in cards]
        if missing:
            raise ValueError(f"Query variables not in reduced model: {missing}")

        var_to_int, operand_axes = make_axis_map(scopes + [[v] for v in self.kept])
        self._operand_axes = operand_axes
        self._out_axes = tuple(var_to_int[v] for v in self.query_vars)
        self._arrays = arrays
        self.cards = [cards[v] for v in self.query_vars]
        self.state_names = {v: list(state_names[v]) for v in self.query_vars}
        self._code_maps = [
            {s: i for i, s in enumerate(state_names[v])} for v in self.kept
        ]
        self._kept_cards = [cards[v] for v in self.kept]

    def largest_intermediate(self):
        """Elements of the largest tensor this program's planned contraction
        builds, read from the plan before anything runs."""
        shapes = [tuple(a.shape) for a in self._arrays] + [(c,) for c in self._kept_cards]
        return largest_intermediate(self._operand_axes, self._out_axes, shapes)

    def run(self, codes):
        """Normalized P(query | evidence) for one vector of evidence codes (a
        long tensor of shape (len(kept),) on the device)."""
        dtype = self._arrays[0].dtype
        evidence = [
            torch.nn.functional.one_hot(codes[k], card).to(dtype)
            for k, card in enumerate(self._kept_cards)
        ]
        values = sum_product_planned(
            self._operand_axes, self._out_axes, list(self._arrays) + evidence
        )
        return values / torch.sum(values)

    def encode(self, evidence):
        """Evidence {var: state name or int} -> int64 code vector."""
        codes = np.empty(len(self.kept), dtype=np.int64)
        for k, var in enumerate(self.kept):
            codes[k] = evidence_code(
                var, evidence[var], self._code_maps[k], self._kept_cards[k]
            )
        return codes

    def __call__(self, evidence):
        codes = torch.from_numpy(self.encode(evidence)).to(config.DEVICE)
        return DiscreteFactor(
            list(self.query_vars), self.cards, self.run(codes), state_names=self.state_names
        )


class _GatherPlan:
    """How ``query_batch`` takes the observed axes out of the CPDs, per row.

    ``torch`` indexing with several index tensors follows numpy's rule: the
    broadcast index axis goes first only when the indices are separated by a
    slice, and stays in place when they are adjacent.  So each CPD with
    observed axes is stored with those axes moved to the front and flattened
    into one; a row's observed states become one flat code, and one
    ``index_select`` per CPD returns ``(n, *free axes)`` whatever the order of
    the scope.  The flat codes of all CPDs come from one gather, one product
    and one sum over a ``(n, n_tables, max observed axes)`` tensor.
    """

    def __init__(self, tables, ev_columns, ev_strides, n_ev):
        width = max(len(c) for c in ev_columns)
        # short rows are padded with column ``n_ev`` (a zero column appended to
        # the ``n_ev`` columns of the codes) at stride 0
        cols = np.full((len(tables), width), n_ev, dtype=np.int64)
        strides = np.zeros((len(tables), width), dtype=np.int64)
        for j, (c, s) in enumerate(zip(ev_columns, ev_strides)):
            cols[j, : len(c)] = c
            strides[j, : len(s)] = s
        self.tables = tables
        self._cols = torch.from_numpy(cols).to(config.DEVICE)
        self._strides = torch.from_numpy(strides).to(config.DEVICE)

    @classmethod
    def table_of(cls, values, scope, ev_pos):
        """(table, evidence columns, strides) of one CPD: ``table`` has the
        observed axes of ``values`` first, flattened C-order into one axis,
        then the free axes in scope order."""
        observed = [i for i, v in enumerate(scope) if v in ev_pos]
        free = [i for i, v in enumerate(scope) if v not in ev_pos]
        shape = tuple(values.shape)
        strides, acc = [], 1
        for i in reversed(observed):
            strides.append(acc)
            acc *= shape[i]
        table = values.permute(observed + free).reshape((acc,) + tuple(shape[i] for i in free))
        return table.contiguous(), [ev_pos[scope[i]] for i in observed], strides[::-1]

    def flat_codes(self, codes):
        """``(n_tables, n)``: each row's flat observed code in each table."""
        padded = torch.nn.functional.pad(codes, (0, 1))
        return (padded[:, self._cols] * self._strides).sum(dim=2).t().contiguous()

    def rows(self, codes):
        """``tables[j][flat code of row i]`` for every table: a list of
        ``(n, *free axes)`` tensors."""
        flat = self.flat_codes(codes)
        return [table.index_select(0, flat[j]) for j, table in enumerate(self.tables)]


class _LogGroup:
    """Gathered CPD rows that share one free scope, combined in log space.

    At a naive Bayes' width a thousand ``P(feature | class)`` rows share the
    class axis; their float32 product underflows to 0 and the row normalises
    to 0/0.  The members' log tables (float64, free axes in one order) are
    concatenated once; per call one gather takes every member's rows, they
    are summed, the per-row maximum is subtracted and the result
    exponentiated: ONE operand of the contraction in place of the group.
    The shift is a per-row constant and cancels in the row's normalisation.
    """

    def __init__(self, members, tables, free_orders, free):
        logs, sizes = [], []
        for j in members:
            perm = [0] + [1 + free_orders[j].index(v) for v in free]
            logs.append(torch.log(tables[j].permute(perm).to(torch.float64)))
            sizes.append(logs[-1].shape[0])
        self.free = free
        self.members = torch.as_tensor(members, dtype=torch.int64, device=config.DEVICE)
        offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
        self._offsets = torch.from_numpy(offsets).to(config.DEVICE)[:, None]
        self._table = torch.cat(logs).contiguous()
        self._free_dims = tuple(range(1, 1 + len(free)))

    def operand(self, flat):
        idx = flat.index_select(0, self.members) + self._offsets  # (m, n)
        m, n = idx.shape
        logp = self._table.index_select(0, idx.reshape(-1))
        logp = logp.reshape((m, n) + self._table.shape[1:]).sum(dim=0)
        shift = torch.amax(logp, dim=self._free_dims, keepdim=True)
        shift = torch.where(torch.isfinite(shift), shift, torch.zeros_like(shift))
        return torch.exp(logp - shift).to(config.DTYPE)


class VariableElimination(Inference):
    """Exact posterior inference by (compiled) variable elimination.

    Each distinct (query variables, evidence variables) signature builds ONCE
    into a planned contraction; repeat queries reuse it with the evidence
    entering as integer codes.

    Examples
    --------
    >>> import numpy as np
    >>> from pgmpy_tpu_torch.factors import TabularCPD
    >>> from pgmpy_tpu_torch.inference import VariableElimination
    >>> from pgmpy_tpu_torch.models import DiscreteBayesianNetwork
    >>> model = DiscreteBayesianNetwork([("rain", "wet")])
    >>> model.add_cpds(
    ...     TabularCPD("rain", 2, [[0.8], [0.2]]),
    ...     TabularCPD("wet", 2, [[0.9, 0.2], [0.1, 0.8]],
    ...                evidence=["rain"], evidence_card=[2]))
    >>> infer = VariableElimination(model)
    >>> phi = infer.query(["rain"], evidence={"wet": 1},
    ...                   show_progress=False)
    >>> phi.values.double().cpu().numpy().round(3).tolist()
    [0.333, 0.667]
    >>> infer.map_query(["rain"], evidence={"wet": 0},
    ...                 show_progress=False)
    {'rain': 0}
    """

    # ------------------------------------------------------------------ #
    # elimination-order resolution
    # ------------------------------------------------------------------ #
    def _elimination_order_for(
        self, variables, evidence, elimination_order, show_progress=False
    ):
        """Resolve ``elimination_order`` (explicit list or heuristic name)
        to the list of variables to eliminate, validating coverage."""
        keep = set(variables) | set(evidence.keys() if evidence else [])
        to_eliminate = set(self.variables) - keep

        if isinstance(elimination_order, (list, tuple)):
            overlap = set(elimination_order) & keep
            if overlap:
                raise ValueError(
                    "Elimination order contains variables which are in variables or evidence args"
                )
            order = [v for v in elimination_order if v in self.model.nodes()]
            if set(order) != to_eliminate:
                raise ValueError(
                    "Elimination order doesn't contain all the variables which need "
                    "to be eliminated. The variables which need to be eliminated are "
                    f"{to_eliminate}"
                )
            return order

        if not to_eliminate:
            return []

        heuristic = _ORDER_HEURISTICS.get(str(elimination_order).lower())
        if heuristic is not None and isinstance(self.model, DiscreteBayesianNetwork):
            return heuristic(self.model).get_elimination_order(
                sorted(to_eliminate, key=str), show_progress=show_progress
            )
        return sorted(to_eliminate, key=str)

    # ------------------------------------------------------------------ #
    # staged elimination on the int-label program representation
    # ------------------------------------------------------------------ #
    def _unique_factors(self):
        unique = {}
        for factor_list in self.factors.values():
            for factor in factor_list:
                unique[id(factor)] = factor
        return list(unique.values())

    def _model_entries(self, evidence):
        """Unique model factors as (values tensor, int-label tuple) entries
        with evidence axes sliced out, plus the label<->var maps and any
        scalar mass from fully-observed factors."""
        var_to_int, _ = make_axis_map([list(self.variables)])
        label_names = {}  # label -> (var, cardinality, state names)

        entries = []
        scalar = 1.0
        evidence = evidence or {}
        for factor in self._unique_factors():
            labels = []
            index = []
            for var, card in zip(factor.variables, factor.cardinality):
                if var in evidence:
                    index.append(factor.get_state_no(var, evidence[var]))
                else:
                    index.append(slice(None))
                    lbl = var_to_int[var]
                    labels.append(lbl)
                    label_names[lbl] = (var, int(card), factor.state_names[var])
            values = factor.values[tuple(index)]
            if labels:
                entries.append((values, tuple(labels)))
            else:
                scalar = scalar * values
        return entries, var_to_int, label_names, scalar

    @staticmethod
    def _contract_out(entries, label, operation):
        """Contract every entry whose axes contain ``label`` down to their
        union scope minus ``label``; returns (new entry or None, survivors)."""
        group = [e for e in entries if label in e[1]]
        rest = [e for e in entries if label not in e[1]]
        if not group:
            return None, rest
        union = []
        for _, axes in group:
            for ax in axes:
                if ax not in union:
                    union.append(ax)
        out = tuple(ax for ax in union if ax != label)
        arrays = [v for v, _ in group]
        axes_list = [a for _, a in group]
        if operation == "marginalize":
            values = sum_product_planned(axes_list, out, arrays)
        else:  # maximize: materialize the union-scope product, max-reduce
            product = sum_product_planned(axes_list, tuple(union), arrays)
            values = torch.amax(product, dim=union.index(label))
        return (values, out), rest

    def _variable_elimination(
        self,
        variables,
        operation,
        evidence=None,
        elimination_order="minfill",
        joint=True,
        show_progress=False,
    ):
        """Eliminate all non-query, non-evidence variables one label at a
        time (``operation`` is "marginalize" or "maximize")."""
        if isinstance(variables, str):
            raise TypeError("variables must be a list of strings")
        if isinstance(evidence, str):
            raise TypeError("evidence must be a list of strings")
        common_vars = set(evidence if evidence is not None else []) & set(variables)
        if common_vars:
            raise ValueError(
                f"Can't have the same variables in both `variables` and `evidence`. Found in both: {common_vars}"
            )

        if not variables:
            # no query variables: the (unnormalized) product of all factors
            unique = self._unique_factors()
            if joint:
                return factor_product(*unique)
            return set(unique)

        order = self._elimination_order_for(
            variables, evidence, elimination_order, show_progress=show_progress
        )
        entries, var_to_int, label_names, scalar = self._model_entries(evidence)

        for var in order:
            entry, entries = self._contract_out(entries, var_to_int[var], operation)
            if entry is not None:
                if entry[1]:
                    entries.append(entry)
                else:
                    scalar = scalar * entry[0]

        # combine what's left into the joint over the query variables
        present = set(itertools.chain.from_iterable(a for _, a in entries))
        missing = [v for v in variables if var_to_int[v] not in present]
        if missing:
            raise ValueError(f"Query variables not present in any factor: {missing}")
        out_labels = tuple(var_to_int[v] for v in variables)
        arrays = [v for v, _ in entries]
        axes_list = [a for _, a in entries]
        values = sum_product_planned(axes_list, out_labels, arrays) * scalar

        cards = [label_names[var_to_int[v]][1] for v in variables]
        names = {v: label_names[var_to_int[v]][2] for v in variables}
        result = DiscreteFactor(list(variables), cards, values, state_names=names)

        normalize = isinstance(self.model, DiscreteBayesianNetwork)
        if joint:
            return result.normalize(inplace=False) if normalize else result
        out = {}
        for query_var in variables:
            phi = result.marginalize(
                [v for v in variables if v != query_var], inplace=False
            )
            out[query_var] = phi.normalize(inplace=False) if normalize else phi
        return out

    # ------------------------------------------------------------------ #
    # the fused ("greedy") path: compiled per-signature programs
    # ------------------------------------------------------------------ #
    def _model_cache(self, name, max_size):
        """A per-model LRU cache that is thrown away when the model's
        ``_cache_token`` changes (a model edit or an in-place CPD write)."""
        token = self.model._cache_token()
        cache = self.model.__dict__.get(name)
        if cache is None or cache[0] != token:
            cache = (token, LRUDict(max_size=max_size))
            self.model.__dict__[name] = cache
        return cache[1]

    def _get_compiled_query(self, variables, ev_vars):
        cache = self._model_cache("_ve_program_cache", 256)
        key = (tuple(variables), tuple(ev_vars))
        prog = cache.get(key)
        if prog is None:
            prog = _CompiledQuery(self, variables, ev_vars)
            cache[key] = prog
        return prog

    def _fused_query(self, variables, evidence, joint):
        evidence = evidence or {}
        ev_vars = sorted(evidence.keys(), key=str)
        prog = self._get_compiled_query(list(variables), ev_vars)
        result = prog(evidence)
        if joint:
            return result
        return {
            var: result.marginalize(
                [v for v in variables if v != var], inplace=False
            )
            for var in variables
        }

    # ------------------------------------------------------------------ #
    # batched queries: one contraction for N evidence rows
    # ------------------------------------------------------------------ #
    def query_batch(self, variables, evidence):
        """Posterior P(variables | evidence_row) for EVERY row of a batch of
        evidence assignments, in one planned contraction.

        The observed axes of each CPD are gathered out per row, so observed
        axes never enter the contraction, and the rows share a batch label:
        the device analogue of a per-row predict loop.

        Parameters
        ----------
        variables : list of query variables
        evidence : dict {var: sequence of state names/indices}, all the
            same length n

        Returns
        -------
        (values, state_names): values has shape (n, card_q1, ...) with each
        row normalized; state_names covers the query variables.
        """
        values, state_names, _ = self._query_batch_masked(variables, evidence)
        return values, state_names

    def _query_batch_masked(self, variables, evidence):
        """:meth:`query_batch`, and a bool tensor (n,) that is True on the
        rows whose evidence has probability 0 through a CPD the contraction
        leaves out (None when it leaves none out): ``query`` gives such a row
        NaN, ``query_batch`` an answer."""
        if not evidence:
            raise ValueError("query_batch requires evidence; use query() otherwise")
        ev_vars = sorted(evidence.keys(), key=str)
        run, state_names, code_maps, impossible = self._get_batch_program(
            tuple(variables), tuple(ev_vars)
        )
        codes = np.empty((len(next(iter(evidence.values()))), len(ev_vars)), np.int64)
        for k, var in enumerate(ev_vars):
            codes[:, k] = evidence_codes(var, evidence[var], code_maps[k], len(code_maps[k]))
        codes = torch.from_numpy(codes).to(config.DEVICE)
        return run(codes), state_names, None if impossible is None else impossible(codes)

    def _get_batch_program(self, variables, ev_vars):
        """Per-signature cache for :meth:`batch_query_program`,
        token-checked and LRU-bounded like ``_get_compiled_query``: predict
        calls query_batch repeatedly with the same signature and must not
        prune the model and rebuild the gather tables per call."""
        cache = self._model_cache("_ve_batch_program_cache", 64)
        key = (tuple(variables), tuple(ev_vars))
        entry = cache.get(key)
        if entry is None:
            entry = self.batch_query_program(list(variables), list(ev_vars))
            cache[key] = entry
        return entry

    def batch_query_program(self, variables, ev_vars):
        """Build the device program behind :meth:`query_batch`: a function
        ``run(codes[n, len(ev_vars)]) -> values[n, *query cards]`` (``codes``
        a long tensor on ``config.DEVICE``, every code already validated on
        the host) plus the query state names, per-evidence-var name->code
        maps and ``impossible(codes) -> bool[n]`` (None when no CPD is left
        out, see below).

        A CPD whose whole scope is observed contributes one number per row,
        which cancels in the row's normalization, so it is left out of the
        contraction: at MUNIN's width a thousand such numbers multiply to 0
        in float32 and the row would normalize to 0/0.  (For a row whose
        evidence has probability 0 the rows that result are therefore
        conditional on the CPDs that remain, not NaN; ``impossible`` finds
        such rows with one gather of the left-out CPDs' entries.)

        The gathered rows of CPDs that keep the same free scope (every
        ``P(feature | class)`` of a naive Bayes) are combined in log space
        into one operand (:class:`_LogGroup`): their product would underflow
        as well."""
        model, _ = self._prune_bayesian_model(
            list(variables), {v: 0 for v in ev_vars}
        )

        state_names = {}
        cards = {}
        for cpd in model.cpds:
            state_names.update(cpd.state_names)
            for var, card in zip(cpd.variables, cpd.cardinality):
                cards[var] = int(card)
        for var in ev_vars:
            if var not in cards:
                raise ValueError(f"Evidence variable {var} pruned out of the model")
        missing = [v for v in variables if v not in cards]
        if missing:
            raise ValueError(f"Query variables not in reduced model: {missing}")

        ev_pos = {v: k for k, v in enumerate(ev_vars)}
        fixed, fixed_scopes = [], []  # CPDs with no observed axis
        tables, ev_columns, ev_strides, free_orders = [], [], [], []
        observed = ([], [], [])  # CPDs with every axis observed: left out
        for cpd in model.cpds:
            scope = list(cpd.variables)
            free = [v for v in scope if v not in ev_pos]
            values = cpd.values.to(config.DEVICE)
            if len(free) == len(scope):
                fixed.append(values)
                fixed_scopes.append(scope)
                continue
            table, columns, strides = _GatherPlan.table_of(values, scope, ev_pos)
            if free:
                tables.append(table)
                ev_columns.append(columns)
                ev_strides.append(strides)
                free_orders.append(free)
            else:
                for part, item in zip(observed, (table, columns, strides)):
                    part.append(item)
        gather = _GatherPlan(tables, ev_columns, ev_strides, len(ev_vars)) if tables else None
        left_out = _GatherPlan(*observed, len(ev_vars)) if observed[0] else None

        by_scope = {}
        for j, free in enumerate(free_orders):
            by_scope.setdefault(frozenset(free), []).append(j)
        singles = [js[0] for js in by_scope.values() if len(js) == 1]
        log_groups = [
            _LogGroup(js, tables, free_orders, free_orders[js[0]])
            for js in by_scope.values() if len(js) > 1
        ]
        gathered_scopes = [["__batch__"] + free_orders[j] for j in singles] + [
            ["__batch__"] + g.free for g in log_groups
        ]

        var_to_int, operand_axes = make_axis_map(
            [["__batch__"]] + fixed_scopes + gathered_scopes
        )
        operand_axes = operand_axes[1:]
        query_axes = tuple(var_to_int[v] for v in variables)
        n_query = len(variables)
        query_cards = [cards[v] for v in variables]
        out_card = int(np.prod(query_cards))

        def run(codes):
            n = codes.shape[0]
            if n * out_card > 2**31:
                raise ValueError(
                    f"query_batch output would have {n * out_card} entries; "
                    "query fewer variables jointly or fewer rows per batch"
                )
            if gather is None:
                # no remaining CPD sees the evidence: every row has one answer
                values = sum_product_planned(operand_axes, query_axes, fixed)
                return (values / torch.sum(values)).expand(n, *query_cards)
            flat = gather.flat_codes(codes)
            operands = [gather.tables[j].index_select(0, flat[j]) for j in singles]
            operands += [group.operand(flat) for group in log_groups]
            values = sum_product_planned(
                operand_axes, (var_to_int["__batch__"],) + query_axes, fixed + operands
            )
            norm = values.reshape(n, -1).sum(dim=1).reshape((n,) + (1,) * n_query)
            return values / norm

        def impossible(codes):
            return torch.stack(left_out.rows(codes)).eq(0).any(dim=0)

        query_names = {v: state_names[v] for v in variables}
        code_maps = [
            {s: i for i, s in enumerate(state_names[v])} for v in ev_vars
        ]
        return run, query_names, code_maps, impossible if left_out is not None else None

    # ------------------------------------------------------------------ #
    # public API
    # ------------------------------------------------------------------ #
    def query(
        self,
        variables,
        evidence=None,
        virtual_evidence=None,
        elimination_order="greedy",
        joint=True,
        show_progress=False,
    ):
        """Posterior P(variables | evidence).

        ``elimination_order="greedy"`` (default) uses the compiled fused
        path; MinFill/MinNeighbors/MinWeight/WeightedMinFill or an explicit
        order run the staged loop.
        """
        evidence = evidence if evidence is not None else {}
        if set(variables) & set(evidence.keys()):
            raise ValueError(f"Can't have the same variables in both `variables` and `evidence`. Found in both: {set(variables) & set(evidence.keys())}")

        if virtual_evidence:
            original_model = self.model
            try:
                self._virtual_evidence(virtual_evidence)
                virt_evidence = {
                    "__" + str(cpd.variables[0]): 0 for cpd in virtual_evidence
                }
                evidence = {**evidence, **virt_evidence}
                return self.query(
                    variables=variables,
                    evidence=evidence,
                    virtual_evidence=None,
                    elimination_order=elimination_order,
                    joint=joint,
                    show_progress=show_progress,
                )
            finally:
                self.__init__(original_model)

        if (
            isinstance(self.model, DiscreteBayesianNetwork)
            and str(elimination_order).lower() == "greedy"
        ):
            return self._fused_query(list(variables), evidence, joint)

        if isinstance(self.model, DiscreteBayesianNetwork):
            model_reduced, evidence = self._prune_bayesian_model(variables, evidence)
            reduced_ve = VariableElimination(model_reduced)
            return reduced_ve._variable_elimination(
                variables=variables,
                operation="marginalize",
                evidence=evidence,
                elimination_order=elimination_order,
                joint=joint,
                show_progress=show_progress,
            )
        return self._variable_elimination(
            variables=variables,
            operation="marginalize",
            evidence=evidence,
            elimination_order=elimination_order,
            joint=joint,
            show_progress=show_progress,
        )

    def max_marginal(
        self,
        variables=None,
        evidence=None,
        elimination_order="minfill",
        show_progress=False,
    ):
        """max_{other vars} P(...); scalar when ``variables`` covers the
        remaining factor.

        The model is pruned to the query/evidence first: with a max
        reduction, barren CPDs do NOT collapse to 1, so pruning changes (and
        defines) the answer."""
        if not variables:
            variables = []
        common_vars = set(evidence if evidence is not None else []) & set(variables)
        if common_vars:
            raise ValueError(
                f"Can't have the same variables in both `variables` and `evidence`. Found in both: {common_vars}"
            )
        target = self
        if isinstance(self.model, DiscreteBayesianNetwork):
            model_reduced, evidence = self._prune_bayesian_model(variables, evidence)
            target = VariableElimination(model_reduced)
        final_distribution = target._variable_elimination(
            variables,
            "maximize",
            evidence=evidence,
            elimination_order=elimination_order,
            joint=True,
            show_progress=show_progress,
        )
        return float(torch.max(final_distribution.values))

    def map_query(
        self,
        variables=None,
        evidence=None,
        virtual_evidence=None,
        elimination_order="greedy",
        show_progress=False,
    ):
        """MAP assignment of ``variables`` given evidence (argmax of the
        joint posterior over the query variables).  ``variables=None``
        means all non-evidence variables."""
        if not variables:
            variables = sorted(
                set(self.variables) - set(evidence or {}), key=str
            )
        variables = list(variables)
        common_vars = set(evidence if evidence is not None else []) & set(variables)
        if common_vars:
            raise ValueError(f"Can't have the same variables in both `variables` and `evidence`. Found in both: {common_vars}")

        final_distribution = self.query(
            variables=variables,
            evidence=evidence,
            virtual_evidence=virtual_evidence,
            elimination_order=elimination_order,
            joint=True,
            show_progress=show_progress,
        )
        argmax = int(torch.argmax(final_distribution.values))
        assignment = final_distribution.assignment([argmax])[0]
        return {var: value for var, value in assignment}

    def induced_graph(self, elimination_order):
        """Union of all factor scopes created while eliminating in the given
        order (as an UndirectedGraph)."""
        from pgmpy_tpu_torch.base.undirected import UndirectedGraph

        if set(elimination_order) != set(self.variables):
            raise ValueError("Set of variables in elimination order different from variables in model")

        eliminated_variables = set()
        working_factors = {
            node: [factor.scope() for factor in self.factors[node]]
            for node in self.factors
        }
        cliques = set()
        for factors in working_factors.values():
            for factor in factors:
                cliques.add(tuple(factor))

        for var in elimination_order:
            factors = [
                factor
                for factor in working_factors[var]
                if not set(factor).intersection(eliminated_variables)
            ]
            phi_scope = set(itertools.chain(*factors)) - {var}
            cliques.add(tuple(phi_scope | {var}))
            del working_factors[var]
            for variable in phi_scope:
                working_factors[variable].append(list(phi_scope))
            eliminated_variables.add(var)

        edges_comb = [
            itertools.combinations(c, 2) for c in filter(lambda x: len(x) > 1, cliques)
        ]
        return UndirectedGraph(itertools.chain(*edges_comb))

    def induced_width(self, elimination_order):
        induced_graph = self.induced_graph(elimination_order)
        import networkx as nx

        return max(len(clique) for clique in nx.find_cliques(induced_graph)) - 1
