"""DBNInference: interface-algorithm filtering/smoothing for 2-TBNs.

Port of ``pgmpy_tpu/inference/dbn.py``.  The forward pass carries an
*interface potential*, a single factor over the outgoing interface nodes,
through each slice with one fused contraction per step (constant memory in
T); smoothing unrolls the network and runs ``VariableElimination``.

``forward_scan`` is the device program.  The JAX package compiles one
``lax.scan`` over the slices; here it is a host loop over slices of torch ops
on ``config.DEVICE``, and that is the divergence on purpose: the contraction
of ``[alpha, transition factors, evidence deltas]`` is planned once
(``ops/einsum.py:sum_product_planned`` caches the plan on the operands'
shapes, which are the same at every slice), the ``(T - 1, card)`` delta
matrices of all slices are built on the device before the loop, nothing is
read back inside the loop, and the stacked marginals come back in one copy
at the end.
"""

from collections import defaultdict

import numpy as np
import torch

from pgmpy_tpu_torch.config import config, to_numpy
from pgmpy_tpu_torch.factors.factor_ops import factor_sum_product
from pgmpy_tpu_torch.models.dynamic_bn import DynamicBayesianNetwork
from pgmpy_tpu_torch.ops.einsum import make_axis_map, sum_product_planned


def _shift(var, dt):
    return (var[0], var[1] + dt)


class DBNInference:
    def __init__(self, model):
        if not isinstance(model, DynamicBayesianNetwork):
            raise ValueError(f"model must be a DynamicBayesianNetwork. Got: {type(model)}")
        model.check_model()
        self.model = model
        self.interface_nodes_0 = sorted(set(model.get_interface_nodes(0)), key=str)
        self.interface_nodes_1 = [(v, 1) for v, _ in self.interface_nodes_0]

        # slice-0 factors and transition (slice-1) factors
        self.start_factors = [
            cpd.to_factor() for cpd in model.get_cpds(time_slice=0)
        ]
        self.transition_factors = [
            cpd.to_factor() for cpd in model.get_cpds(time_slice=1)
        ]
        self.slice0_vars = sorted(set(model.get_slice_nodes(0)), key=str)

    @staticmethod
    def _apply_evidence(factors, evidence):
        if not evidence:
            return factors
        out = []
        for phi in factors:
            sliced = [(v, s) for v, s in evidence.items() if v in phi.variables]
            if sliced:
                phi = phi.reduce(sliced, inplace=False, show_warnings=False)
            if phi.variables:
                out.append(phi)
        return out

    def forward_inference(self, variables, evidence=None, args=None):
        """Filtering: P(variables | evidence up to their time slices).

        ``variables``/``evidence`` use (name, t) keys with arbitrary t.
        Returns {variable: DiscreteFactor}.
        """
        variables = [tuple(v) for v in variables]
        evidence = {tuple(k): v for k, v in (evidence or {}).items()}
        max_t = max(
            [t for _, t in variables]
            + [t for _, t in evidence.keys()]
            + [0]
        )

        # evidence grouped by slice
        ev_by_slice = defaultdict(dict)
        for (name, t), state in evidence.items():
            ev_by_slice[t][(name, t)] = state
        query_by_slice = defaultdict(list)
        for name, t in variables:
            query_by_slice[t].append((name, t))

        results = {}
        alpha = None  # carried interface potential over interface_nodes_0
        for t in range(max_t + 1):
            if t == 0:
                factors = list(self.start_factors)
            else:
                # shift transition factors into slice coordinates (0 = t-1)
                factors = list(self.transition_factors)
                if alpha is not None:
                    factors.append(alpha)

            # slice-local evidence (translate to local coordinates)
            local_ev = {}
            for (name, et), state in ev_by_slice[t].items():
                local_ev[(name, 0 if t == 0 else 1)] = state
            factors = self._apply_evidence(factors, local_ev)

            # answer queries for this slice
            local_queries = [
                (name, 0 if t == 0 else 1) for name, _ in query_by_slice[t]
            ]
            for (name, orig_t), local in zip(query_by_slice[t], local_queries):
                phi = factor_sum_product([local], factors).normalize(inplace=False)
                out = phi.copy()
                out.variables = [(name, orig_t)]
                out.state_names = {(name, orig_t): phi.state_names[local]}
                out.name_to_no = {(name, orig_t): phi.name_to_no[local]}
                out.no_to_name = {(name, orig_t): phi.no_to_name[local]}
                results[(name, orig_t)] = out

            # propagate: marginalize everything but the outgoing interface
            if t < max_t:
                out_interface = (
                    self.interface_nodes_0 if t == 0 else self.interface_nodes_1
                )
                alpha = factor_sum_product(out_interface, factors).normalize(
                    inplace=False
                )
                # relabel interface(1) -> interface(0) for the next slice
                relabel = {
                    iv: (iv[0], 0) for iv in alpha.variables
                }
                new_vars = [relabel[v] for v in alpha.variables]
                alpha.state_names = {
                    relabel[v]: alpha.state_names[v] for v in alpha.variables
                }
                alpha.name_to_no = {
                    relabel[v]: alpha.name_to_no[v] for v in alpha.variables
                }
                alpha.no_to_name = {
                    relabel[v]: alpha.no_to_name[v] for v in alpha.variables
                }
                alpha.variables = new_vars
        return results

    def forward_scan(self, variables, evidence=None, n_time_slices=None):
        """Filtering on ``config.DEVICE``: a loop over time slices with the
        interface potential carried as a dense tensor, constant memory in T
        and no host read inside the loop.

        ``variables``: list of variable NAMES (not (name, t)); filtered
        marginals are returned for every slice: {(name, t): ndarray}.
        ``evidence``: {(name, t): state}, a state name or, for anything that
        is not a state name, ``int(state)`` as a state index; an index
        outside the variable's states raises ``ValueError``.  As in the JAX
        package, evidence at ``t >= 1`` on a name without a slice-1 variable
        is ignored.
        """
        evidence = {tuple(k): v for k, v in (evidence or {}).items()}
        if n_time_slices is None:
            n_time_slices = max([t for _, t in evidence.keys()] + [1]) + 1

        # transition-slice structure: operands = alpha(interface0) +
        # transition factors + per-variable evidence deltas on slice-1 vars
        trans_scopes = [list(f.variables) for f in self.transition_factors]
        trans_arrays = [f.values for f in self.transition_factors]
        slice1_vars = sorted({(v[0], 1) for f in self.transition_factors for v in f.variables if v[1] == 1}, key=str)
        iface0 = list(self.interface_nodes_0)
        iface1 = [(v, 1) for v, _ in iface0]

        cards = {}
        state_names = {}
        for f in self.transition_factors + self.start_factors:
            for v, c in zip(f.variables, f.cardinality):
                cards[v] = int(c)
                state_names[v] = f.state_names[v]

        all_scopes = [iface0] + trans_scopes + [[v] for v in slice1_vars]
        var_to_int, operand_axes = make_axis_map(all_scopes)

        def contract(alpha, deltas, out_vars):
            # one cached plan per output: the operands' shapes never change
            return sum_product_planned(
                operand_axes, [var_to_int[v] for v in out_vars], [alpha] + trans_arrays + deltas
            )

        # evidence codes per slice for slice-1 vars, validated on the host
        ev_matrix = np.full((n_time_slices, len(slice1_vars)), -1, dtype=np.int64)
        for (name, t), state in evidence.items():
            v1 = (name, 1)
            if v1 in slice1_vars and 1 <= t < n_time_slices:
                names = state_names[v1]
                code = names.index(state) if state in names else int(state)
                if not 0 <= code < cards[v1]:
                    raise ValueError(f"Evidence state {state!r} not valid for {(name, t)}")
                ev_matrix[t, slice1_vars.index(v1)] = code
        # per variable the (T - 1, card) deltas of every slice: a one-hot row
        # where the variable is observed, all ones where it is not
        codes = torch.as_tensor(ev_matrix[1:], device=config.DEVICE)
        delta_rows = []
        for j, v in enumerate(slice1_vars):
            onehot = torch.nn.functional.one_hot(codes[:, j].clamp_min(0), cards[v])
            delta_rows.append(torch.where(
                codes[:, j : j + 1] >= 0, onehot.to(config.DTYPE),
                torch.ones((), dtype=config.DTYPE, device=config.DEVICE),
            ))

        # initial alpha: slice-0 posterior over the interface given slice-0
        # evidence (one-off)
        factors0 = self._apply_evidence(
            list(self.start_factors),
            {(n, 0): s for (n, t), s in evidence.items() if t == 0},
        )
        alpha = factor_sum_product(iface0, factors0).normalize(inplace=False).values

        query_vars1 = [(name, 1) for name in variables]
        marg_rows = [[] for _ in query_vars1]
        for t in range(n_time_slices - 1):
            deltas = [rows[t] for rows in delta_rows]
            # filtered marginals for the query vars at this slice
            for qi, q in enumerate(query_vars1):
                m = contract(alpha, deltas, [q])
                marg_rows[qi].append(m / m.sum())
            alpha = contract(alpha, deltas, iface1)
            alpha = alpha / alpha.sum()

        out = {}
        # slice 0 marginals from the start factors
        for name in variables:
            phi = factor_sum_product([(name, 0)], factors0).normalize(inplace=False)
            out[(name, 0)] = np.array(to_numpy(phi.values))
        if n_time_slices > 1 and variables:
            # one readback: (T - 1, sum of the query cardinalities)
            stacked = np.array(to_numpy(torch.cat([torch.stack(rows) for rows in marg_rows], dim=1)))
            start = 0
            for name in variables:
                arr = stacked[:, start : start + cards[(name, 1)]]
                start += cards[(name, 1)]
                for t in range(1, n_time_slices):
                    out[(name, t)] = arr[t - 1]
        return out

    def backward_inference(self, variables, evidence=None):
        """Smoothing: P(variables | ALL evidence).  Implemented by unrolling
        to the constant BN and running VariableElimination (exact; simple and
        correct for moderate horizons)."""
        from pgmpy_tpu_torch.inference.ve import VariableElimination

        variables = [tuple(v) for v in variables]
        evidence = {tuple(k): v for k, v in (evidence or {}).items()}
        max_t = max(
            [t for _, t in variables] + [t for _, t in evidence.keys()] + [1]
        )
        bn = self._unrolled(max_t + 1)
        infer = VariableElimination(bn)
        str_ev = {f"{k[0]}_{k[1]}": v for k, v in evidence.items()}
        results = {}
        for name, t in variables:
            phi = infer.query([f"{name}_{t}"], evidence=str_ev, show_progress=False)
            out = phi.copy()
            out.variables = [(name, t)]
            out.state_names = {(name, t): phi.state_names[f"{name}_{t}"]}
            out.name_to_no = {(name, t): phi.name_to_no[f"{name}_{t}"]}
            out.no_to_name = {(name, t): phi.no_to_name[f"{name}_{t}"]}
            results[(name, t)] = out
        return results

    def _unrolled(self, n_slices):
        first = self.model.get_constant_bn(0)
        bn = first
        for t in range(1, max(n_slices - 1, 1)):
            shifted = self.model.get_constant_bn(t)
            for edge in shifted.edges():
                if not bn.has_edge(*edge):
                    bn.add_edge(*edge)
            for cpd in shifted.cpds:
                if bn.get_cpds(cpd.variable) is None:
                    bn.add_cpds(cpd)
        return bn

    def query(self, variables, evidence=None, args="exact"):
        """Posterior over ``variables`` given all evidence (smoothing)."""
        return self.backward_inference(variables, evidence)
