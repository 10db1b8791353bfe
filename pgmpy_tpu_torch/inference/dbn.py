"""DBNInference: interface-algorithm filtering/smoothing for 2-TBNs.

Port of ``pgmpy_tpu/inference/dbn.py``.  The forward pass carries an
*interface potential*, a single factor over the outgoing interface nodes,
through each slice with one fused contraction per step (constant memory in
T); smoothing unrolls the network and runs ``VariableElimination``.

``forward_scan`` is the device program (K10).  The JAX package compiles one
``lax.scan`` over the slices; here, on a CUDA device, ONE launch of the
hand-written ``filter_scan`` kernel (``csrc/einsum_plan.cu``, host tables in
``ops/einsum.py:ScanProgram``) runs every transition slice inside one block:
the contraction of ``[alpha, transition factors]`` to the joint over the
interface and the queries with each marginal read from it (or, where that
joint would pass a block's limit, the ``1 + queries`` planned contractions
the plain version runs), a slice's evidence pinning the observed labels to
its row of codes instead of multiplying deltas, its steps run level by level,
then the normalisations, and alpha carried to the next slice.  The slice-0
work stays on the host (``factor_sum_product``, K3).  On the CPU the plain version
:func:`scan_reference` loops over the slices on the host.  Slice-0 evidence
on an interface variable is kept in alpha as a one-hot mask; the JAX package
reduces it out of the start factors and then raises (a fault fixed in the
port on purpose).
"""

from collections import defaultdict

import numpy as np
import torch

from pgmpy_tpu_torch.config import config, to_numpy
from pgmpy_tpu_torch.factors.discrete import DiscreteFactor
from pgmpy_tpu_torch.factors.factor_ops import factor_sum_product
from pgmpy_tpu_torch.models.dynamic_bn import DynamicBayesianNetwork
from pgmpy_tpu_torch.ops.einsum import ScanProgram, make_axis_map, sum_product_reference


def _shift(var, dt):
    return (var[0], var[1] + dt)


def _evidence_code(key, state, names, card):
    """A state name, or ``int(state)`` as a state index, validated."""
    code = names.index(state) if state in names else int(state)
    if not 0 <= code < card:
        raise ValueError(f"Evidence state {state!r} not valid for {key}")
    return code


def scan_reference(inputs, alpha):
    """Plain version of ``filter_scan`` (``DBNInference._scan_inputs``'
    ``inputs``, the slice-0 interface posterior ``alpha``): a host loop over
    the slices of plain planned contractions (``torch.einsum`` steps), the
    deltas of every slice built on the device before the loop, nothing read
    back inside it -> ``(T - 1, sum of query cards)``."""
    operand_axes, outputs = inputs["operand_axes"], inputs["outputs"]
    trans = list(inputs["trans_arrays"])
    device, dtype = alpha.device, alpha.dtype
    codes = torch.as_tensor(inputs["codes"], device=device)
    # per variable the (T - 1, card) deltas of every slice: a one-hot row
    # where the variable is observed, all ones where it is not
    delta_rows = []
    for j, card in enumerate(inputs["delta_cards"]):
        onehot = torch.nn.functional.one_hot(codes[:, j].clamp_min(0), card)
        delta_rows.append(torch.where(codes[:, j : j + 1] >= 0, onehot.to(dtype),
                                      torch.ones((), dtype=dtype, device=device)))
    rows = []
    for t in range(codes.shape[0]):
        operands = [alpha] + trans + [r[t] for r in delta_rows]
        marginals = []
        for labels in outputs[:-1]:
            m = sum_product_reference(operand_axes, labels, operands)
            marginals.append(m / m.sum())
        alpha = sum_product_reference(operand_axes, outputs[-1], operands)
        alpha = alpha / alpha.sum()
        rows.append(torch.cat(marginals))
    return torch.stack(rows)


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
        self._scan_programs = {}

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

    def _scan_inputs(self, variables, evidence, n_time_slices):
        """What ``forward_scan`` contracts, built on the host: a dict of the
        slice's operand labels (``[alpha] + transition factors + one delta
        per slice-1 variable``), the outputs' labels (each query variable,
        then the slice-1 interface), the transition tables, the cards of the
        deltas, the ``(T - 1, variables)`` evidence codes (-1 unobserved),
        the slice-0 factors with a one-hot mask per observed slice-0
        variable, and the horizon."""
        evidence = {tuple(k): v for k, v in (evidence or {}).items()}
        if n_time_slices is None:
            n_time_slices = max([t for _, t in evidence.keys()] + [1]) + 1

        # transition-slice structure: operands = alpha(interface0) +
        # transition factors + per-variable evidence deltas on slice-1 vars
        trans_scopes = [list(f.variables) for f in self.transition_factors]
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
        outputs = [(var_to_int[(name, 1)],) for name in variables]
        outputs.append(tuple(var_to_int[v] for v in iface1))

        # evidence codes per slice for slice-1 vars, validated on the host
        ev_matrix = np.full((n_time_slices, len(slice1_vars)), -1, dtype=np.int64)
        for (name, t), state in evidence.items():
            v1 = (name, 1)
            if v1 in slice1_vars and 1 <= t < n_time_slices:
                ev_matrix[t, slice1_vars.index(v1)] = _evidence_code(
                    (name, t), state, state_names[v1], cards[v1])
        # slice 0: an observed variable stays in the start factors, masked by
        # a one-hot factor (an observed interface variable is carried on)
        factors0 = list(self.start_factors)
        slice0 = {v for f in self.start_factors for v in f.variables}
        for (name, t), state in evidence.items():
            v0 = (name, 0)
            if t == 0 and v0 in slice0:
                mask = np.zeros(cards[v0])
                mask[_evidence_code((name, t), state, state_names[v0], cards[v0])] = 1.0
                factors0.append(DiscreteFactor([v0], [cards[v0]], mask,
                                               state_names={v0: state_names[v0]}))
        return {
            "operand_axes": operand_axes, "outputs": outputs,
            "trans_arrays": [f.values for f in self.transition_factors],
            "delta_cards": [cards[v] for v in slice1_vars], "codes": ev_matrix[1:],
            "factors0": factors0, "iface0": iface0, "n_time_slices": n_time_slices,
            "alpha_shape": tuple(cards[v] for v in iface0),
            "query_cards": [cards[(name, 1)] for name in variables],
        }

    def _scan_program(self, inputs):
        """The ``filter_scan`` tables of these inputs' signature, built once
        per (outputs, transition strides, dtype) and kept."""
        trans = inputs["trans_arrays"]
        shapes = [inputs["alpha_shape"]] + [tuple(a.shape) for a in trans] + [
            (c,) for c in inputs["delta_cards"]]
        strides = [tuple(a.stride()) for a in trans]
        key = (tuple(inputs["outputs"]), tuple(strides),
               trans[0].dtype if trans else config.DTYPE)
        program = self._scan_programs.get(key)
        if program is None:
            program = ScanProgram(inputs["operand_axes"], inputs["outputs"], shapes, strides,
                                  torch.empty((), dtype=key[2]).element_size())
            self._scan_programs[key] = program
        return program

    def forward_scan(self, variables, evidence=None, n_time_slices=None):
        """Filtering on ``config.DEVICE``: the interface potential carried over
        the slices as a dense tensor, constant memory in T, one readback.

        ``variables``: list of variable NAMES (not (name, t)); filtered
        marginals are returned for every slice: {(name, t): ndarray}.
        ``evidence``: {(name, t): state}, a state name or, for anything that
        is not a state name, ``int(state)`` as a state index; an index
        outside the variable's states raises ``ValueError``.  As in the JAX
        package, evidence at ``t >= 1`` on a name without a slice-1 variable
        is ignored.  Slice-0 evidence on an interface variable is kept in
        alpha as a one-hot mask (the JAX package raises on it).
        """
        return self._forward_scan(variables, evidence, n_time_slices)

    def _forward_scan(self, variables, evidence=None, n_time_slices=None, kernel=True):
        """``forward_scan``; with ``kernel=False`` the plain version runs on a
        CUDA device too (the check of the kernel)."""
        inputs = self._scan_inputs(variables, evidence, n_time_slices)
        n_time_slices = inputs["n_time_slices"]
        factors0 = inputs["factors0"]
        # initial alpha: slice-0 posterior over the interface given slice-0
        # evidence (one-off)
        alpha = factor_sum_product(inputs["iface0"], factors0).normalize(inplace=False).values

        out = {}
        # slice 0 marginals from the start factors
        for name in variables:
            phi = factor_sum_product([(name, 0)], factors0).normalize(inplace=False)
            out[(name, 0)] = np.array(to_numpy(phi.values))
        if n_time_slices > 1 and variables:
            if alpha.device.type == "cuda" and kernel:
                program = self._scan_program(inputs)
                stacked = program.run(alpha, inputs["trans_arrays"], inputs["codes"])
            else:
                stacked = scan_reference(inputs, alpha)
            # one readback: (T - 1, sum of the query cardinalities)
            stacked = np.array(to_numpy(stacked))
            start = 0
            for name, card in zip(variables, inputs["query_cards"]):
                arr = stacked[:, start : start + card]
                start += card
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
