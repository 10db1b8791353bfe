"""Loopy belief propagation's flooding engine (K7): every round of a query,
until the messages converge or ``max_iter`` rounds have run.

Edge ``e`` is the e-th ``(factor, variable)`` incidence in factor order;
messages are ``(E, C)`` tensors (``C`` the largest cardinality) whose entries
beyond an edge's cardinality stay 0.  A round:

* variable -> factor: the fixed message times the product of the variable's
  OTHER incoming factor -> variable messages, taken in log space (each
  incoming message's log first shifted to a largest entry of 0, the sum's
  row maximum subtracted before ``exp``: a hub of hundreds of factors does
  not underflow), normalised;
* factor -> variable: per edge ``(f, k)``, the table of ``f`` times the
  variable -> factor messages of its other positions, summed down to axis
  ``k``, normalised;
* delta: the largest absolute change of any ``(E, C)`` entry.  Rounds run
  while ``rounds < max_iter`` and the last delta is not below ``tol``.

* On a CUDA tensor, :func:`flood_cuda`: ONE cooperative launch of the
  hand-written kernel of ``csrc/loopy_bp.cu`` (built with ``nvcc`` at first
  use) runs every round, a grid-wide barrier after each phase, and leaves
  the messages, the round count and the last delta on the card.  It reads
  the tables of a :class:`FloodPlan` at their true shapes (CSR rows of each
  variable's edges; each factor's table in one flat arena).  A build or
  launch failure raises, as does a factor of more than ``MAX_ARITY``
  variables.
* On a CPU tensor, the plain version :func:`flood_reference`: a few torch
  ops a round (factors bucketed by their power-of-two padded shape, the
  exclusive product through a padded neighbour table, the factor step
  through ``einsum.sum_product_reference``), one host read of the delta a
  round.  It runs on a CUDA tensor too, as the card's oracle, and launches
  no kernel of K3 there.

It replaces ``pgmpy_tpu/inference/fg_bp.py:148`` ``round_fn`` and ``:188``
``engine`` (its ``lax.while_loop`` ``:199``).  ``LAUNCHES`` counts the
kernel's launches; :func:`reset_launches` zeroes it.
"""

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from pgmpy_tpu_torch.ops._build import load_library
from pgmpy_tpu_torch.ops.einsum import sum_product_reference

MAX_ARITY = 16  # the digits of a factor's table a thread holds
EDGE_WORDS, FACTOR_WORDS = 4, 3  # int32 words per edge row and per factor row
HBM_BYTES_PER_S = 3.35e12  # published peak of one H100 SXM
PLAIN_OPS_PER_S = 67e12  # its float32 rate outside the tensor cores

LAUNCHES = 0


def reset_launches():
    global LAUNCHES
    LAUNCHES = 0


class Flood(NamedTuple):
    """A flood's result, on the messages' device: the factor -> variable
    messages ``(E, C)``, the rounds run (int32, 0-d) and the last round's
    delta (0-d, ``inf`` after no round)."""

    f2v: torch.Tensor
    rounds: torch.Tensor
    delta: torch.Tensor


def check_arity(plan):
    """Raise unless every factor of ``plan`` has at most ``MAX_ARITY``
    variables, the kernel's limit."""
    widest = int(plan.factor_arity.max())
    if widest > MAX_ARITY:
        raise ValueError(f"loopy flood: a factor of {widest} variables; the kernel takes at most "
                         f"MAX_ARITY = {MAX_ARITY}")


class FloodPlan:
    """The index tables of flooding BP on a factor graph, built once on the
    host from ``factor_scopes`` and ``cardinality``.

    For the kernel, at true shapes: each variable's edges as CSR
    (``var_offsets``, ``var_ids``, in the order ``var_edges`` lists them);
    per edge its factor, cardinality, stride in the factor's table and
    variable row (``edge_rows``, ``(E, 4)``); per factor its table offset in
    the flat arena, arity and first edge (``factor_rows``, ``(F, 3)``; the
    edges of a factor are consecutive, in scope order).

    For the plain version: factors bucketed by their power-of-two padded
    shape (``groups``: shape, factors, edge ids ``(F_g, arity)``), the
    inverse permutation of the buckets' outputs, and the padded neighbour
    table (:meth:`nbr`, built at first use: it holds ``E x (largest degree -
    1)`` entries)."""

    def __init__(self, factor_scopes, cardinality):
        self.edges = []
        for fi, scope in enumerate(factor_scopes):
            for var in scope:
                self.edges.append((fi, var))
        E = len(self.edges)
        self.n_edges, self.n_factors = E, len(factor_scopes)
        self.max_card = C = max(int(c) for c in cardinality.values())
        self.cards = np.array([int(cardinality[var]) for _, var in self.edges], dtype=np.int64)
        self.mask = np.arange(C)[None, :] < self.cards[:, None]

        self.var_edges = {}
        for e, (_, var) in enumerate(self.edges):
            self.var_edges.setdefault(var, []).append(e)
        row_of = {var: i for i, var in enumerate(self.var_edges)}
        degrees = [len(v) for v in self.var_edges.values()]
        self.var_offsets = np.concatenate([[0], np.cumsum(degrees)]).astype(np.int64)
        self.var_ids = np.array([e for v in self.var_edges.values() for e in v], dtype=np.int64)

        scope_cards = [[int(cardinality[v]) for v in scope] for scope in factor_scopes]
        arity = np.array([len(s) for s in factor_scopes], dtype=np.int64)
        sizes = np.array([int(np.prod(c, dtype=np.int64)) for c in scope_cards], dtype=np.int64)
        self.factor_arity = arity
        self.factor_first = np.concatenate([[0], np.cumsum(arity)[:-1]]).astype(np.int64)
        self.factor_offset = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
        self.arena_size = int(sizes.sum())
        self.table_shapes = [tuple(c) for c in scope_cards]
        strides = [np.cumprod([1] + c[::-1][:-1])[::-1] if c else [] for c in scope_cards]
        self.edge_factor = np.repeat(np.arange(len(factor_scopes)), arity)
        self.edge_stride = np.array([s for st in strides for s in st], dtype=np.int64)
        self.edge_var = np.array([row_of[var] for _, var in self.edges], dtype=np.int64)
        self.edge_rows = np.stack([self.edge_factor, self.cards, self.edge_stride, self.edge_var],
                                  axis=1).reshape(E, EDGE_WORDS)
        self.factor_rows = np.stack([self.factor_offset, arity, self.factor_first], axis=1)

        groups = {}
        for fi, cards in enumerate(scope_cards):
            groups.setdefault(tuple(1 << max(0, (c - 1).bit_length()) for c in cards), []).append(fi)
        self.groups = []
        out_edge_order = []
        for shape in sorted(groups):
            fis = groups[shape]
            eidx = (self.factor_first[fis][:, None] + np.arange(len(shape))[None, :]).astype(np.int64)
            out_edge_order.extend(eidx.T.reshape(-1).tolist())
            self.groups.append((shape, fis, eidx))
        self.inv_perm = np.empty(E, dtype=np.int64)
        self.inv_perm[np.asarray(out_edge_order, dtype=np.int64)] = np.arange(E)
        self._nbr = None
        self._device = {}

    def nbr(self):
        """Per edge, the other edges into the same variable, padded with
        ``E`` (a row of zeros appended to the log-messages, log 1)."""
        if self._nbr is None:
            E = self.n_edges
            D = max(max((len(v) for v in self.var_edges.values()), default=1) - 1, 1)
            nbr = np.full((E, D), E, dtype=np.int64)
            for edges in self.var_edges.values():
                for e in edges:
                    others = [e2 for e2 in edges if e2 != e]
                    nbr[e, : len(others)] = others
            self._nbr = nbr
        return self._nbr

    def host_words(self):
        """One int32 buffer: the edge rows, the factor rows, the CSR
        offsets and edge ids; and the word offset of each part."""
        parts = [self.edge_rows.ravel(), self.factor_rows.ravel(), self.var_offsets, self.var_ids]
        starts = np.concatenate([[0], np.cumsum([p.size for p in parts])[:-1]])
        return np.concatenate(parts).astype(np.int32), [int(s) for s in starts]

    def on(self, device, plain=False):
        """The plan's tables on ``device``, uploaded once: for the kernel the
        int32 buffer (:meth:`host_words`) and its part offsets; with
        ``plain`` the plain version's ``nbr``, bucket edge ids and
        ``inv_perm``."""
        key = (device, plain)
        if key not in self._device:
            if plain:
                self._device[key] = (torch.from_numpy(self.nbr()).to(device),
                                     [torch.from_numpy(eidx).to(device)
                                      for _, _, eidx in self.groups],
                                     torch.from_numpy(self.inv_perm).to(device))
            else:
                words, starts = self.host_words()
                self._device[key] = (torch.from_numpy(words).to(device), starts)
        return self._device[key]

    def build_tables(self, factor_values, dtype, device):
        """:class:`FloodTables` of the factors' current values, in ``dtype``
        on ``device``."""
        arena = torch.cat([torch.as_tensor(v, device=device).reshape(-1) for v in factor_values])
        if arena.numel() != self.arena_size:
            raise ValueError(f"loopy flood: the factors hold {arena.numel()} entries, their "
                             f"scopes {self.arena_size}")
        return FloodTables(self, arena.to(dtype), factor_values)


class FloodTables:
    """The factor tables of one flood: ``arena``, every table at its true
    shape in factor order (the kernel's input), and :meth:`padded`, the
    plain version's tables stacked per bucket and zero-padded to its shape,
    built from the factors' values at first use."""

    def __init__(self, plan, arena, factor_values):
        self.plan, self.arena = plan, arena
        self._values = factor_values
        self._padded = None

    def padded(self):
        if self._padded is None:
            out = []
            for shape, fis, _ in self.plan.groups:
                rows = []
                for fi in fis:
                    vals = torch.as_tensor(self._values[fi], device=self.arena.device)
                    vals = vals.to(self.arena.dtype).reshape(self.plan.table_shapes[fi])
                    pad = []
                    for size, full in zip(reversed(vals.shape), reversed(shape)):
                        pad += [0, full - size]
                    rows.append(torch.nn.functional.pad(vals, pad) if any(pad) else vals)
                out.append(torch.stack(rows))
            self._padded = out
        return self._padded


def _plan(plan_or_program):
    return getattr(plan_or_program, "plan", plan_or_program)


def _check(plan, fixed, f2v_init, tables):
    shape = (plan.n_edges, plan.max_card)
    dtype, device = tables.arena.dtype, tables.arena.device
    for name, t in (("fixed", fixed), ("f2v_init", f2v_init)):
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != device:
            raise ValueError(f"loopy flood: {name} must be {dtype} {shape} on {device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


# ---------------------------------------------------------------------- #
# the plain version
# ---------------------------------------------------------------------- #
def _normalize(msgs):
    total = torch.sum(msgs, dim=-1, keepdim=True)
    return torch.where(total > 0, msgs / torch.where(total > 0, total, 1.0), msgs)


def centered_log(msgs):
    """``log`` of each row of ``msgs`` minus the row's largest finite entry:
    a per-row constant, which the normalisation cancels, that keeps a sum of
    hundreds of near-uniform messages' logs near 0 instead of near -400."""
    logs = torch.log(msgs)
    top = torch.amax(logs, dim=-1, keepdim=True)
    return logs - torch.where(torch.isfinite(top), top, torch.zeros_like(top))


def log_product(logs, dim):
    """``exp`` of the sum of ``logs`` over ``dim`` after subtracting each
    row's finite maximum, normalised over the last axis."""
    total = logs.sum(dim=dim)
    shift = torch.amax(total, dim=-1, keepdim=True)
    shift = torch.where(torch.isfinite(shift), shift, torch.zeros_like(shift))
    return _normalize(torch.exp(total - shift))


def flood_round_reference(plan_or_program, f2v, log_fixed, tables):
    """One flooding round of the plain version: (new factor -> variable
    messages, the largest change of any entry), in the messages' dtype."""
    plan = _plan(plan_or_program)
    C = plan.max_card
    nbr, eidxs, inv_perm = plan.on(f2v.device, plain=True)
    logs = torch.cat([centered_log(f2v), f2v.new_zeros((1, C))])
    # variable -> factor: the exclusive product, in log space
    v2f = log_product(torch.cat([logs[nbr], log_fixed[:, None, :]], dim=1), dim=1)
    outs = []
    for (shape, _, _), eidx, table in zip(plan.groups, eidxs, tables.padded()):
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
            out_k = sum_product_reference(axes, (0, k + 1), operands)
            if shape[k] < C:
                out_k = torch.nn.functional.pad(out_k, (0, C - shape[k]))
            elif shape[k] > C:
                out_k = out_k[:, :C]
            outs.append(out_k)
    new_f2v = _normalize(torch.cat(outs)[inv_perm])
    return new_f2v, torch.max(torch.abs(new_f2v - f2v))


def flood_reference(plan_or_program, fixed, f2v_init, tables, max_iter, tol):
    """Plain version: flood from ``f2v_init`` (masked to each edge's
    cardinality) with the fixed messages ``fixed`` (both ``(E, C)`` in the
    tables' dtype on their device) until the delta falls below ``tol`` or
    ``max_iter`` rounds; one host read of the delta a round."""
    plan = _plan(plan_or_program)
    _check(plan, fixed, f2v_init, tables)
    mask = torch.from_numpy(plan.mask).to(fixed.device)
    f2v = f2v_init * mask
    delta = torch.full((), float("inf"), dtype=fixed.dtype, device=fixed.device)
    log_fixed = torch.log(fixed)
    rounds = 0
    while rounds < max_iter:
        f2v, delta = flood_round_reference(plan, f2v, log_fixed, tables)
        rounds += 1
        if float(delta) < tol:
            break
    return Flood(f2v, torch.tensor(rounds, dtype=torch.int32, device=fixed.device), delta)


# ---------------------------------------------------------------------- #
# the kernel
# ---------------------------------------------------------------------- #
def _library():
    lib = load_library("loopy_bp", ["loopy_bp.cu"])
    vp, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.pgmpy_loopy_flood.argtypes = [i32, i32, i32] + [vp] * 14 + [i32, f64, vp]
    lib.pgmpy_loopy_flood.restype = ctypes.c_int
    return lib


def flood_cuda(plan_or_program, fixed, f2v_init, tables, max_iter, tol):
    """ONE cooperative launch of the flooding kernel on the current stream of
    the tables' card; the arguments and result are those of
    :func:`flood_reference`, and nothing is read back."""
    global LAUNCHES
    plan = _plan(plan_or_program)
    _check(plan, fixed, f2v_init, tables)
    device = tables.arena.device
    if device.type != "cuda":
        raise ValueError(f"loopy flood_cuda: the tables must be on a CUDA device, got {device}")
    check_arity(plan)
    E, C = plan.n_edges, plan.max_card
    if E * C >= 2**31 or plan.arena_size >= 2**31:
        raise ValueError(f"loopy flood: {E} x {C} messages or {plan.arena_size} table entries, "
                         "beyond the kernel's int32 index")
    max_iter = int(max_iter)
    with torch.cuda.device(device):
        dtype = fixed.dtype
        out = torch.empty((E, C), dtype=dtype, device=device)
        rounds = torch.empty((), dtype=torch.int32, device=device)
        delta = torch.empty((), dtype=dtype, device=device)
        words, starts = plan.on(device)
        fixed, f2v_init = fixed.contiguous(), f2v_init.contiguous()
        scratch = torch.empty((3, E, C), dtype=dtype, device=device)
        deltas = torch.empty(max(max_iter, 1), dtype=dtype, device=device)
        ptr = words.data_ptr()
        err = _library().pgmpy_loopy_flood(
            fixed.element_size(), E, C, *(ptr + 4 * s for s in starts), tables.arena.data_ptr(),
            fixed.data_ptr(), f2v_init.data_ptr(), out.data_ptr(), scratch[0].data_ptr(),
            scratch[1].data_ptr(), scratch[2].data_ptr(), deltas.data_ptr(), rounds.data_ptr(),
            delta.data_ptr(), max_iter, float(tol), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"loopy flood launch failed: cudaError_t {err}")
    LAUNCHES += 1
    return Flood(out, rounds, delta)


def flood(plan_or_program, fixed, f2v_init, tables, max_iter, tol):
    """Dispatch on the tables' device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    device = tables.arena.device
    if device.type == "cuda":
        return flood_cuda(plan_or_program, fixed, f2v_init, tables, max_iter, tol)
    if device.type == "cpu":
        return flood_reference(plan_or_program, fixed, f2v_init, tables, max_iter, tol)
    raise ValueError(f"loopy flood: unsupported device {device}")


# ---------------------------------------------------------------------- #
# bound
# ---------------------------------------------------------------------- #
def round_operations(plan):
    """Operations of one round: per edge, an add per (other edge of its
    variable, state) and a few per state (the fixed log, the shift, exp,
    the normalisation, the centred log); per edge ``(f, k)``, a multiply
    per other position and an add for every entry of ``f``'s table."""
    degree = np.diff(plan.var_offsets)[plan.edge_var]
    sizes = np.array([int(np.prod(s, dtype=np.int64)) for s in plan.table_shapes],
                     dtype=np.int64)
    per_factor = sizes * plan.factor_arity * plan.factor_arity  # arity edges, arity ops an entry
    return int(plan.max_card * (degree - 1 + 6).sum() + per_factor.sum())


def bound_ms(plan, rounds, dtype):
    """(bound_ms, bound_by) of a flood of ``rounds`` rounds on one H100.

    Bytes at 3.35 TB/s: the plan's int32 tables, the factor tables, the
    fixed and the initial messages read once a flood (they do not change
    between rounds, and the whole working set fits in the card's 50 MB L2);
    and each round the messages read and the new messages written, since
    every block writes its edges' messages and other blocks read them after
    the grid barrier.  Operations: ``rounds`` times :func:`round_operations`
    at 67e12 per second.  The longer of the two."""
    elem = torch.empty((), dtype=dtype).element_size()
    words = plan.edge_rows.size + plan.factor_rows.size + plan.var_offsets.size + plan.var_ids.size
    messages = elem * plan.n_edges * plan.max_card
    nbytes = 4 * words + elem * plan.arena_size + 2 * messages + rounds * 2 * messages
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = rounds * round_operations(plan) / PLAIN_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")
