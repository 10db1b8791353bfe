"""The ancestral sweep (K5): every row of a discrete Bayesian network drawn
node after node in topological order.

A sweep walks the nodes in order; per node it forms each row's flat parent
configuration from the row's earlier codes, takes that row of the node's
``(prod(parent cards), card)`` log table and either draws a state (the
exponential race: ``argmax_s(logit_s - log E_s)``, ``E ~ Exp(1)`` clamped at
``1e-20``), keeps a clamp (``given``: one state for every row), or fixes an
evidence state and adds its log probability to the row's log weight.
``partial`` codes ``>= 0`` replace a row's draw before its children are drawn.
A parent index ``d + j`` reads column ``j`` of a ``prev`` code matrix (the
previous slice of the particle filter), and node ``i`` writes column
``columns[i]`` of the output, so one slice of a 2-TBN is a sweep too.

* On a CUDA tensor, the hand-written kernel of ``csrc/ancestral.cu`` (built
  with ``nvcc`` at first use): ONE launch for the whole sweep, a block's rows
  in shared memory, up to ``GROUPS`` threads per row drawing the nodes of one
  level of the topological order at a time (:func:`sweep_groups`), random bits from Philox keyed on
  one 64-bit draw from the call's generator.  A build or launch failure
  raises.
* On a CPU tensor, the plain version :func:`sweep_reference`: a handful of
  torch ops per node, its race noise drawn from the generator node by node
  (``utils/mathext.py:race_noise``).

Both take an explicit ``noise`` tensor in place of the generator: ``log E``
for every (state, row), ``(sum of cards, n)``, node ``i``'s states from row
``noise_offsets[i]``.  On the same noise the kernel and the plain version
give the same codes and log weights, to the bit.

It replaces ``pgmpy_tpu/sampling/core.py:173`` ``_forward``, ``:189``
``_forward_partial`` and ``:208`` ``_likelihood_weighted`` (K5), and
``pgmpy_tpu/sampling/smc.py:101`` ``_sweep`` (K9, the particle filter's
slice).  ``LAUNCHES`` counts the kernel's launches for the ancestral sampler,
``PARTICLE_LAUNCHES`` those for the particle filter's tables (made with
``particle=True``); :func:`reset_launches` zeroes both.
"""

import ctypes

import numpy as np
import torch

from pgmpy_tpu_torch.config import config
from pgmpy_tpu_torch.ops._build import load_library
from pgmpy_tpu_torch.utils.mathext import race_noise

MAX_TILE_ROWS = 128  # rows a block at most (times the groups: at most 1024 threads)
GROUPS = 8  # threads per row at most: each draws its share of a level's nodes
SHARED_BUDGET = 48 * 1024  # a block's tile of codes stays within the default shared memory
_NODE_HEADER = 4  # kHeader in ancestral.cu: card, table offset, noise offset, parent count
DRAW = -1  # a node's mode: drawn; s >= 0: clamped to s; -2 - s: evidence state s

LAUNCHES = 0
PARTICLE_LAUNCHES = 0


def reset_launches():
    global LAUNCHES, PARTICLE_LAUNCHES
    LAUNCHES = 0
    PARTICLE_LAUNCHES = 0


def noise_offsets(cards):
    """Each node's first row in a ``(sum of cards, n)`` noise tensor."""
    return np.concatenate([[0], np.cumsum(cards)[:-1]]).astype(np.int64)


def sweep_groups(n_nodes, n_levels, most):
    """Threads per row of a sweep: as many as the nodes of an average level,
    at most ``most``.  A group with no node in a level only waits at its
    barrier while holding its warp, so fewer groups leave room for more rows
    (ALARM's slice of 37 nodes in 11 levels: 0.194 ms with 4 groups, 0.285
    with 8, on an H100)."""
    return max(1, min(int(most), -(-int(n_nodes) // max(int(n_levels), 1))))


def plan_tile(d, code_bytes, groups=None):
    """(rows a block, codes a tile row, shared bytes) of a sweep over ``d``
    nodes with ``groups`` threads per row (default ``GROUPS``).  A tile row
    is padded to an odd number of 4-byte words (the lanes of a warp reading
    one column then hit distinct banks); a block holds as many rows as
    ``SHARED_BUDGET`` allows, at most ``MAX_TILE_ROWS`` and
    ``1024 // groups``, in whole warps where it holds at least one."""
    groups = GROUPS if groups is None else groups
    row_bytes = -(-max(int(d), 1) * code_bytes // 4) * 4
    if (row_bytes // 4) % 2 == 0:
        row_bytes += 4
    rows = min(MAX_TILE_ROWS, 1024 // groups, SHARED_BUDGET // row_bytes)
    if rows < 1:
        raise ValueError(f"ancestral sweep: a row of {d} codes of {code_bytes} bytes does not fit "
                         f"a block's {SHARED_BUDGET} bytes of shared memory")
    if rows >= 32:
        rows -= rows % 32
    return rows, row_bytes // code_bytes, rows * row_bytes


def level_schedule(parents, loads, groups):
    """(schedule, starts, levels): the nodes level by level (a node's level is
    one more than the highest of its ``parents``, which are earlier nodes;
    roots are level 0), each level's nodes dealt to ``groups`` groups, the
    node of most load (for the sweep: states) first to the group of least
    load so far, each group's nodes in node order; group g of level l holds
    ``schedule[starts[l * groups + g]: starts[l * groups + g + 1]]``."""
    level = np.zeros(len(parents), dtype=np.int64)
    for i, ps in enumerate(parents):
        level[i] = 1 + max((level[p] for p in ps), default=-1)
    n_levels = int(level.max()) + 1 if len(parents) else 0
    schedule, starts = [], [0]
    for lv in range(n_levels):
        members = np.flatnonzero(level == lv)
        load, dealt = np.zeros(groups, dtype=np.int64), [[] for _ in range(groups)]
        for i in sorted(members, key=lambda i: (-loads[i], i)):
            g = int(np.argmin(load))
            dealt[g].append(int(i))
            load[g] += loads[i]
        for g in range(groups):
            schedule.extend(sorted(dealt[g]))
            starts.append(len(schedule))
    return np.asarray(schedule, dtype=np.int32), np.asarray(starts, dtype=np.int32), n_levels


class SweepTables:
    """The host side of a sampler's sweep: the node table the kernel reads
    (one int32 row per node: card, table offset, noise offset, parent count,
    parents, strides; padded to the widest node), each node's output column,
    the level schedule (:func:`level_schedule`, dealt to ``groups`` groups:
    :func:`sweep_groups`) and, per card, the log tables
    concatenated into one flat tensor beside the uploaded node table,
    columns and schedule.

    ``node_specs``: per node in topological order (parents, strides, log
    table ``(rows, card)``); a parent index below ``d`` is a column of the
    sweep's own output, ``d + j`` column ``j`` of the previous slice.
    ``columns``: the output column of each node (default: its position).
    ``particle``: the tables of the particle filter, whose launches
    ``PARTICLE_LAUNCHES`` counts."""

    def __init__(self, node_specs, cards, out_dtype, columns=None, particle=False):
        self.node_specs = node_specs
        self.cards = [int(c) for c in cards]
        self.out_dtype = out_dtype
        self.particle = bool(particle)
        d = len(node_specs)
        self.columns = np.arange(d, dtype=np.int32) if columns is None else \
            np.asarray(columns, dtype=np.int32)
        if sorted(self.columns.tolist()) != list(range(d)):
            raise ValueError("ancestral sweep: the nodes' columns are not a permutation")
        self.has_prev = any(p >= d for ps, _, _ in node_specs for p in ps)
        sizes = [int(t.numel()) for _, _, t in node_specs]
        self.total = int(sum(sizes))
        self.table_offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
        self.noise_offsets = noise_offsets(self.cards)
        self.width = max([len(p) for p, _, _ in node_specs] + [1])
        nodes = np.zeros((len(node_specs), _NODE_HEADER + 2 * self.width), dtype=np.int64)
        nodes[:, 0] = self.cards
        nodes[:, 1] = self.table_offsets
        nodes[:, 2] = self.noise_offsets
        for i, (parents, strides, _) in enumerate(node_specs):
            nodes[i, 3] = len(parents)
            nodes[i, _NODE_HEADER: _NODE_HEADER + len(parents)] = parents
            nodes[i, _NODE_HEADER + self.width: _NODE_HEADER + self.width + len(parents)] = strides
        self.nodes = nodes.astype(np.int32)
        node_of = np.argsort(self.columns)  # the node that writes each column
        parents = [[int(node_of[p]) for p in ps if p < d] for ps, _, _ in node_specs]
        self.groups = sweep_groups(d, level_schedule(parents, self.cards, 1)[2], GROUPS)
        self.schedule, self.starts, self.n_levels = level_schedule(parents, self.cards,
                                                                   self.groups)
        self.device = node_specs[0][2].device if node_specs else config.DEVICE
        self._device = {}

    def modes(self, given=None, evidence=None):
        """The per-call int32 mode of every node: ``DRAW``, a clamp's state,
        or ``-2 - state`` for evidence (a clamp wins).  A state outside its
        node's card raises ``ValueError``."""
        mode = np.full(len(self.cards), DRAW, dtype=np.int64)
        for i, state in (evidence or {}).items():
            mode[i] = -2 - int(state)
        if given is not None:
            given = np.asarray(given, dtype=np.int64)
            mode = np.where(given >= 0, given, mode)
        states = np.where(mode >= 0, mode, -2 - mode)
        if ((mode != DRAW) & ((states < 0) | (states >= np.asarray(self.cards)))).any():
            raise ValueError("ancestral sweep: a clamp or evidence state is outside its node's "
                             "states")
        return mode.astype(np.int32)

    def on(self, device):
        """(flat log tables, one int32 buffer of the node table, the columns,
        the schedule and its starts) on ``device``, made once per device."""
        entry = self._device.get(device)
        if entry is not None:
            torch.cuda.current_stream(device).wait_event(entry[2])
            return entry[:2]
        tables = torch.cat([t.reshape(-1) for _, _, t in self.node_specs]).to(device)
        host = np.concatenate([self.nodes.ravel(), self.columns, self.schedule,
                               self.starts]).astype(np.int32)
        plan = torch.from_numpy(host).pin_memory().to(device, non_blocking=True)
        uploaded = torch.cuda.Event()
        uploaded.record(torch.cuda.current_stream(device))
        self._device[device] = (tables, plan, uploaded)
        return tables, plan


def _library():
    lib = load_library("ancestral", ["ancestral.cu"])
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.pgmpy_ancestral_sweep.argtypes = [
        i64, i32, i32, vp, vp, vp, vp, i32, i32, vp, vp, i32, vp, i32, vp, vp, vp, i64, vp, vp,
        i64, i32, vp, i32, i32, i64, i64, vp]
    lib.pgmpy_ancestral_sweep.restype = ctypes.c_int
    return lib


def _check_noise(noise, sweep, n, dtype, device):
    if noise.device != device or noise.dtype != dtype:
        raise TypeError(f"ancestral sweep: noise must be {dtype} on {device}, got "
                        f"{noise.dtype} on {noise.device}")
    if tuple(noise.shape) != (sum(sweep.cards), n):
        raise ValueError(f"ancestral sweep: noise must be (sum of cards, n) = "
                         f"{(sum(sweep.cards), n)}, got {tuple(noise.shape)}")


def _check_slices(sweep, n, prev, out, device):
    """The previous slice and the output matrix of a sweep that has them."""
    d = len(sweep.cards)
    if sweep.has_prev:
        if prev is None:
            raise ValueError("ancestral sweep: these tables read a previous slice; pass prev")
        if prev.dim() != 2 or prev.shape[0] != d or prev.shape[1] < n or prev.device != device:
            raise ValueError(f"ancestral sweep: prev must be (d, >= n) = ({d}, >= {n}) on "
                             f"{device}, got {tuple(prev.shape)} on {prev.device}")
    if out is not None:
        if (out.dim() != 2 or out.shape[0] != d or out.shape[1] < n or not out.is_contiguous()
                or out.dtype != sweep.out_dtype or out.device != device):
            raise ValueError(f"ancestral sweep: out must be a contiguous column-major "
                             f"{sweep.out_dtype} (d, >= n) = ({d}, >= {n}) on {device}")


def sweep_reference(sweep, n, gen, given=None, partial=None, evidence=None, noise=None,
                    prev=None, out=None):
    """Plain version: one pass over the topological order on
    ``config.DEVICE``; returns (codes, log weights ``(n,)`` in
    ``config.DTYPE`` or None without evidence).  The codes are ``(n, d)`` in
    ``sweep.out_dtype``, columns as ``sweep.columns`` says, or, with ``out``,
    written into ``out[:, :n]`` (column-major ``(d, ld)``), which is returned.

    given: (d,) host ints, -1 = sample, >=0 = clamp to that state for all
    rows (root evidence / do).  partial: (n, d) device ints, entries >= 0
    replace the draw for that row BEFORE children are sampled, so
    descendants condition on the supplied values; clamps take precedence.
    evidence: {node position: state}: the node is fixed to the state and
    ``log p(state | parents)`` is added to the row's log weight.  noise:
    ``log E`` per (state, row) in place of draws from ``gen``.  prev:
    ``(d, >= n)`` codes of the previous slice, read by parent indices
    ``>= d``."""
    device = config.DEVICE
    evidence = evidence or {}
    d = len(sweep.node_specs)
    columns = [None] * d
    if noise is not None:
        _check_noise(noise, sweep, n, sweep.node_specs[0][2].dtype, sweep.device)
    _check_slices(sweep, n, prev, out, sweep.device)
    logw = torch.zeros(n, dtype=config.DTYPE, device=device) if evidence else None
    for i, (parent_idx, strides, log_table) in enumerate(sweep.node_specs):
        col = int(sweep.columns[i])
        clamped = given is not None and given[i] >= 0
        if clamped or i in evidence:
            state = int(given[i]) if clamped else evidence[i]
            columns[col] = torch.full((n,), state, dtype=torch.int64, device=device)
            if clamped:
                continue
        if parent_idx:
            flat = None
            for pi, st in zip(parent_idx, strides):
                value = columns[pi] if pi < d else prev[pi - d, :n].long()
                term = value if st == 1 else value * st
                flat = term if flat is None else flat + term
            logits = log_table.index_select(0, flat)  # (n, card)
        else:
            logits = log_table[0].expand(n, -1)
        if i in evidence:
            logw = logw + logits[:, evidence[i]]
            continue
        if noise is None:
            race = race_noise(logits.shape, gen, logits.dtype)
        else:
            first = int(sweep.noise_offsets[i])
            race = noise[first: first + sweep.cards[i]].t()
        draw = torch.argmax(logits - race, dim=-1)
        if partial is not None:
            draw = torch.where(partial[:, i] >= 0, partial[:, i], draw)
        columns[col] = draw
    if out is not None:
        out[:, :n] = torch.stack(columns).to(sweep.out_dtype)
        return out[:, :n], logw
    return torch.stack(columns, dim=1).to(sweep.out_dtype), logw


def sweep_cuda(sweep, n, gen, given=None, partial=None, evidence=None, noise=None, prev=None,
               out=None):
    """ONE launch of the sweep kernel on the current stream of the
    sampler's card; the arguments and results are those of
    :func:`sweep_reference`.  Without ``noise`` the kernel's Philox key is
    one 64-bit draw from ``gen``.  ``prev`` is read in the output's code type
    (converted if it is not)."""
    global LAUNCHES, PARTICLE_LAUNCHES
    if sweep.total >= 2**31:
        raise ValueError(f"ancestral sweep: the log tables hold {sweep.total} entries, beyond "
                         "the kernel's int32 index")
    device = sweep.device
    if device.type != "cuda":
        raise ValueError("sweep_cuda: the sampler's log tables must be on a CUDA device")
    d = len(sweep.cards)
    mode = sweep.modes(given, evidence)
    code_bytes = torch.empty((), dtype=sweep.out_dtype).element_size()
    rows, stride, shared = plan_tile(d, code_bytes, sweep.groups)
    _check_slices(sweep, n, prev, out, device)
    with torch.cuda.device(device):
        tables, plan = sweep.on(device)
        if noise is not None:
            _check_noise(noise, sweep, n, tables.dtype, device)
            noise = noise.contiguous()
            key = None
        else:
            key = torch.randint(-2**63, 2**63 - 1, (1,), generator=gen, dtype=torch.int64,
                                device=device)
        if partial is not None:
            partial = partial.to(device=device, dtype=torch.int64).contiguous()
            if tuple(partial.shape) != (n, d):
                raise ValueError(f"ancestral sweep: partial must be (n, d) = {(n, d)}")
            if bool((partial >= torch.as_tensor(sweep.cards, device=device)).any()):
                raise ValueError("ancestral sweep: a partial code is outside its node's states")
        if not sweep.has_prev:
            prev = None
        elif prev.dtype != sweep.out_dtype or prev.stride(1) != 1:
            prev = prev[:, :n].to(sweep.out_dtype).contiguous()
        codes = torch.empty((n, d), dtype=sweep.out_dtype, device=device) if out is None else out
        logw = torch.empty(n, dtype=tables.dtype, device=device) if evidence else None
        if n == 0 or d == 0:
            return (codes if out is None else out[:, :n]), logw
        evidence_nodes = np.flatnonzero(mode <= -2).astype(np.int32)
        call = torch.from_numpy(np.concatenate([mode, evidence_nodes])).pin_memory().to(
            device, non_blocking=True)
        columns = plan.data_ptr() + 4 * sweep.nodes.size
        schedule = columns + 4 * sweep.columns.size
        err = _library().pgmpy_ancestral_sweep(
            n, d, sweep.width, plan.data_ptr(), columns, schedule,
            schedule + 4 * sweep.schedule.size, sweep.n_levels, sweep.groups, call.data_ptr(),
            call.data_ptr() + 4 * d, evidence_nodes.size, tables.data_ptr(),
            tables.element_size(), 0 if partial is None else partial.data_ptr(),
            0 if noise is None else noise.data_ptr(), 0 if prev is None else prev.data_ptr(),
            0 if prev is None else prev.stride(0), 0 if key is None else key.data_ptr(),
            codes.data_ptr(), 0 if out is None else out.shape[1], code_bytes,
            0 if logw is None else logw.data_ptr(), stride, rows * sweep.groups, -(-n // rows),
            shared,
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ancestral sweep launch failed: cudaError_t {err}")
    if sweep.particle:
        PARTICLE_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return (codes if out is None else out[:, :n]), logw


def sweep(sweep_tables, n, gen, given=None, partial=None, evidence=None, noise=None, prev=None,
          out=None):
    """Dispatch on the sampler's log tables: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    device = sweep_tables.device
    if device.type == "cuda":
        return sweep_cuda(sweep_tables, n, gen, given, partial, evidence, noise, prev, out)
    if device.type == "cpu":
        return sweep_reference(sweep_tables, n, gen, given, partial, evidence, noise, prev, out)
    raise ValueError(f"ancestral sweep: unsupported device {device}")
