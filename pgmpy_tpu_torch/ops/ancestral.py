"""The ancestral sweep (K5): every row of a discrete Bayesian network drawn
node after node in topological order.

A sweep walks the nodes in order; per node it forms each row's flat parent
configuration from the row's earlier codes and either draws a state from
that row of the node's CDF table (the inverse CDF: one uniform ``u`` in
``[0, 1)`` per row and node, the state the count of the row's cumulative
probabilities at or below ``u``; :func:`cdf_rows`), keeps a clamp
(``given``: one state for every row), or fixes an evidence state and adds
its log probability, from the node's ``(prod(parent cards), card)`` log
table, to the row's log weight.
``partial`` codes ``>= 0`` replace a row's draw before its children are drawn.
A parent index ``d + j`` reads column ``j`` of a ``prev`` code matrix (the
previous slice of the particle filter), and node ``i`` writes column
``columns[i]`` of the output, so one slice of a 2-TBN is a sweep too.

* On a CUDA tensor, the hand-written kernel of ``csrc/ancestral.cu`` (built
  with ``nvcc`` at first use): ONE launch for the whole sweep, a block's rows
  in shared memory (:func:`plan_tile`), up to ``GROUPS`` threads per row
  drawing the nodes of one level of the topological order at a time
  (:func:`sweep_groups`), the uniforms from Philox keyed on one 64-bit draw
  from the call's generator.  A build or launch failure raises.
* On a CPU tensor, the plain version :func:`sweep_reference`: a handful of
  torch ops per node, its uniforms drawn from the generator node by node.

Both take an explicit ``noise`` tensor in place of the generator: the
uniforms, ``(d, n)`` float64, node ``i``'s in row ``i``.  On the same noise
the kernel and the plain version give the same codes and log weights, to the
bit.

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

MAX_TILE_ROWS = 128  # rows a block at most (times the groups: at most 1024 threads)
GROUPS = 8  # threads per row at most: each draws its share of a level's nodes
SHARED_LIMIT = 227 * 1024  # a block's shared memory at most (past 48 KB it opts in)
SM_SHARED = 228 * 1024  # a multiprocessor's shared memory (H100)
BLOCK_RESERVED = 1024  # the shared memory the card keeps for each resident block
SM_THREADS = 2048  # threads a multiprocessor holds at once
SM_BLOCKS = 32  # blocks a multiprocessor holds at once
SM_REGISTERS = 65536  # a multiprocessor's 32-bit registers
REGISTERS = 48  # the sweep kernel's registers a thread (ptxas, every instantiation), off the card
SMS = 132  # multiprocessors of an H100 SXM, when no card is asked
DRAW_COST = 4  # a draw's Philox block and flat row, in reads of two states
STAGE_BYTES = 8 * 1024  # a block's two stage buffers of node rows and modes at most
# kHeader in ancestral.cu: card, log table offset, CDF offset, parent count, column, node
_NODE_HEADER = 6
CDF_PAD = 2.0  # past a row's states: above every uniform
DRAW = -1  # a node's mode: drawn; s >= 0: clamped to s; -2 - s: evidence state s

LAUNCHES = 0
PARTICLE_LAUNCHES = 0


def reset_launches():
    global LAUNCHES, PARTICLE_LAUNCHES
    LAUNCHES = 0
    PARTICLE_LAUNCHES = 0


def noise_offsets(cards):
    """Each variable's first row in a ``(sum of cards, n)`` noise tensor (the
    Gibbs sweep's race noise)."""
    return np.concatenate([[0], np.cumsum(cards)[:-1]]).astype(np.int64)


def cdf_rows(log_table):
    """The ``(rows, pairs, 2)`` float64 CDF table of a ``(rows, card)`` log
    table: per row the running sum of the probabilities over the states,
    divided by the row's total, each row padded to an even count with
    ``CDF_PAD``.  A state at the log clamp of a zero probability
    (``log(1e-38)`` in the table's type) counts 0, so its cumulative value is
    the state before it (0 for the first) and no uniform picks it over a
    state of mass; the last state with mass is exactly 1.  A row with no mass
    is uniform, as a race over equal logits is.  The draw of a uniform ``u``
    is the count of a row's entries at or below ``u``."""
    logs = log_table.detach().cpu()
    clamp = float(torch.tensor(np.log(1e-38), dtype=logs.dtype))
    logs = logs.double().numpy()
    rows, card = logs.shape
    p = np.where(logs <= clamp, 0.0, np.exp(logs))
    empty = p.sum(axis=1) <= 0
    p[empty] = 1.0
    cum = np.cumsum(p, axis=1)
    out = np.full((rows, card + card % 2), CDF_PAD)
    out[:, :card] = cum / cum[:, -1:]
    return out.reshape(rows, -1, 2)


def sweep_groups(n_nodes, n_levels, most):
    """Threads per row of a sweep: as many as the nodes of an average level,
    at most ``most``.  A group with no node in a level only waits at its
    barrier while holding its warp, so fewer groups leave room for more rows
    (ALARM's slice of 37 nodes in 11 levels: 0.194 ms with 4 groups, 0.285
    with 8, on an H100)."""
    return max(1, min(int(most), -(-int(n_nodes) // max(int(n_levels), 1))))


def resident_blocks(shared, threads):
    """Blocks of ``threads`` threads and ``shared`` bytes of shared memory a
    multiprocessor holds at once, as the card counts them: by its shared
    memory (each block's and ``BLOCK_RESERVED``), its registers
    (``REGISTERS`` a thread, allocated 256 a warp), its threads and its
    block slots.  On a card the wrapper asks the card instead
    (:func:`card_resident`)."""
    warps = -(-int(threads) // 32)
    registers = warps * (-(-REGISTERS * 32 // 256) * 256)
    return min(SM_SHARED // (shared + BLOCK_RESERVED), SM_REGISTERS // registers,
               SM_THREADS // threads, SM_BLOCKS)


def tile_bytes(rows, row_bytes):
    """A tile's bytes, to the 16-byte boundary the stage buffers start at."""
    return -(-rows * row_bytes // 16) * 16


def plan_tile(d, code_bytes, groups=None, n=None, sms=SMS, extra=0, resident=resident_blocks):
    """(rows a block, codes a tile row, shared bytes) of a sweep of ``n``
    rows over ``d`` nodes with ``groups`` threads per row (default
    ``GROUPS``) on a card of ``sms`` multiprocessors, each block also
    holding ``extra`` bytes (its stage buffers); ``resident(shared,
    threads)`` is the blocks a multiprocessor holds.  A tile row is padded to an
    odd number of 4-byte words (the lanes of a warp reading one column then
    hit distinct banks).  The candidates: whole warps of rows (32, 64, ...
    at most ``MAX_TILE_ROWS`` and ``1024 // groups``) within
    ``SHARED_LIMIT``, and, where a warp of rows passes the default 48 KB, as
    many rows as fit in it (fewer than a warp: a warp then holds two
    groups).  Of those the one that runs the ``n`` rows in the fewest rounds
    of resident blocks, then the one a multiprocessor holds the most rows
    of, then the smallest."""
    groups = GROUPS if groups is None else groups
    row_bytes = -(-max(int(d), 1) * code_bytes // 4) * 4
    if (row_bytes // 4) % 2 == 0:
        row_bytes += 4
    most = min(MAX_TILE_ROWS, 1024 // groups)
    candidates = [rows for rows in range(32, most + 1, 32)
                  if tile_bytes(rows, row_bytes) + extra <= SHARED_LIMIT]
    narrow = min(most, (48 * 1024 - extra) // row_bytes)
    if narrow < 32 and (narrow >= 1 or not candidates):
        candidates.append(narrow)
    candidates = [rows for rows in candidates if rows >= 1]
    if not candidates:
        raise ValueError(f"ancestral sweep: a row of {d} codes of {code_bytes} bytes does not fit "
                         f"a block's {SHARED_LIMIT} bytes of shared memory")

    def key(rows):
        per_sm = resident(tile_bytes(rows, row_bytes) + extra, rows * groups)
        rounds = -(-(-(-int(n) // rows)) // (per_sm * sms)) if n else 0
        return rounds, -rows * per_sm, rows

    rows = min(candidates, key=key)
    return rows, row_bytes // code_bytes, tile_bytes(rows, row_bytes) + extra


def deal(items, loads, groups):
    """``items`` dealt to ``groups`` groups: the item of most load first to
    the group of least load so far (the lowest group on a tie); each group's
    items in their order.  Returns the lists and the largest group load."""
    load, dealt = np.zeros(groups, dtype=np.int64), [[] for _ in range(groups)]
    for x in sorted(range(len(items)), key=lambda x: (-loads[x], x)):
        g = int(np.argmin(load))
        dealt[g].append(x)
        load[g] += loads[x]
    return [[items[x] for x in sorted(d)] for d in dealt], int(load.max(initial=0))


def draw_cost(card):
    """A node's load when the levels are dealt: its Philox block and flat
    row, and one 16-byte read per two states."""
    return DRAW_COST + (int(card) + 1) // 2


def level_schedule(parents, loads, groups, most=None):
    """(schedule, starts, levels): the nodes level by level (a node's level is
    one more than the highest of its ``parents``, which are earlier nodes;
    roots are level 0; with ``most``, a level of more nodes is cut, in node
    order, into consecutive levels of at most ``most``), each level's nodes
    dealt to ``groups`` groups (:func:`deal`, by load: for the sweep,
    :func:`draw_cost`), each group's nodes in node order; group g of level l
    holds
    ``schedule[starts[l * groups + g]: starts[l * groups + g + 1]]``."""
    level = np.zeros(len(parents), dtype=np.int64)
    for i, ps in enumerate(parents):
        level[i] = 1 + max((level[p] for p in ps), default=-1)
    n_levels = int(level.max()) + 1 if len(parents) else 0
    schedule, starts, cut = [], [0], 0
    for lv in range(n_levels):
        members = [int(i) for i in np.flatnonzero(level == lv)]
        step = len(members) if most is None else max(int(most), 1)
        for at in range(0, len(members), step):
            part = members[at: at + step]
            for group in deal(part, [loads[i] for i in part], groups)[0]:
                schedule.extend(group)
                starts.append(len(schedule))
            cut += 1
    return np.asarray(schedule, dtype=np.int32), np.asarray(starts, dtype=np.int32), cut


class SweepTables:
    """The host side of a sampler's sweep: the node table (``nodes``: one
    int32 row per node, card, log table offset, CDF offset, parent count,
    output column, node index, parents, strides, padded to ``row_ints``, a
    multiple of 4; the kernel reads its rows in schedule order,
    ``sched_nodes``), each node's output column, the level schedule
    (:func:`level_schedule`, dealt to ``groups`` groups: :func:`sweep_groups`;
    no level more than ``stage_nodes``, the rows the kernel's stage buffers
    hold within ``STAGE_BYTES``), the CDF rows (:func:`cdf_rows`, every
    node's from an even offset of one float64 array, ``cdf``) and, per card,
    the log tables concatenated into one flat tensor beside the uploaded CDF
    rows, schedule-order node table and level starts.

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
        cdf_sizes = [int(t.shape[0]) * (c + c % 2) for c, (_, _, t) in zip(self.cards, node_specs)]
        self.cdf_offsets = np.concatenate([[0], np.cumsum(cdf_sizes)[:-1]]).astype(np.int64)
        self._cdf = None
        self.width = max([len(p) for p, _, _ in node_specs] + [1])
        self.row_ints = -(-(_NODE_HEADER + 2 * self.width) // 4) * 4
        nodes = np.zeros((len(node_specs), self.row_ints), dtype=np.int64)
        nodes[:, 0] = self.cards
        nodes[:, 1] = self.table_offsets
        nodes[:, 2] = self.cdf_offsets
        nodes[:, 4] = self.columns
        nodes[:, 5] = np.arange(d)
        for i, (parents, strides, _) in enumerate(node_specs):
            nodes[i, 3] = len(parents)
            nodes[i, _NODE_HEADER: _NODE_HEADER + len(parents)] = parents
            nodes[i, _NODE_HEADER + self.width: _NODE_HEADER + self.width + len(parents)] = strides
        self.nodes = nodes.astype(np.int32)
        node_of = np.argsort(self.columns)  # the node that writes each column
        parents = [[int(node_of[p]) for p in ps if p < d] for ps, _, _ in node_specs]
        loads = [draw_cost(c) for c in self.cards]
        self.groups = sweep_groups(d, level_schedule(parents, loads, 1)[2], GROUPS)
        most = max(1, STAGE_BYTES // (2 * 4 * (self.row_ints + 1)))
        self.schedule, self.starts, self.n_levels = level_schedule(parents, loads, self.groups,
                                                                   most)
        level_starts = self.starts[::self.groups]
        self.stage_nodes = int(np.diff(level_starts).max(initial=1))
        self.stage_bytes = 2 * self.stage_nodes * (self.row_ints + 1) * 4
        self.sched_nodes = self.nodes[self.schedule]
        self.position = np.argsort(self.schedule).astype(np.int32)  # node -> schedule entry
        self.device = node_specs[0][2].device if node_specs else config.DEVICE
        self._device = {}
        self._cdf_device = {}

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

    @property
    def cdf(self):
        """Every node's CDF rows (:func:`cdf_rows`) end to end, float64, node
        ``i``'s from ``cdf_offsets[i]``; made at first use from the log
        tables' values."""
        if self._cdf is None:
            cdfs = [cdf_rows(t).reshape(-1) for _, _, t in self.node_specs]
            self._cdf = np.concatenate(cdfs) if cdfs else np.zeros(0)
        return self._cdf

    def cdf_tables(self, device):
        """Each node's CDF rows as the plain version reads them: ``(rows,
        card rounded up to even)`` float64 on ``device``, made once per
        device."""
        tables = self._cdf_device.get(device)
        if tables is None:
            flat = torch.from_numpy(self.cdf).to(device)
            tables = [flat[int(o): int(o) + t.shape[0] * (c + c % 2)].view(t.shape[0], -1)
                      for o, c, (_, _, t) in zip(self.cdf_offsets, self.cards, self.node_specs)]
            self._cdf_device[device] = tables
        return tables

    def on(self, device):
        """(flat log tables, the CDF rows, one int32 buffer of the node table,
        the columns, the schedule and its starts) on ``device``, made once
        per device."""
        entry = self._device.get(device)
        if entry is not None:
            torch.cuda.current_stream(device).wait_event(entry[3])
            return entry[:3]
        tables = torch.cat([t.reshape(-1) for _, _, t in self.node_specs]).to(device)
        cdf = torch.from_numpy(self.cdf).pin_memory().to(device, non_blocking=True)
        host = np.concatenate([self.sched_nodes.ravel(), self.starts]).astype(np.int32)
        plan = torch.from_numpy(host).pin_memory().to(device, non_blocking=True)
        uploaded = torch.cuda.Event()
        uploaded.record(torch.cuda.current_stream(device))
        self._device[device] = (tables, cdf, plan, uploaded)
        return tables, cdf, plan


def call_modes(sweep, mode):
    """What a launch reads of a call's modes (:meth:`SweepTables.modes`): the
    modes in schedule order, and the evidence nodes' schedule entries in
    node order (the order their log probabilities are added in)."""
    return mode[sweep.schedule], sweep.position[np.flatnonzero(mode <= -2)]


_RESIDENT = {}


def card_resident(device, table_bytes, code_bytes):
    """``resident(shared, threads)`` for :func:`plan_tile` on ``device``: the
    blocks a multiprocessor holds of the kernel for these types, from the
    card's occupancy query (its registers included), cached."""
    lib = _library()

    def resident(shared, threads):
        key = (device, table_bytes, code_bytes, int(shared), int(threads))
        if key not in _RESIDENT:
            blocks = ctypes.c_int(0)
            with torch.cuda.device(device):
                err = lib.pgmpy_ancestral_occupancy(table_bytes, code_bytes, int(threads),
                                                    int(shared), ctypes.byref(blocks))
            if err != 0:
                raise RuntimeError(f"ancestral sweep occupancy query failed: cudaError_t {err}")
            _RESIDENT[key] = blocks.value
        return _RESIDENT[key]

    return resident


def _library():
    lib = load_library("ancestral", ["ancestral.cu"])
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.pgmpy_ancestral_sweep.argtypes = [
        i64, i32, i32, i32, vp, vp, i32, i32, i32, vp, vp, i32, vp, i32, vp, vp, vp, vp, i64, vp,
        vp, i64, i32, vp, i32, i32, i64, i64, vp]
    lib.pgmpy_ancestral_sweep.restype = ctypes.c_int
    lib.pgmpy_ancestral_occupancy.argtypes = [i32, i32, i32, i64, vp]
    lib.pgmpy_ancestral_occupancy.restype = ctypes.c_int
    return lib


def _check_noise(noise, sweep, n, device):
    if noise.device != device or noise.dtype != torch.float64:
        raise TypeError(f"ancestral sweep: noise must be float64 uniforms on {device}, got "
                        f"{noise.dtype} on {noise.device}")
    if tuple(noise.shape) != (len(sweep.cards), n):
        raise ValueError(f"ancestral sweep: noise must be (d, n) = {(len(sweep.cards), n)}, got "
                         f"{tuple(noise.shape)}")


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
    the float64 uniform per (node, row), ``(d, n)``, in place of draws from
    ``gen`` (one ``(n,)`` draw per drawn node, in node order).  prev:
    ``(d, >= n)`` codes of the previous slice, read by parent indices
    ``>= d``."""
    device = config.DEVICE
    evidence = evidence or {}
    d = len(sweep.node_specs)
    columns = [None] * d
    if noise is not None:
        _check_noise(noise, sweep, n, sweep.device)
    _check_slices(sweep, n, prev, out, sweep.device)
    cdf = sweep.cdf_tables(sweep.device)
    logw = torch.zeros(n, dtype=config.DTYPE, device=device) if evidence else None
    for i, (parent_idx, strides, log_table) in enumerate(sweep.node_specs):
        col = int(sweep.columns[i])
        clamped = given is not None and given[i] >= 0
        if clamped or i in evidence:
            state = int(given[i]) if clamped else evidence[i]
            columns[col] = torch.full((n,), state, dtype=torch.int64, device=device)
            if clamped:
                continue
        flat = None
        for pi, st in zip(parent_idx, strides):
            value = columns[pi] if pi < d else prev[pi - d, :n].long()
            term = value if st == 1 else value * st
            flat = term if flat is None else flat + term
        if i in evidence:
            logits = log_table[0].expand(n, -1) if flat is None else \
                log_table.index_select(0, flat)  # (n, card)
            logw = logw + logits[:, evidence[i]]
            continue
        rows = cdf[i][0].expand(n, -1) if flat is None else cdf[i].index_select(0, flat)
        if noise is None:
            u = torch.rand(n, generator=gen, dtype=torch.float64, device=gen.device).to(device)
        else:
            u = noise[i]
        draw = (rows <= u[:, None]).sum(dim=-1)
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
    rows, stride, shared = plan_tile(
        d, code_bytes, sweep.groups, n,
        torch.cuda.get_device_properties(device).multi_processor_count, sweep.stage_bytes,
        card_resident(device, sweep.node_specs[0][2].element_size(), code_bytes))
    _check_slices(sweep, n, prev, out, device)
    with torch.cuda.device(device):
        tables, cdf, plan = sweep.on(device)
        if noise is not None:
            _check_noise(noise, sweep, n, device)
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
        mode_sched, evidence_nodes = call_modes(sweep, mode)
        call = torch.from_numpy(np.concatenate([mode_sched, evidence_nodes])).pin_memory().to(
            device, non_blocking=True)
        err = _library().pgmpy_ancestral_sweep(
            n, d, sweep.width, sweep.row_ints, plan.data_ptr(),
            plan.data_ptr() + 4 * sweep.sched_nodes.size, sweep.n_levels, sweep.groups,
            sweep.stage_nodes, call.data_ptr(), call.data_ptr() + 4 * d, evidence_nodes.size,
            tables.data_ptr(), tables.element_size(), cdf.data_ptr(),
            0 if partial is None else partial.data_ptr(),
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
