"""The Gibbs sweep (K6): every chain through one systematic-scan sweep of a
discrete Bayesian or Markov network.

Variable after variable in the scan order, each chain's local conditional
``log P(v | blanket)`` is the sum, over the variable's blanket factors, of
the factor's log-table row at the chain's current states (the table stored
with ``v``'s axis last, ``(rows, card)``), and the variable is redrawn from
it by the exponential race (``argmax_s(logit_s - log E_s)``, ``E ~ Exp(1)``
clamped at ``1e-20``).  A variable in no factor is drawn uniform.  The sum's
association is part of the contract: a variable's factors are cut into
pieces of at most ``PIECE_FACTORS`` (:func:`piece_cuts`), each piece summed
in factor order, the pieces' sums added in piece order.

* On a CUDA tensor, the hand-written kernel of ``csrc/gibbs.cu`` (built with
  ``nvcc`` at first use): ONE launch per sweep, a block's chains in shared
  memory, ``groups`` threads per chain (``ops.ancestral.sweep_groups``, at
  most ``GROUPS``) working the pieces of one level at a time (a level holds
  no two variables of one factor, so the sweep's draws are the sequential
  scan's), random bits from Philox keyed on one 64-bit draw per sweep from
  the call's generator.  A build or launch failure raises.
* On a CPU tensor, the plain version :func:`sweep_reference`: a few torch
  ops per (variable, blanket factor), its race noise drawn from the
  generator variable by variable (``utils/mathext.py:race_noise``).

Both take an explicit ``noise`` tensor in place of the generator: ``log E``
for every (state, chain), ``(sum of cards, n)``, variable ``i``'s states from
row ``noise_offsets[i]``.  On the same noise the kernel and the plain version
give the same codes, to the bit.

It replaces ``pgmpy_tpu/sampling/gibbs.py:120`` ``_conditional_logits``,
``:148`` ``_sweep`` and ``:160`` ``_run_chains``.  ``LAUNCHES`` counts the
kernel's launches; :func:`reset_launches` zeroes it.
"""

import ctypes

import numpy as np
import torch

from pgmpy_tpu_torch.config import config
from pgmpy_tpu_torch.ops._build import load_library
from pgmpy_tpu_torch.ops.ancestral import deal, noise_offsets, sweep_groups
from pgmpy_tpu_torch.utils.mathext import race_noise

GROUPS = 32  # threads per chain at most: each works its share of a level's pieces
PIECE_FACTORS = 8  # blanket factors a piece sums at most (csrc/gibbs.cu: kPieceFactors)
MAX_TILE_ROWS = 128  # chains a block at most (times the groups: at most 1024 threads)
SHARED_BUDGET = 48 * 1024  # a block's tile of codes and scratch sums
STAGE_BUDGET = 96 * 1024  # padded log tables up to this size are staged into shared memory
SHARED_LIMIT = 232_448  # bytes of shared memory one block may use on Hopper (227 KB)
ROW_ALIGN = 4  # table rows padded to multiples of four entries (16-byte loads)
TABLE_ALIGN = 8  # tables start on multiples of eight entries (a float row of 5-8 in one sector)

LAUNCHES = 0


def reset_launches():
    global LAUNCHES
    LAUNCHES = 0


def piece_cuts(n_factors):
    """The sizes of the pieces a variable's ``n_factors`` blanket factors are
    cut into, in order: as few as hold at most ``PIECE_FACTORS`` each, as
    even as possible (the larger first).  One piece, of 0 factors, for a
    variable in no factor."""
    n_pieces = max(1, -(-int(n_factors) // PIECE_FACTORS))
    size, extra = divmod(int(n_factors), n_pieces)
    return [size + (p < extra) for p in range(n_pieces)]


def conditional_logits(var_specs, cards, states, i):
    """log P(variable ``i`` = k | the rest) up to a constant, for EVERY chain:
    ``states`` (d, n) int64 -> (n, card), summed in the tables' type: each
    piece of ``var_specs[i]`` (per blanket factor: table ``(rows, card)``,
    other variables' positions, their row strides; :func:`piece_cuts`) in
    factor order, then the pieces in order."""
    n = states.shape[1]
    total, first = None, 0
    for size in piece_cuts(len(var_specs[i])):
        part = None
        for table, other_idx, rstrides in var_specs[i][first: first + size]:
            if not other_idx:
                rows = table[0].expand(n, -1)
            else:
                row = None
                for j, s in zip(other_idx, rstrides):
                    term = states[j] if s == 1 else states[j] * s
                    row = term if row is None else row + term
                rows = table.index_select(0, row)
            part = rows if part is None else part + rows
        first += size
        if part is not None:
            total = part if total is None else total + part
    if total is None:  # a variable in no factor: uniform
        total = torch.zeros((n, cards[i]), dtype=config.DTYPE, device=states.device)
    return total


def blanket_levels(var_specs):
    """Each variable's level: one more than the highest level of its blanket
    neighbours earlier in the scan order (0 without one)."""
    level = np.zeros(len(var_specs), dtype=np.int64)
    for i, specs in enumerate(var_specs):
        earlier = {j for _, others, _ in specs for j in others if j < i}
        level[i] = 1 + max((level[j] for j in earlier), default=-1)
    return level


def plan_launch(n, d, code_bytes, groups, sms, slots, elem):
    """(blocks, rows, stride, tile bytes) of a sweep of ``n`` chains over
    ``d`` variables with ``groups`` threads per chain and ``slots`` scratch
    sums of ``elem`` bytes per chain: each tile row padded to an odd number
    of 4-byte words (the lanes of a warp reading one column hit distinct
    banks); a block holds at most ``MAX_TILE_ROWS`` chains, ``1024 //
    groups`` and what ``SHARED_BUDGET`` allows; at least ``sms`` blocks (one
    per multiprocessor) where there are as many chains, the chains dealt
    evenly (block b holds ``n // blocks`` or one more).  ``rows`` is the
    largest block's chains; the tile and scratch take ``tile bytes``."""
    row_bytes = -(-max(int(d), 1) * code_bytes // 4) * 4
    if (row_bytes // 4) % 2 == 0:
        row_bytes += 4
    per_row = row_bytes + int(slots) * elem
    most = min(MAX_TILE_ROWS, 1024 // groups, (SHARED_BUDGET - 32) // per_row)
    if most < 1:
        raise ValueError(f"gibbs sweep: a chain of {d} codes of {code_bytes} bytes does not fit "
                         f"a block's {SHARED_BUDGET} bytes of shared memory")
    n = max(int(n), 1)
    blocks = max(-(-n // most), min(int(sms), n))
    rows = -(-n // blocks)
    tile = _align16(rows * row_bytes) + _align16(rows * int(slots) * elem)
    return blocks, rows, row_bytes // code_bytes, tile


def _align16(nbytes):
    return (int(nbytes) + 15) // 16 * 16


class GibbsTables:
    """The host side of a Gibbs sweep, CSR: per variable (card, noise offset,
    first blanket factor, factor count), per (variable, factor) (offset of
    its table in the padded flat tables, other count, first other), per
    other (column, row stride); the pieces (variable, first factor, factor
    count, scratch slot or -1 where the piece is the whole variable) and the
    combines (variable, first slot, pieces) of the variables cut into
    several; the level schedule (:func:`blanket_levels`), each level's
    pieces and then its combines dealt to ``groups`` groups by load (a
    piece: states x its factors, plus states where it draws; a combine:
    states x (pieces + 1)); and, per card, the padded log tables
    concatenated into one flat tensor beside one uploaded int32 buffer of
    the rest.  In the flat tables every row is padded to a multiple of
    ``ROW_ALIGN`` entries and every table starts on such a boundary.

    ``var_specs``: per variable in scan order, its blanket factors (table
    ``(rows, card)`` with the variable's axis last, other variables'
    positions, their row strides)."""

    def __init__(self, var_specs, cards, out_dtype):
        self.var_specs = var_specs
        self.cards = [int(c) for c in cards]
        self.out_dtype = out_dtype
        d = len(var_specs)
        specs = [s for per_var in var_specs for s in per_var]
        self.total = int(sum(int(t.numel()) for t, _, _ in specs))
        self.noise_offsets = noise_offsets(self.cards) if d else np.zeros(0, dtype=np.int64)
        counts = [len(per_var) for per_var in var_specs]
        self.vars = np.zeros((d, 4), dtype=np.int64)
        self.vars[:, 0] = self.cards
        self.vars[:, 1] = self.noise_offsets
        self.vars[:, 2] = np.concatenate([[0], np.cumsum(counts)[:-1]]) if d else []
        self.vars[:, 3] = counts
        widths = [-(-int(t.shape[1]) // ROW_ALIGN) * ROW_ALIGN for t, _, _ in specs]
        padded = [-(-int(t.shape[0]) * w // TABLE_ALIGN) * TABLE_ALIGN
                  for (t, _, _), w in zip(specs, widths)]
        n_others = [len(others) for _, others, _ in specs]
        self.specs = np.zeros((len(specs), 3), dtype=np.int64)
        self.specs[:, 0] = np.concatenate([[0], np.cumsum(padded)[:-1]]) if specs else []
        self.specs[:, 1] = n_others
        self.specs[:, 2] = np.concatenate([[0], np.cumsum(n_others)[:-1]]) if specs else []
        self.padded_total = int(sum(padded))
        self.others = np.array([(j, s) for _, others, strides in specs
                                for j, s in zip(others, strides)], dtype=np.int64).reshape(-1, 2)
        self.levels = blanket_levels(var_specs)
        self.n_levels = int(self.levels.max()) + 1 if d else 0
        self._cut(counts)
        self.groups = sweep_groups(len(self.pieces), max(self.n_levels, 1), GROUPS)
        self._schedule()
        self.vars, self.specs, self.others, self.pieces, self.combines = (
            a.astype(np.int32) for a in (self.vars, self.specs, self.others, self.pieces,
                                         self.combines))
        self.device = specs[0][0].device if specs else config.DEVICE
        self._device = {}

    def _cut(self, counts):
        """The pieces and combines, and each level's scratch slots: a split
        variable's pieces write ``card`` sums each, from the level's next
        free slot."""
        pieces, combines, self.slots = [], [], 0
        for lv in range(self.n_levels):
            slot = 0
            for i in np.flatnonzero(self.levels == lv):
                cuts, first = piece_cuts(counts[i]), int(self.vars[i, 2])
                if len(cuts) == 1:
                    pieces.append((i, first, cuts[0], -1))
                    continue
                combines.append((i, slot, len(cuts)))
                for size in cuts:
                    pieces.append((i, first, size, slot))
                    first += size
                    slot += self.cards[i]
            self.slots = max(self.slots, slot)
        self.pieces = np.array(pieces, dtype=np.int64).reshape(-1, 4)
        self.combines = np.array(combines, dtype=np.int64).reshape(-1, 3)

    def _schedule(self):
        """Each level's pieces (``schedule_a`` / ``starts_a``) and combines
        (``schedule_b`` / ``starts_b``) dealt to the groups: group g of level
        l works ``schedule_a[starts_a[l * groups + g]: starts_a[l * groups +
        g + 1]]``.  ``critical_path``: the sum over levels of the largest
        group's load in each phase."""
        piece_level = self.levels[self.pieces[:, 0]] if len(self.pieces) else np.zeros(0)
        comb_level = self.levels[self.combines[:, 0]] if len(self.combines) else np.zeros(0)
        cards = np.asarray(self.cards, dtype=np.int64)
        piece_loads = [cards[i] * (k + (s < 0)) for i, _, k, s in self.pieces]
        comb_loads = [cards[i] * (p + 1) for i, _, p in self.combines]
        self.critical_path = 0
        out = {}
        for name, level_of, loads in (("a", piece_level, piece_loads),
                                      ("b", comb_level, comb_loads)):
            schedule, starts = [], [0]
            for lv in range(self.n_levels):
                members = [int(x) for x in np.flatnonzero(level_of == lv)]
                dealt, most = deal(members, [loads[x] for x in members], self.groups)
                self.critical_path += most
                for group in dealt:
                    schedule.extend(group)
                    starts.append(len(schedule))
            out[name] = (np.asarray(schedule, dtype=np.int32), np.asarray(starts, dtype=np.int32))
        (self.schedule_a, self.starts_a), (self.schedule_b, self.starts_b) = out["a"], out["b"]

    def sections(self):
        """The int32 buffer's parts in order, their offsets, and its length
        (padded to a multiple of 4 for 16-byte copies)."""
        parts = [self.vars, self.specs, self.others, self.pieces, self.combines,
                 self.schedule_a, self.starts_a, self.schedule_b, self.starts_b]
        sizes = np.cumsum([p.size for p in parts])
        offsets = np.concatenate([[0], sizes[:-1]]).astype(np.int64)
        return parts, offsets, -(-int(sizes[-1]) // 4) * 4

    def flat_tables(self, device):
        """The log tables in the kernel's layout: every table row padded with
        zeros to a multiple of ``ROW_ALIGN`` entries, concatenated."""
        dtype = self.var_specs[0][0][0].dtype if self.total else config.DTYPE
        out = torch.zeros(max(self.padded_total, ROW_ALIGN), dtype=dtype, device=device)
        for (t, _, _), offset in zip((s for per_var in self.var_specs for s in per_var),
                                     self.specs[:, 0]):
            rows, card = t.shape
            width = -(-card // ROW_ALIGN) * ROW_ALIGN
            out[int(offset): int(offset) + rows * width].view(rows, width)[:, :card] = t
        return out

    def on(self, device):
        """(padded flat log tables, one int32 buffer of the variables,
        factors, others, pieces, combines and schedules) on ``device``, made
        once per device."""
        entry = self._device.get(device)
        if entry is not None:
            torch.cuda.current_stream(device).wait_event(entry[2])
            return entry[:2]
        tables = self.flat_tables(device)
        parts, _, total = self.sections()
        host = np.zeros(total, dtype=np.int32)
        flat = np.concatenate([p.ravel() for p in parts])
        host[:flat.size] = flat
        plan = torch.from_numpy(host).pin_memory().to(device, non_blocking=True)
        uploaded = torch.cuda.Event()
        uploaded.record(torch.cuda.current_stream(device))
        self._device[device] = (tables, plan, uploaded)
        return tables, plan


def _library():
    lib = load_library("gibbs", ["gibbs.cu"])
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.pgmpy_gibbs_sweep.argtypes = [
        i64, i32, vp, vp, i32, i32, i32, i32, vp, i32, i64, vp, vp, vp, vp, i32, i32, i32, i64,
        i32, i64, vp]
    lib.pgmpy_gibbs_sweep.restype = ctypes.c_int
    return lib


def _check(tables, codes, noise, out, dtype, device):
    d = len(tables.cards)
    if codes.dim() != 2 or codes.shape[1] != d or codes.device != device:
        raise ValueError(f"gibbs sweep: codes must be (n, {d}) on {device}, got "
                         f"{tuple(codes.shape)} on {codes.device}")
    n = codes.shape[0]
    if noise is not None:
        if noise.device != device or noise.dtype != dtype:
            raise TypeError(f"gibbs sweep: noise must be {dtype} on {device}, got "
                            f"{noise.dtype} on {noise.device}")
        if tuple(noise.shape) != (sum(tables.cards), n):
            raise ValueError(f"gibbs sweep: noise must be (sum of cards, n) = "
                             f"{(sum(tables.cards), n)}, got {tuple(noise.shape)}")
    if out is not None and (tuple(out.shape) != (n, d) or out.dtype != tables.out_dtype
                            or not out.is_contiguous() or out.device != device):
        raise ValueError(f"gibbs sweep: out must be a contiguous {tables.out_dtype} (n, d) = "
                         f"{(n, d)} on {device}")


def sweep_reference(tables, codes, gen, noise=None, out=None):
    """Plain version: one sweep of every chain on the tables' device, the
    variables in scan order; ``codes`` (n, d) integers -> (n, d) in
    ``tables.out_dtype`` (written into ``out`` when given, which may be
    ``codes``).  noise: ``log E`` per (state, chain) in place of draws from
    ``gen``."""
    dtype = tables.var_specs[0][0][0].dtype if tables.total else config.DTYPE
    _check(tables, codes, noise, out, dtype, tables.device)
    states = codes.to(torch.int64).T.contiguous()
    for i in range(len(tables.cards)):
        logits = conditional_logits(tables.var_specs, tables.cards, states, i)
        if noise is None:
            race = race_noise(logits.shape, gen, logits.dtype)
        else:
            first = int(tables.noise_offsets[i])
            race = noise[first: first + tables.cards[i]].t()
        states[i] = torch.argmax(logits - race, dim=-1)
    result = states.T.to(tables.out_dtype)
    if out is None:
        return result.contiguous()
    return out.copy_(result)


def launch_plan(tables, n, device):
    """(blocks, rows, stride, staged entries, plan staged, shared bytes) of
    one launch on ``device`` (:func:`plan_launch`): the padded tables staged
    into shared memory when they fit ``STAGE_BUDGET``, then the int32 plan
    when the block's shared memory (``SHARED_LIMIT``) holds it too."""
    code_bytes = torch.empty((), dtype=tables.out_dtype).element_size()
    elem = (tables.var_specs[0][0][0] if tables.total else torch.empty((), dtype=config.DTYPE)
            ).element_size()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks, rows, stride, shared = plan_launch(n, len(tables.cards), code_bytes, tables.groups,
                                               sms, tables.slots, elem)
    staged = tables.padded_total if tables.padded_total * elem <= STAGE_BUDGET else 0
    shared += _align16(staged * elem)
    plan_bytes = 4 * tables.sections()[2]
    plan_staged = shared + plan_bytes <= SHARED_LIMIT
    return blocks, rows, stride, staged, plan_staged, shared + plan_bytes * plan_staged


def sweep_cuda(tables, codes, gen, noise=None, out=None):
    """ONE launch of the sweep kernel on the current stream of the sampler's
    card; the arguments and result are those of :func:`sweep_reference`.
    Without ``noise`` the kernel's Philox key is one 64-bit draw from
    ``gen``."""
    global LAUNCHES
    if tables.total >= 2**31 or getattr(tables, "padded_total", 0) >= 2**31:
        raise ValueError(f"gibbs sweep: the log tables hold {tables.total} entries, beyond the "
                         "kernel's int32 index")
    device = tables.device
    if device.type != "cuda":
        raise ValueError("gibbs sweep_cuda: the sampler's log tables must be on a CUDA device")
    n, d = codes.shape[0], len(tables.cards)
    code_bytes = torch.empty((), dtype=tables.out_dtype).element_size()
    with torch.cuda.device(device):
        blocks, rows, stride, staged, plan_staged, shared = launch_plan(tables, n, device)
        flat, plan = tables.on(device)
        _check(tables, codes, noise, out, flat.dtype, device)
        codes = codes.to(tables.out_dtype).contiguous()
        if noise is not None:
            noise = noise.contiguous()
            key = None
        else:
            key = torch.randint(-2**63, 2**63 - 1, (1,), generator=gen, dtype=torch.int64,
                                device=device)
        if out is None:
            out = torch.empty((n, d), dtype=tables.out_dtype, device=device)
        if n == 0 or d == 0:
            return out
        _, offsets, plan_ints = tables.sections()
        sections = (ctypes.c_longlong * 9)(*(int(x) for x in offsets))
        err = _library().pgmpy_gibbs_sweep(
            n, d, plan.data_ptr(), sections, plan_ints, int(plan_staged), tables.n_levels,
            tables.groups, flat.data_ptr(),
            flat.element_size(), staged, codes.data_ptr(),
            0 if noise is None else noise.data_ptr(), 0 if key is None else key.data_ptr(),
            out.data_ptr(), code_bytes, stride, rows, blocks, tables.slots, shared,
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gibbs sweep launch failed: cudaError_t {err}")
    LAUNCHES += 1
    return out


def sweep(tables, codes, gen, noise=None, out=None):
    """Dispatch on the sampler's log tables: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    device = tables.device
    if device.type == "cuda":
        return sweep_cuda(tables, codes, gen, noise, out)
    if device.type == "cpu":
        return sweep_reference(tables, codes, gen, noise, out)
    raise ValueError(f"gibbs sweep: unsupported device {device}")
