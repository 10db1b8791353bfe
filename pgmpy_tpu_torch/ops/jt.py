"""The junction-tree calibration kernels (K2): clique potentials and the
two-pass messages, wave by wave.

A :class:`WavePlan` is the host side of one ``JunctionTreeProgram``: its
messages grouped into waves whose messages are independent (upward messages
by the height of their source clique, downward ones by the depth of their
destination, every connected component of a forest in the same waves), and
int64 descriptor tables that say where every clique lies in one flat
**belief arena**, where every edge's message lies in one **sepset arena**
(canonical sepset order), how a source-clique entry maps to a sepset entry
and a sepset entry to a destination-clique entry, and which factor entries
make up a clique entry.  The tables are built once per program and uploaded
once per device.

:func:`calibrate_waves` runs a calibration on a fresh pair of arenas:

* on a CUDA tensor, the hand-written kernels of ``csrc/jt_calibrate.cu``
  (built with ``nvcc`` at first use): ``clique_potentials`` once, then per
  wave ``sepset_wave`` and ``absorb_wave``.  A build or launch failure raises;
* on a CPU tensor, the plain version :func:`calibrate_waves_reference`: the
  same arithmetic in torch ops on views of the same arenas, in the same wave
  order.

It replaces ``pgmpy_tpu/inference/bp.py:396`` (``JunctionTreeProgram._build``:
``stage0``, the fused schedule and the chunked segments).  ``JT_LAUNCHES``
counts the kernels' launches and ``LAUNCHES`` each kernel's;
:func:`reset_launches` zeroes both.
"""

import ctypes
import functools
from dataclasses import dataclass, field

import numpy as np
import torch

from pgmpy_tpu_torch.config import TINY, config
from pgmpy_tpu_torch.ops._build import load_library

WIDTHS = (16, 24)  # the table widths jt_calibrate.cu is compiled for (MUNIN needs 16)
MAX_AXES = WIDTHS[-1]  # the most axes a clique may have on the card
BLOCK = 256  # kBlock: threads per block of every kernel
# arena entries one block of clique_potentials owns (a multiple of ALIGN),
# halved for a clique whose tables of row offsets would not fit TABLE_BYTES
ENTRIES_PER_BLOCK = 16384
TABLE_BYTES = 32768  # the most bytes of one clique_potentials block's tables of row offsets
SHARED_LIMIT = 48 * 1024  # dynamic shared memory of a block without an opt-in
ABSORB_ENTRIES = 2048  # kAbsorbEntries: arena entries one block of absorb_wave owns
ALIGN = 4  # kAlign: an absorb_wave or clique_potentials block starts on a multiple of 4 entries
MIN_WALK = 16  # a lane of sepset_wave walks at least this many reduced entries, where it can
MAX_WALK = 32  # ... and at most this many: a longer reduction is cut into chunks
MAX_LANES_LOG2 = 8  # at most BLOCK lanes reduce one sepset entry
# the most source entries one block of sepset_wave reads: a lane walks fewer
# than 2 MIN_WALK entries (of one entry, or of MIN_WALK // reduced entries
# when an entry has one lane) unless a whole block reduces one entry, and
# then at most MAX_WALK
MAX_BLOCK_WALK = BLOCK * max(2 * MIN_WALK, MAX_WALK)

# clique rows (host only): offset into the belief arena, size
CLIQUE_OFFSET, CLIQUE_SIZE = 0, 1
# potential rows (kPot* in jt_calibrate.cu; runs of factorless cliques first,
# then one per factored clique): its first clique, arena offset, entries,
# factors (0: a run of ones), merged axes, first factor row, entries per
# block; the split of its rows (of the innermost merged axis) into a low part
# (the merged axes from the second up to POT_LOW_AXES: POT_LOW rows, and
# their multiply-shift constants) and a high part, of which a block's run
# touches at most POT_HIGH rows; then the merged axes' sizes and
# multiply-shift constants (``width`` each, innermost first)
(POT_CLIQUE, POT_OFFSET, POT_SIZE, POT_FACTORS, POT_NDIM, POT_FACTOR, POT_ENTRIES, POT_LOW_AXES,
 POT_LOW, POT_LOW_MAGIC, POT_HIGH, POT_HEADER) = range(12)
# potential factor rows (a clique's factors in potential_specs order): factor
# id, then its stride along each merged axis (innermost first)
FAC_TABLE, FAC_HEADER = range(2)
# message rows (kMsg* in jt_calibrate.cu), then seven blocks of ``width``
# values, innermost axis first: the kept axes' sizes, source strides,
# canonical sepset strides and multiply-shift constants (source order,
# adjacent axes merged), the reduced axes' sizes, source strides and
# multiply-shift constants (merged)
(MSG_SRC, MSG_DST, MSG_EDGE, MSG_FRESH, MSG_SIZE, MSG_REDUCED, MSG_RATIO, MSG_SEPSET,
 MSG_NKEEP, MSG_NRED, MSG_LANES_LOG2, MSG_ENTRY_MAJOR, MSG_CHUNKS, MSG_CHUNK_LEN, MSG_RUNS,
 MSG_PARTIAL, MSG_SRC_OFFSET, MSG_PER_THREAD, MSG_HEADER) = range(19)
KEEP_DIMS, KEEP_STRIDES, KEEP_SEPSET, KEEP_MAGIC, RED_DIMS, RED_STRIDES, RED_MAGIC = range(7)
# group rows (one destination of a wave): kGroup*, then the destination's
# axes merged for all its incoming messages (innermost first): sizes, and
# multiply-shift constants
(GROUP_DST, GROUP_BEGIN, GROUP_END, GROUP_NDIM, GROUP_NDECODE, GROUP_OFFSET, GROUP_SIZE,
 GROUP_HEADER) = range(8)
# absorb rows (one per incoming message of a group, schedule order): the
# message, its ratio's offset in the scratch, its stride along each merged axis
ABSORB_MSG, ABSORB_RATIO, ABSORB_HEADER = range(3)

JT_LAUNCHES = 0  # every launch of the three kernels
LAUNCHES = {"clique_potentials": 0, "sepset_wave": 0, "absorb_wave": 0}  # by kernel


def reset_launches():
    global JT_LAUNCHES
    JT_LAUNCHES = 0
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# --------------------------------------------------------------------------- #
# the wave plan
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class WavePlan:
    """The descriptor tables of one junction-tree program (see the module
    docstring); every array is int64.  Not to be changed once made:
    ``device_tables`` keeps their uploaded copies."""

    width: int
    clique_shapes: list
    sepset_shapes: list
    total: int  # belief arena entries
    sepset_total: int  # sepset arena entries
    cliques: np.ndarray  # (C, 2): CLIQUE_OFFSET, CLIQUE_SIZE; host only
    potentials: np.ndarray  # (R, POT_HEADER + 2 * width): fill runs, then factored cliques
    potential_starts: np.ndarray  # (R,) first block of each row in clique_potentials' grid
    potential_blocks: int
    fill_rows: int  # the rows that are runs of factorless cliques (the first ones)
    potential_factors: np.ndarray  # (F, FAC_HEADER + width)
    messages: np.ndarray  # (M, MSG_HEADER + 7 * width), by message id (uploaded in wave order)
    wave_messages: np.ndarray  # (M,) message ids, wave by wave, schedule order within
    wave_message_start: np.ndarray  # (W + 1,)
    message_blocks: np.ndarray  # (M,) by wave_messages: first block in its wave's grid
    sepset_blocks: np.ndarray  # (W,) blocks of each wave's sepset_wave launch
    groups: np.ndarray  # (G, GROUP_HEADER + 2 * width)
    absorb_rows: np.ndarray  # (M, ABSORB_HEADER + width), group by group
    wave_group_start: np.ndarray  # (W + 1,)
    group_blocks: np.ndarray  # (G,) first block in its wave's absorb_wave grid
    absorb_blocks: np.ndarray  # (W,)
    scratch_size: int  # ratio entries of the largest wave
    partial_size: int  # double partials of the largest wave (MSG_PARTIAL)
    n_up_waves: int
    potential_specs: list  # the program's, for the plain version
    message_specs: list  # the program's messages, for the plain version
    factor_shapes: list
    clique_sizes: list
    sepset_sizes: list
    factor_sizes: list
    device_tables: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def n_waves(self):
        return len(self.wave_message_start) - 1

    def wave(self, w):
        """(message ids, [(destination clique, message ids)]) of wave ``w``."""
        lo, hi = self.wave_message_start[w], self.wave_message_start[w + 1]
        glo, ghi = self.wave_group_start[w], self.wave_group_start[w + 1]
        groups = [(int(row[GROUP_DST]),
                   self.absorb_rows[row[GROUP_BEGIN]:row[GROUP_END], ABSORB_MSG].tolist())
                  for row in self.groups[glo:ghi]]
        return self.wave_messages[lo:hi].tolist(), groups


def row_major_strides(shape):
    strides, step = [], 1
    for n in reversed(shape):
        strides.append(step)
        step *= int(n)
    return strides[::-1]


def merge_axes(dims, *strides):
    """Drop size-1 axes and merge each axis into the one before it where the
    two are adjacent in memory in every stride list (``stride[k] ==
    stride[k + 1] * dim[k + 1]``): a row-major walk over the merged axes
    visits the same offsets in the same order, with fewer digits to decode.
    Returns (dims, *strides)."""
    out_d, out_s = [], [[] for _ in strides]
    for k, d in enumerate(dims):
        if d == 1:
            continue
        if out_d and all(o[-1] == s[k] * d for o, s in zip(out_s, strides)):
            out_d[-1] *= int(d)
            for o, s in zip(out_s, strides):
                o[-1] = int(s[k])
        else:
            out_d.append(int(d))
            for o, s in zip(out_s, strides):
                o.append(int(s[k]))
    return (out_d, *out_s)


def magic(d):
    """The multiply-shift constants of a divisor ``2 <= d < 2**31``, packed as
    ``mul | shift << 32``: ``n // d == (n * mul) >> (32 + shift)`` for every
    ``0 <= n < 2**31`` (``__umulhi(n, mul) >> shift``; with ``l =
    ceil(log2 d)``, ``mul = ceil(2**(31 + l) / d)`` fits 32 bits)."""
    l = (int(d) - 1).bit_length()
    return -(-(1 << (31 + l)) // int(d)) | ((l - 1) << 32)


def message_cut(reduced):
    """(lanes_log2, chunks, chunk_len, per_thread) of a message whose sepset
    entries each reduce ``reduced`` source entries: 2^k lanes per entry so
    that a lane walks at least ``MIN_WALK`` of them (at most a block), the
    reduced space cut into chunks of at most ``MAX_WALK`` entries per lane,
    and a lone lane given ``MIN_WALK // reduced`` entries when their
    reductions are short."""
    log2 = 0 if reduced < 2 * MIN_WALK else min(
        MAX_LANES_LOG2, (reduced // MIN_WALK).bit_length() - 1)
    chunk_len = -(-reduced // -(-reduced // ((1 << log2) * MAX_WALK)))
    per_thread = max(1, MIN_WALK // reduced) if log2 == 0 else 1
    return log2, -(-reduced // chunk_len), chunk_len, per_thread


def block_walks(rows):
    """The most source entries one ``sepset_wave`` block of each message
    (rows of ``WavePlan.messages``) reads: its sepset entries (``per_thread``
    runs of a block's) times its chunk of the reduced space."""
    return (np.minimum((BLOCK >> rows[:, MSG_LANES_LOG2]) * rows[:, MSG_PER_THREAD],
                       rows[:, MSG_SIZE]) * rows[:, MSG_CHUNK_LEN])


def _waves(program):
    """Wave number of every message of ``program``: upward messages (the
    first ``n_edges``, child to parent) by the height of their source,
    downward ones by the depth of their destination, after the upward waves."""
    n_up = program.n_edges
    messages = program.messages
    height = [0] * len(program.cliques)
    # upward messages come deepest first, so a child's height is final
    # before it sends
    for src, dst, *_ in messages[:n_up]:
        height[dst] = max(height[dst], height[src] + 1)
    n_up_waves = 1 + max((height[src] for src, *_ in messages[:n_up]), default=-1)
    depth = [0] * len(program.cliques)
    for src, dst, *_ in messages[n_up:]:
        depth[dst] = depth[src] + 1
    waves = [height[src] for src, *_ in messages[:n_up]]
    waves += [n_up_waves + depth[dst] - 1 for _, dst, *_ in messages[n_up:]]
    return waves, n_up_waves


def _potential_tables(program, shapes, sizes, offsets, width):
    """(potential rows, potential factor rows) of stage 0: runs of adjacent
    factorless cliques, then each factored clique with its axes merged
    wherever every one of its factors treats two adjacent axes alike (both
    absent, or adjacent in the factor too), and its factors' strides along the
    merged axes, with the split of its rows (:func:`_row_split`).  A factored
    clique's blocks own ENTRIES_PER_BLOCK entries (no more than it spans),
    halved until their tables of row offsets fit TABLE_BYTES."""
    fill, factored, factor_rows = [], [], []
    for c, specs in enumerate(program.potential_specs):
        row = np.zeros(POT_HEADER + 2 * width, dtype=np.int64)
        if not specs:
            if fill and fill[-1][POT_OFFSET] + fill[-1][POT_SIZE] == offsets[c]:
                fill[-1][POT_SIZE] += sizes[c]
            else:
                row[[POT_CLIQUE, POT_OFFSET, POT_SIZE, POT_ENTRIES]] = (
                    c, offsets[c], sizes[c], ENTRIES_PER_BLOCK)
                fill.append(row)
            continue
        strides = []
        for f_idx, perm, spec in specs:
            f_strides = row_major_strides(program.factor_shapes[f_idx])
            # clique axis a holds factor axis perm[spec[a]] (None: absent)
            strides.append([0 if s is None else f_strides[perm[s]] for s in spec])
        dims, *merged = merge_axes(shapes[c], *strides)
        if not dims:  # a clique of one entry
            dims, merged = [1], [[0] for _ in specs]
        # no more than the clique spans from the 4-entry boundary below it
        entries = min(ENTRIES_PER_BLOCK, -(-(int(sizes[c]) + ALIGN - 1) // ALIGN) * ALIGN)
        split = _row_split(dims[::-1], entries)
        while entries > ALIGN and 4 * len(specs) * (split[1] + split[2]) > TABLE_BYTES:
            entries = max(ALIGN, entries // (2 * ALIGN) * ALIGN)
            split = _row_split(dims[::-1], entries)
        low_axes, low, high = split
        row[:POT_HEADER] = [c, offsets[c], sizes[c], len(specs), len(dims), len(factor_rows),
                            entries, low_axes, low, magic(low) if low > 1 else 0, high]
        row[POT_HEADER:POT_HEADER + len(dims)] = dims[::-1]
        row[POT_HEADER + width:POT_HEADER + width + len(dims)] = [
            magic(d) if d > 1 else 0 for d in dims[::-1]]
        factored.append(row)
        for (f_idx, _, _), st in zip(specs, merged):
            frow = np.zeros(FAC_HEADER + width, dtype=np.int64)
            frow[FAC_TABLE] = f_idx
            frow[FAC_HEADER:FAC_HEADER + len(st)] = st[::-1]
            factor_rows.append(frow)
    rows = fill + factored
    return (np.stack(rows) if rows else np.zeros((0, POT_HEADER + 2 * width), dtype=np.int64),
            np.stack(factor_rows) if factor_rows
            else np.zeros((0, FAC_HEADER + width), dtype=np.int64))


def _row_split(dims, entries):
    """(low axes, low rows, most high rows a block touches) of a clique's
    merged axes ``dims`` (innermost first) for blocks of ``entries``: its rows
    (of the innermost axis) split as q = low + R high, R the product of the
    merged axes from the second up to ``low axes``, chosen so that a block
    decodes the fewest rows (R low, and the high ones its run touches)."""
    rows = int(np.prod(dims[1:]))  # every row of the clique
    touched = min((entries - 1) // dims[0] + 2, rows)  # rows a block's run touches
    best, low = None, 1
    for low_axes in range(1, len(dims) + 1):
        if low_axes > 1:
            low *= int(dims[low_axes - 1])
        high = min((touched - 1) // low + 2, rows // low)
        if best is None or low + high < best[1] + best[2]:
            best = (low_axes, low, high)
    return best


def potential_shared(plan):
    """The dynamic shared bytes of a ``clique_potentials`` launch: per factor
    of a clique a table pointer, ``width`` 32-bit strides and its row offsets
    (low and high), for the clique that needs the most."""
    rows = plan.potentials
    per_factor = 8 + 4 * plan.width + 4 * (rows[:, POT_LOW] + rows[:, POT_HIGH])
    return int((rows[:, POT_FACTORS] * per_factor).max(initial=0))


def build_plan(program):
    """:class:`WavePlan` of a ``JunctionTreeProgram`` (any object with its
    ``cliques``, ``clique_shapes``, ``sepset_shapes``, ``factor_shapes``,
    ``potential_specs``, ``messages`` and ``n_edges``)."""
    shapes = [tuple(int(n) for n in s) for s in program.clique_shapes]
    n_cliques = len(shapes)
    # the narrowest compiled width that holds every clique (a wider tree is
    # laid out at its own width, and the CUDA wrapper refuses it)
    need = max([0] + [len(s) for s in shapes])
    width = next((w for w in WIDTHS if w >= need), need)
    sizes = np.array([int(np.prod(s)) for s in shapes], dtype=np.int64)
    if n_cliques and sizes.max() >= 2**31:
        raise ValueError(f"a clique of {int(sizes.max())} entries is too large")
    clique_offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    sep_shapes = [tuple(int(n) for n in s) for s in program.sepset_shapes]
    sep_sizes = np.array([int(np.prod(s)) for s in sep_shapes], dtype=np.int64)
    edge_offsets = np.concatenate([[0], np.cumsum(sep_sizes)[:-1]]).astype(np.int64)

    cliques = np.zeros((n_cliques, 2), dtype=np.int64)
    cliques[:, CLIQUE_OFFSET] = clique_offsets
    cliques[:, CLIQUE_SIZE] = sizes
    potentials, potential_factors = _potential_tables(program, shapes, sizes, clique_offsets,
                                                      width)
    fill_rows = int((potentials[:, POT_FACTORS] == 0).sum())
    blocks = -(-(potentials[:, POT_OFFSET] % ALIGN + potentials[:, POT_SIZE])
               // potentials[:, POT_ENTRIES])

    # messages
    waves, n_up_waves = _waves(program)
    n_waves = 1 + max(waves, default=-1)
    messages = np.zeros((len(program.messages), MSG_HEADER + 7 * width), dtype=np.int64)
    ratio_strides = {}  # message -> its ratio's stride along each destination axis
    for m, (src, dst, reduce_axes, perm, (bperm, bspec), edge, fresh) in enumerate(
            program.messages):
        src_shape, src_strides = shapes[src], row_major_strides(shapes[src])
        reduce_axes = sorted(reduce_axes)
        kept = [a for a in range(len(src_shape)) if a not in reduce_axes]
        canon = [kept[p] for p in perm]  # source axis of each canonical sepset axis
        canon_strides = row_major_strides([src_shape[a] for a in canon])
        sep_stride = {a: canon_strides[k] for k, a in enumerate(canon)}
        # kept axes in source order (consecutive threads, consecutive addresses),
        # each with its source stride and its canonical sepset stride
        kd, ks, kj = merge_axes([src_shape[a] for a in kept], [src_strides[a] for a in kept],
                                [sep_stride[a] for a in kept])
        rd, rs = merge_axes([src_shape[a] for a in reduce_axes],
                            [src_strides[a] for a in reduce_axes])
        reduced = int(np.prod([src_shape[a] for a in reduce_axes]))
        log2, chunks, chunk_len, per_thread = message_cut(reduced)
        inner = next((a for a in reversed(range(len(src_shape))) if src_shape[a] > 1), None)
        row = messages[m]
        row[[MSG_SRC, MSG_DST, MSG_EDGE, MSG_FRESH, MSG_SIZE, MSG_REDUCED, MSG_SEPSET,
             MSG_NKEEP, MSG_NRED, MSG_LANES_LOG2, MSG_ENTRY_MAJOR, MSG_CHUNKS, MSG_CHUNK_LEN,
             MSG_RUNS, MSG_SRC_OFFSET, MSG_PER_THREAD]] = [
            src, dst, edge, int(fresh), sep_sizes[edge], reduced, edge_offsets[edge],
            len(kd), len(rd), log2, int(inner is not None and inner in kept), chunks, chunk_len,
            -(-int(sep_sizes[edge]) // ((BLOCK >> log2) * per_thread)), clique_offsets[src],
            per_thread]
        for column, values in ((KEEP_DIMS, kd), (KEEP_STRIDES, ks), (KEEP_SEPSET, kj),
                               (KEEP_MAGIC, [magic(d) for d in kd]), (RED_DIMS, rd),
                               (RED_STRIDES, rs), (RED_MAGIC, [magic(d) for d in rd])):
            start = MSG_HEADER + column * width
            row[start:start + len(values)] = values[::-1]
        canon_ratio = row_major_strides(sep_shapes[edge])
        ratio_strides[m] = [0 if s is None else canon_ratio[bperm[s]] for s in bspec]

    wave_messages, wave_message_start, message_blocks = [], [0], []
    sepset_blocks, absorb_blocks, scratch_size, partial_size = [], [], 0, 0
    groups, absorb_rows, wave_group_start, group_blocks = [], [], [0], []
    by_wave = [[] for _ in range(n_waves)]
    for m, w in enumerate(waves):
        by_wave[w].append(m)
    for ids in by_wave:
        ratio, partial, nblocks = 0, 0, 0
        for m in ids:
            row = messages[m]
            row[MSG_RATIO] = ratio
            ratio += row[MSG_SIZE]
            # every message has its partials' slot: with normalize_messages
            # all of them combine through it
            row[MSG_PARTIAL] = partial
            partial += row[MSG_CHUNKS] * row[MSG_SIZE]
            message_blocks.append(nblocks)
            nblocks += int(row[MSG_RUNS] * row[MSG_CHUNKS])
        scratch_size = max(scratch_size, ratio)
        partial_size = max(partial_size, partial)
        wave_messages.extend(ids)
        wave_message_start.append(len(wave_messages))
        sepset_blocks.append(nblocks)
        order = {}
        for m in ids:
            order.setdefault(int(messages[m, MSG_DST]), []).append(m)
        nblocks = 0
        for dst, incoming in order.items():
            # the destination's axes, merged where every incoming ratio treats
            # two of them alike, innermost first
            dims, *strides = merge_axes(shapes[dst], *(ratio_strides[m] for m in incoming))
            used = [k for k in range(len(dims)) if any(s[len(dims) - 1 - k] for s in strides)]
            row = np.zeros(GROUP_HEADER + 2 * width, dtype=np.int64)
            row[:GROUP_HEADER] = [dst, len(absorb_rows), len(absorb_rows) + len(incoming),
                                  len(dims), 1 + max(used, default=-1), clique_offsets[dst],
                                  sizes[dst]]
            row[GROUP_HEADER:GROUP_HEADER + len(dims)] = dims[::-1]
            row[GROUP_HEADER + width:GROUP_HEADER + width + len(dims)] = [
                magic(d) for d in dims[::-1]]
            groups.append(row)
            for m, st in zip(incoming, strides):
                arow = np.zeros(ABSORB_HEADER + width, dtype=np.int64)
                arow[:ABSORB_HEADER] = [m, messages[m, MSG_RATIO]]
                arow[ABSORB_HEADER:ABSORB_HEADER + len(st)] = st[::-1]
                absorb_rows.append(arow)
            group_blocks.append(nblocks)
            offset = int(clique_offsets[dst])
            nblocks += -(-(offset + int(sizes[dst]) - offset // ALIGN * ALIGN) // ABSORB_ENTRIES)
        wave_group_start.append(len(groups))
        absorb_blocks.append(nblocks)

    def i64(values, columns=None):
        if columns is not None:
            return (np.stack(values) if values
                    else np.zeros((0, columns), dtype=np.int64)).astype(np.int64)
        return np.asarray(values, dtype=np.int64)

    return WavePlan(
        width=width,
        clique_shapes=shapes,
        sepset_shapes=sep_shapes,
        total=int(sizes.sum()),
        sepset_total=int(sep_sizes.sum()),
        cliques=cliques,
        potentials=potentials,
        potential_starts=np.concatenate([[0], np.cumsum(blocks)[:-1]]).astype(np.int64),
        potential_blocks=int(blocks.sum()),
        fill_rows=fill_rows,
        potential_factors=potential_factors,
        messages=messages,
        wave_messages=i64(wave_messages),
        wave_message_start=i64(wave_message_start),
        message_blocks=i64(message_blocks),
        sepset_blocks=i64(sepset_blocks),
        groups=i64(groups, GROUP_HEADER + 2 * width),
        absorb_rows=i64(absorb_rows, ABSORB_HEADER + width),
        wave_group_start=i64(wave_group_start),
        group_blocks=i64(group_blocks),
        absorb_blocks=i64(absorb_blocks),
        scratch_size=int(scratch_size),
        partial_size=int(partial_size),
        n_up_waves=n_up_waves,
        potential_specs=[list(s) for s in program.potential_specs],
        message_specs=list(program.messages),
        factor_shapes=[tuple(s) for s in program.factor_shapes],
        clique_sizes=sizes.tolist(),
        sepset_sizes=sep_sizes.tolist(),
        factor_sizes=[int(np.prod(s)) for s in program.factor_shapes],
    )


# --------------------------------------------------------------------------- #
# the arenas
# --------------------------------------------------------------------------- #
def arena_views(plan, arena, sepsets):
    """(beliefs, mu): one view of ``arena`` per clique (``clique_shapes[c]``)
    and one of ``sepsets`` per edge (canonical sepset order)."""
    beliefs = [part.view(shape) for part, shape in zip(
        torch.split(arena, plan.clique_sizes), plan.clique_shapes)]
    mu = [part.view(shape) for part, shape in zip(
        torch.split(sepsets, plan.sepset_sizes), plan.sepset_shapes)]
    return beliefs, mu


def _inputs(plan, factor_arrays):
    """(device, dtype) of a calibration: the factors' device, and their
    promoted type (``config.DTYPE`` when there is no factor)."""
    if len(factor_arrays) != len(plan.factor_sizes):
        raise ValueError(f"calibrate: {len(factor_arrays)} factor tables for a program of "
                         f"{len(plan.factor_sizes)}")
    if not factor_arrays:
        return config.DEVICE, config.DTYPE
    devices = {a.device for a in factor_arrays}
    if len(devices) > 1:
        raise ValueError(f"calibrate: factor tables on several devices: {sorted(map(str, devices))}")
    sizes = [a.numel() for a in factor_arrays]
    if sizes != plan.factor_sizes:
        f = next(k for k, (a, b) in enumerate(zip(sizes, plan.factor_sizes)) if a != b)
        raise ValueError(f"calibrate: factor table {f} has {sizes[f]} entries, its shape "
                         f"{plan.factor_shapes[f]} {plan.factor_sizes[f]}")
    return devices.pop(), functools.reduce(torch.promote_types, {a.dtype for a in factor_arrays})


def _expand(arr, perm, shape_spec):
    """Transpose by ``perm`` then insert singleton axes per ``shape_spec``
    (``inference.bp._broadcast_spec``'s layout).  Identity transposes and
    reshapes are elided."""
    if perm != tuple(range(len(perm))):
        arr = arr.permute(perm)
    shape = []
    it = iter(arr.shape)
    for spec in shape_spec:
        shape.append(next(it) if spec is not None else 1)
    shape = tuple(shape)
    if shape != tuple(arr.shape):
        arr = arr.reshape(shape)
    return arr


# --------------------------------------------------------------------------- #
# the plain version, one function per kernel
# --------------------------------------------------------------------------- #
def clique_potentials_reference(plan, factor_arrays, beliefs):
    """Stage 0 into the clique views ``beliefs``: each clique the broadcast
    product of its factors in ``potential_specs`` order (1 without one)."""
    arrays = [a.reshape(shape) for a, shape in zip(factor_arrays, plan.factor_shapes)]
    for c, specs in enumerate(plan.potential_specs):
        if not specs:
            beliefs[c].fill_(1)
            continue
        f_idx, perm, spec = specs[0]
        pot = _expand(arrays[f_idx], perm, spec).expand(plan.clique_shapes[c])
        for f_idx, perm, spec in specs[1:]:
            pot = pot * _expand(arrays[f_idx], perm, spec)
        beliefs[c].copy_(pot)


def sepset_wave_reference(plan, w, beliefs, mu, operation="marginalize", normalize=False):
    """Wave ``w``'s messages: each sigma (sum or max of the source down to the
    sepset, canonical order, normalised by its total with ``normalize``) goes
    to the edge's view in ``mu``; returns {message: ratio}, the ratio being
    sigma over the edge's previous message clamped at ``TINY`` (sigma itself
    for a fresh edge)."""
    reduce = torch.sum if operation == "marginalize" else torch.amax
    ratios = {}
    for m in plan.wave(w)[0]:
        src, _, reduce_axes, perm, _, edge, fresh = plan.message_specs[m]
        # torch.sum / amax over dim=() would reduce every axis
        sigma = reduce(beliefs[src], dim=reduce_axes) if reduce_axes else beliefs[src]
        sigma = sigma.permute(perm)
        if normalize:
            sigma = sigma / torch.clamp_min(torch.sum(sigma), TINY)
        # mu is zero only where sigma is zero: the clamp gives 0/0 = 0
        ratios[m] = sigma if fresh else sigma / torch.clamp_min(mu[edge], TINY)
        mu[edge].copy_(sigma)
    return ratios


def absorb_wave_reference(plan, w, beliefs, ratios):
    """Wave ``w``'s ratios multiplied into their destinations' views, in
    schedule order."""
    for dst, incoming in plan.wave(w)[1]:
        for m in incoming:
            bperm, bspec = plan.message_specs[m][4]
            beliefs[dst].mul_(_expand(ratios[m], bperm, bspec))


def calibrate_waves_reference(plan, factor_arrays, operation="marginalize", normalize=False):
    """Plain version: torch ops on views of a fresh pair of arenas, in wave
    order.  Returns (belief arena, sepset arena)."""
    device, dtype = _inputs(plan, factor_arrays)
    arena = torch.empty(plan.total, dtype=dtype, device=device)
    sepsets = torch.empty(plan.sepset_total, dtype=dtype, device=device)
    beliefs, mu = arena_views(plan, arena, sepsets)
    clique_potentials_reference(plan, [a.to(dtype) for a in factor_arrays], beliefs)
    for w in range(plan.n_waves):
        ratios = sepset_wave_reference(plan, w, beliefs, mu, operation, normalize)
        absorb_wave_reference(plan, w, beliefs, ratios)
    return arena, sepsets


# --------------------------------------------------------------------------- #
# the CUDA kernels, one wrapper per kernel
# --------------------------------------------------------------------------- #
def _library():
    lib = load_library("jt_calibrate", ["jt_calibrate.cu"])
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.pgmpy_jt_clique_potentials.argtypes = [
        i32, vp, vp, vp, i32, vp, vp, i64, i32, i32, vp]
    lib.pgmpy_jt_sepset_wave.argtypes = [
        i32, i32, i32, vp, vp, vp, vp, vp, vp, vp, i32, i64, i32, ctypes.c_double, vp]
    lib.pgmpy_jt_absorb_wave.argtypes = [
        i32, vp, vp, vp, vp, i32, vp, i64, i32, vp]
    for fn in (lib.pgmpy_jt_clique_potentials, lib.pgmpy_jt_sepset_wave,
               lib.pgmpy_jt_absorb_wave):
        fn.restype = ctypes.c_int
    return lib


_TABLES = ("potentials", "potential_starts", "potential_factors", "wave_rows",
           "message_blocks", "groups", "group_blocks", "absorb_rows")


def _device_tables(plan, device):
    """The plan's tables in one int64 buffer on ``device`` (uploaded once per
    device and kept on the plan), and each wave's launch arguments: pointers
    to its slices of the tables and its grid sizes."""
    entry = plan.device_tables.get(device)
    if entry is not None:
        # order this stream behind the upload, whichever stream made it
        torch.cuda.current_stream(device).wait_event(entry["uploaded"])
        return entry
    tables = {name: getattr(plan, name) for name in _TABLES if name != "wave_rows"}
    tables["wave_rows"] = plan.messages[plan.wave_messages]  # a wave's rows are one slice
    arrays = [np.ascontiguousarray(tables[name], dtype=np.int64).ravel() for name in _TABLES]
    starts = np.concatenate([[0], np.cumsum([a.size for a in arrays])])
    flat = np.concatenate(arrays + [np.zeros(1, dtype=np.int64)])
    buf = torch.from_numpy(flat).pin_memory().to(device, non_blocking=True)
    uploaded = torch.cuda.Event()
    uploaded.record(torch.cuda.current_stream(device))
    ptr = {name: buf.data_ptr() + 8 * int(s) for name, s in zip(_TABLES, starts)}
    message_row, group_row = 8 * plan.messages.shape[1], 8 * plan.groups.shape[1]
    waves = []
    for w in range(plan.n_waves):
        lo, hi = (int(x) for x in plan.wave_message_start[w:w + 2])
        glo, ghi = (int(x) for x in plan.wave_group_start[w:w + 2])
        waves.append({"messages": (ptr["wave_rows"] + message_row * lo,
                                   ptr["message_blocks"] + 8 * lo, lo, hi - lo,
                                   int(plan.sepset_blocks[w])),
                      "groups": (ptr["groups"] + group_row * glo, ptr["group_blocks"] + 8 * glo,
                                 ghi - glo, int(plan.absorb_blocks[w]))})
    entry = {"buffer": buf, "uploaded": uploaded, "ptr": ptr, "waves": waves, "tickets": {},
             "factor_pointers": (None, None, None)}
    plan.device_tables[device] = entry
    return entry


def _tickets(plan, entry, tensor):
    """``sepset_wave``'s per-message tickets (in wave order) for the current
    stream: zeroed once (every launch leaves them zero), one set per stream,
    so that two streams calibrating one plan at once do not share them."""
    stream = torch.cuda.current_stream(tensor.device)
    tickets = entry["tickets"].get(stream.cuda_stream)
    if tickets is None:
        tickets = torch.zeros(max(len(plan.messages), 1), dtype=torch.int32,
                              device=tensor.device)
        entry["tickets"][stream.cuda_stream] = tickets
    return tickets


def _factor_pointers(entry, arrays, device):
    """A device table of the factor tables' addresses; uploaded again only
    when an address changes (a caller that calibrates the same tables again
    and again uploads it once)."""
    key = tuple(a.data_ptr() for a in arrays)
    kept, table, uploaded = entry["factor_pointers"]
    if kept == key:
        torch.cuda.current_stream(device).wait_event(uploaded)
        return table
    table = torch.tensor(list(key) or [0], dtype=torch.int64).pin_memory().to(
        device, non_blocking=True)
    uploaded = torch.cuda.Event()
    uploaded.record(torch.cuda.current_stream(device))
    entry["factor_pointers"] = (key, table, uploaded)
    return table


def _launched(err, name):
    global JT_LAUNCHES
    if err != 0:
        raise RuntimeError(f"jt_calibrate {name} launch failed: cudaError_t {err}")
    JT_LAUNCHES += 1
    LAUNCHES[name] += 1


def _stream(tensor):
    return torch.cuda.current_stream(tensor.device).cuda_stream


def clique_potentials_cuda(plan, factor_arrays, arena):
    """``clique_potentials``: stage 0 for every clique into ``arena`` in one
    launch.  ``factor_arrays`` are contiguous, of the arena's type and on
    its card."""
    shared_bytes = potential_shared(plan)
    if shared_bytes > SHARED_LIMIT:
        raise ValueError(f"clique_potentials: a block needs {shared_bytes} bytes of shared "
                         f"memory for its factors' strides and row offsets, more than "
                         f"{SHARED_LIMIT}")
    with torch.cuda.device(arena.device):
        entry = _device_tables(plan, arena.device)
        ptr = entry["ptr"]
        pointers = _factor_pointers(entry, factor_arrays, arena.device)
        _launched(_library().pgmpy_jt_clique_potentials(
            arena.element_size(), arena.data_ptr(), ptr["potentials"], ptr["potential_starts"],
            len(plan.potentials), ptr["potential_factors"], pointers.data_ptr(),
            plan.potential_blocks, shared_bytes, plan.width, _stream(arena)),
            "clique_potentials")


def sepset_wave_cuda(plan, w, arena, sepsets, scratch, partial, operation="marginalize",
                     normalize=False):
    """``sepset_wave``: every message of wave ``w`` in one launch; sigma into
    ``sepsets``, the ratio into the message's slot of ``scratch``.  A message
    cut into chunks (every message, with ``normalize``) combines its double
    partials in ``partial`` (``plan.partial_size`` float64 entries)."""
    with torch.cuda.device(arena.device):
        entry = _device_tables(plan, arena.device)
        rows, msg_blocks, lo, n_msgs, n_blocks = entry["waves"][w]["messages"]
        _launched(_library().pgmpy_jt_sepset_wave(
            arena.element_size(), int(operation == "maximize"), int(normalize),
            arena.data_ptr(), sepsets.data_ptr(), scratch.data_ptr(), partial.data_ptr(),
            _tickets(plan, entry, arena).data_ptr() + 4 * lo, rows, msg_blocks, n_msgs,
            n_blocks, plan.width, TINY, _stream(arena)), "sepset_wave")


def absorb_wave_cuda(plan, w, arena, scratch):
    """``absorb_wave``: wave ``w``'s ratios multiplied into their
    destinations in one launch, 2,048 destination entries per block."""
    with torch.cuda.device(arena.device):
        entry = _device_tables(plan, arena.device)
        groups, group_blocks, n_groups, n_blocks = entry["waves"][w]["groups"]
        _launched(_library().pgmpy_jt_absorb_wave(
            arena.element_size(), arena.data_ptr(), scratch.data_ptr(), groups, group_blocks,
            n_groups, entry["ptr"]["absorb_rows"], n_blocks, plan.width, _stream(arena)),
            "absorb_wave")


def wave_scratch(plan, arena):
    """(ratio scratch, double partials) for a calibration on ``arena``'s card."""
    return (torch.empty(max(plan.scratch_size, 1), dtype=arena.dtype, device=arena.device),
            torch.empty(max(plan.partial_size, 1), dtype=torch.float64, device=arena.device))


def calibrate_waves_cuda(plan, factor_arrays, operation="marginalize", normalize=False):
    """The hand-written kernels on the current stream: ``clique_potentials``
    once, then ``sepset_wave`` and ``absorb_wave`` per wave.  Returns (belief
    arena, sepset arena), both fresh."""
    if plan.width > MAX_AXES:
        raise ValueError(f"calibrate_waves_cuda: a clique has {plan.width} axes, the kernels "
                         f"take at most {MAX_AXES}")
    if operation not in ("marginalize", "maximize"):
        raise ValueError(f"calibrate: unknown operation {operation!r}")
    device, dtype = _inputs(plan, factor_arrays)
    if device.type != "cuda":
        raise ValueError("calibrate_waves_cuda: the factor tables must be on a CUDA device")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"calibrate_waves_cuda: float32 or float64 tables, got {dtype}")
    arrays = [a.to(dtype).contiguous() for a in factor_arrays]
    arena = torch.empty(plan.total, dtype=dtype, device=device)
    sepsets = torch.empty(plan.sepset_total, dtype=dtype, device=device)
    if plan.total == 0:
        return arena, sepsets
    scratch, partial = wave_scratch(plan, arena)
    clique_potentials_cuda(plan, arrays, arena)
    for w in range(plan.n_waves):
        sepset_wave_cuda(plan, w, arena, sepsets, scratch, partial, operation, normalize)
        absorb_wave_cuda(plan, w, arena, scratch)
    return arena, sepsets


def calibrate_waves(plan, factor_arrays, operation="marginalize", normalize=False):
    """Dispatch: the CUDA kernels for CUDA tensors, the plain version for CPU
    tensors.  Returns (belief arena, sepset arena)."""
    device = factor_arrays[0].device if len(factor_arrays) else config.DEVICE
    if device.type == "cuda":
        return calibrate_waves_cuda(plan, factor_arrays, operation, normalize)
    if device.type == "cpu":
        return calibrate_waves_reference(plan, factor_arrays, operation, normalize)
    raise ValueError(f"calibrate: unsupported device {device}")
