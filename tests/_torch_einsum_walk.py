"""A numpy walk of the step tables that ``csrc/einsum_plan.cu`` reads (K3's
``plan_block`` / ``plan_grid``, K10's ``filter_scan``): the only CPU check of
what the CUDA threads compute.

``plan_grid``'s int64 step rows are read word by word as the kernel reads
them: its inputs' slots (an operand pointer, or an arena offset), the output
slot, the merged output and reduced extents (innermost first), each input's
strides per label, and the lanes and chunk each output entry is split into.
Every (output, lane) sums its chunk of reduced entries, then the lanes are
added.  The walk also asserts what the kernel takes for granted: lanes a
power of two that divides the block, the chunks covering every reduced
entry, a step's output never overlapping a live intermediate nor the step's
own inputs (the threads of a step over the grid read while others write;
only the barrier after the step orders them), and every intermediate read
once, by a later step than the one that wrote it.  :func:`grid_cover` walks
``plan_grid``'s stride: every (output, lane) task of every step is worked
exactly once by a grid of any size.

``plan_block`` and K10 share the level schedule: int32 step rows and offset
pairs in one launch buffer (:func:`parse_buffer` reads it back as
``level_table`` does on the card), walked level by level
(:func:`walk_levels`, :func:`walk_scan`; :func:`check_scan_schedule`: no
step reads or overwrites what another step of its level writes, each step's
level one more than its inputs', every warp's work in its level), the
operands read through their staged offsets where the launch stages them.
``random_signature``, ``network_signature`` and ``wide_case`` make the
seeded contractions both the CPU and the card's tests run."""

import math

import numpy as np

from pgmpy_tpu_torch.ops import einsum as E


def flat(tensor):
    """The storage a tensor's data pointer and strides address, as float64."""
    if tensor.numel() == 0:
        return np.zeros(0)
    n = sum((s - 1) * st for s, st in zip(tensor.shape, tensor.stride())) + 1
    return tensor.as_strided((n,), (1,), tensor.storage_offset()).double().numpy()


def _digits(ext, count):
    if not len(ext):
        return np.zeros((count, 0), dtype=np.int64)
    radix = np.cumprod([1] + [int(e) for e in ext[:-1]])
    return np.arange(count)[:, None] // radix[None, :] % np.asarray(ext, dtype=np.int64)[None, :]


def walk_steps(rows, operands, arena, out, threads, base=0, live=None):
    """Run table ``rows`` over ``operands`` (flat arrays by pointer index),
    the float64 ``arena`` (intermediates from offset ``base`` up) and the flat
    ``out``; ``live`` tracks the intermediates written and not yet read."""
    h, L = len(E.HEADER), E.MAX_LABELS
    live = {} if live is None else live
    for row in rows:
        n_in, in0, in1, oslot, n_out, n_red, oc, rc, lanes, chunk = (int(x) for x in row[:h])
        assert lanes & (lanes - 1) == 0 and lanes <= threads and threads % lanes == 0
        assert lanes * chunk >= rc
        assert n_out <= L and n_red <= L and n_in in (1, 2)
        ext_o, ext_r = row[h:h + n_out], row[h + L:h + L + n_red]
        assert oc == math.prod(int(e) for e in ext_o) and rc == math.prod(int(e) for e in ext_r)
        do, dr = _digits(ext_o, oc), _digits(ext_r, rc)
        prod = np.ones((oc, rc))
        read = []  # the step's arena inputs: (offset, size)
        for k, slot in enumerate((in0, in1)[:n_in]):
            s_o = row[h + (2 + 2 * k) * L:h + (2 + 2 * k) * L + n_out]
            s_r = row[h + (3 + 2 * k) * L:h + (3 + 2 * k) * L + n_red]
            offsets = (do @ s_o)[:, None] + (dr @ s_r)[None, :]
            if slot >= 0:
                source = operands[slot]
            else:
                offset = -1 - slot
                if offset >= base:  # an intermediate: read once, then dead
                    assert offset in live, f"step reads arena {offset}, never written or read"
                    read.append((offset, live.pop(offset)))
                source = arena[offset:]
            if offsets.size:
                prod = prod * source[offsets]
        padded = np.zeros((oc, lanes * chunk))
        padded[:, :rc] = prod
        result = padded.reshape(oc, lanes, chunk).sum(axis=2).sum(axis=1)
        if oslot < 0:
            out[:oc] = result
        else:
            if oslot >= base:
                for start, size in list(live.items()) + read:
                    assert oslot + max(oc, 1) <= start or start + size <= oslot, \
                        "a step's output overlaps a live intermediate or its own input"
                live[oslot] = max(oc, 1)
            arena[oslot:oslot + oc] = result
    return live


def grid_cover(table, blocks, threads=E.GRID_THREADS):
    """``plan_grid``'s stride over ``blocks`` blocks of ``threads``: thread j
    of block b works tasks ``b * threads + j + k * blocks * threads`` of every
    step (``run_tasks``); asserts that each (output, lane) task of each step
    is worked exactly once.  Returns the rounds of the largest step."""
    stride = blocks * threads
    rounds = 0
    for row in table.steps:
        tasks = int(row[6]) * int(row[8])
        steps_rounds = -(-tasks // stride)
        worked = (np.arange(stride)[:, None] + stride * np.arange(steps_rounds)[None, :]).ravel()
        worked = worked[worked < tasks]
        assert np.array_equal(np.bincount(worked, minlength=tasks), np.ones(tasks, np.int64)), \
            "a task is worked twice or never"
        rounds = max(rounds, steps_rounds)
    return rounds


def walk_plan(table, arrays, out_shape):
    """A :class:`PlanTable` over torch ``arrays`` -> the contraction (float64).
    ``plan_block``: its launch buffer parsed and walked level by level
    (:func:`walk_levels`).  ``plan_grid``: its stride walked at one block, at
    its ``grid`` (the blocks its largest step's tasks fill: one round) and
    between."""
    arena = np.full(max(table.arena, 1), np.nan)
    out = np.full(math.prod(out_shape), np.nan)
    if table.schedule == "plan_block":
        walk_levels(table, [flat(a) for a in arrays], arena, out)
        return out.reshape(out_shape)
    threads = E.GRID_THREADS
    live = walk_steps(table.steps, [flat(a) for a in arrays], arena, out, threads)
    assert not live, "an intermediate was never read"
    tasks = table.steps[:, 6] * table.steps[:, 8]
    assert 1 <= table.grid <= E.MAX_GRID_BLOCKS
    assert table.grid == min(E.MAX_GRID_BLOCKS, max(1, -(-int(tasks.max()) // threads)))
    for blocks in sorted({1, 7, max(1, table.grid // 2), table.grid}):
        grid_cover(table, blocks, threads)
    assert table.grid == E.MAX_GRID_BLOCKS or grid_cover(table, table.grid, threads) <= 1
    return out.reshape(out_shape)


def parse_buffer(buf, n_steps, n_results, n_levels, n_work, n_ptrs):
    """A level launch's int32 buffer read as ``level_table`` reads it on the
    card: (rows (n_steps, SCAN_ROW), results (n, 4), level_start, work (n,
    3), each operand's staged offset, each operand's span, pairs (n, 2))."""
    at = 0

    def take(n):
        nonlocal at
        part = buf[at:at + n]
        at += n
        return part

    rows = take(n_steps * E.SCAN_ROW).reshape(n_steps, E.SCAN_ROW)
    results = take(4 * n_results).reshape(-1, 4)
    level_start = take(n_levels * E.SCAN_WARPS + 1)
    work = take(3 * n_work).reshape(-1, 3)
    offsets, spans = take(n_ptrs), take(n_ptrs)
    at += at % 2  # the pairs start 8-byte aligned
    pairs = buf[at:].reshape(-1, 2)
    return rows, results, level_start, work, offsets, spans, pairs


def staged_operands(operands, offsets, spans):
    """The operands as ``stage_levels`` lays them out in shared memory: each
    span at its offset of one flat array; returns the views the kernel's
    ``scan_input`` reads (``s_ops + op_off[slot]``)."""
    assert [len(o) for o in operands] == spans.tolist()
    assert np.array_equal(offsets, np.concatenate([[0], np.cumsum(spans)[:-1]]).astype(offsets.dtype)
                          if len(spans) else offsets)
    flat_ops = np.concatenate(operands) if operands else np.zeros(0)
    return [flat_ops[int(o):] for o in offsets]


def walk_levels(table, operands, arena, out):
    """A ``plan_block`` :class:`PlanTable` over the flat ``operands``: its
    buffer parsed back (equal to the table's rows, level starts, work items
    and pairs), the schedule checked (:func:`check_scan_schedule`), then
    level after level each step (within a level in reverse, to show that
    order does not matter), its operands read through their staged offsets
    where the launch stages them; the last step writes ``out``."""
    n_ptrs = len(operands)
    rows, results, level_start, work, offsets, spans, pairs = parse_buffer(
        table.buffer, len(table.steps), 0, table.n_levels, len(table.work), n_ptrs)
    assert np.array_equal(rows, table.steps) and np.array_equal(pairs, table.pairs)
    assert np.array_equal(level_start, table.level_start) and np.array_equal(work, table.work)
    assert len(results) == 0
    check_scan_schedule(table, rows, pairs)
    if table.staged:
        operands = staged_operands(operands, offsets, spans)
        assert table.shared_bytes <= E.SCAN_SHARED_LIMIT
    finals = [s for s in range(len(rows)) if rows[s, 3] < 0]
    assert finals == [len(rows) - 1], "the last step, and only it, writes the call's output"
    for level in range(table.n_levels):
        for s in np.flatnonzero(table.levels == level)[::-1]:
            walk_scan_step(rows, pairs, s, operands, arena, [], out)


def scan_step(rows, pairs, s):
    """Step ``s`` of a filter_scan table: (n_in, in0, in1, out, out_count,
    free, lanes, pinned outputs [(var, place, ext)], pinned reduced [(var,
    qplace, ext)], output pairs (out_count, 2), reduced pairs (free x the
    pinned extents, 2))."""
    row = rows[s]
    n_in, in0, in1, out, oc, free, lanes, n_po, n_pr, at_o, at_r = (int(x) for x in row[:11])
    h, L = E.SCAN_HEADER, E.MAX_LABELS
    pin_out = [tuple(int(x) for x in row[h + 3 * i:h + 3 * i + 3]) for i in range(n_po)]
    pin_red = [tuple(int(x) for x in row[h + 3 * L + 3 * i:h + 3 * L + 3 * i + 3])
               for i in range(n_pr)]
    red = free * math.prod(e for _, _, e in pin_red)
    return (n_in, in0, in1, out, oc, free, lanes, pin_out, pin_red, pairs[at_o:at_o + oc],
            pairs[at_r:at_r + red])


def scan_regions(rows, pairs):
    """Per step (the arena regions it reads, the region it writes), each
    (offset, entries): an input reads up to its largest offset pair; a step
    writing the call's output (slot -1, plan_block's last) writes no arena
    region (None)."""
    out = []
    for s in range(len(rows)):
        n_in, in0, in1, oslot, oc, *_, out_pairs, red_pairs = scan_step(rows, pairs, s)
        reads = []
        for k, slot in enumerate((in0, in1)[:n_in]):
            if slot < 0:  # an empty step reads nothing, but still after its input
                reach = (int(out_pairs[:, k].max()) + int(red_pairs[:, k].max()) + 1
                         if len(out_pairs) and len(red_pairs) else 0)
                reads.append((-1 - slot, reach))
        assert oslot >= -1, "a step writes before the arena"
        out.append((reads, None if oslot < 0 else (oslot, max(oc, 1))))
    return out


def _overlap(a, b):
    return a[0] < b[0] + b[1] and b[0] < a[0] + a[1]


def input_levels(levels, rows, pairs):
    """Each step's level as its inputs give it: one more than the highest
    level of the steps that produce its arena inputs (0 where it reads
    operands only).  An input's producer is the step that writes a region
    starting at the input's offset at the highest level below the reader's;
    asserts that the reader stays within that region and that no other step
    at a level from the producer's to the reader's overwrites what it reads.
    (Offsets are reused across levels, so table order says nothing.)"""
    regions = scan_regions(rows, pairs)
    out = []
    for s, (reads, _) in enumerate(regions):
        need = 0
        for r in reads:
            producers = [w for w in range(len(rows)) if regions[w][1] is not None
                         and regions[w][1][0] == r[0] and levels[w] < levels[s]]
            if not producers:  # K10's alpha: written by the normalisation, not a step
                continue
            p = max(producers, key=lambda w: levels[w])
            assert r[1] <= regions[p][1][1], "a step reads past its input's region"
            for w in range(len(rows)):
                if w != p and regions[w][1] is not None and levels[p] <= levels[w] <= levels[s]:
                    assert not _overlap(r, regions[w][1]), \
                        f"step {w} overwrites what step {s} reads before it reads it"
            need = max(need, int(levels[p]) + 1)
        out.append(need)
    return np.array(out, dtype=np.int64)


def check_scan_schedule(program, rows, pairs):
    """What ``run_levels`` takes for granted of its tables: within a level
    no step reads what a step of the same level writes (its own output
    included) and no two steps write overlapping entries; every (level,
    warp)'s work items lie in that level, and each step's items are ranks 0
    .. group - 1 of one group of warps, each warp once; lanes a power of two
    up to a warp; every offset inside its input.  Returns the number of
    barriers a slice (levels + 1)."""
    regions = scan_regions(rows, pairs)
    levels = program.levels
    assert len(levels) == len(rows) and levels.min() == 0
    assert set(levels.tolist()) == set(range(program.n_levels))
    assert np.array_equal(input_levels(levels, rows, pairs), levels)
    for level in range(program.n_levels):
        members = np.flatnonzero(levels == level)
        writes = [regions[s][1] for s in members if regions[s][1] is not None]
        for i, w in enumerate(writes):
            assert not any(_overlap(w, x) for x in writes[i + 1:]), "two writes of a level overlap"
            for s in members:
                for r in regions[s][0]:
                    assert not _overlap(r, w), "a step reads what a step of its level writes"
    lanes = rows[:, 6]
    assert ((lanes & (lanes - 1)) == 0).all() and (lanes <= 32).all() and (lanes >= 1).all()
    assert (pairs >= 0).all()
    start, work = program.level_start, program.work
    assert len(start) == program.n_levels * E.SCAN_WARPS + 1 and start[0] == 0
    assert start[-1] == len(work) and (np.diff(start) >= 0).all()
    seen = {}
    for level in range(program.n_levels):
        for w in range(E.SCAN_WARPS):
            for item in range(start[level * E.SCAN_WARPS + w],
                              start[level * E.SCAN_WARPS + w + 1]):
                step, rank, group = (int(x) for x in work[item])
                assert levels[step] == level
                seen.setdefault(step, []).append((rank, group, w))
    assert sorted(seen) == list(range(len(rows))), "a step has no warp"
    for step, items in seen.items():
        group = items[0][1]
        assert sorted(r for r, _, _ in items) == list(range(group))
        assert all(g == group for _, g, _ in items)
        assert len({w for _, _, w in items}) == group
    return program.n_levels + 1


def walk_scan_step(rows, pairs, s, operands, arena, code, out=None):
    """Step ``s`` of a level table in numpy, as ``scan_partial`` reads it:
    per output entry its offset pair, zero where a pinned output digit
    differs from the slice's code; per reduced entry its pair, the pinned
    reduced labels held to the slice's codes (those it leaves unobserved
    walked); each lane's chunk of the entries summed, then the lanes.  A
    step whose output slot is -1 writes ``out``."""
    n_in, in0, in1, oslot, oc, free, lanes, pin_out, pin_red, out_pairs, red_pairs = \
        scan_step(rows, pairs, s)
    keep_o = np.ones(oc, dtype=bool)
    o = np.arange(oc)
    for var, place, ext in pin_out:
        if code[var] >= 0:
            keep_o &= o // place % ext == code[var]
    q = np.arange(len(red_pairs)) // free
    keep_r = np.ones(len(red_pairs), dtype=bool)
    for var, qplace, ext in pin_red:
        if code[var] >= 0:
            keep_r &= q // qplace % ext == code[var]
    chosen = red_pairs[keep_r]
    count = len(chosen)
    chunk = -(-count // lanes)
    assert lanes * chunk >= count
    prod = np.ones((oc, count))
    for k, slot in enumerate((in0, in1)[:n_in]):
        source = operands[slot] if slot >= 0 else arena[-1 - slot:]
        prod = prod * source[out_pairs[:, k][:, None] + chosen[:, k][None, :]]
    padded = np.zeros((oc, lanes * chunk))
    padded[:, :count] = prod
    result = padded.reshape(oc, lanes, chunk).sum(axis=2).sum(axis=1)
    if oslot < 0:
        out[:oc] = np.where(keep_o, result, 0.0)
    else:
        arena[oslot:oslot + oc] = np.where(keep_o, result, 0.0)


def walk_scan(program, alpha, trans, codes):
    """A :class:`ScanProgram` over ``alpha``, the transition tensors and the
    (slices, variables) codes -> the (slices, width) normalised marginals,
    as ``filter_scan`` computes them slice by slice: the tables of the
    codes' pattern, level after level (within a level in reverse, to show
    that order does not matter), then the normalisations."""
    codes = np.asarray(codes)
    observed = tuple(int(j) for j in np.flatnonzero((codes >= 0).any(axis=0)))
    rows, pairs = program.tables_for(observed)
    parsed = parse_buffer(program.table(observed), len(rows), len(program.results),
                          program.n_levels, len(program.work), len(trans))
    for part, want in zip(parsed, (rows, program.results, program.level_start, program.work)):
        assert np.array_equal(part, want)
    assert np.array_equal(parsed[-1], pairs) and np.array_equal(parsed[-2], program.spans)
    check_scan_schedule(program, rows, pairs)
    arena = np.full(program.arena, np.nan)
    arena[:program.alpha_size] = alpha.contiguous().reshape(-1).double().numpy()
    operands = [flat(t) for t in trans]
    if program.layout(observed)[0]:
        operands = staged_operands(operands, parsed[4], parsed[5])
    assert [len(o) for o in map(flat, trans)] == program.spans.tolist()
    out = np.full((codes.shape[0], program.width), np.nan)
    for t, code in enumerate(codes):
        for level in range(program.n_levels):
            for s in np.flatnonzero(program.levels == level)[::-1]:
                walk_scan_step(rows, pairs, s, operands, arena, code)
        for offset, entries, column, _ in program.results:
            m = arena[offset:offset + entries].copy()
            with np.errstate(invalid="ignore", divide="ignore"):
                m = m / m.sum()
            if column < 0:
                arena[:entries] = m
            else:
                out[t, column:column + entries] = m
    return out


def random_signature(seed, batch=False):
    """(operand labels, output labels, float64 arrays) of a random
    contraction: 1-12 operands over up to 8 labels of extent 1-4 (scalars
    among them), the labels spread out (not 0..n-1), the output a random
    ordered subset; with ``batch`` a label of extent 7 on some operands and
    first in the output."""
    rng = np.random.default_rng(seed)
    n_ops = int(rng.integers(1, 13))
    n_labels = int(rng.integers(1, 9))
    labels = [int(a) for a in rng.choice(50, n_labels, replace=False)]
    ext = {a: int(rng.integers(1, 5)) for a in labels}
    axes = []
    for _ in range(n_ops):
        k = min(int(rng.integers(0, 4)), n_labels)
        axes.append(tuple(int(a) for a in rng.choice(labels, k, replace=False)))
    present = list(dict.fromkeys(a for ax in axes for a in ax))
    out = tuple(int(a) for a in rng.permutation(present)[: int(rng.integers(0, len(present) + 1))])
    if batch:
        b = 51
        ext[b] = 7
        axes = [(b,) + ax if rng.random() < 0.5 or i == 0 else ax for i, ax in enumerate(axes)]
        out = (b,) + out
    arrays = [rng.random([ext[a] for a in ax]) + 0.1 for ax in axes]
    return axes, out, arrays


def network_signature(seed, n_vars=None):
    """(operand labels, output labels, float64 arrays) of a random network's
    marginal: 12-40 CPD-like factors (a variable and up to three earlier
    parents, 2-4 states each, labels spread out) contracted to one or two of
    its variables; the greedy plan of such a contraction has several steps a
    level."""
    rng = np.random.default_rng(1000 + seed)
    n = n_vars or int(rng.integers(12, 41))
    labels = [int(a) for a in rng.choice(400, n, replace=False)]
    ext = {a: int(rng.integers(2, 5)) for a in labels}
    axes = []
    for i, a in enumerate(labels):
        parents = rng.choice(i, size=min(i, int(rng.integers(0, 4))), replace=False) if i else []
        axes.append((a,) + tuple(labels[int(p)] for p in parents))
    out = tuple(int(a) for a in rng.choice(labels, int(rng.integers(1, 3)), replace=False))
    arrays = [rng.random([ext[a] for a in ax]) + 0.1 for ax in axes]
    return axes, out, arrays


# steps of 13-16 binary output labels, more than MAX_LABELS: the block's
# offset pairs carry unpinned labels, so no row slot limits them
WIDE_CASES = {
    # (operand labels, output labels, the step whose output is wide)
    "marginal_13_of_14": ([tuple(range(14))], tuple(range(13)), -1),
    "product_16": ([tuple(range(8)), tuple(range(8, 16))], tuple(range(16)), -1),
    "product_16_reversed": ([tuple(range(10)), tuple(range(6, 16))], tuple(range(15, -1, -1)),
                            -1),
    "intermediate_13": ([tuple(range(7)), tuple(range(7, 14)), tuple(range(14)), (14,)],
                        tuple(range(13)), 0),
    "intermediate_15": ([tuple(range(8)), tuple(range(8, 16)), tuple(range(16)), (16,)],
                        tuple(range(15)), 0),
}


def wide_case(name):
    """One of ``WIDE_CASES`` on seeded binary operands: (operand labels,
    output labels, float64 arrays, the output labels of the step named
    wide)."""
    axes, out, wide = WIDE_CASES[name]
    rng = np.random.default_rng(len(name))
    arrays = [rng.random((2,) * len(ax)) + 0.1 for ax in axes]
    plan = E.contraction_plan(tuple(axes), out, tuple((2,) * len(ax) for ax in axes))
    return axes, out, arrays, plan[wide][1]
