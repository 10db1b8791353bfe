"""Interleaved-format einsum helpers: the device-side contraction core (K3).

Port of ``pgmpy_tpu/ops/einsum.py``.  A host-side planner maps variable
names to integer axis labels; a contraction is given as operands aligned
with tuples of labels plus the output labels, and its ``opt_einsum`` path is
computed once per static (axes, shapes) signature and cached.

* On CUDA tensors, the hand-written kernels of ``csrc/einsum_plan.cu`` (built
  with ``nvcc`` at first use) run the cached plan, compiled once per
  signature (:class:`PlanTable`), in ONE launch: ``plan_block`` runs the
  whole plan in one block, its steps grouped by dependency level (one
  barrier a level) on int32 rows and offset-pair tables, as K10 runs a
  slice; ``plan_grid`` runs it as one cooperative launch over as many blocks
  as the card holds at once, a grid barrier between steps.  ``plan_block``
  is chosen where every step's union (output entries x reduced entries) is
  at most ``BLOCK_UNION`` and its modelled time is at most the grid's
  (:func:`block_units`, :func:`grid_work`).  A build or launch failure raises.
* On CPU tensors, the plain version :func:`_run_plan`: each step a two-operand
  (or one-operand) ``torch.einsum`` whose labels are renumbered into
  ``[0, 52)`` (``torch.einsum``'s sublist form rejects labels outside it, and
  a MUNIN covering subtree has more variables than that; it takes no
  contraction path either).  Float32 products run in full f32 (``config``
  disables TF32).

The same step rows, with the evidence folded in, drive ``forward_scan``'s
exact filter (K10, :class:`ScanProgram`): every slice's contractions run
inside one ``filter_scan`` launch, level by level.

It replaces ``pgmpy_tpu/ops/einsum.py:26`` ``sum_product``, ``:57``
``_cached_path`` and ``:73`` ``sum_product_planned`` (one XLA program per
signature), and ``pgmpy_tpu/inference/dbn.py:131`` ``forward_scan``'s
``lax.scan``.  ``LAUNCHES`` counts each K3 kernel's launches (one a
contraction), ``SCAN_LAUNCHES`` the filter's; :func:`reset_launches` zeroes
both.
"""

import ctypes
import math
from functools import lru_cache

import numpy as np
import torch

# plan_block is considered only where no step's union is larger (it bounds
# the block's offset tables); it is then chosen where the level model's time
# (block_units) is at most the grid's (grid_work).  The constants are a
# least-squares fit (in relative error) of both schedules' device times on
# an H100 (700 W) by tools/k3_schedules.py over its 14 contractions (9
# synthetic, 5 of MUNIN's): with them the models pick the faster schedule on
# all 14, where the largest union alone (at most BLOCK_UNION) picked the
# slower one on 7.
BLOCK_UNION = 1 << 16
BLOCK_LAUNCH_US = 2.96  # plan_block: a launch and its staging
BLOCK_UNIT_US = 0.0860  # plan_block: one unit of _scan_cost on a level's costliest warp
GRID_LAUNCH_US = 2.81  # plan_grid: a launch
GRID_STEP_US = 2.03  # plan_grid: a step and its grid barrier
GRID_ENTRY_US = 0.333  # plan_grid: a reduced entry a lane walks (its digits decoded)
GRID_RESIDENT = 132 * 2048  # plan_grid's tasks in one round: an H100's resident threads
SCAN_JOINT = 1 << 16  # filter_scan: a slice's joint of at most so many entries is one contraction
MAX_LABELS = 12  # output labels, and reduced labels, of one step after merging
MAX_OPERANDS = 448  # operand pointers in the launch's parameter block (3,584 of 4,096 bytes)
BLOCK_THREADS = 512  # plan_block's and filter_scan's one block
GRID_THREADS = 256  # a block of plan_grid
GRID_LANE_ENTRIES = 8  # reduced entries a plan_grid lane sums, aimed at
SHARED_ARENA_BYTES = 160 * 1024  # a block's intermediates in shared memory up to this
SCAN_WARPS = BLOCK_THREADS // 32  # the warps dealt among a level's steps (plan_block, filter_scan)
SCAN_SETUP = 8  # a level task's set-up, in reduced entries, when dealing warps and lanes
SCAN_STAGE_BYTES = 160 * 1024  # a level launch's operands and tables in shared memory up to this
SCAN_SHARED_LIMIT = 227 * 1024  # a level launch's dynamic shared memory at most
SCAN_PATTERNS = 16  # observed patterns whose tables a ScanProgram keeps (the oldest dropped)
MAX_GRID_BLOCKS = 1 << 20  # plan_grid's blocks asked for at most (they stride over the rest)

# one step of plan_grid's table (int64): a header, then MAX_LABELS words
# each of the output extents, the reduced extents, and the first and second
# input's strides per output label and per reduced label (innermost label
# first, 0 where absent)
HEADER = ("n_in", "in0", "in1", "out", "n_out", "n_red", "out_count", "red_count", "lanes",
          "chunk")
STEP_WORDS = len(HEADER) + 6 * MAX_LABELS
# a level step (plan_block and filter_scan; int32): n_in, in0, in1, out (-1:
# the call's output), out_count, free reduced count, lanes, pinned outputs,
# pinned reduced, where its output and its reduced offset pairs start, 0;
# then MAX_LABELS (variable, place, extent) triples of pinned output labels
# and MAX_LABELS of pinned reduced labels
SCAN_HEADER = 12
SCAN_ROW = SCAN_HEADER + 6 * MAX_LABELS

LAUNCHES = {"plan_block": 0, "plan_grid": 0}
SCAN_LAUNCHES = 0


def reset_launches():
    global SCAN_LAUNCHES
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    SCAN_LAUNCHES = 0


def _relabel_einsum(pairs, out_axes):
    """``torch.einsum`` in sublist form over ``pairs`` of (tensor, labels),
    with the labels renumbered densely from 0."""
    dense = {}
    args = []
    for arr, axes in pairs:
        args.append(arr)
        args.append([dense.setdefault(a, len(dense)) for a in axes])
    args.append([dense[a] for a in out_axes])
    return torch.einsum(*args)


def _run_plan(operand_axes, out_axes, arrays, plan):
    """Plain version: execute a contraction plan (see
    :func:`contraction_plan`) one ``torch.einsum`` step at a time."""
    ops = [(arr, tuple(axes)) for arr, axes in zip(arrays, operand_axes)]
    for step, keep in plan:
        picked = [ops[i] for i in step]
        for i in sorted(step, reverse=True):
            del ops[i]
        ops.append((_relabel_einsum(picked, keep), keep))
    if len(ops) != 1:
        raise ValueError("contraction path did not reduce to one operand")
    return _relabel_einsum(ops, tuple(out_axes))


@lru_cache(maxsize=4096)
def contraction_plan(operand_axes, out_axes, shapes, optimize="greedy"):
    """The contraction plan of a static signature: opt_einsum's path (a list
    of operand-position tuples) with, for each step, the labels its result
    keeps.  A label is kept if the output or any operand not yet contracted
    still needs it.  Cached, so planning is paid once per signature."""
    import opt_einsum

    interleaved = []
    for axes, shape in zip(operand_axes, shapes):
        interleaved.append(np.empty(shape))
        interleaved.append(list(axes))
    interleaved.append(list(out_axes))
    path, _ = opt_einsum.contract_path(*interleaved, optimize=optimize)

    ops = [tuple(axes) for axes in operand_axes]
    # how many live operands still carry each label
    uses = {}
    for axes in ops:
        for a in set(axes):
            uses[a] = uses.get(a, 0) + 1
    out_set = set(out_axes)
    plan = []
    for step in path:
        picked = [ops[i] for i in step]
        for i in sorted(step, reverse=True):
            del ops[i]
        for axes in picked:
            for a in set(axes):
                uses[a] -= 1
        keep = []
        for axes in picked:
            for a in axes:
                if (a in out_set or uses[a] > 0) and a not in keep:
                    keep.append(a)
        keep = tuple(keep)
        for a in keep:
            uses[a] += 1
        ops.append(keep)
        plan.append((tuple(step), keep))
    return tuple(plan)


def largest_intermediate(operand_axes, out_axes, shapes, optimize="greedy"):
    """Elements of the largest tensor the planned contraction of this
    signature builds (its intermediates and its output).  Decided from the
    plan alone, before anything runs."""
    operand_axes = tuple(tuple(ax) for ax in operand_axes)
    shapes = tuple(tuple(int(d) for d in shape) for shape in shapes)
    size = {}
    for axes, shape in zip(operand_axes, shapes):
        size.update(zip(axes, shape))
    plan = contraction_plan(operand_axes, tuple(out_axes), shapes, optimize)
    results = [keep for _, keep in plan] + [tuple(out_axes)]
    return max(int(np.prod([size[a] for a in axes], dtype=np.float64)) for axes in results)


# --------------------------------------------------------------------------- #
# the step table the kernels read
# --------------------------------------------------------------------------- #
def _pow2_ceil(x):
    return 1 << max(int(x) - 1, 0).bit_length()


def step_lanes(out_count, red_count, threads, entries=GRID_LANE_ENTRIES):
    """Lanes per output entry of a step (a power of two, at most ``threads``):
    enough that each sums about ``entries`` reduced entries, more while
    the block's threads would otherwise idle, never more than the reduced
    entries."""
    lanes = _pow2_ceil(-(-red_count // entries)) if red_count else 1
    if out_count * lanes < threads:
        lanes = max(lanes, 1 << (threads // max(out_count, 1)).bit_length() - 1)
    return max(1, min(lanes, _pow2_ceil(max(red_count, 1)), threads))


def _merge(dims):
    """Drop extent-1 labels and merge neighbours that every tensor walks as
    one: ``dims`` are [extent, stride per tensor...] innermost first, and an
    outer label joins the inner one where each stride is the inner stride
    times the inner extent."""
    out = []
    for dim in dims:
        if dim[0] == 1:
            continue
        if out and dim[0] and out[-1][0] and all(
                s == t * out[-1][0] for s, t in zip(dim[1:], out[-1][1:])):
            out[-1] = [out[-1][0] * dim[0]] + out[-1][1:]
        else:
            out.append(list(dim))
    return out


class _Operand:
    __slots__ = ("slot", "labels", "strides")

    def __init__(self, slot, labels, strides):
        self.slot = slot  # >= 0: an operand pointer; < 0: -(1 + arena offset)
        self.labels = tuple(labels)
        self.strides = strides  # label -> stride in elements (summed over repeats)


def label_sizes(operand_axes, shapes):
    """Each label's extent; an axis of extent 1 broadcasts against the
    label's other extents."""
    size = {}
    for axes, shape in zip(operand_axes, shapes):
        for a, n in zip(axes, shape):
            n = int(n)
            if size.get(a, 1) == 1:
                size[a] = n
            elif n not in (1, size[a]):
                raise ValueError(f"einsum_plan: label {a} has extents {size[a]} and {n}")
    return size


def _contiguous(labels, size):
    strides, acc = {}, 1
    for a in reversed(labels):
        strides[a] = strides.get(a, 0) + acc
        acc *= size[a]
    return strides


def _step_row(inputs, out_labels, out_slot, size):
    """One table row (its header's lanes and chunk left 0): ``inputs`` one or
    two :class:`_Operand`, the result written contiguously in
    ``out_labels`` order to ``out_slot`` (-1: the call's output; else an
    arena offset)."""
    if len(set(out_labels)) != len(out_labels):
        raise ValueError(f"einsum_plan: repeated output labels {out_labels}")
    reduced = []
    for op in inputs:
        for a in op.labels:
            if a not in out_labels and a not in reduced:
                reduced.append(a)

    def strides(a):
        return [op.strides.get(a, 0) for op in inputs] + [0] * (2 - len(inputs))

    out_dims = _merge([[size[a]] + strides(a) for a in reversed(out_labels)])
    # reduced labels innermost where the first input's strides are smallest
    red_dims = _merge(sorted(([size[a]] + strides(a) for a in reduced),
                             key=lambda d: (d[1], d[2])))
    for kind, dims in (("output", out_dims), ("reduced", red_dims)):
        if len(dims) > MAX_LABELS:
            raise ValueError(f"einsum_plan: a step has {len(dims)} {kind} labels after merging, "
                             f"beyond the kernel's MAX_LABELS = {MAX_LABELS}")
    row = np.zeros(STEP_WORDS, dtype=np.int64)
    row[:8] = [len(inputs), inputs[0].slot, inputs[1].slot if len(inputs) > 1 else 0, out_slot,
               len(out_dims), len(red_dims), math.prod(d[0] for d in out_dims),
               math.prod(d[0] for d in red_dims)]
    h, L = len(HEADER), MAX_LABELS
    for k, dims in enumerate((out_dims, red_dims)):
        for j, (ext, s0, s1) in enumerate(dims):
            row[h + k * L + j] = ext
            row[h + (2 + k) * L + j] = s0
            row[h + (4 + k) * L + j] = s1
    return row


class _Tmp:
    """An intermediate of a slice: its size, the level of the step that
    writes it and of the one that reads it, and its arena offset once
    placed."""

    __slots__ = ("size", "level", "read", "offset")

    def __init__(self, size):
        self.size, self.level, self.read, self.offset = size, None, None, None


def _symbolic_steps(out_axes, operands, plan, target, size):
    """The steps of one planned contraction as (inputs, output labels,
    output), an input an :class:`_Operand` whose slot is an int (a pointer,
    or -(1 + arena offset)) or a :class:`_Tmp`, the last step's output the
    arena offset ``target``, every other a new :class:`_Tmp`."""
    ops = list(operands)
    steps = []

    def emit(inputs, labels, final):
        out = target if final else _Tmp(max(math.prod(size[a] for a in labels), 1))
        steps.append((inputs, tuple(labels), out))
        return None if final else _Operand(out, labels, _contiguous(labels, size))

    if not plan:
        emit(ops[:1], out_axes, True)
    for index, (step, keep) in enumerate(plan):
        picked = [ops[i] for i in step]
        for i in sorted(step, reverse=True):
            del ops[i]
        last = index == len(plan) - 1
        if last and set(keep) != set(out_axes):
            raise ValueError(f"einsum_plan: the plan ends in {keep}, not {out_axes}")
        while len(picked) > 2:  # a wider step as a chain of pairs
            later = set(keep).union(*(op.labels for op in picked[2:]))
            labels = tuple(dict.fromkeys(a for op in picked[:2] for a in op.labels if a in later))
            picked = [emit(picked[:2], labels, False)] + picked[2:]
        ops.append(emit(picked, out_axes if last else keep, last))
    return steps


def _place(tmps, base):
    """Arena offsets from ``base`` up for the intermediates: two may share
    entries only where one is read at a level before the other is written
    (the steps of a level run at once).  First fit, in order of the level
    that writes them.  Returns the arena's end."""
    end, live = base, []  # live: (offset, size, level read)
    for tmp in sorted(tmps, key=lambda t: t.level):
        live = [entry for entry in live if entry[2] >= tmp.level]
        offset = base
        for start, length, _ in sorted(live):
            if start - offset >= tmp.size:
                break
            offset = max(offset, start + length)
        tmp.offset = offset
        live.append((offset, tmp.size, tmp.read))
        end = max(end, offset + tmp.size)
    return end


def _operands(slots, operand_axes, shapes, strides):
    """One :class:`_Operand` per operand: its slot, and each label's stride
    in elements (summed over repeated labels; a broadcast axis of extent 1
    does not move)."""
    ops = []
    for slot, axes, shape, stride in zip(slots, operand_axes, shapes, strides):
        label_strides = {}
        for a, n, s in zip(axes, shape, stride):
            label_strides[a] = label_strides.get(a, 0) + (0 if n == 1 else int(s))
        ops.append(_Operand(slot, axes, label_strides))
    return ops


def _resolved(op):
    """``op`` with an intermediate's slot replaced by its arena offset."""
    if isinstance(op.slot, _Tmp):
        return _Operand(-1 - op.slot.offset, op.labels, op.strides)
    return op


def compile_steps(operand_axes, out_axes, shapes, strides, plan, slots, out_slot, arena_base):
    """``plan_grid``'s table rows of one planned contraction.  ``slots[i]``
    is operand ``i``'s slot (>= 0 a pointer index, < 0 an arena offset as
    -(1 + offset)); the last step writes the result contiguously in
    ``out_axes`` order to ``out_slot`` (-1: the call's output; else an arena
    offset).  Intermediates get arena offsets from ``arena_base`` up, reused
    once dead (``plan_grid`` runs the steps one after another, a grid barrier
    between them).  Returns (rows (steps, STEP_WORDS) int64, unions per step,
    arena end)."""
    size = label_sizes(operand_axes, shapes)
    out_axes = tuple(out_axes)
    missing = set(out_axes) - set(size)
    if missing:
        raise ValueError(f"einsum_plan: output labels {sorted(missing)} are in no operand")
    steps = _symbolic_steps(out_axes, _operands(slots, operand_axes, shapes, strides), plan,
                            out_slot, size)
    tmps = []
    for index, (inputs, _, out) in enumerate(steps):  # step i is level i
        for op in inputs:
            if isinstance(op.slot, _Tmp):
                op.slot.read = index
        if isinstance(out, _Tmp):
            out.level = index
            tmps.append(out)
    end = _place(tmps, arena_base)
    table = np.stack([_step_row([_resolved(op) for op in inputs], labels,
                                out.offset if isinstance(out, _Tmp) else out, size)
                      for inputs, labels, out in steps])
    unions = table[:, 6] * table[:, 7]
    return table, unions, end


def set_lanes(table):
    """Fill each ``plan_grid`` row's lanes and chunk (reduced entries a lane
    sums) for blocks of ``GRID_THREADS``, each lane aimed at
    ``GRID_LANE_ENTRIES`` reduced entries."""
    for row in table:
        lanes = step_lanes(int(row[6]), int(row[7]), GRID_THREADS, GRID_LANE_ENTRIES)
        row[8] = lanes
        row[9] = -(-int(row[7]) // lanes)
    return table


def block_units(levels, lanes, work, level_start, out_counts, red_counts):
    """``plan_block``'s critical path under the level model: per level the
    costliest warp's units (:func:`_scan_cost` of its work items), summed
    over the levels.  Its time is ``BLOCK_LAUNCH_US + BLOCK_UNIT_US`` per
    unit."""
    units = 0
    for level in range(levels):
        warps = level_start[level * SCAN_WARPS: (level + 1) * SCAN_WARPS + 1]
        units += max((sum(_scan_cost(out_counts[s], red_counts[s], int(lanes[s]), group)
                          for s, _, group in work[a:b]) for a, b in zip(warps[:-1], warps[1:])),
                     default=0)
    return units


def grid_work(out_counts, red_counts):
    """``plan_grid``'s reduced entries a lane walks, summed over the steps
    (rounds of ``GRID_RESIDENT`` tasks, each lane's chunk at its
    ``step_lanes``).  Its time is ``GRID_LAUNCH_US``, ``GRID_STEP_US`` a step
    and ``GRID_ENTRY_US`` an entry."""
    work = 0
    for out_count, red_count in zip(out_counts, red_counts):
        lanes = step_lanes(int(out_count), int(red_count), GRID_THREADS)
        work += -(-int(out_count) * lanes // GRID_RESIDENT) * -(-int(red_count) // lanes)
    return work


def choose_schedule(block, grid):
    """``"plan_block"`` where its modelled time ``block`` (None: not a
    candidate) is at most ``grid``'s, else ``"plan_grid"``."""
    return "plan_block" if block is not None and block <= grid else "plan_grid"


def _spans(shapes, strides):
    """Each operand's storage span in elements, from its first entry to its
    last (0 for an empty one)."""
    return np.array([0 if math.prod(shape) == 0 else
                     sum((n - 1) * st for n, st in zip(shape, stride)) + 1
                     for shape, stride in zip(shapes, strides)], dtype=np.int64)


class PlanTable:
    """One signature's compiled plan, uploaded once per device (:meth:`on`).

    ``schedule`` is ``"plan_block"`` where every step's union is within
    ``BLOCK_UNION``, the operands' offsets fit the block's int32 tables and
    the block's modelled time (``block_us``, from ``block_units``; None
    where the block is not a candidate) is at most the grid's (``grid_us``,
    from ``grid_work``), else ``"plan_grid"``;
    ``unions`` the union of each step, ``arena`` the intermediates'
    entries.

    ``plan_block``: the steps grouped by dependency level (``levels``,
    ``n_levels``), each level's warps and each step's lanes dealt by
    :func:`deal_level` (``work``, ``level_start``, ``lanes``), the
    intermediates placed so that no step reads or overwrites what another
    step of its level writes; ``steps`` the int32 rows (``SCAN_ROW``, no pins)
    and ``pairs`` the offset pairs (:func:`_scan_tables`), in one int32
    launch buffer (:func:`level_buffer`, ``buffer``) with the operands'
    offsets and ``spans`` in shared memory; ``shared`` where the arena sits
    in shared memory, ``staged`` where the buffer and the operands do too
    (``operands_at``, ``table_at``, ``shared_bytes``: :func:`level_layout`).
    ``K3``'s one-slice form of ``ScanProgram``.

    ``plan_grid``: ``steps`` int64 rows of ``STEP_WORDS`` (digits decoded on
    the card), the steps run one after another, and ``grid`` the blocks its
    largest step's tasks fill (the launch takes at most as many as the card
    holds at once)."""

    def __init__(self, operand_axes, out_axes, shapes, strides, itemsize, plan, schedule=None):
        slots = list(range(len(operand_axes)))
        size = label_sizes(operand_axes, shapes)
        out_axes = tuple(out_axes)
        missing = set(out_axes) - set(size)
        if missing:
            raise ValueError(f"einsum_plan: output labels {sorted(missing)} are in no operand")
        steps = _symbolic_steps(out_axes, _operands(slots, operand_axes, shapes, strides), plan,
                                -1, size)
        out_counts, red_counts = _counts(steps, size)
        self.unions = out_counts * red_counts
        self.out_shape = tuple(size[a] for a in out_axes)
        self.spans = _spans(shapes, strides)
        self.block_units = self.block_us = None
        if schedule != "plan_grid":
            self.levels = step_levels(steps)
            self.n_levels, self.lanes, self.work, self.level_start = deal_levels(
                self.levels, out_counts, red_counts)
            self.block_units = block_units(self.n_levels, self.lanes, self.work,
                                           self.level_start, out_counts, red_counts)
            if int(self.unions.max(initial=0)) <= BLOCK_UNION and int(
                    self.spans.max(initial=0)) < 2**31:
                self.block_us = BLOCK_LAUNCH_US + BLOCK_UNIT_US * self.block_units
        self.grid_work = grid_work(out_counts, red_counts)
        self.grid_us = GRID_LAUNCH_US + GRID_STEP_US * len(steps) + GRID_ENTRY_US * self.grid_work
        self.schedule = schedule or choose_schedule(self.block_us, self.grid_us)
        self._device = {}
        if self.schedule == "plan_grid":
            try:
                rows, _, self.arena = compile_steps(operand_axes, out_axes, shapes, strides,
                                                    plan, slots, -1, 0)
            except ValueError as err:
                # past the grid's MAX_LABELS: the block decodes no digit
                if schedule is not None or self.block_us is None or "MAX_LABELS" not in str(err):
                    raise
                self.schedule = "plan_block"
            else:
                self.steps = set_lanes(rows)
                tasks = self.steps[:, 6] * self.steps[:, 8]
                self.grid = int(np.clip(-(-int(tasks.max()) // GRID_THREADS), 1,
                                        MAX_GRID_BLOCKS))
                self.shared = False
                return
        self.arena = _place([out for _, _, out in steps if isinstance(out, _Tmp)], 0)
        specs = [([_resolved(op) for op in inputs], labels,
                  out.offset if isinstance(out, _Tmp) else out) for inputs, labels, out in steps]
        self.steps, self.pairs = level_tables(specs, self.lanes, size, {}, self.arena)
        self.buffer = level_buffer(self.steps, np.zeros((0, 4), np.int64), self.level_start,
                                   self.work, self.spans, self.pairs)
        self.shared = self.arena * itemsize <= SHARED_ARENA_BYTES
        self.staged, self.operands_at, self.table_at, self.shared_bytes = level_layout(
            self.arena, itemsize, self.shared, self.spans, self.buffer.size, 0)

    def on(self, device):
        """The launch buffer on ``device`` (``plan_grid``: the int64 steps),
        uploaded once."""
        buf = self._device.get(device)
        if buf is None:
            host = self.steps if self.schedule == "plan_grid" else self.buffer
            buf = torch.from_numpy(np.ascontiguousarray(host)).to(device)
            self._device[device] = buf
        return buf


@lru_cache(maxsize=4096)
def plan_table(operand_axes, out_axes, shapes, strides, itemsize, optimize="greedy"):
    """The :class:`PlanTable` of a signature, cached: the plan's signature
    plus the operands' strides and item size."""
    plan = contraction_plan(operand_axes, out_axes, shapes, optimize)
    return PlanTable(operand_axes, out_axes, shapes, strides, itemsize, plan)


# --------------------------------------------------------------------------- #
# the CUDA launches
# --------------------------------------------------------------------------- #
def _library():
    from pgmpy_tpu_torch.ops._build import load_library

    lib = load_library("einsum_plan", ["einsum_plan.cu"])
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.pgmpy_plan_block.argtypes = [vp, i32, i32, i32, i64, i32, vp, i32, vp, vp, i32, i64,
                                     i64, i64, vp, i32, vp]
    lib.pgmpy_plan_grid.argtypes = [vp, i32, i64, vp, i32, vp, vp, vp, i32, vp]
    lib.pgmpy_filter_scan.argtypes = [vp, i32, i32, i32, i32, i64, i32, vp, i32, vp, vp, i32,
                                      i64, i64, i64, vp, i32, vp, i32, i32, vp, i32, i32, vp]
    for fn in (lib.pgmpy_plan_block, lib.pgmpy_plan_grid, lib.pgmpy_filter_scan):
        fn.restype = ctypes.c_int
    return lib


def _pointers(arrays, device):
    """(host array of the operands' data pointers, its length, a device copy
    of it when there are more than ``MAX_OPERANDS``, else None)."""
    ptrs = [a.data_ptr() for a in arrays]
    host = (ctypes.c_void_p * max(len(ptrs), 1))(*ptrs)
    many = None
    if len(ptrs) > MAX_OPERANDS:
        many = torch.tensor(ptrs, dtype=torch.int64).to(device)
    return host, len(ptrs), many


def _check_operands(arrays):
    device, dtype = arrays[0].device, arrays[0].dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"einsum_plan: operands must be float32 or float64, got {dtype}")
    for a in arrays:
        if a.device != device or a.dtype != dtype:
            raise ValueError(f"einsum_plan: operands on {a.device} as {a.dtype} beside "
                             f"{device} as {dtype}")
    return device, dtype


def _run_plan_cuda(operand_axes, out_axes, arrays, optimize):
    """The planned contraction on the card, its table cached per signature."""
    _, dtype = _check_operands(arrays)
    shapes = tuple(tuple(a.shape) for a in arrays)
    strides = tuple(tuple(a.stride()) for a in arrays)
    table = plan_table(operand_axes, out_axes, shapes, strides,
                       torch.empty((), dtype=dtype).element_size(), optimize)
    return launch_plan(table, arrays)


def launch_plan(table, arrays):
    """One ``plan_block`` or ``plan_grid`` launch of a :class:`PlanTable`
    over ``arrays`` (the shapes and strides it was compiled for) on the
    current stream -> the contraction."""
    device, dtype = _check_operands(arrays)
    with torch.cuda.device(device):
        buf = table.on(device)
        out = torch.empty(table.out_shape, dtype=dtype, device=device)
        arena = None if table.shared else torch.empty(max(table.arena, 1), dtype=dtype,
                                                      device=device)
        host, n, many = _pointers(arrays, device)
        stream = torch.cuda.current_stream(device).cuda_stream
        elem = out.element_size()
        lib = _library()
        if table.schedule == "plan_block":
            err = lib.pgmpy_plan_block(
                buf.data_ptr(), len(table.steps), table.n_levels, len(table.work), buf.numel(),
                int(table.staged), host, n, 0 if many is None else many.data_ptr(),
                0 if arena is None else arena.data_ptr(), int(table.shared), table.operands_at,
                table.table_at, table.shared_bytes, out.data_ptr(), elem, stream)
        else:
            err = lib.pgmpy_plan_grid(
                buf.data_ptr(), len(table.steps), table.grid, host, n,
                0 if many is None else many.data_ptr(), arena.data_ptr(), out.data_ptr(), elem,
                stream)
    if err != 0:
        raise RuntimeError(f"einsum_plan {table.schedule} launch failed: cudaError_t {err}")
    LAUNCHES[table.schedule] += 1
    return out


def sum_product_planned(operand_axes, out_axes, arrays, optimize="greedy"):
    """Contract ``arrays`` (aligned with ``operand_axes``, each a tuple of
    integer axis labels) down to ``out_axes`` along a contraction plan cached
    on (axes, shapes), so host-side planning is paid once per signature: the
    CUDA kernels on CUDA tensors, the plain version on CPU tensors."""
    operand_axes = tuple(tuple(ax) for ax in operand_axes)
    out_axes = tuple(out_axes)
    device = arrays[0].device
    if device.type == "cuda":
        return _run_plan_cuda(operand_axes, out_axes, arrays, optimize)
    if device.type != "cpu":
        raise ValueError(f"sum_product_planned: unsupported device {device}")
    return sum_product_reference(operand_axes, out_axes, arrays, optimize)


def sum_product_reference(operand_axes, out_axes, arrays, optimize="greedy"):
    """Plain version of :func:`sum_product_planned` on any device: the
    cached plan, one ``torch.einsum`` per step."""
    shapes = tuple(tuple(a.shape) for a in arrays)
    operand_axes = tuple(tuple(ax) for ax in operand_axes)
    plan = contraction_plan(operand_axes, tuple(out_axes), shapes, optimize)
    return _run_plan(operand_axes, tuple(out_axes), arrays, plan)


def sum_product(operand_axes, out_axes, *arrays, optimize="greedy"):
    """Contract ``arrays`` (aligned with ``operand_axes``) down to
    ``out_axes``."""
    return sum_product_planned(operand_axes, out_axes, arrays, optimize=optimize)


def make_axis_map(factor_scopes):
    """Map every variable appearing in ``factor_scopes`` to a unique integer
    axis label.  Returns (var_to_int dict, operand_axes list)."""
    var_to_int = {}
    operand_axes = []
    for scope in factor_scopes:
        axes = []
        for var in scope:
            if var not in var_to_int:
                var_to_int[var] = len(var_to_int)
            axes.append(var_to_int[var])
        operand_axes.append(tuple(axes))
    return var_to_int, operand_axes


# --------------------------------------------------------------------------- #
# K10: the exact filter's slices in one launch
# --------------------------------------------------------------------------- #
def _scan_cost(out_count, red_count, lanes, group):
    """A filter_scan step's time on ``group`` warps at ``lanes`` lanes an
    output, in reduced entries: its rounds of 32 tasks, each a set-up and a
    lane's chunk."""
    rounds = -(-int(out_count) * lanes // (32 * group))
    return rounds * (SCAN_SETUP + -(-int(red_count) // lanes))


def _scan_lanes(out_count, red_count, group):
    """(cost, lanes) of a step on ``group`` warps at its best number of lanes
    (a power of two up to 32 and up to its reduced entries)."""
    options = [1 << k for k in range(6) if 1 << k <= max(1, _pow2_ceil(red_count))]
    return min((_scan_cost(out_count, red_count, lanes, group), lanes) for lanes in options)


def deal_level(out_counts, red_counts, warps):
    """A level's steps dealt to ``warps`` warps: ``(items, lanes)``, an
    item ``(step, warp, rank, group)`` for each warp of the ``group`` warps
    (ranks 0 .. group - 1) that stride over step ``step``'s tasks, and per
    step its lanes.  Costs are :func:`_scan_lanes`'.  With at least as many
    steps as warps, each step goes whole to the least loaded warp, the
    costliest first; else each has one warp and the rest go, one by one, to
    the step that then takes longest, while that shortens it."""
    n = len(out_counts)

    def best(s, group):
        return _scan_lanes(out_counts[s], red_counts[s], group)

    items = []
    if n >= warps:
        loads = [0] * warps
        for s in sorted(range(n), key=lambda s: (-best(s, 1)[0], s)):
            w = loads.index(min(loads))
            loads[w] += best(s, 1)[0]
            items.append((s, w, 0, 1))
        return items, [best(s, 1)[1] for s in range(n)]
    groups = [1] * n
    for _ in range(warps - n):
        s = max(range(n), key=lambda s: (best(s, groups[s])[0], -s))
        if best(s, groups[s] + 1)[0] >= best(s, groups[s])[0]:
            break
        groups[s] += 1
    w = 0
    for s in range(n):
        for rank in range(groups[s]):
            items.append((s, w, rank, groups[s]))
            w += 1
    return items, [best(s, groups[s])[1] for s in range(n)]


def _scan_tables(inputs, out_labels, out_offset, size, pinned, lanes):
    """One filter_scan step: its row (int32, ``SCAN_ROW`` words; the offset
    tables' places left 0) and its two offset tables, int32 (entries, 2)
    pairs of (first input's offset, second input's offset): per output entry
    (row-major over ``out_labels``) and per reduced entry, the reduced labels
    not in ``pinned`` innermost (in the first input's stride order), the
    pinned ones outermost.  ``pinned``: {label: evidence variable}."""
    def strides(a):
        return [op.strides.get(a, 0) for op in inputs] + [0] * (2 - len(inputs))

    reduced = list(dict.fromkeys(a for op in inputs for a in op.labels if a not in out_labels))
    free = sorted((a for a in reduced if a not in pinned), key=lambda a: strides(a))
    pins = [a for a in reduced if a in pinned]

    def table(labels, innermost_first):
        ext = [size[a] for a in labels]
        count = math.prod(ext)
        index = np.arange(count, dtype=np.int64)
        pairs = np.zeros((count, 2), dtype=np.int64)
        place = 1
        for a in (labels if innermost_first else labels[::-1]):
            digit = index // place % size[a]
            pairs += digit[:, None] * np.asarray(strides(a), dtype=np.int64)[None, :]
            place *= size[a]
        return pairs

    # unpinned labels take no slot of the row: the offset pairs carry them
    if sum(a in pinned for a in out_labels) > MAX_LABELS or len(pins) > MAX_LABELS:
        raise ValueError(f"filter_scan: a step pins more than MAX_LABELS = {MAX_LABELS} labels")
    out_pairs = table(list(out_labels), False)
    red_pairs = table(free + pins, True)
    row = np.zeros(SCAN_ROW, dtype=np.int64)
    row[:9] = [len(inputs), inputs[0].slot, inputs[1].slot if len(inputs) > 1 else 0, out_offset,
               len(out_pairs), math.prod(size[a] for a in free), lanes,
               sum(a in pinned for a in out_labels), len(pins)]
    at = SCAN_HEADER
    for j, a in enumerate(out_labels):
        if a in pinned:
            row[at:at + 3] = [pinned[a], math.prod(size[b] for b in out_labels[j + 1:]), size[a]]
            at += 3
    at = SCAN_HEADER + 3 * MAX_LABELS
    qplace = 1
    for a in pins:
        row[at:at + 3] = [pinned[a], qplace, size[a]]
        qplace *= size[a]
        at += 3
    return row, out_pairs, red_pairs


def _counts(steps, size):
    """(output entries, reduced entries) of each step of ``steps``."""
    out_counts, red_counts = [], []
    for inputs, labels, _ in steps:
        reduced = dict.fromkeys(a for op in inputs for a in op.labels if a not in labels)
        out_counts.append(math.prod(size[a] for a in labels))
        red_counts.append(math.prod(size[a] for a in reduced))
    return np.array(out_counts, dtype=np.int64), np.array(red_counts, dtype=np.int64)


def step_levels(steps):
    """Each step's dependency level, one more than the highest level of the
    steps whose results it reads (an intermediate, or an arena offset a step
    wrote; operands and what no step writes are level -1), and each
    intermediate's ``level`` (written) and ``read`` (the level that reads it)
    set for :func:`_place`."""
    written, levels = {}, []
    for inputs, _, out in steps:
        keys = [op.slot if isinstance(op.slot, _Tmp) else ("arena", -1 - op.slot)
                for op in inputs if isinstance(op.slot, _Tmp) or op.slot < 0]
        level = max([written[k] + 1 for k in keys if k in written], default=0)
        for op in inputs:
            if isinstance(op.slot, _Tmp):
                op.slot.read = level
        levels.append(level)
        if isinstance(out, _Tmp):
            out.level = level
        written[out if isinstance(out, _Tmp) else ("arena", out)] = level
    return np.array(levels, dtype=np.int64)


def deal_levels(levels, out_counts, red_counts):
    """Each level's warps and each step's lanes (:func:`deal_level`):
    (levels, lanes per step, work items ``(step, rank, group)`` in (level,
    warp) order, level_start: per (level, warp) the first of its items,
    ``levels * SCAN_WARPS + 1`` entries)."""
    n_levels = int(levels.max()) + 1 if len(levels) else 0
    lanes = np.ones(len(levels), dtype=np.int64)
    work = []
    for level in range(n_levels):
        members = np.flatnonzero(levels == level)
        items, chosen = deal_level(out_counts[members], red_counts[members], SCAN_WARPS)
        lanes[members] = chosen
        work += [(level, w, int(members[s]), rank, group) for s, w, rank, group in items]
    work.sort(key=lambda item: (item[0], item[1]))
    starts = np.zeros(n_levels * SCAN_WARPS + 1, dtype=np.int64)
    for level, w, *_ in work:
        starts[level * SCAN_WARPS + w + 1] += 1
    return (n_levels, lanes, np.array([item[2:] for item in work], dtype=np.int64).reshape(-1, 3),
            np.cumsum(starts))


def level_tables(specs, lanes, size, pinned, arena):
    """(step rows int32 (steps, SCAN_ROW), offset pairs int32 (n, 2)) of
    resolved ``specs`` (inputs, output labels, output slot: an arena offset,
    or -1 for the call's output) at ``lanes``, the labels of ``pinned``
    ({label: code column}) pinned (:func:`_scan_tables`).  Raises where an
    offset passes the kernel's int32 index."""
    rows, pairs, at = [], [], 0
    for (inputs, labels, out), n in zip(specs, lanes):
        row, out_pairs, red_pairs = _scan_tables(inputs, labels, out, size, pinned, int(n))
        row[9], row[10] = at, at + len(out_pairs)
        at += len(out_pairs) + len(red_pairs)
        rows.append(row)
        pairs += [out_pairs, red_pairs]
    pairs = np.concatenate(pairs)
    if max(int(np.abs(pairs).max(initial=0)), at, arena) >= 2**31:
        raise ValueError("einsum_plan: a level table's offsets pass the kernel's int32 index")
    return np.stack(rows).astype(np.int32), pairs.astype(np.int32)


def level_buffer(rows, results, level_start, work, spans, pairs):
    """The int32 launch buffer ``run_levels`` reads: the step rows, the
    results (K10's normalisations; none for a contraction), the level starts,
    the work items, each operand's offset in the staged operands and its
    span, then (8-byte aligned) the offset pairs."""
    offsets = np.concatenate([[0], np.cumsum(spans)[:-1]]) if len(spans) else spans
    head = np.concatenate([np.asarray(rows, np.int64).ravel(), results.ravel(), level_start,
                           work.ravel(), offsets, spans]).astype(np.int64)
    head = np.concatenate([head, np.zeros(len(head) % 2, dtype=np.int64)])
    return np.concatenate([head.astype(np.int32), np.asarray(pairs, np.int32).ravel()])


def level_layout(arena, itemsize, shared, spans, words, extra):
    """(staged, byte offset of the operands, byte offset of the table,
    dynamic shared bytes) of a level launch: the arena first where
    ``shared``, then, where both fit ``SCAN_STAGE_BYTES`` and the block's
    limit (``staged``), the operands and the int32 buffer of ``words``, then
    ``extra`` bytes (K10's codes)."""
    arena = -(-arena * itemsize // 16) * 16 if shared else 0
    operands = -(-int(np.sum(spans)) * itemsize // 16) * 16
    table = 4 * int(words)
    staged = (operands + table <= SCAN_STAGE_BYTES
              and arena + operands + table + extra <= SCAN_SHARED_LIMIT)
    table_at = arena + (operands if staged else 0)
    return staged, arena, table_at, table_at + (table if staged else 0) + extra


class ScanProgram:
    """The host side of ``filter_scan``: every transition slice of
    ``forward_scan`` in one launch of one block.

    ``operand_axes`` are the labels of ``[alpha] + transition factors +
    evidence deltas`` (the plain version's operands; a delta's one label is
    its variable's); ``outputs`` are the label tuples of the query marginals
    and, last, of the next interface.  The kernel contracts alpha and the
    transition factors only: evidence is folded into the steps' reads.  A
    label whose variable the call observes in some slice is pinned, per
    slice, to that slice's code (an output entry with another digit is 0, a
    reduced label walks its code alone); an unobserved variable costs
    nothing.

    The arena holds alpha at offset 0, then one result per output, then
    (``merged``) the joint, then the intermediates from ``base`` up.  Where
    the joint over the interface and the queries holds at most
    ``SCAN_JOINT`` entries (``merged``), a slice is one planned contraction
    to the joint and a one-input step from it to each output; otherwise each
    output's own plan, as the plain version runs them.  The steps are grouped
    by dependency level (``levels``; a step's level is one more than the
    highest level of the steps whose results it reads): a level's steps run
    at once, its warps and each step's lanes dealt by :func:`deal_level`, one
    barrier after each level.  Then each result is normalised: a query's into
    its columns of the ``(slices, sum of query cards)`` output, the
    interface's into alpha.

    A step is an int32 row (``SCAN_ROW``: inputs, output, counts, lanes,
    pins, and where its offset tables start) and two tables of offset pairs
    (:func:`_scan_tables`): a task reads its output entry's pair and its
    chunk of reduced pairs, and no digit is decoded on the card.  The launch
    reads one int32 buffer (:meth:`table`, per observed pattern), staged in
    shared memory with the transition factors once per launch where they
    fit."""

    def __init__(self, operand_axes, outputs, shapes, pointer_strides, itemsize,
                 optimize="greedy"):
        n_pointer = len(pointer_strides)
        self.n_vars = len(operand_axes) - 1 - n_pointer
        self.var_labels = [tuple(operand_axes[1 + n_pointer + j])[0] for j in range(self.n_vars)]
        operand_axes = tuple(tuple(ax) for ax in operand_axes[:1 + n_pointer])
        shapes = tuple(tuple(int(d) for d in s) for s in shapes[:1 + n_pointer])
        size = self.size = label_sizes(operand_axes, shapes)
        self.alpha_size = math.prod(shapes[0])
        offset = self.alpha_size
        # alpha (contiguous, at arena offset 0) and the transition factors;
        # a broadcast axis of extent 1 does not move
        strides = [tuple(_contiguous(range(len(shapes[0])), dict(enumerate(shapes[0]))).values())
                   [::-1]] + [tuple(st) for st in pointer_strides]
        operands = _operands([-1] + list(range(n_pointer)), operand_axes, shapes, strides)
        # each transition factor's storage span, staged in shared memory
        self.spans = _spans(shapes[1:], pointer_strides)
        result_rows, column = [], 0
        for r, labels in enumerate(outputs):
            entries = math.prod(size[a] for a in labels)
            last = r == len(outputs) - 1
            result_rows.append((offset, entries, -1 if last else column, 0))
            column += 0 if last else entries
            offset += entries
        self.width = column
        # the joint over the interface and the queries, where a block may
        # hold it: one contraction, then each output a one-input step from it
        joint = tuple(dict.fromkeys(a for labels in outputs[::-1] for a in labels))
        joint_entries = math.prod(size[a] for a in joint)
        self.merged = joint_entries <= SCAN_JOINT
        steps = []
        if self.merged:
            self.base = offset + joint_entries
            plan = contraction_plan(operand_axes, joint, shapes, optimize)
            steps += _symbolic_steps(joint, operands, plan, offset, size)
            joint_op = _Operand(-1 - offset, joint, _contiguous(joint, size))
            steps += [([joint_op], tuple(labels), out_offset)
                      for (out_offset, *_), labels in zip(result_rows, outputs)]
        else:
            self.base = offset
            for (out_offset, *_), labels in zip(result_rows, outputs):
                plan = contraction_plan(operand_axes, tuple(labels), shapes, optimize)
                steps += _symbolic_steps(tuple(labels), operands, plan, out_offset, size)
        # dependency levels: the joint (merged) and every intermediate are
        # written by one step of the slice; alpha and the operands are not
        self.levels = step_levels(steps)
        self.arena = _place([out for _, _, out in steps if isinstance(out, _Tmp)], self.base)
        self.specs = [([_resolved(op) for op in inputs], labels,
                       out.offset if isinstance(out, _Tmp) else out)
                      for inputs, labels, out in steps]
        self.out_counts, self.red_counts = _counts(self.specs, size)
        # each level's warps and each step's lanes
        self.n_levels, self.lanes, self.work, self.level_start = deal_levels(
            self.levels, self.out_counts, self.red_counts)
        self.results = np.array(result_rows, dtype=np.int64).reshape(-1, 4)
        self.itemsize = itemsize
        self.shared = self.arena * itemsize <= SHARED_ARENA_BYTES
        self._patterns = {}
        self.steps = self.tables_for(())[0]

    def _pattern(self, observed):
        """The cache entry of the pattern ``observed``: its tables, launch
        buffer, layout and device copies, built on first use.  The last
        ``SCAN_PATTERNS`` patterns are kept, the oldest dropped first."""
        observed = tuple(sorted({int(j) for j in observed}))
        entry = self._patterns.get(observed)
        if entry is None:
            entry = self._patterns[observed] = {"tables": self._build(observed), "device": {}}
            if len(self._patterns) > SCAN_PATTERNS:
                del self._patterns[next(iter(self._patterns))]
        return entry

    def tables_for(self, observed):
        """(step rows int32 (steps, SCAN_ROW), offset pairs int32 (n, 2))
        when the variables ``observed`` (indices into the codes' columns) may
        be observed: their labels pinned."""
        return self._pattern(observed)["tables"]

    def _build(self, observed):
        pinned = {self.var_labels[j]: j for j in observed}
        return level_tables(self.specs, self.lanes, self.size, pinned, self.arena)

    def table(self, observed):
        """The launch's int32 buffer (:func:`level_buffer`): step rows,
        results, level starts, work items, the transition factors' offsets in
        shared memory and spans, then the offset pairs."""
        entry = self._pattern(observed)
        if "table" not in entry:
            rows, pairs = entry["tables"]
            entry["table"] = level_buffer(rows, self.results, self.level_start, self.work,
                                          self.spans, pairs)
        return entry["table"]

    def layout(self, observed):
        """(staged, byte offset of the factors, byte offset of the table,
        dynamic shared bytes) (:func:`level_layout`): the arena first where
        ``shared``, then, where both fit ``SCAN_STAGE_BYTES`` and the block's
        limit (``staged``), the transition factors and the int32 table, then
        the slice's codes (int32)."""
        entry = self._pattern(observed)
        if "layout" not in entry:
            entry["layout"] = level_layout(self.arena, self.itemsize, self.shared, self.spans,
                                           self.table(observed).size, 4 * self.n_vars)
        return entry["layout"]

    def on(self, device, observed):
        """The table of ``observed`` on ``device``, uploaded once."""
        uploaded = self._pattern(observed)["device"]
        if device not in uploaded:
            uploaded[device] = torch.from_numpy(self.table(observed)).to(device)
        return uploaded[device]

    def run(self, alpha, pointers, codes):
        """ONE ``filter_scan`` launch over every slice: ``alpha`` the
        slice-0 interface posterior, ``pointers`` the transition factors'
        tensors (the strides the program was built for), ``codes`` int
        (slices, variables) evidence codes (-1 unobserved), a numpy array (a
        tensor is read back to the host for its pattern) -> (slices, width)
        normalised query marginals."""
        global SCAN_LAUNCHES
        device, dtype = _check_operands([alpha] + list(pointers))
        host = np.asarray(codes.cpu() if torch.is_tensor(codes) else codes)
        n_slices = host.shape[0]
        if host.shape != (n_slices, self.n_vars):
            raise ValueError(f"filter_scan: codes must be (slices, {self.n_vars}), got "
                             f"{tuple(host.shape)}")
        if alpha.numel() != self.alpha_size:
            raise ValueError(f"filter_scan: alpha has {alpha.numel()} entries, the interface "
                             f"{self.alpha_size}")
        observed = tuple(int(j) for j in np.flatnonzero((host >= 0).any(axis=0)))
        staged, operands_at, table_at, shared_bytes = self.layout(observed)
        n_steps = len(self.tables_for(observed)[0])
        with torch.cuda.device(device):
            buf = self.on(device, observed)
            # pinned, so the host does not wait: the call stays queued
            # behind earlier work on the stream
            codes = torch.from_numpy(np.ascontiguousarray(host, dtype=np.int32)).pin_memory().to(
                device, non_blocking=True)
            alpha = alpha.contiguous()
            out = torch.empty((n_slices, self.width), dtype=dtype, device=device)
            arena = None if self.shared else torch.empty(self.arena, dtype=dtype, device=device)
            ptrs, n, many = _pointers(pointers, device)
            err = _library().pgmpy_filter_scan(
                buf.data_ptr(), n_steps, len(self.results), self.n_levels, len(self.work),
                buf.numel(), int(staged), ptrs, n, 0 if many is None else many.data_ptr(),
                0 if arena is None else arena.data_ptr(), int(self.shared), operands_at,
                table_at, shared_bytes, alpha.data_ptr(), self.alpha_size, codes.data_ptr(),
                self.n_vars, n_slices, out.data_ptr(), self.width, out.element_size(),
                torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"filter_scan launch failed: cudaError_t {err}")
        SCAN_LAUNCHES += 1
        return out
