"""Interleaved-format einsum helpers: the device-side contraction core (K3).

Port of ``pgmpy_tpu/ops/einsum.py``.  A host-side planner maps variable
names to integer axis labels; a contraction is given as operands aligned
with tuples of labels plus the output labels, and its ``opt_einsum`` path is
computed once per static (axes, shapes) signature and cached.

* On CUDA tensors, the hand-written kernels of ``csrc/einsum_plan.cu`` (built
  with ``nvcc`` at first use) run the cached plan, compiled once per
  signature into a table of steps (:class:`PlanTable`), and run it in ONE
  launch: ``plan_block`` runs the whole plan in one block when every step's
  union (output entries x reduced entries) is at most ``BLOCK_UNION``;
  ``plan_grid`` runs it otherwise as one cooperative launch over as many
  blocks as the card holds at once, a grid barrier between steps.  A build
  or launch failure raises.
* On CPU tensors, the plain version :func:`_run_plan`: each step a two-operand
  (or one-operand) ``torch.einsum`` whose labels are renumbered into
  ``[0, 52)`` (``torch.einsum``'s sublist form rejects labels outside it, and
  a MUNIN covering subtree has more variables than that; it takes no
  contraction path either).  Float32 products run in full f32 (``config``
  disables TF32).

The same table drives ``forward_scan``'s exact filter (K10, :class:`ScanProgram`):
every slice's contractions run inside one ``filter_scan`` launch.

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

# plan_block when no step's union is larger, else plan_grid: on the card, one
# block was 1.5x faster than the grid on a MUNIN VE query (28 steps, unions up
# to 1,080) and 1.4-1.7x slower on a BP query (8 steps, up to 12,000) and a
# do-query (8 steps, up to 46,656); the grid's barrier costs as much as one
# block's step of ~2,000-6,000 union entries
BLOCK_UNION = 1 << 13
SCAN_JOINT = 1 << 16  # filter_scan: a slice's joint of at most so many entries is one contraction
MAX_LABELS = 12  # output labels, and reduced labels, of one step after merging
MAX_OPERANDS = 448  # operand pointers in the launch's parameter block (3,584 of 4,096 bytes)
BLOCK_THREADS = 512  # plan_block's and filter_scan's one block
GRID_THREADS = 256  # a block of plan_grid
LANE_ENTRIES = 32  # reduced entries a lane sums, aimed at (plan_block)
GRID_LANE_ENTRIES = 8  # the same for plan_grid, whose steps spread over the whole card
SHARED_ARENA_BYTES = 160 * 1024  # a block's intermediates in shared memory up to this
MAX_GRID_BLOCKS = 1 << 20  # plan_grid's blocks asked for at most (they stride over the rest)

# one step of the table: a header, then MAX_LABELS words each of the output
# extents, the reduced extents, and the first and second input's strides per
# output label and per reduced label (innermost label first, 0 where absent)
HEADER = ("n_in", "in0", "in1", "out", "n_out", "n_red", "out_count", "red_count", "lanes",
          "chunk")
STEP_WORDS = len(HEADER) + 6 * MAX_LABELS

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


def step_lanes(out_count, red_count, threads, entries=LANE_ENTRIES):
    """Lanes per output entry of a step (a power of two, at most ``threads``):
    enough that each sums about ``entries`` reduced entries, more while
    the block's threads would otherwise idle, never more than the reduced
    entries."""
    lanes = _pow2_ceil(-(-red_count // entries)) if red_count else 1
    if out_count * lanes < threads:
        lanes = max(lanes, 1 << (threads // max(out_count, 1)).bit_length() - 1)
    return max(1, min(lanes, _pow2_ceil(max(red_count, 1)), threads))


class _Arena:
    """First-fit offsets of the intermediates in the arena, each freed when
    its one reader has run."""

    def __init__(self, base):
        self.base = self.end = base
        self.live = {}

    def alloc(self, size):
        size = max(int(size), 1)
        offset = self.base
        for start in sorted(self.live):
            if start - offset >= size:
                break
            offset = max(offset, start + self.live[start])
        self.live[offset] = size
        self.end = max(self.end, offset + size)
        return offset

    def free(self, offset):
        del self.live[offset]


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


def compile_steps(operand_axes, out_axes, shapes, strides, plan, slots, out_slot, arena_base):
    """The table rows of one planned contraction.  ``slots[i]`` is operand
    ``i``'s slot (>= 0 a pointer index, < 0 an arena offset as -(1 +
    offset)); the last step writes the result contiguously in ``out_axes``
    order to ``out_slot`` (-1: the call's output; else an arena offset).
    Intermediates get arena offsets from ``arena_base`` up, reused once dead.
    Returns (rows (steps, STEP_WORDS) int64, unions per step, arena end)."""
    size = label_sizes(operand_axes, shapes)
    ops = []
    for slot, axes, shape, stride in zip(slots, operand_axes, shapes, strides):
        label_strides = {}
        for a, n, s in zip(axes, shape, stride):
            # a broadcast axis of extent 1 does not move
            label_strides[a] = label_strides.get(a, 0) + (0 if n == 1 else int(s))
        ops.append(_Operand(slot, axes, label_strides))
    out_axes = tuple(out_axes)
    missing = set(out_axes) - set(size)
    if missing:
        raise ValueError(f"einsum_plan: output labels {sorted(missing)} are in no operand")
    arena = _Arena(arena_base)
    rows = []

    def emit(inputs, labels, final):
        if final:
            row = _step_row(inputs, labels, out_slot, size)
            result = None
        else:
            offset = arena.alloc(math.prod(size[a] for a in labels))
            row = _step_row(inputs, labels, offset, size)
            result = _Operand(-1 - offset, labels, _contiguous(labels, size))
        for op in inputs:  # read by this step only: free once it has run
            if op.slot < 0 and -1 - op.slot in arena.live:
                arena.free(-1 - op.slot)
        rows.append(row)
        return result

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
    table = np.stack(rows)
    unions = table[:, 6] * table[:, 7]
    return table, unions, arena.end


def set_lanes(table, threads, entries=LANE_ENTRIES):
    """Fill each row's lanes and chunk (reduced entries a lane sums) for
    blocks of ``threads``, each lane aimed at ``entries`` reduced entries."""
    for row in table:
        lanes = step_lanes(int(row[6]), int(row[7]), threads, entries)
        row[8] = lanes
        row[9] = -(-int(row[7]) // lanes)
    return table


def choose_schedule(unions):
    """``"plan_block"`` when no step's union exceeds ``BLOCK_UNION``, else
    ``"plan_grid"``: decided from the plan alone."""
    return "plan_block" if int(max(unions, default=0)) <= BLOCK_UNION else "plan_grid"


class PlanTable:
    """One signature's compiled plan: the steps (``steps``, int64 rows of
    ``STEP_WORDS``), the schedule (``"plan_block"`` where every step's union
    is within ``BLOCK_UNION``, else ``"plan_grid"``), the arena of
    intermediates (``arena`` elements; in shared memory for ``plan_block``
    when ``arena * itemsize <= SHARED_ARENA_BYTES``), and for ``plan_grid``
    the blocks its largest step's tasks fill (``grid``; the launch takes at
    most as many as the card holds at once).  Uploaded once per device
    (:meth:`on`)."""

    def __init__(self, operand_axes, out_axes, shapes, strides, itemsize, plan, schedule=None):
        slots = list(range(len(operand_axes)))
        steps, self.unions, self.arena = compile_steps(
            operand_axes, out_axes, shapes, strides, plan, slots, -1, 0)
        self.out_shape = tuple(label_sizes(operand_axes, shapes)[a] for a in out_axes)
        self.schedule = schedule or choose_schedule(self.unions)
        block = self.schedule == "plan_block"
        self.steps = set_lanes(steps, BLOCK_THREADS if block else GRID_THREADS,
                               LANE_ENTRIES if block else GRID_LANE_ENTRIES)
        tasks = self.steps[:, 6] * self.steps[:, 8]
        self.grid = int(np.clip(-(-int(tasks.max()) // GRID_THREADS), 1, MAX_GRID_BLOCKS))
        self.shared = (self.schedule == "plan_block"
                       and self.arena * itemsize <= SHARED_ARENA_BYTES)
        self._device = {}

    def on(self, device):
        """The steps as one int64 buffer on ``device``, uploaded once."""
        buf = self._device.get(device)
        if buf is None:
            buf = torch.from_numpy(np.ascontiguousarray(self.steps)).to(device)
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
    lib.pgmpy_plan_block.argtypes = [vp, i32, vp, i32, vp, vp, vp, i64, i32, vp]
    lib.pgmpy_plan_grid.argtypes = [vp, i32, i64, vp, i32, vp, vp, vp, i32, vp]
    lib.pgmpy_filter_scan.argtypes = [vp, i32, vp, i32, vp, i32, vp, i32, vp, vp, i64, vp, i32,
                                      vp, i32, i32, vp, i32, i32, vp]
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
        steps = table.on(device)
        out = torch.empty(table.out_shape, dtype=dtype, device=device)
        arena = None if table.shared else torch.empty(max(table.arena, 1), dtype=dtype,
                                                      device=device)
        host, n, many = _pointers(arrays, device)
        stream = torch.cuda.current_stream(device).cuda_stream
        elem = out.element_size()
        lib = _library()
        if table.schedule == "plan_block":
            err = lib.pgmpy_plan_block(
                steps.data_ptr(), len(table.steps), host, n,
                0 if many is None else many.data_ptr(), 0 if arena is None else arena.data_ptr(),
                out.data_ptr(), table.arena * elem if table.shared else 0, elem, stream)
        else:
            err = lib.pgmpy_plan_grid(
                steps.data_ptr(), len(table.steps), table.grid, host, n,
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
class ScanProgram:
    """The host side of ``filter_scan``: every transition slice of
    ``forward_scan`` in one launch of one block.

    The operands of each slice's contractions are ``[alpha] + transition
    factors + evidence deltas`` (labels ``operand_axes``); ``outputs`` are
    the label tuples of the query marginals and, last, of the next interface.
    The arena holds alpha at offset 0, then the deltas (a one-hot row where
    the slice observes the variable, all ones where it does not), then one
    result per output, then (``merged``) the joint, then the intermediates
    from ``base`` up.  Per slice the kernel fills the deltas from that
    slice's row of codes and runs the steps (block schedule): where the
    joint over the interface and the queries holds at most ``SCAN_JOINT``
    entries (``merged``), one planned contraction to the joint and a
    one-input step from it to each output; otherwise each output's own
    plan, as the plain version runs them.  Then it normalises each result:
    a query's into its columns of the ``(slices, sum of query cards)``
    output, the interface's into alpha.

    Tables (int64): ``steps`` (rows of ``STEP_WORDS``), ``deltas`` (arena
    offset, variable, state) per delta entry, ``results`` (arena offset,
    entries, output column or -1 for the interface, 0) per output."""

    def __init__(self, operand_axes, outputs, shapes, pointer_strides, itemsize,
                 optimize="greedy"):
        operand_axes = tuple(tuple(ax) for ax in operand_axes)
        shapes = tuple(tuple(int(d) for d in s) for s in shapes)
        n_pointer = len(pointer_strides)
        n_delta = len(operand_axes) - 1 - n_pointer
        size = {}
        for axes, shape in zip(operand_axes, shapes):
            size.update(zip(axes, shape))
        self.alpha_size = math.prod(shapes[0])
        offset = self.alpha_size
        slots = [-1]  # alpha at arena offset 0
        slots += list(range(n_pointer))
        delta_rows = []
        for j in range(n_delta):
            card = shapes[1 + n_pointer + j][0]
            slots.append(-1 - offset)
            delta_rows += [(offset + k, j, k) for k in range(card)]
            offset += card
        result_rows, column = [], 0
        for r, labels in enumerate(outputs):
            entries = math.prod(size[a] for a in labels)
            last = r == len(outputs) - 1
            result_rows.append((offset, entries, -1 if last else column, 0))
            column += 0 if last else entries
            offset += entries
        self.width = column
        # alpha and the deltas are contiguous in the arena
        strides = [tuple(_contiguous(range(len(s)), dict(enumerate(s))).values())[::-1]
                   for s in shapes]
        strides[1:1 + n_pointer] = [tuple(s) for s in pointer_strides]
        # the joint over the interface and the queries, where a block may
        # hold it: one contraction, then each output a one-input step from it
        joint = tuple(dict.fromkeys(a for labels in outputs[::-1] for a in labels))
        joint_entries = math.prod(size[a] for a in joint)
        self.merged = joint_entries <= SCAN_JOINT
        tables = []
        if self.merged:
            self.base = offset + joint_entries
            plan = contraction_plan(operand_axes, joint, shapes, optimize)
            steps, _, self.arena = compile_steps(operand_axes, joint, shapes, strides, plan, slots,
                                                 offset, self.base)
            tables.append(steps)
            joint_op = _Operand(-1 - offset, joint, _contiguous(joint, size))
            tables += [_step_row([joint_op], tuple(labels), out_offset, size)[None]
                       for (out_offset, *_), labels in zip(result_rows, outputs)]
        else:
            self.base = self.arena = offset
            for (out_offset, *_), labels in zip(result_rows, outputs):
                plan = contraction_plan(operand_axes, tuple(labels), shapes, optimize)
                steps, _, end = compile_steps(operand_axes, labels, shapes, strides, plan, slots,
                                              out_offset, self.base)
                tables.append(steps)
                self.arena = max(self.arena, end)
        self.steps = set_lanes(np.concatenate(tables), BLOCK_THREADS)
        self.deltas = np.array(delta_rows, dtype=np.int64).reshape(-1, 3)
        self.results = np.array(result_rows, dtype=np.int64).reshape(-1, 4)
        self.n_vars = n_delta
        self.shared = self.arena * itemsize <= SHARED_ARENA_BYTES
        self._device = {}

    def on(self, device):
        """(steps, deltas, results) as one int64 buffer on ``device``,
        uploaded once."""
        buf = self._device.get(device)
        if buf is None:
            host = np.concatenate([self.steps.ravel(), self.deltas.ravel(),
                                   self.results.ravel()])
            buf = torch.from_numpy(host).to(device)
            self._device[device] = buf
        return buf

    def run(self, alpha, pointers, codes):
        """ONE ``filter_scan`` launch over every slice: ``alpha`` the
        slice-0 interface posterior, ``pointers`` the transition factors'
        tensors (the strides the program was built for), ``codes`` int
        (slices, variables) evidence codes (-1 unobserved) -> (slices,
        width) normalised query marginals."""
        global SCAN_LAUNCHES
        device, dtype = _check_operands([alpha] + list(pointers))
        n_slices = codes.shape[0]
        if tuple(codes.shape) != (n_slices, self.n_vars):
            raise ValueError(f"filter_scan: codes must be (slices, {self.n_vars}), got "
                             f"{tuple(codes.shape)}")
        if alpha.numel() != self.alpha_size:
            raise ValueError(f"filter_scan: alpha has {alpha.numel()} entries, the interface "
                             f"{self.alpha_size}")
        with torch.cuda.device(device):
            buf = self.on(device)
            codes = codes.to(device=device, dtype=torch.int32).contiguous()
            alpha = alpha.contiguous()
            out = torch.empty((n_slices, self.width), dtype=dtype, device=device)
            elem = out.element_size()
            arena = None if self.shared else torch.empty(self.arena, dtype=dtype, device=device)
            host, n, many = _pointers(pointers, device)
            base = buf.data_ptr()
            deltas = base + 8 * self.steps.size
            results = deltas + 8 * self.deltas.size
            err = _library().pgmpy_filter_scan(
                base, len(self.steps), deltas, len(self.deltas), results, len(self.results),
                host, n, 0 if many is None else many.data_ptr(),
                0 if arena is None else arena.data_ptr(), self.arena * elem if self.shared else 0,
                alpha.data_ptr(), self.alpha_size, codes.data_ptr(), self.n_vars, n_slices,
                out.data_ptr(), self.width, elem, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"filter_scan launch failed: cudaError_t {err}")
        SCAN_LAUNCHES += 1
        return out
