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
ENTRIES_PER_BLOCK = 1024  # arena entries one block of clique_potentials / absorb_wave owns
MIN_WALK = 32  # a lane of sepset_wave walks at least this many reduced entries
MAX_LANES_LOG2 = 8  # at most BLOCK lanes reduce one sepset entry

# clique rows: offset into the belief arena, size, axis count, then the axes' sizes
CLIQUE_OFFSET, CLIQUE_SIZE, CLIQUE_NDIM, CLIQUE_HEADER = 0, 1, 2, 3
# message rows (kMsg* in jt_calibrate.cu), then five blocks of ``width`` values:
# the kept axes' sizes and source strides (canonical sepset order, adjacent
# axes merged), the reduced axes' sizes and source strides (merged), and the
# ratio's stride along each destination-clique axis (0 where the sepset lacks it)
(MSG_SRC, MSG_DST, MSG_EDGE, MSG_FRESH, MSG_SIZE, MSG_REDUCED, MSG_LANES_LOG2,
 MSG_RATIO, MSG_SEPSET, MSG_NKEEP, MSG_NRED, MSG_HEADER) = range(12)

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
    cliques: np.ndarray  # (C, CLIQUE_HEADER + width)
    clique_blocks: np.ndarray  # (C,) first block of each clique in clique_potentials' grid
    potential_blocks: int
    clique_factors: np.ndarray  # (C + 1,) CSR into ``factors``
    factors: np.ndarray  # (F, 1 + width): factor id, its stride along each clique axis
    messages: np.ndarray  # (M, MSG_HEADER + 5 * width)
    wave_messages: np.ndarray  # (M,) message ids, wave by wave, schedule order within
    wave_message_start: np.ndarray  # (W + 1,)
    message_blocks: np.ndarray  # (M,) by wave_messages: first block in its wave's grid
    sepset_blocks: np.ndarray  # (W,) blocks of each wave's sepset_wave launch
    groups: np.ndarray  # (G, 3): destination clique, its messages' [begin, end) in group_messages
    group_messages: np.ndarray  # message ids, schedule order within a group
    wave_group_start: np.ndarray  # (W + 1,)
    group_blocks: np.ndarray  # (G,) first block in its wave's absorb_wave grid
    absorb_blocks: np.ndarray  # (W,)
    scratch_size: int  # ratio entries of the largest wave
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
        groups = [(int(d), self.group_messages[b:e].tolist())
                  for d, b, e in self.groups[glo:ghi]]
        return self.wave_messages[lo:hi].tolist(), groups


def row_major_strides(shape):
    strides, step = [], 1
    for n in reversed(shape):
        strides.append(step)
        step *= int(n)
    return strides[::-1]


def merge_axes(dims, strides):
    """Drop size-1 axes and merge each axis into the one before it where the
    two are adjacent in memory (``stride[k] == stride[k + 1] * dim[k + 1]``):
    a row-major walk over the merged axes visits the same offsets in the same
    order, with fewer digits to decode."""
    out_d, out_s = [], []
    for d, s in zip(dims, strides):
        if d == 1:
            continue
        if out_d and out_s[-1] == s * d:
            out_d[-1] *= d
            out_s[-1] = s
        else:
            out_d.append(int(d))
            out_s.append(int(s))
    return out_d, out_s


def lanes_log2(reduced):
    """log2 of the lanes that reduce one sepset entry of a message whose
    entries each sum ``reduced`` source entries: enough that a lane walks at
    least ``MIN_WALK`` of them, at most a block."""
    if reduced < 2 * MIN_WALK:
        return 0
    return min(MAX_LANES_LOG2, int(np.log2(reduced // MIN_WALK)))


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

    cliques = np.zeros((n_cliques, CLIQUE_HEADER + width), dtype=np.int64)
    cliques[:, CLIQUE_OFFSET] = clique_offsets
    cliques[:, CLIQUE_SIZE] = sizes
    for c, shape in enumerate(shapes):
        cliques[c, CLIQUE_NDIM] = len(shape)
        cliques[c, CLIQUE_HEADER:CLIQUE_HEADER + len(shape)] = shape
    blocks = -(-sizes // ENTRIES_PER_BLOCK)
    clique_blocks = np.concatenate([[0], np.cumsum(blocks)[:-1]]).astype(np.int64)

    # stage 0: each clique's factors in potential_specs order
    factor_rows, clique_factors = [], [0]
    for c, specs in enumerate(program.potential_specs):
        for f_idx, perm, spec in specs:
            f_strides = row_major_strides(program.factor_shapes[f_idx])
            row = np.zeros(1 + width, dtype=np.int64)
            row[0] = f_idx
            # clique axis a holds factor axis perm[spec[a]] (None: absent)
            for a, s in enumerate(spec):
                if s is not None:
                    row[1 + a] = f_strides[perm[s]]
            factor_rows.append(row)
        clique_factors.append(len(factor_rows))
    factors = (np.stack(factor_rows) if factor_rows
               else np.zeros((0, 1 + width), dtype=np.int64))

    # messages
    waves, n_up_waves = _waves(program)
    n_waves = 1 + max(waves, default=-1)
    messages = np.zeros((len(program.messages), MSG_HEADER + 5 * width), dtype=np.int64)
    keep_d, keep_s, red_d, red_s, dst_s = (MSG_HEADER + k * width for k in range(5))
    for m, (src, dst, reduce_axes, perm, (bperm, bspec), edge, fresh) in enumerate(
            program.messages):
        src_shape, src_strides = shapes[src], row_major_strides(shapes[src])
        kept = [a for a in range(len(src_shape)) if a not in reduce_axes]
        canon = [kept[p] for p in perm]  # source axis of each canonical sepset axis
        kd, ks = merge_axes([src_shape[a] for a in canon], [src_strides[a] for a in canon])
        rd, rs = merge_axes([src_shape[a] for a in reduce_axes],
                            [src_strides[a] for a in reduce_axes])
        reduced = int(np.prod([src_shape[a] for a in reduce_axes]))
        row = messages[m]
        row[[MSG_SRC, MSG_DST, MSG_EDGE, MSG_FRESH, MSG_SIZE, MSG_REDUCED, MSG_LANES_LOG2,
             MSG_SEPSET, MSG_NKEEP, MSG_NRED]] = [
            src, dst, edge, int(fresh), sep_sizes[edge], reduced, lanes_log2(reduced),
            edge_offsets[edge], len(kd), len(rd)]
        row[keep_d:keep_d + len(kd)] = kd
        row[keep_s:keep_s + len(ks)] = ks
        row[red_d:red_d + len(rd)] = rd
        row[red_s:red_s + len(rs)] = rs
        ratio_strides = row_major_strides(sep_shapes[edge])
        for a, s in enumerate(bspec):
            if s is not None:
                row[dst_s + a] = ratio_strides[bperm[s]]

    wave_messages, wave_message_start, message_blocks = [], [0], []
    sepset_blocks, absorb_blocks, scratch_size = [], [], 0
    groups, group_messages, wave_group_start, group_blocks = [], [], [0], []
    by_wave = [[] for _ in range(n_waves)]
    for m, w in enumerate(waves):
        by_wave[w].append(m)
    for ids in by_wave:
        ratio, nblocks = 0, 0
        for m in ids:
            row = messages[m]
            row[MSG_RATIO] = ratio
            ratio += row[MSG_SIZE]
            message_blocks.append(nblocks)
            per_block = BLOCK >> int(row[MSG_LANES_LOG2])
            nblocks += -(-int(row[MSG_SIZE]) // per_block)
        scratch_size = max(scratch_size, ratio)
        wave_messages.extend(ids)
        wave_message_start.append(len(wave_messages))
        sepset_blocks.append(nblocks)
        order = {}
        for m in ids:
            order.setdefault(int(messages[m, MSG_DST]), []).append(m)
        nblocks = 0
        for dst, incoming in order.items():
            groups.append((dst, len(group_messages), len(group_messages) + len(incoming)))
            group_messages.extend(incoming)
            group_blocks.append(nblocks)
            nblocks += int(blocks[dst])
        wave_group_start.append(len(groups))
        absorb_blocks.append(nblocks)

    def i64(values, shape=None):
        out = np.asarray(values, dtype=np.int64)
        return out.reshape(shape) if shape is not None else out

    return WavePlan(
        width=width,
        clique_shapes=shapes,
        sepset_shapes=sep_shapes,
        total=int(sizes.sum()),
        sepset_total=int(sep_sizes.sum()),
        cliques=cliques,
        clique_blocks=clique_blocks,
        potential_blocks=int(blocks.sum()),
        clique_factors=i64(clique_factors),
        factors=factors,
        messages=messages,
        wave_messages=i64(wave_messages),
        wave_message_start=i64(wave_message_start),
        message_blocks=i64(message_blocks),
        sepset_blocks=i64(sepset_blocks),
        groups=i64(groups, (-1, 3)),
        group_messages=i64(group_messages),
        wave_group_start=i64(wave_group_start),
        group_blocks=i64(group_blocks),
        absorb_blocks=i64(absorb_blocks),
        scratch_size=int(scratch_size),
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
        i32, vp, vp, vp, i32, vp, vp, vp, i64, i32, i32, vp]
    lib.pgmpy_jt_sepset_wave.argtypes = [
        i32, i32, i32, vp, vp, vp, vp, vp, vp, vp, i32, i64, i32, ctypes.c_double, vp]
    lib.pgmpy_jt_absorb_wave.argtypes = [
        i32, vp, vp, vp, vp, vp, vp, i32, vp, i64, i32, i32, vp]
    for fn in (lib.pgmpy_jt_clique_potentials, lib.pgmpy_jt_sepset_wave,
               lib.pgmpy_jt_absorb_wave):
        fn.restype = ctypes.c_int
    return lib


_TABLES = ("cliques", "clique_blocks", "clique_factors", "factors", "messages",
           "wave_messages", "message_blocks", "groups", "group_messages", "group_blocks")


def _device_tables(plan, device):
    """The plan's tables in one int64 buffer on ``device`` (uploaded once per
    device and kept on the plan), and each wave's launch arguments: pointers
    to its slices of the tables and its grid sizes."""
    entry = plan.device_tables.get(device)
    if entry is not None:
        # order this stream behind the upload, whichever stream made it
        torch.cuda.current_stream(device).wait_event(entry["uploaded"])
        return entry
    arrays = [np.ascontiguousarray(getattr(plan, name), dtype=np.int64).ravel()
              for name in _TABLES]
    starts = np.concatenate([[0], np.cumsum([a.size for a in arrays])])
    flat = np.concatenate(arrays + [np.zeros(1, dtype=np.int64)])
    buf = torch.from_numpy(flat).pin_memory().to(device, non_blocking=True)
    uploaded = torch.cuda.Event()
    uploaded.record(torch.cuda.current_stream(device))
    ptr = {name: buf.data_ptr() + 8 * int(s) for name, s in zip(_TABLES, starts)}
    waves = []
    for w in range(plan.n_waves):
        lo, hi = (int(x) for x in plan.wave_message_start[w:w + 2])
        glo, ghi = (int(x) for x in plan.wave_group_start[w:w + 2])
        waves.append({"messages": (ptr["wave_messages"] + 8 * lo, ptr["message_blocks"] + 8 * lo,
                                   hi - lo, int(plan.sepset_blocks[w])),
                      "groups": (ptr["groups"] + 24 * glo, ptr["group_blocks"] + 8 * glo,
                                 ghi - glo, int(plan.absorb_blocks[w]))})
    entry = {"buffer": buf, "uploaded": uploaded, "ptr": ptr, "waves": waves,
             "factor_pointers": (None, None, None)}
    plan.device_tables[device] = entry
    return entry


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
    with torch.cuda.device(arena.device):
        entry = _device_tables(plan, arena.device)
        ptr = entry["ptr"]
        pointers = _factor_pointers(entry, factor_arrays, arena.device)
        _launched(_library().pgmpy_jt_clique_potentials(
            arena.element_size(), arena.data_ptr(), ptr["cliques"], ptr["clique_blocks"],
            len(plan.clique_shapes), ptr["clique_factors"], ptr["factors"], pointers.data_ptr(),
            plan.potential_blocks, ENTRIES_PER_BLOCK, plan.width, _stream(arena)),
            "clique_potentials")


def sepset_wave_cuda(plan, w, arena, sepsets, scratch, operation="marginalize", normalize=False):
    """``sepset_wave``: every message of wave ``w`` in one launch; sigma into
    ``sepsets``, the ratio into the message's slot of ``scratch``.  With
    ``normalize`` the launch runs one block per message (the total is a
    dependency across the message)."""
    with torch.cuda.device(arena.device):
        entry = _device_tables(plan, arena.device)
        wave_msgs, msg_blocks, n_msgs, n_blocks = entry["waves"][w]["messages"]
        _launched(_library().pgmpy_jt_sepset_wave(
            arena.element_size(), int(operation == "maximize"), int(normalize),
            arena.data_ptr(), sepsets.data_ptr(), scratch.data_ptr(), entry["ptr"]["cliques"],
            entry["ptr"]["messages"], wave_msgs, msg_blocks, n_msgs,
            n_msgs if normalize else n_blocks, plan.width, TINY, _stream(arena)), "sepset_wave")


def absorb_wave_cuda(plan, w, arena, scratch):
    """``absorb_wave``: wave ``w``'s ratios multiplied into their
    destinations in one launch, one thread per destination entry."""
    with torch.cuda.device(arena.device):
        entry = _device_tables(plan, arena.device)
        groups, group_blocks, n_groups, n_blocks = entry["waves"][w]["groups"]
        _launched(_library().pgmpy_jt_absorb_wave(
            arena.element_size(), arena.data_ptr(), scratch.data_ptr(), entry["ptr"]["cliques"],
            entry["ptr"]["messages"], groups, group_blocks, n_groups,
            entry["ptr"]["group_messages"], n_blocks, ENTRIES_PER_BLOCK, plan.width,
            _stream(arena)), "absorb_wave")


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
    scratch = torch.empty(max(plan.scratch_size, 1), dtype=dtype, device=device)
    clique_potentials_cuda(plan, arrays, arena)
    for w in range(plan.n_waves):
        sepset_wave_cuda(plan, w, arena, sepsets, scratch, operation, normalize)
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
