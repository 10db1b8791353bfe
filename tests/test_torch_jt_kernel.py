"""K2, the junction-tree calibration kernels (``pgmpy_tpu_torch/ops/jt.py``,
``csrc/jt_calibrate.cu``), on the CPU.

* The wave tables are valid: every message appears once, a source has
  received in earlier waves exactly the messages the sequential schedule gave
  it before it sends, no clique is a source and a destination of one wave, and
  the launch grids cover every arena and sepset entry exactly once (ASIA,
  ALARM, INSURANCE, CHILD, a forest, MUNIN's tree).
* A numpy walk of the descriptor tables, block by block (in a random order)
  and thread by thread as the CUDA kernels read them, agrees with the plain
  version (rtol 1e-5 in float32: the walk sums in float64 as the kernels do,
  the plain version in float32); no ``sepset_wave`` block reads more than
  ``MAX_BLOCK_WALK`` source entries, on MUNIN's tree too; the host's
  multiply-shift constants divide exactly, and the absorb odometer gives the
  indices a full decode gives.
* The plain version agrees with ``pgmpy_tpu``'s ``JunctionTreeProgram`` on
  the same numpy tables at the beliefs' tolerance of ``test_torch_bp.py``
  (atol 1e-6, rtol 1e-4): both operations, messages normalised or not.
* Float64 stays float64, and agrees with a numpy float64 enumeration of the
  joint at 1e-12.

The kernels themselves run on the card only: ``tests/test_torch_jt_kernel_cuda.py``.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgmpy_tpu.inference.bp import JunctionTreeProgram as JaxProgram
from pgmpy_tpu.utils import get_example_model as jax_example

from _torch_parity import random_bn_pair
from pgmpy_tpu_torch.config import TINY
from pgmpy_tpu_torch.inference.bp import JunctionTreeProgram
from pgmpy_tpu_torch.ops import jt
from pgmpy_tpu_torch.readwrite import BIFReader
from pgmpy_tpu_torch.utils.utils import _EXAMPLE_DIR

BELIEF_TOL = dict(atol=1e-6, rtol=1e-4)
NETWORKS = ("asia", "alarm", "insurance", "child")


def _tables(jax_model):
    """(factor scopes, cardinalities, float64 factor tables) of a network's CPDs."""
    factors = [cpd.to_factor() for cpd in jax_model.get_cpds()]
    scopes = [list(f.variables) for f in factors]
    cards = {v: int(c) for f in factors for v, c in zip(f.variables, f.cardinality)}
    return scopes, cards, [np.asarray(f.values, dtype=np.float64) for f in factors]


def _renamed(scopes, cards, arrays, suffix):
    return ([[v + suffix for v in s] for s in scopes], {v + suffix: c for v, c in cards.items()},
            arrays)


@pytest.fixture(scope="module")
def tables():
    out = {name: _tables(jax_example(name)) for name in NETWORKS}
    # a forest of two trees, as a pruned model gives
    a, b = out["asia"], _renamed(*_tables(jax_example("cancer")), "_2")
    out["forest"] = (a[0] + b[0], {**a[1], **b[1]}, a[2] + b[2])
    return out


def _scaled(arrays, seed):
    """The tables times random positive scales: arbitrary-scale potentials, as a
    Markov network has, so that normalising the messages matters."""
    rng = np.random.default_rng(seed)
    return [a * rng.uniform(0.25, 4.0) for a in arrays]


# --------------------------------------------------------------------------- #
# the wave tables
# --------------------------------------------------------------------------- #
def _munin_program():
    reader = BIFReader(path=f"{_EXAMPLE_DIR}/munin.bif.gz")
    scopes = [[v] + list(reader.variable_parents.get(v, [])) for v in reader.variable_names]
    return JunctionTreeProgram.from_factors(scopes, dict(reader.variable_cards),
                                            normalize_messages=False)


def _assert_plan_valid(program, plan):
    messages = program.messages
    n_msgs = len(messages)
    wave_of = np.full(n_msgs, -1)
    for w in range(plan.n_waves):
        ids, groups = plan.wave(w)
        assert ids, f"wave {w} is empty"
        for m in ids:
            assert wave_of[m] == -1, f"message {m} appears twice"
            wave_of[m] = w
        sources = {messages[m][0] for m in ids}
        dsts = [d for d, _ in groups]
        # no destination entry has two writers, and no source is rewritten
        # while the wave reads it
        assert len(dsts) == len(set(dsts)) and not sources & set(dsts)
        assert sorted(m for _, inc in groups for m in inc) == sorted(ids)
        for d, inc in groups:
            assert inc == sorted(inc) and all(messages[m][1] == d for m in inc)
    assert (wave_of >= 0).all(), "a message is in no wave"
    assert sorted(plan.wave_messages.tolist()) == list(range(n_msgs))
    # a source has received, in earlier waves, exactly what the sequential
    # schedule gave it before it sends
    for m, (src, *_) in enumerate(messages):
        before = {k for k in range(m) if messages[k][1] == src}
        earlier = {k for k in range(n_msgs) if messages[k][1] == src and wave_of[k] < wave_of[m]}
        assert before == earlier, f"message {m}"
    # every edge: first its fresh message, then the other one
    for edge in range(program.n_edges):
        pair = [m for m in range(n_msgs) if messages[m][5] == edge]
        assert len(pair) == 2 and messages[pair[0]][6] and not messages[pair[1]][6]
        assert wave_of[pair[0]] < wave_of[pair[1]]
    # the grids: clique_potentials' blocks cover their cliques; absorb_wave's
    # cover their destinations from the 4-entry boundary at or below each
    # offset; sepset_wave's cover every (run of sepset entries, chunk of the
    # reduced space) of every message
    sizes = plan.cliques[:, jt.CLIQUE_SIZE]
    per = -(-sizes // jt.ENTRIES_PER_BLOCK)
    assert plan.potential_blocks == per.sum()
    assert (plan.clique_blocks == np.concatenate([[0], np.cumsum(per)[:-1]])).all()
    offsets = plan.cliques[:, jt.CLIQUE_OFFSET]
    absorb_per = -(-(offsets + sizes - offsets // jt.ALIGN * jt.ALIGN) // jt.ABSORB_ENTRIES)
    for w in range(plan.n_waves):
        glo, ghi = plan.wave_group_start[w:w + 2]
        dsts = plan.groups[glo:ghi, jt.GROUP_DST]
        counts = absorb_per[dsts]
        assert (plan.group_blocks[glo:ghi] == np.concatenate([[0], np.cumsum(counts)[:-1]])).all()
        assert plan.absorb_blocks[w] == counts.sum()
        lo, hi = plan.wave_message_start[w:w + 2]
        rows = plan.messages[plan.wave_messages[lo:hi]]
        runs = -(-rows[:, jt.MSG_SIZE] // ((jt.BLOCK >> rows[:, jt.MSG_LANES_LOG2])
                                            * rows[:, jt.MSG_PER_THREAD]))
        assert (rows[:, jt.MSG_RUNS] == runs).all()
        assert (rows[:, jt.MSG_CHUNKS] * rows[:, jt.MSG_CHUNK_LEN] >= rows[:, jt.MSG_REDUCED]).all()
        assert ((rows[:, jt.MSG_CHUNKS] - 1) * rows[:, jt.MSG_CHUNK_LEN]
                < rows[:, jt.MSG_REDUCED]).all(), "an empty chunk"
        blocks = runs * rows[:, jt.MSG_CHUNKS]
        assert (plan.message_blocks[lo:hi] == np.concatenate([[0], np.cumsum(blocks)[:-1]])).all()
        assert plan.sepset_blocks[w] == blocks.sum()
        # each message's ratio and partial slots lie inside the wave's
        # scratch, apart
        ends = rows[:, jt.MSG_RATIO] + rows[:, jt.MSG_SIZE]
        assert (rows[:, jt.MSG_RATIO] == np.concatenate([[0], ends[:-1]])).all()
        assert ends[-1] <= plan.scratch_size
        ends = rows[:, jt.MSG_PARTIAL] + rows[:, jt.MSG_CHUNKS] * rows[:, jt.MSG_SIZE]
        assert (rows[:, jt.MSG_PARTIAL] == np.concatenate([[0], ends[:-1]])).all()
        assert ends[-1] <= plan.partial_size
        # no block reads more source entries than the design's maximum
        assert (jt.block_walks(rows) <= jt.MAX_BLOCK_WALK).all()
        # the offsets folded into the rows are the cliques'
        assert (rows[:, jt.MSG_SRC_OFFSET] == offsets[rows[:, jt.MSG_SRC]]).all()
        assert (plan.groups[glo:ghi, jt.GROUP_OFFSET] == offsets[dsts]).all()
        assert (plan.groups[glo:ghi, jt.GROUP_SIZE] == sizes[dsts]).all()
    assert plan.total == sum(int(np.prod(s)) for s in program.clique_shapes)
    assert plan.sepset_total == sum(int(np.prod(s)) for s in program.sepset_shapes)


@pytest.mark.parametrize("name", NETWORKS + ("forest",))
def test_wave_tables_valid(tables, name):
    scopes, cards, _ = tables[name]
    program = JunctionTreeProgram.from_factors(scopes, cards)
    plan = program.wave_plan()
    _assert_plan_valid(program, plan)
    if name == "forest":
        assert len(program.component_roots) == 2
    # upward waves by height, then as many downward ones by depth
    assert plan.n_waves == 2 * plan.n_up_waves


def test_munin_wave_tables_valid():
    """Build only: MUNIN's merged tree as the main path builds it."""
    program = _munin_program()
    plan = program.wave_plan()
    _assert_plan_valid(program, plan)
    assert plan.width == jt.WIDTHS[0] >= max(len(s) for s in program.clique_shapes)
    assert plan.n_waves < len(program.messages) // 10


_MUNIN_WIDTH_SCRIPT = """
from pgmpy_tpu_torch.inference.bp import JunctionTreeProgram
from pgmpy_tpu_torch.readwrite import BIFReader
from pgmpy_tpu_torch.utils.utils import _EXAMPLE_DIR
reader = BIFReader(path=f"{_EXAMPLE_DIR}/munin.bif.gz")
scopes = [[v] + list(reader.variable_parents.get(v, [])) for v in reader.variable_names]
program = JunctionTreeProgram.from_factors(scopes, dict(reader.variable_cards),
                                           normalize_messages=False)
print(len(program.cliques), max(len(s) for s in program.clique_shapes),
      program.wave_plan().width)
"""


@pytest.mark.parametrize("hash_seeds", [(1, 2, 3, 4)])
def test_munin_width_across_hash_seeds(hash_seeds):
    """MUNIN's merged tree follows the string hash seed (its clique count
    varies); under each of these seeds every clique fits the kernels'
    ``MAX_AXES``, so the card calibrates it instead of raising."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _MUNIN_WIDTH_SCRIPT], cwd=root, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env={**os.environ, "PYTHONHASHSEED": str(s), "PYTHONPATH": root})
        for s in hash_seeds]
    for seed, proc in zip(hash_seeds, procs):
        out, err = proc.communicate(timeout=240)
        assert proc.returncode == 0, f"PYTHONHASHSEED={seed}: {err}"
        n_cliques, axes, width = map(int, out.split())
        assert axes <= width <= jt.MAX_AXES, f"PYTHONHASHSEED={seed}: {n_cliques} cliques"


# --------------------------------------------------------------------------- #
# a numpy walk of the tables, as the CUDA threads read them
# --------------------------------------------------------------------------- #
def _find_slot(starts, b):
    return int(np.searchsorted(starts, b, side="right")) - 1


def _split_digit(index, size, packed):
    """``split_digit`` of jt_calibrate.cu: (digit, rest) by multiply-shift."""
    mul, shift = packed & 0xFFFFFFFF, packed >> 32
    rest = ((index * mul) >> 32) >> shift
    return index - rest * size, rest


def _walk(index, n, dims, magics, strides):
    """``walk`` of jt_calibrate.cu for an array of indices: a row-major walk
    over ``n`` axes given innermost first."""
    off = np.zeros_like(index)
    for a in range(n - 1):
        digit, index = _split_digit(index, dims[a], magics[a])
        off += digit * strides[a]
    return off + index * strides[n - 1] if n else off


def _digits(index, row, width):
    nd = int(row[jt.CLIQUE_NDIM])
    dims = row[jt.CLIQUE_HEADER:jt.CLIQUE_HEADER + width]
    digit = np.zeros((width, index.size), dtype=np.int64)
    for a in range(nd - 1, -1, -1):
        digit[a] = index % dims[a]
        index = index // dims[a]
    return digit


def _group_axes(plan, grow):
    W = plan.width
    return (grow[jt.GROUP_HEADER:jt.GROUP_HEADER + W],
            grow[jt.GROUP_HEADER + W:jt.GROUP_HEADER + 2 * W])


def _ratio_index(index, ndec, dims, magics, strides):
    """The ratio entry of destination entries ``index``: the digits of the
    merged axes by multiply-shift, innermost first, up to the last axis any
    incoming ratio uses."""
    idx = np.zeros_like(index)
    for a in range(ndec):
        digit, index = _split_digit(index, dims[a], magics[a])
        idx += digit * strides[a]
    return idx


def absorb_indices(at, offset, vec, nd, ndec, dims, magics, strides):
    """``absorb_wave``'s ratio indices for one block's consecutive arena
    addresses ``at`` of a destination at ``offset``, as the threads compute
    them: a whole slot of ``vec`` entries on a ``vec``-aligned address decodes
    its first entry by multiply-shift, and each next entry steps the innermost
    digit (adds its stride) unless that digit carries, and then decodes
    again; a slot at either end of the run decodes every entry."""
    i = at - offset
    size0 = int(dims[0]) if nd else 1
    slot = at - at % vec
    whole = (slot >= at[0]) & (slot + vec <= at[-1] + 1)  # a slot at either end decodes all
    decoded = ~whole | (at % vec == 0) | (i % size0 == 0)
    k = np.arange(at.size)
    last = np.maximum.accumulate(np.where(decoded, k, 0))
    full = _ratio_index(i, ndec, dims, magics, strides)
    return full[last] + (k - last) * (int(strides[0]) if ndec else 0)


def numpy_walk(plan, arrays, operation, normalize, dtype=np.float32, seed=0):
    """The kernels' arithmetic over their grids and descriptor tables: every
    block finds its slot by the block prefix, every thread its entries, and
    the blocks of a launch run in a random order (the card runs them in
    none).  Asserts as it goes that every sepset entry of a message that
    combines partials is combined once, from every chunk, in chunk order;
    that every destination entry is read and written once per wave; that every
    ticket is back at 0 after each wave; and that no block reads more than
    ``MAX_BLOCK_WALK`` source entries.  Returns (belief arena, sepset arena,
    writes per arena entry in stage 0)."""
    W = plan.width
    col = {k: jt.MSG_HEADER + k * W for k in range(7)}
    tiny = dtype(TINY)
    rng = np.random.default_rng(seed)
    maximize = operation == "maximize"
    combine = np.maximum if maximize else np.add
    flat = [np.asarray(a, dtype=dtype).ravel() for a in arrays]
    arena = np.full(plan.total, np.nan, dtype=dtype)
    mu = np.full(plan.sepset_total, np.nan, dtype=dtype)
    writes = np.zeros(plan.total, dtype=np.int64)
    sep_writes = np.zeros(plan.sepset_total, dtype=np.int64)
    tickets = np.zeros(len(plan.messages), dtype=np.int64)  # by position in wave order
    threads = np.arange(jt.BLOCK)
    vec = 16 // np.dtype(dtype).itemsize  # entries per 16-byte slot of absorb_wave

    # clique_potentials
    for b in range(plan.potential_blocks):
        c = _find_slot(plan.clique_blocks, b)
        row = plan.cliques[c]
        begin = (b - plan.clique_blocks[c]) * jt.ENTRIES_PER_BLOCK
        i = np.arange(begin, min(row[jt.CLIQUE_SIZE], begin + jt.ENTRIES_PER_BLOCK))
        digit = _digits(i.copy(), row, W)
        x = np.ones(i.size, dtype=dtype)
        for f in range(plan.clique_factors[c], plan.clique_factors[c + 1]):
            fr = plan.factors[f]
            v = flat[fr[0]][(digit * fr[1:, None]).sum(axis=0)]
            x = v if f == plan.clique_factors[c] else x * v
        arena[row[jt.CLIQUE_OFFSET] + i] = x
        writes[row[jt.CLIQUE_OFFSET] + i] += 1

    def finish(row, j, sigma):
        """A message's final sigma for its sepset entries j: normalised,
        ratio into the scratch, sigma into mu."""
        ratio_at, sep_at = row[jt.MSG_RATIO] + j, row[jt.MSG_SEPSET] + j
        old = mu[sep_at]
        scratch[ratio_at] = sigma if row[jt.MSG_FRESH] else sigma / np.maximum(old, tiny)
        mu[sep_at] = sigma
        sep_writes[sep_at] += 1

    wave_rows = plan.messages[plan.wave_messages]  # the device copy: rows in wave order
    for w in range(plan.n_waves):
        lo, hi = plan.wave_message_start[w:w + 2]
        starts = plan.message_blocks[lo:hi]
        rows, wave_tickets = wave_rows[lo:hi], tickets[lo:hi]
        scratch = np.full(max(plan.scratch_size, 1), np.nan, dtype=dtype)
        partial = np.full(max(plan.partial_size, 1), np.nan)
        partial_writes = np.zeros(max(plan.partial_size, 1), dtype=np.int64)
        # sepset_wave: blocks over (message, chunk, run of sepset entries)
        for b in rng.permutation(int(plan.sepset_blocks[w])):
            slot = _find_slot(starts, b)
            row = rows[slot]
            m = plan.wave_messages[lo + slot]  # for the messages below only
            size, reduced = int(row[jt.MSG_SIZE]), int(row[jt.MSG_REDUCED])
            runs, chunks, chunk_len = (int(row[k]) for k in (jt.MSG_RUNS, jt.MSG_CHUNKS,
                                                            jt.MSG_CHUNK_LEN))
            log2 = int(row[jt.MSG_LANES_LOG2])
            lanes, per_block = 1 << log2, jt.BLOCK >> log2
            run, chunk = (b - starts[slot]) % runs, (b - starts[slot]) // runs
            if row[jt.MSG_ENTRY_MAJOR]:
                lane, entry, step = threads >> (8 - log2), threads & (per_block - 1), per_block
            else:
                lane, entry, step = threads & (lanes - 1), threads >> log2, 1
            keep = (int(row[jt.MSG_NKEEP]), row[col[jt.KEEP_DIMS]:], row[col[jt.KEEP_MAGIC]:])
            red = (int(row[jt.MSG_NRED]), row[col[jt.RED_DIMS]:], row[col[jt.RED_MAGIC]:])
            src = row[jt.MSG_SRC_OFFSET]
            r_end = min(reduced, (chunk + 1) * chunk_len)
            per_thread = int(row[jt.MSG_PER_THREAD])
            assert per_thread == 1 or lanes == 1
            read, sigmas, cells_j = 0, [], []
            for n in range(per_thread):  # a lone lane's entries, one block apart
                q = (run * per_thread + n) * per_block + entry
                live = q < size
                base = _walk(q[live], *keep, row[col[jt.KEEP_STRIDES]:])
                part = np.full(jt.BLOCK, -np.inf if maximize else 0.0)
                for t, jb in zip(np.flatnonzero(live), base):
                    r = np.arange(chunk * chunk_len + lane[t], r_end, lanes)
                    read += r.size
                    vals = arena[src + jb + _walk(r, *red, row[col[jt.RED_STRIDES]:])]
                    if vals.size:  # in walk order, as the thread adds
                        vals = vals.astype(np.float64)
                        part[t] = vals.max() if maximize else np.cumsum(vals)[-1]
                for s in 1 << np.arange(log2)[::-1]:  # the lanes' fixed tree
                    t = threads[lane < s]
                    part[t] = combine(part[t], part[t + s * step])
                lead = live & (lane == 0)
                cells_j.append(_walk(q[lead], *keep, row[col[jt.KEEP_SEPSET]:]))
                sigmas.append(part[lead])
            assert read <= jt.MAX_BLOCK_WALK, f"a block of message {m} reads {read}"
            j, part = np.concatenate(cells_j), np.concatenate(sigmas)
            if not normalize and chunks == 1:
                finish(row, j, part.astype(dtype))
                continue
            cells = row[jt.MSG_PARTIAL] + chunk * size + j
            partial[cells] = part
            partial_writes[cells] += 1
            wave_tickets[slot] += 1
            if wave_tickets[slot] < runs * chunks:
                continue
            # the message's last block: its partials, in chunk order
            cells = row[jt.MSG_PARTIAL] + np.arange(chunks * size).reshape(chunks, size)
            assert (partial_writes[cells] == 1).all(), \
                f"message {m}: every sepset entry takes one partial from every chunk"
            sigma = partial[cells[0]]
            for c in range(1, chunks):
                sigma = combine(sigma, partial[cells[c]])
            sigma = sigma.astype(dtype)
            if normalize:
                sigma = sigma / max(dtype(sigma.astype(np.float64).sum()), tiny)
            finish(row, np.arange(size), sigma)
            wave_tickets[slot] = 0
        assert not tickets.any(), f"wave {w}: a ticket is not back at 0"
        # absorb_wave: blocks over (destination, run of ABSORB_ENTRIES entries
        # from the 4-entry boundary at or below its offset)
        glo, ghi = plan.wave_group_start[w:w + 2]
        gstarts = plan.group_blocks[glo:ghi]
        touched = np.zeros(plan.total, dtype=np.int64)
        for b in rng.permutation(int(plan.absorb_blocks[w])):
            g = _find_slot(gstarts, b)
            grow = plan.groups[glo + g]
            offset, size = int(grow[jt.GROUP_OFFSET]), int(grow[jt.GROUP_SIZE])
            base = offset // jt.ALIGN * jt.ALIGN + (b - gstarts[g]) * jt.ABSORB_ENTRIES
            at = np.arange(max(offset, base), min(offset + size, base + jt.ABSORB_ENTRIES))
            touched[at] += 1
            x = arena[at]
            dims, magics = _group_axes(plan, grow)
            nd, ndec = int(grow[jt.GROUP_NDIM]), int(grow[jt.GROUP_NDECODE])
            for arow in plan.absorb_rows[grow[jt.GROUP_BEGIN]:grow[jt.GROUP_END]]:
                strides = arow[jt.ABSORB_HEADER:]
                idx = absorb_indices(at, offset, vec, nd, ndec, dims, magics, strides)
                assert (idx == _ratio_index(at - offset, ndec, dims, magics, strides)).all()
                x = x * scratch[arow[jt.ABSORB_RATIO] + idx]
            arena[at] = x
        want = np.zeros(plan.total, dtype=np.int64)
        for dst in plan.groups[glo:ghi, jt.GROUP_DST]:
            offset, size = plan.cliques[dst, [jt.CLIQUE_OFFSET, jt.CLIQUE_SIZE]]
            want[offset:offset + size] = 1
        assert (touched == want).all(), \
            f"wave {w}: every destination entry is read and written once, no other entry"
    assert (sep_writes == 2).all(), "every sepset entry is written by both its messages"
    return arena, mu, writes


def wide_tables(seed=0):
    """(factor scopes, cardinalities, float64 tables) of a tree wider than
    MUNIN's: one clique of 18 binary axes (one factor over them) beside three
    small ones, so its tables take the kernels' 24-axis width."""
    names = [f"W{i:02d}" for i in range(21)]
    scopes = [names[:18], [names[0], names[18]], [names[17], names[19]], [names[18], names[20]]]
    rng = np.random.default_rng(seed)
    return scopes, {v: 2 for v in names}, [rng.random((2,) * len(s)) for s in scopes]


@pytest.mark.parametrize("operation", ["marginalize", "maximize"])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("case", ["asia", "alarm", "random", "wide"])
def test_numpy_walk_matches_plain(tables, case, operation, normalize):
    if case in ("asia", "alarm"):
        scopes, cards, arrays = tables[case]
    elif case == "wide":
        scopes, cards, arrays = wide_tables()
    else:
        port_model, _ = random_bn_pair(7, n_nodes=10, edge_prob=0.45)
        factors = [cpd.to_factor() for cpd in port_model.get_cpds()]
        scopes = [list(f.variables) for f in factors]
        cards = {v: int(c) for f in factors for v, c in zip(f.variables, f.cardinality)}
        arrays = [f.values.double().numpy() for f in factors]
    arrays = _scaled(arrays, 3)
    program = JunctionTreeProgram.from_factors(scopes, cards, normalize_messages=normalize)
    plan = program.wave_plan()
    assert len(program.messages) >= 6
    assert plan.width == (jt.WIDTHS[1] if case == "wide" else jt.WIDTHS[0])
    arena, mu, writes = numpy_walk(plan, arrays, operation, normalize)
    assert (writes == 1).all(), "clique_potentials writes every arena entry once"
    ref_arena, ref_mu = jt.calibrate_waves_reference(
        plan, [torch.from_numpy(a.astype(np.float32)) for a in arrays], operation, normalize)
    np.testing.assert_allclose(arena, ref_arena.numpy(), rtol=1e-5, atol=0)
    np.testing.assert_allclose(mu, ref_mu.numpy(), rtol=1e-5, atol=0)


def test_numpy_walk_cases_cover_every_form(tables):
    """The walk's cases reach every form the kernels take: messages cut into
    chunks, lone lanes owning several entries, lanes of an entry adjacent and
    entries adjacent, destinations
    that start off a 16-byte boundary, and groups of several messages."""
    port_model, _ = random_bn_pair(7, n_nodes=10, edge_prob=0.45)
    factors = [cpd.to_factor() for cpd in port_model.get_cpds()]
    random_case = ([list(f.variables) for f in factors],
                   {v: int(c) for f in factors for v, c in zip(f.variables, f.cardinality)})
    plans = [JunctionTreeProgram.from_factors(*case[:2]).wave_plan()
             for case in (tables["asia"], tables["alarm"], random_case, wide_tables())]
    rows = np.concatenate([p.messages[:, :jt.MSG_HEADER] for p in plans])
    lanes = rows[:, jt.MSG_LANES_LOG2] > 0
    assert (rows[:, jt.MSG_CHUNKS] > 1).any() and (rows[:, jt.MSG_PER_THREAD] > 1).any()
    assert (lanes & (rows[:, jt.MSG_ENTRY_MAJOR] == 1)).any()
    assert (lanes & (rows[:, jt.MSG_ENTRY_MAJOR] == 0)).any()
    assert any((p.cliques[p.groups[:, jt.GROUP_DST], jt.CLIQUE_OFFSET] % jt.ALIGN).any()
               for p in plans)
    assert any((p.groups[:, jt.GROUP_END] - p.groups[:, jt.GROUP_BEGIN] > 1).any() for p in plans)


def test_merged_walk_visits_the_same_offsets():
    """Merged axes (adjacent in every stride list) walked innermost first by
    multiply-shift, as ``walk`` does, visit the offsets of the unmerged
    row-major walk, in both stride lists (a source's and a sepset's)."""
    rng = np.random.default_rng(0)
    for _ in range(50):
        shape = tuple(int(n) for n in rng.integers(1, 4, size=int(rng.integers(1, 7))))
        strides = jt.row_major_strides(shape)
        axes = sorted(rng.choice(len(shape), size=int(rng.integers(1, len(shape) + 1)),
                                 replace=False).tolist())
        if rng.random() < 0.5:
            axes = list(rng.permutation(axes))
        dims, st = [shape[a] for a in axes], [strides[a] for a in axes]
        other = jt.row_major_strides([shape[a] for a in sorted(axes)])
        other = [other[sorted(axes).index(a)] for a in axes]
        md, ms, mo = jt.merge_axes(dims, st, other)
        n = int(np.prod(dims))
        idx = np.arange(n)
        digits = np.unravel_index(idx, dims)
        magics = [jt.magic(d) for d in md[::-1]]
        for plain, merged in ((st, ms), (other, mo)):
            want = sum(d * s for d, s in zip(digits, plain))
            assert (_walk(idx.copy(), len(md), md[::-1], magics, merged[::-1]) == want).all()
        assert len(md) <= len(dims) and 1 not in md


@pytest.mark.parametrize("reduced", [1, 15, 16, 17, 343, 4095, 8192, 8193, 98_000, 392_000])
def test_message_cut(reduced):
    """The host's cut of one message: 2^k lanes per sepset entry, each walking
    at least MIN_WALK reduced entries where there are that many (fewer than
    2 MIN_WALK unless a whole block reduces one entry), and the reduced space
    in chunks of at most MAX_WALK entries per lane, none empty."""
    log2, chunks, chunk_len, per_thread = jt.message_cut(reduced)
    lanes = 1 << log2
    assert 0 <= log2 <= jt.MAX_LANES_LOG2
    assert chunks * chunk_len >= reduced > (chunks - 1) * chunk_len
    assert -(-chunk_len // lanes) <= jt.MAX_WALK
    if lanes > 1:
        assert reduced // lanes >= jt.MIN_WALK
    if lanes < jt.BLOCK:
        assert chunks == 1 and reduced < 2 * jt.MIN_WALK * lanes
    assert per_thread >= 1 and (per_thread == 1 or (lanes == 1 and per_thread * reduced
                                                    <= jt.MIN_WALK))
    assert (jt.BLOCK >> log2) * per_thread * chunk_len <= jt.MAX_BLOCK_WALK


@pytest.mark.parametrize("low, high", [(2, 2**12), (2**12, 2**20), (2**20, 2**31)])
def test_multiply_shift_divides(low, high):
    """``magic``'s constants divide every numerator below 2^31 exactly."""
    rng = np.random.default_rng(low)
    divisors = np.unique(np.concatenate([rng.integers(low, high, 300), [low, high - 1]]))
    for d in divisors.tolist():
        packed = jt.magic(d)
        assert packed & 0xFFFFFFFF < 2**32 and 0 <= packed >> 32 < 31
        n = np.concatenate([rng.integers(0, 2**31, 500), [0, 1, d - 1, d, 2**31 - 1,
                                                          (2**31 - 1) // d * d - 1]])
        n = n[(n >= 0) & (n < 2**31)].astype(np.int64)
        digit, rest = _split_digit(n, d, packed)
        assert (rest == n // d).all() and (digit == n % d).all(), d


def test_absorb_odometer_matches_decode():
    """Stepping the innermost digit within a 16-byte slot gives the ratio
    index a full decode gives, for unaligned offsets, both element sizes and
    merged axes whose innermost size is 2 to 7."""
    rng = np.random.default_rng(5)
    for _ in range(60):
        shape = [int(n) for n in rng.integers(2, 8, size=int(rng.integers(1, 5)))]
        strides = [int(s) if rng.random() < 0.7 else 0 for s in jt.row_major_strides(shape)]
        dims, st = shape[::-1], strides[::-1]
        magics = [jt.magic(d) for d in dims]
        ndec = 1 + max([k for k, s in enumerate(st) if s], default=-1)
        offset = int(rng.integers(0, 64))
        at = np.arange(offset, offset + int(np.prod(shape)))
        full = _ratio_index(at - offset, ndec, dims, magics, st)
        for vec in (2, 4):
            got = absorb_indices(at, offset, vec, len(dims), ndec, dims, magics, st)
            assert (got == full).all()


def test_munin_no_block_reads_more_than_the_maximum():
    """Build only: on MUNIN's tree no block of any wave reads more than
    MAX_BLOCK_WALK source entries (a plan of one block per run of sepset
    entries had a block reading 392,000 at PYTHONHASHSEED=0), large messages
    are cut into chunks, and every wave's
    sepset_wave launch has at least as many blocks as its largest message
    needs at that maximum."""
    plan = _munin_program().wave_plan()
    walks = jt.block_walks(plan.messages)
    assert walks.max() <= jt.MAX_BLOCK_WALK
    sources = plan.cliques[plan.messages[:, jt.MSG_SRC], jt.CLIQUE_SIZE]
    assert (plan.messages[sources >= 1_000_000, jt.MSG_SIZE] <= 64).any()
    split = plan.messages[:, jt.MSG_CHUNKS] > 1
    assert split.any() and (plan.messages[split, jt.MSG_LANES_LOG2] == jt.MAX_LANES_LOG2).all()
    for w in range(plan.n_waves):
        lo, hi = plan.wave_message_start[w:w + 2]
        largest = int(sources[plan.wave_messages[lo:hi]].max())
        assert plan.sepset_blocks[w] * jt.MAX_BLOCK_WALK >= largest


# --------------------------------------------------------------------------- #
# the plain version against pgmpy_tpu
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("operation", ["marginalize", "maximize"])
@pytest.mark.parametrize("name", NETWORKS + ("forest",))
def test_plain_matches_jax(tables, name, operation, normalize):
    scopes, cards, arrays = tables[name]
    arrays = [a.astype(np.float32) for a in (_scaled(arrays, 1) if normalize else arrays)]
    port = JunctionTreeProgram.from_factors(scopes, cards, normalize_messages=normalize)
    ref = JaxProgram.from_factors(scopes, cards, normalize_messages=normalize)
    assert port.cliques == ref.cliques and port.messages == ref.messages
    before = jt.JT_LAUNCHES
    beliefs, mu = port.calibrate([torch.from_numpy(a) for a in arrays], operation)
    assert jt.JT_LAUNCHES == before, "a CPU calibration launched a kernel"
    jax_arrays = [jnp.asarray(a) for a in arrays]
    want_b, want_mu = ref.executor(operation, one_shot=True)(jax_arrays)
    want_b, want_mu = [np.asarray(w) for w in want_b], [np.asarray(w) for w in want_mu]
    assert len(beliefs) == len(want_b) and len(mu) == len(want_mu)
    nan = sum(int(np.isnan(w).sum()) for w in want_b + want_mu)
    if nan:
        # pgmpy_tpu's jitted program on the CPU gives NaN in some entries of
        # ALARM, INSURANCE and the forest with normalised messages, where the
        # same ops run one by one (``jax.disable_jit``) give none: there the
        # port is held to the op-by-op arithmetic.
        assert normalize
        with jax.disable_jit():
            eager_b, eager_mu = ref._build(operation, len(ref.messages))(jax_arrays)
        for wants, eager in ((want_b, eager_b), (want_mu, eager_mu)):
            for k, w in enumerate(wants):
                wants[k] = np.where(np.isnan(w), np.asarray(eager[k]), w)
    for got, want, shape in zip(beliefs, want_b, port.clique_shapes):
        assert tuple(got.shape) == shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **BELIEF_TOL)
    for got, want, shape in zip(mu, want_mu, port.sepset_shapes):
        assert tuple(got.shape) == shape
        np.testing.assert_allclose(got.numpy(), want, **BELIEF_TOL)


def _joint(scopes, arrays):
    variables = sorted({v for s in scopes for v in s})
    letters = {v: chr(ord("a") + i) for i, v in enumerate(variables)}
    spec = ",".join("".join(letters[v] for v in s) for s in scopes)
    return variables, letters, np.einsum(spec + "->" + "".join(letters[v] for v in variables),
                                         *arrays)


def test_float64_stays_float64(tables):
    """Float64 tables give float64 beliefs and messages, equal to the numpy
    float64 joint's clique and sepset marginals at 1e-12."""
    scopes, cards, arrays = tables["asia"]
    program = JunctionTreeProgram.from_factors(scopes, cards, normalize_messages=False)
    beliefs, mu = program.calibrate([torch.from_numpy(a) for a in arrays])
    variables, letters, joint = _joint(scopes, arrays)
    for clique, b in zip(program.cliques, beliefs):
        assert b.dtype == torch.float64
        want = np.einsum("".join(letters[v] for v in variables) + "->"
                         + "".join(letters[v] for v in clique), joint)
        np.testing.assert_allclose(b.numpy(), want, rtol=1e-12, atol=1e-15)
    for edge_key, e in program.edge_ids.items():
        c1, c2 = tuple(edge_key)
        sepset = sorted(set(c1) & set(c2), key=str)
        assert mu[e].dtype == torch.float64
        want = np.einsum("".join(letters[v] for v in variables) + "->"
                         + "".join(letters[v] for v in sepset), joint)
        np.testing.assert_allclose(mu[e].numpy(), want, rtol=1e-12, atol=1e-15)


def test_fresh_arena_every_calibration(tables):
    """The beliefs a caller holds are not overwritten by the next calibration."""
    scopes, cards, arrays = tables["asia"]
    program = JunctionTreeProgram.from_factors(scopes, cards)
    first, _ = program.calibrate([torch.from_numpy(a) for a in arrays])
    kept = [b.clone() for b in first]
    program.calibrate([torch.from_numpy(a * 2.0) for a in arrays])
    assert all(torch.equal(a, b) for a, b in zip(first, kept))


def test_executor_signature_and_wide_clique():
    """``executor`` has the JAX package's signature; a clique beyond the
    kernels' axis limit calibrates on the CPU and is refused by the CUDA
    wrapper, which never falls back."""
    port_params = list(inspect.signature(JunctionTreeProgram.executor).parameters.items())
    jax_params = list(inspect.signature(JaxProgram.executor).parameters.items())
    assert [(k, p.default) for k, p in port_params] == [(k, p.default) for k, p in jax_params]
    n = jt.MAX_AXES + 1
    names = [f"V{i:02d}" for i in range(n)]
    # axes of one state past the fourth keep the clique small
    shape = tuple(2 if i < 4 else 1 for i in range(n))
    program = JunctionTreeProgram.from_factors(
        [names, names[:2]], {v: k for v, k in zip(names, shape)})
    plan = program.wave_plan()
    assert plan.width == n
    rng = np.random.default_rng(0)
    arrays = [torch.from_numpy(rng.random(shape)), torch.from_numpy(rng.random((2, 2)))]
    beliefs, _ = program.calibrate(arrays)
    assert tuple(beliefs[0].shape) == shape
    with pytest.raises(ValueError, match="axes"):
        jt.calibrate_waves_cuda(plan, arrays)
    with pytest.raises(ValueError, match="CUDA"):
        jt.calibrate_waves_cuda(JunctionTreeProgram.from_factors(
            [names[:2]], {v: 2 for v in names[:2]}).wave_plan(), arrays[1:])


def test_every_bp_caller_goes_through_the_wave_plan(tables, monkeypatch):
    """BeliefPropagation's calibrations (the main path and the per-signature
    query programs) call the dispatcher, once per calibration."""
    from _torch_parity import to_port
    from pgmpy_tpu_torch.inference import BeliefPropagation

    calls = []
    real = jt.calibrate_waves

    def counted(*args, **kwargs):
        calls.append(args[2])
        return real(*args, **kwargs)

    monkeypatch.setattr(jt, "calibrate_waves", counted)
    bp = BeliefPropagation(to_port(jax_example("asia")))
    bp.calibrate()
    bp.max_calibrate()
    bp.query(["lung"], evidence={"smoke": "yes"})
    assert calls == ["marginalize", "maximize", "marginalize"]


def test_forest_components_share_waves(tables):
    """The two trees of a forest run in the same waves, not one after another."""
    scopes, cards, _ = tables["forest"]
    program = JunctionTreeProgram.from_factors(scopes, cards)
    first_wave, _ = program.wave_plan().wave(0)
    names = {v for m in first_wave for v in program.cliques[program.messages[m][0]]}
    assert any(v.endswith("_2") for v in names) and any(not v.endswith("_2") for v in names)
