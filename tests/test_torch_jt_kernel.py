"""K2, the junction-tree calibration kernels (``pgmpy_tpu_torch/ops/jt.py``,
``csrc/jt_calibrate.cu``), on the CPU.

* The wave tables are valid: every message appears once, a source has
  received in earlier waves exactly the messages the sequential schedule gave
  it before it sends, no clique is a source and a destination of one wave, and
  the launch grids cover every arena and sepset entry exactly once (ASIA,
  ALARM, INSURANCE, CHILD, a forest, MUNIN's tree).
* A numpy walk of the descriptor tables, block by block and thread by thread
  as the CUDA kernels read them, agrees with the plain version (rtol 1e-5 in
  float32: the walk sums in float64 as the kernels do, the plain version in
  float32).
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
    # the grids: blocks of clique_potentials and absorb_wave cover their
    # cliques, and sepset_wave's cover every sepset entry, exactly once
    sizes = plan.cliques[:, jt.CLIQUE_SIZE]
    per = -(-sizes // jt.ENTRIES_PER_BLOCK)
    assert plan.potential_blocks == per.sum()
    assert (plan.clique_blocks == np.concatenate([[0], np.cumsum(per)[:-1]])).all()
    for w in range(plan.n_waves):
        glo, ghi = plan.wave_group_start[w:w + 2]
        dsts = plan.groups[glo:ghi, 0]
        counts = per[dsts]
        assert (plan.group_blocks[glo:ghi] == np.concatenate([[0], np.cumsum(counts)[:-1]])).all()
        assert plan.absorb_blocks[w] == counts.sum()
        lo, hi = plan.wave_message_start[w:w + 2]
        rows = plan.messages[plan.wave_messages[lo:hi]]
        blocks = -(-rows[:, jt.MSG_SIZE] // (jt.BLOCK >> rows[:, jt.MSG_LANES_LOG2]))
        assert (plan.message_blocks[lo:hi] == np.concatenate([[0], np.cumsum(blocks)[:-1]])).all()
        assert plan.sepset_blocks[w] == blocks.sum()
        # each message's ratio slot lies inside the wave's scratch, apart
        ends = rows[:, jt.MSG_RATIO] + rows[:, jt.MSG_SIZE]
        assert (rows[:, jt.MSG_RATIO] == np.concatenate([[0], ends[:-1]])).all()
        assert ends[-1] <= plan.scratch_size
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


def _walk_offsets(index, n, dims, strides):
    """``walk_offset`` of jt_calibrate.cu, for an array of indices."""
    off = np.zeros_like(index)
    for a in range(n - 1, -1, -1):
        off += (index % dims[a]) * strides[a]
        index = index // dims[a]
    return off


def _digits(index, row, width):
    nd = int(row[jt.CLIQUE_NDIM])
    dims = row[jt.CLIQUE_HEADER:jt.CLIQUE_HEADER + width]
    digit = np.zeros((width, index.size), dtype=np.int64)
    for a in range(nd - 1, -1, -1):
        digit[a] = index % dims[a]
        index = index // dims[a]
    return digit


def numpy_walk(plan, arrays, operation, normalize, dtype=np.float32):
    """The kernels' arithmetic over their grids and descriptor tables: every
    block finds its slot by the block prefix, every thread its entry.  Returns
    (belief arena, sepset arena, writes per arena entry)."""
    W = plan.width
    kd, ks, rd, rs, ds = (jt.MSG_HEADER + k * W for k in range(5))
    tiny = dtype(TINY)
    flat = [np.asarray(a, dtype=dtype).ravel() for a in arrays]
    arena = np.full(plan.total, np.nan, dtype=dtype)
    mu = np.full(plan.sepset_total, np.nan, dtype=dtype)
    writes = np.zeros(plan.total, dtype=np.int64)
    sep_writes = np.zeros(plan.sepset_total, dtype=np.int64)
    threads = np.arange(jt.BLOCK)

    def owned(b, starts, slot, size):
        begin = (b - starts[slot]) * jt.ENTRIES_PER_BLOCK
        return np.arange(begin, min(size, begin + jt.ENTRIES_PER_BLOCK))

    # clique_potentials
    for b in range(plan.potential_blocks):
        c = _find_slot(plan.clique_blocks, b)
        row = plan.cliques[c]
        i = owned(b, plan.clique_blocks, c, row[jt.CLIQUE_SIZE])
        digit = _digits(i.copy(), row, W)
        x = np.ones(i.size, dtype=dtype)
        for f in range(plan.clique_factors[c], plan.clique_factors[c + 1]):
            fr = plan.factors[f]
            v = flat[fr[0]][(digit * fr[1:, None]).sum(axis=0)]
            x = v if f == plan.clique_factors[c] else x * v
        arena[row[jt.CLIQUE_OFFSET] + i] = x
        writes[row[jt.CLIQUE_OFFSET] + i] += 1
    for w in range(plan.n_waves):
        lo, hi = plan.wave_message_start[w:w + 2]
        starts = plan.message_blocks[lo:hi]
        scratch = np.full(max(plan.scratch_size, 1), np.nan, dtype=dtype)
        # sepset_wave: blocks over (message, run of entries); with normalize
        # one block per message, walking its runs one after another
        if normalize:
            runs = [(plan.wave_messages[m], j0) for m in range(lo, hi)
                    for j0 in range(0, plan.messages[plan.wave_messages[m], jt.MSG_SIZE],
                                    jt.BLOCK >> plan.messages[plan.wave_messages[m],
                                                              jt.MSG_LANES_LOG2])]
        else:
            runs = []
            for b in range(plan.sepset_blocks[w]):
                slot = _find_slot(starts, b)
                m = plan.wave_messages[lo + slot]
                runs.append((m, (b - starts[slot]) * (jt.BLOCK >> plan.messages[
                    m, jt.MSG_LANES_LOG2])))
        for m, j0 in runs:
            row = plan.messages[m]
            log2 = int(row[jt.MSG_LANES_LOG2])
            lanes = 1 << log2
            j = j0 + (threads >> log2)
            lane = threads & (lanes - 1)
            part = np.zeros(jt.BLOCK) if operation == "marginalize" else np.full(jt.BLOCK, -np.inf)
            live = j < row[jt.MSG_SIZE]
            src = plan.cliques[row[jt.MSG_SRC], jt.CLIQUE_OFFSET]
            base = _walk_offsets(j[live], int(row[jt.MSG_NKEEP]), row[kd:], row[ks:])
            for t, jb in zip(np.flatnonzero(live), base):
                r = np.arange(lane[t], row[jt.MSG_REDUCED], lanes)
                vals = arena[src + jb + _walk_offsets(r, int(row[jt.MSG_NRED]), row[rd:], row[rs:])]
                vals = vals.astype(np.float64)
                part[t] = vals.sum() if operation == "marginalize" else max(vals.max(), -np.inf)
            for t in np.flatnonzero(live & (lane == 0)):
                group = part[t:t + lanes]
                sigma = dtype(group.sum() if operation == "marginalize" else group.max())
                ratio_at, sep_at = row[jt.MSG_RATIO] + j[t], row[jt.MSG_SEPSET] + j[t]
                if normalize:
                    scratch[ratio_at] = sigma
                    continue
                scratch[ratio_at] = sigma if row[jt.MSG_FRESH] else sigma / max(mu[sep_at], tiny)
                mu[sep_at] = sigma
                sep_writes[sep_at] += 1
        if normalize:  # the end of each message's block: divide by the total
            for m in plan.wave_messages[lo:hi]:
                row = plan.messages[m]
                r0, s0, n = row[jt.MSG_RATIO], row[jt.MSG_SEPSET], row[jt.MSG_SIZE]
                sigma = scratch[r0:r0 + n] / max(dtype(scratch[r0:r0 + n].astype(np.float64).sum()),
                                                 tiny)
                scratch[r0:r0 + n] = (sigma if row[jt.MSG_FRESH]
                                      else sigma / np.maximum(mu[s0:s0 + n], tiny))
                mu[s0:s0 + n] = sigma
                sep_writes[s0:s0 + n] += 1
        # absorb_wave
        glo, ghi = plan.wave_group_start[w:w + 2]
        gstarts = plan.group_blocks[glo:ghi]
        for b in range(plan.absorb_blocks[w]):
            g = _find_slot(gstarts, b)
            dst, in_lo, in_hi = plan.groups[glo + g]
            row = plan.cliques[dst]
            i = owned(b, gstarts, g, row[jt.CLIQUE_SIZE])
            digit = _digits(i.copy(), row, W)
            x = arena[row[jt.CLIQUE_OFFSET] + i]
            for m in plan.group_messages[in_lo:in_hi]:
                mrow = plan.messages[m]
                x = x * scratch[mrow[jt.MSG_RATIO] + (digit * mrow[ds:ds + W, None]).sum(axis=0)]
            arena[row[jt.CLIQUE_OFFSET] + i] = x
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
@pytest.mark.parametrize("case", ["asia", "random", "wide"])
def test_numpy_walk_matches_plain(tables, case, operation, normalize):
    if case == "asia":
        scopes, cards, arrays = tables["asia"]
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


def test_merged_walk_visits_the_same_offsets():
    rng = np.random.default_rng(0)
    for _ in range(50):
        shape = tuple(int(n) for n in rng.integers(1, 4, size=int(rng.integers(1, 7))))
        strides = jt.row_major_strides(shape)
        axes = sorted(rng.choice(len(shape), size=int(rng.integers(1, len(shape) + 1)),
                                 replace=False).tolist())
        if rng.random() < 0.5:
            axes = list(rng.permutation(axes))
        dims, st = [shape[a] for a in axes], [strides[a] for a in axes]
        md, ms = jt.merge_axes(dims, st)
        n = int(np.prod(dims))
        idx = np.arange(n)
        assert (_walk_offsets(idx.copy(), len(dims), dims, st)
                == _walk_offsets(idx.copy(), len(md), md, ms)).all()
        assert len(md) <= len(dims) and 1 not in md


def test_lanes_per_entry():
    assert [jt.lanes_log2(r) for r in (1, 63, 64, 127, 128, 8191, 8192, 400_000)] == \
        [0, 0, 1, 1, 2, 7, 8, 8]
    for r in range(1, 5000, 37):
        lanes = 1 << jt.lanes_log2(r)
        assert lanes <= jt.BLOCK and (lanes == 1 or r // lanes >= jt.MIN_WALK)


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
