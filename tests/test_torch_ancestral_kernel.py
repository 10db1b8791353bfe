"""The ancestral sweep (K5) on the CPU, and what a CPU test can see of its
CUDA route (``csrc/ancestral.cu``): the node table, per-call modes and tile
plan the wrapper hands the kernel, emulated in numpy against the plain
version on the same explicit noise.

Every comparison here is to the bit: the explicit noise is the uniforms the
plain version draws from its generator, and the emulation reads the CDF rows
as the kernel reads them (from each node's even offset, pairs of entries),
counts the entries at or below the uniform, and adds the evidence's log
probabilities in the tables' type in the kernel's order.  The sweep's
parity with pgmpy_tpu (deterministic networks, equal codes) and its
distribution stay in ``tests/test_torch_sampling.py``."""

import numpy as np
import pytest
import torch

from pgmpy_tpu.utils import get_example_model as jax_example

from _torch_parity import random_bn_tables, to_port
from pgmpy_tpu_torch.models import DiscreteBayesianNetwork
from pgmpy_tpu_torch.factors import TabularCPD
from pgmpy_tpu_torch.ops import ancestral
from pgmpy_tpu_torch.sampling import CompiledAncestralSampler
from pgmpy_tpu_torch.utils.interop import bn_from_numpy
from pgmpy_tpu_torch.utils.mathext import seeded_generator

N = 300


@pytest.fixture(scope="module", params=["random", "alarm"])
def sampler(request):
    if request.param == "alarm":
        return CompiledAncestralSampler(to_port(jax_example("alarm")))
    names, edges, tuples = random_bn_tables(7, n_nodes=10)
    return CompiledAncestralSampler(bn_from_numpy(edges, tuples, nodes=names))


def _case(sampler, kind, seed):
    """(given, partial, evidence) of one call: a plain draw, clamps, partial
    codes, or evidence."""
    d = len(sampler.variables)
    rng = np.random.default_rng(seed)
    given, partial, evidence = None, None, None
    if kind == "clamp":
        given = np.full(d, -1)
        for i in rng.choice(d, 3, replace=False):
            given[i] = rng.integers(0, sampler.cards[i])
    elif kind == "partial":
        codes = np.stack([rng.integers(0, c, N) for c in sampler.cards], axis=1)
        codes[rng.random(codes.shape) < 0.7] = -1
        partial = torch.from_numpy(codes)
    elif kind == "evidence":
        evidence = {int(i): int(rng.integers(0, sampler.cards[i]))
                    for i in rng.choice(d, 3, replace=False)}
    return given, partial, evidence


def generator_noise(sweep, n, seed, given=None, evidence=None):
    """The uniforms the plain version draws from ``seeded_generator(seed)``,
    laid out as the explicit noise tensor: one row per node, drawn nodes
    only, in node order."""
    gen = seeded_generator(seed)
    noise = torch.zeros(len(sweep.cards), n, dtype=torch.float64)
    for i in range(len(sweep.cards)):
        if (given is not None and given[i] >= 0) or i in (evidence or {}):
            continue
        noise[i] = torch.rand(n, generator=gen, dtype=torch.float64)
    return noise


KINDS = ["draw", "clamp", "partial", "evidence"]


@pytest.mark.parametrize("kind", KINDS)
def test_explicit_noise_gives_the_generator_draw(sampler, kind):
    given, partial, evidence = _case(sampler, kind, 3)
    sweep = sampler._sweep_tables
    want = sampler._sweep(N, seeded_generator(11), given=given, partial=partial,
                          evidence=evidence)
    noise = generator_noise(sweep, N, 11, given, evidence)
    got = sampler._sweep(N, None, given=given, partial=partial, evidence=evidence, noise=noise)
    assert torch.equal(got[0], want[0]) and got[0].dtype == sampler._out_dtype
    if evidence:
        assert torch.equal(got[1], want[1])
    else:
        assert got[1] is None and want[1] is None


def emulated_sweep(sweep, n, modes, noise, partial=None):
    """The kernel's schedule and arithmetic in numpy, from what it is handed:
    level by level (none longer than its stage buffers), the level's node
    rows staged from the schedule-order table with the modes in schedule
    order, group by group, each node's parents read from columns drawn in
    an earlier level; the CDF rows read as pairs from each node's even
    offset and counted against the uniform; then the evidence's log
    probabilities added in node order.  Rows side by side."""
    h, width, groups = ancestral._NODE_HEADER, sweep.width, sweep.groups
    assert sweep.row_ints % 4 == 0 and sweep.row_ints >= h + 2 * width
    assert np.array_equal(sweep.sched_nodes, sweep.nodes[sweep.schedule])
    tables = torch.cat([t.reshape(-1) for _, _, t in sweep.node_specs]).numpy()
    cdf = sweep.cdf
    assert cdf.dtype == np.float64 and (sweep.cdf_offsets % 2 == 0).all()
    mode_sched, evidence_at = ancestral.call_modes(sweep, np.asarray(modes))
    noise = noise.numpy()
    codes = np.full((n, len(sweep.cards)), -1, dtype=np.int64)  # by column
    lw = np.zeros(n, dtype=tables.dtype)

    def flat_of(nd):
        flat = np.zeros(n, dtype=np.int64)
        for j in range(nd[3]):
            parent = codes[:, nd[h + j]]
            assert (parent >= 0).all(), "a parent read before its level"
            flat += parent * nd[h + width + j]
        return flat

    for lv in range(sweep.n_levels):
        first, last = sweep.starts[lv * groups], sweep.starts[(lv + 1) * groups]
        assert last - first <= sweep.stage_nodes
        staged, staged_modes = sweep.sched_nodes[first:last].copy(), mode_sched[first:last]
        drawn = {}
        for g in range(groups):
            for x in range(sweep.starts[lv * groups + g], sweep.starts[lv * groups + g + 1]):
                nd, m = staged[x - first], staged_modes[x - first]
                card, _, offset, _, col, i = nd[:h]
                if m >= 0 or m <= -2:
                    drawn[col] = np.full(n, m if m >= 0 else -2 - m)
                    continue
                pairs = (card + 1) // 2
                row = cdf[offset + flat_of(nd)[:, None] * 2 * pairs + np.arange(2 * pairs)]
                draw = (row <= noise[i][:, None]).sum(axis=1)
                if partial is not None:
                    draw = np.where(partial[:, i] >= 0, partial[:, i], draw)
                drawn[col] = draw
        for col, draw in drawn.items():  # the level's barrier
            codes[:, col] = draw
    for x in evidence_at:
        nd = sweep.sched_nodes[x]
        logits = tables[nd[1] + flat_of(nd)[:, None] * nd[0] + np.arange(nd[0])]  # (n, card)
        lw = lw + logits[np.arange(n), -2 - mode_sched[x]]
    return codes, lw


@pytest.mark.parametrize("stage_bytes", [ancestral.STAGE_BYTES, 160])
@pytest.mark.parametrize("kind", KINDS)
def test_node_table_computes_the_plain_sweep(sampler, kind, stage_bytes, monkeypatch):
    """The walk against the plain version; with stage buffers of 160 bytes
    (one or two node rows) every level is cut into levels of that many."""
    given, partial, evidence = _case(sampler, kind, 5)
    monkeypatch.setattr(ancestral, "STAGE_BYTES", stage_bytes)
    sweep = ancestral.SweepTables(sampler._node_specs, sampler.cards, sampler._out_dtype)
    assert sweep.stage_nodes <= max(1, stage_bytes // (8 * (sweep.row_ints + 1)))
    dtype = sweep.node_specs[0][2].dtype
    noise = torch.rand((len(sweep.cards), N), generator=seeded_generator(2), dtype=torch.float64)
    codes, logw = ancestral.sweep_reference(sweep, N, None, given=given, partial=partial,
                                            evidence=evidence, noise=noise)
    want_codes, want_lw = emulated_sweep(sweep, N, sweep.modes(given, evidence), noise,
                                         None if partial is None else partial.numpy())
    np.testing.assert_array_equal(codes.long().numpy(), want_codes)
    if evidence:
        assert logw.dtype == dtype
        np.testing.assert_array_equal(logw.numpy(), want_lw)


def test_node_table_and_modes():
    model = DiscreteBayesianNetwork([("a", "c"), ("b", "c")])
    model.add_cpds(TabularCPD("a", 2, [[0.3], [0.7]]), TabularCPD("b", 3, [[0.2], [0.3], [0.5]]),
                   TabularCPD("c", 2, np.full((2, 6), 0.5), evidence=["a", "b"],
                              evidence_card=[2, 3]))
    sampler = CompiledAncestralSampler(model)
    sweep = sampler._sweep_tables
    order = sampler.variables
    assert order.index("c") == 2
    a, b = order.index("a"), order.index("b")
    assert sweep.width == 2 and sweep.total == 2 + 3 + 12
    # card, log table offset, CDF offset (the rows of 2 and 3 states padded
    # to 2 and 4 entries), parents, column, node, parents, strides, padding
    np.testing.assert_array_equal(sweep.nodes[2], [2, 5, 6, 2, 2, 2, a, b, 3 if a < b else 1,
                                                   1 if a < b else 2, 0, 0])
    np.testing.assert_array_equal(sweep.cdf_offsets, [0, sweep.cards[0] + sweep.cards[0] % 2, 6])
    np.testing.assert_array_equal(sweep.cdf[6:].reshape(6, 2)[:, 0], 0.5)
    np.testing.assert_array_equal(sweep.cdf[6:].reshape(6, 2)[:, 1], 1.0)
    # a clamp wins over evidence on the same node; evidence is -2 - state
    assert sweep.modes([1, -1, -1], {0: 0, 2: 1}).tolist() == [1, -1, -3]
    assert sweep.modes().tolist() == [-1, -1, -1]
    with pytest.raises(ValueError, match="outside"):
        sweep.modes([-1, -1, 2])
    with pytest.raises(ValueError, match="outside"):
        sweep.modes(evidence={0: 5})


def test_level_schedule(sampler):
    sweep = sampler._sweep_tables
    groups = sweep.groups
    assert groups == ancestral.sweep_groups(len(sweep.cards), sweep.n_levels, ancestral.GROUPS)
    assert sweep.starts.shape == (sweep.n_levels * groups + 1,) and sweep.starts[0] == 0
    assert sorted(sweep.schedule.tolist()) == list(range(len(sweep.cards)))  # each node once
    level = {}
    for lv in range(sweep.n_levels):
        loads = []
        for g in range(groups):
            part = sweep.schedule[sweep.starts[lv * groups + g]: sweep.starts[lv * groups + g + 1]]
            assert list(part) == sorted(part)
            level.update({int(i): lv for i in part})
            loads.append(sum(ancestral.draw_cost(sweep.cards[i]) for i in part))
        # dealt by cost: no group holds more than the lightest one plus one node
        assert max(loads) - min(loads) <= max(ancestral.draw_cost(c) for c in sweep.cards)
    for i, (parents, _, _) in enumerate(sampler._node_specs):
        assert all(level[p] < level[i] for p in parents)
        assert not parents or level[i] == 1 + max(level[p] for p in parents)


def test_level_schedule_of_a_chain_and_a_star():
    schedule, starts, n_levels = ancestral.level_schedule([(), (0,), (1,)], [2, 3, 2], 2)
    assert n_levels == 3 and schedule.tolist() == [0, 1, 2] and starts.tolist() == [0, 1, 1, 2, 2, 3, 3]
    schedule, starts, n_levels = ancestral.level_schedule([(), (0,), (0,), (0,)], [2, 5, 2, 2], 2)
    assert n_levels == 2 and schedule.tolist() == [0, 1, 2, 3] and starts.tolist() == [0, 1, 1, 2, 4]


@pytest.mark.parametrize("d,code_bytes,groups,n,extra,want", [
    # MUNIN: 1041 int8 codes a row, padded to 261 words; 32 rows (33 KB, 256
    # threads) put 160 rows on a multiprocessor (5 blocks by registers), 64
    # rows 128: three rounds of 21,120 rows for 52,048, where 64 take four
    (1041, 1, 8, 52_048, 0, (32, 1044, 32 * 1044)),
    (1041, 1, 8, None, 0, (32, 1044, 32 * 1044)),
    # with MUNIN's two stage buffers of 78 node rows (8,112 bytes)
    (1041, 1, 8, 52_048, 8112, (32, 1044, 32 * 1044 + 8112)),
    # 128 states or more: int32 codes, 1041 words is odd already; 32 rows
    # (130 KB, one block a multiprocessor) take 13 rounds, 11 rows (four
    # blocks within 48 KB) 9
    (1041, 4, 8, 52_048, 0, (11, 1041, 45_808)),
    # ALARM's slice: 32 rows x 4 groups, 10 blocks a multiprocessor (by
    # registers), as many rows as 64-row blocks and a finer last round
    (37, 1, 4, 262_144, 1632, (32, 44, 32 * 44 + 1632)),
    # a tiny network: 64 rows of one group, 21 blocks a multiprocessor
    (1, 1, 1, 10, 0, (64, 4, 256)),
])
def test_tile_plans(d, code_bytes, groups, n, extra, want):
    rows, stride, shared = ancestral.plan_tile(d, code_bytes, groups, n, extra=extra)
    assert (rows, stride, shared) == want
    row_bytes = stride * code_bytes
    assert shared % 16 == extra % 16 and shared <= ancestral.SHARED_LIMIT
    assert rows * groups <= 1024 and shared == ancestral.tile_bytes(rows, row_bytes) + extra
    per_sm = ancestral.resident_blocks(shared, rows * groups)
    assert per_sm * (shared + ancestral.BLOCK_RESERVED) <= ancestral.SM_SHARED
    assert per_sm * rows * groups <= ancestral.SM_THREADS
    assert per_sm * -(-rows * groups // 32) * 32 * ancestral.REGISTERS <= ancestral.SM_REGISTERS
    if n:  # no candidate runs the rows in fewer rounds
        rounds = -(-(-(-n // rows)) // (per_sm * ancestral.SMS))
        for other in range(32, min(ancestral.MAX_TILE_ROWS, 1024 // groups) + 1, 32):
            other_shared = ancestral.tile_bytes(other, row_bytes) + extra
            if other_shared <= ancestral.SHARED_LIMIT:
                k = ancestral.resident_blocks(other_shared, other * groups)
                assert -(-(-(-n // other)) // (k * ancestral.SMS)) >= rounds
    with pytest.raises(ValueError, match="shared memory"):
        ancestral.plan_tile(20_000, 4)


@pytest.mark.parametrize("probs", [
    [0.0, 0.5, 0.0, 0.5, 0.0], [0.2, 0.3, 0.5], [0.0, 0.0, 1.0], [1.0], [0.0, 0.0, 0.0],
    [1e-30, 1.0 - 1e-30], [0.25, 0.0, 0.75, 0.0]])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cdf_rows_never_pick_a_state_without_mass(probs, dtype):
    """The CDF row of a probability row (zeros at the sampler's log clamp):
    every uniform in [0, 1), the extremes included, draws a state of mass;
    a row without mass draws uniformly, as a race over equal logits."""
    p = np.asarray(probs)
    logs = torch.as_tensor(np.log(np.maximum(p, 1e-38)), dtype=dtype)[None, :]
    row = ancestral.cdf_rows(logs).reshape(-1)
    card = len(probs)
    assert row.shape == (card + card % 2,) and (row[card:] == ancestral.CDF_PAD).all()
    assert (np.diff(row[:card]) >= 0).all()
    mass = p > 0 if p.sum() > 0 else np.ones(card, bool)
    assert row[np.flatnonzero(mass)[-1]] == 1.0
    u = np.concatenate([[0.0, np.nextafter(1.0, 0.0)], np.random.default_rng(0).random(4000)])
    draws = (row[None, :] <= u[:, None]).sum(axis=1)
    assert mass[draws].all()
    want = p / p.sum() if p.sum() > 0 else np.full(card, 1 / card)
    got = np.bincount(draws[2:], minlength=card) / 4000
    assert np.abs(got - want).max() < 5 * np.sqrt(0.25 / 4000) + 1e-3


def test_the_cuda_route_refuses(sampler):
    sweep = sampler._sweep_tables
    with pytest.raises(ValueError, match="CUDA"):
        ancestral.sweep_cuda(sweep, 4, None)
    with pytest.raises(ValueError, match="int32 index"):
        ancestral.sweep_cuda(type("Huge", (), {"total": 2**31})(), 4, None)
    with pytest.raises(ValueError, match="noise"):
        ancestral.sweep_reference(sweep, 4, None, noise=torch.zeros(3, 4, dtype=torch.float64))
    with pytest.raises(TypeError, match="noise"):
        ancestral.sweep_reference(sweep, 4, None,
                                  noise=torch.zeros(len(sweep.cards), 4, dtype=torch.float32))
