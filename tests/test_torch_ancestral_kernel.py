"""The ancestral sweep (K5) on the CPU, and what a CPU test can see of its
CUDA route (``csrc/ancestral.cu``): the node table, per-call modes and tile
plan the wrapper hands the kernel, emulated in numpy against the plain
version on the same explicit noise.

Every comparison here is to the bit: the explicit noise is the noise the
plain version draws from its generator, and the emulation subtracts,
compares and adds in the tables' type in the kernel's order.  The sweep's
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
from pgmpy_tpu_torch.utils.mathext import race_noise, seeded_generator

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
    """The race noise the plain version draws from ``seeded_generator(seed)``,
    laid out as the explicit noise tensor: node by node, drawn nodes only."""
    gen = seeded_generator(seed)
    dtype = sweep.node_specs[0][2].dtype
    noise = torch.zeros(sum(sweep.cards), n, dtype=dtype)
    for i, card in enumerate(sweep.cards):
        if (given is not None and given[i] >= 0) or i in (evidence or {}):
            continue
        first = int(sweep.noise_offsets[i])
        noise[first: first + card] = race_noise((n, card), gen, dtype).t()
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
    """The kernel's arithmetic in numpy from the node table, the modes and the
    flat log tables it is handed; rows side by side, nodes in order."""
    nodes = sweep.nodes
    width = (nodes.shape[1] - 4) // 2
    tables = torch.cat([t.reshape(-1) for _, _, t in sweep.node_specs]).numpy()
    noise = noise.numpy()
    codes = np.zeros((n, len(nodes)), dtype=np.int64)
    lw = np.zeros(n, dtype=tables.dtype)
    rows = np.arange(n)
    for i, (card, offset, first, n_parents) in enumerate(nodes[:, :4]):
        mode = modes[i]
        if mode >= 0:
            codes[:, i] = mode
            continue
        flat = np.zeros(n, dtype=np.int64)
        for j in range(n_parents):
            flat += codes[:, nodes[i, 4 + j]] * nodes[i, 4 + width + j]
        logits = tables[offset + flat[:, None] * card + np.arange(card)]  # (n, card)
        if mode <= -2:
            lw = lw + logits[rows, -2 - mode]
            codes[:, i] = -2 - mode
            continue
        draw = np.argmax(logits - noise[first: first + card].T, axis=1)
        if partial is not None:
            draw = np.where(partial[:, i] >= 0, partial[:, i], draw)
        codes[:, i] = draw
    return codes, lw


@pytest.mark.parametrize("kind", KINDS)
def test_node_table_computes_the_plain_sweep(sampler, kind):
    given, partial, evidence = _case(sampler, kind, 5)
    sweep = sampler._sweep_tables
    dtype = sweep.node_specs[0][2].dtype
    noise = race_noise((sum(sweep.cards), N), seeded_generator(2), dtype)
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
    np.testing.assert_array_equal(sweep.nodes[2], [2, 5, 5, 2, a, b, 3 if a < b else 1,
                                                   1 if a < b else 2])
    np.testing.assert_array_equal(sweep.noise_offsets, [0, sweep.cards[0], 5])
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
            loads.append(sum(sweep.cards[i] for i in part))
        # dealt by states: no group holds more than the lightest one plus one node
        assert max(loads) - min(loads) <= max(sweep.cards)
    for i, (parents, _, _) in enumerate(sampler._node_specs):
        assert all(level[p] < level[i] for p in parents)
        assert not parents or level[i] == 1 + max(level[p] for p in parents)


def test_level_schedule_of_a_chain_and_a_star():
    schedule, starts, n_levels = ancestral.level_schedule([(), (0,), (1,)], [2, 3, 2], 2)
    assert n_levels == 3 and schedule.tolist() == [0, 1, 2] and starts.tolist() == [0, 1, 1, 2, 2, 3, 3]
    schedule, starts, n_levels = ancestral.level_schedule([(), (0,), (0,), (0,)], [2, 5, 2, 2], 2)
    assert n_levels == 2 and schedule.tolist() == [0, 1, 2, 3] and starts.tolist() == [0, 1, 1, 2, 4]


def test_tile_plans():
    # MUNIN: 1041 int8 codes a row, padded to 261 words; 32 rows, 33 KB
    assert ancestral.plan_tile(1041, 1) == (32, 1044, 32 * 1044)
    # 128 states or more: int32 codes, 1041 words is odd already
    assert ancestral.plan_tile(1041, 4) == (11, 1041, 11 * 4164)
    assert ancestral.plan_tile(37, 1) == (128, 44, 128 * 44)
    assert ancestral.plan_tile(1, 1) == (128, 4, 512)
    with pytest.raises(ValueError, match="shared memory"):
        ancestral.plan_tile(20_000, 4)


def test_the_cuda_route_refuses(sampler):
    sweep = sampler._sweep_tables
    with pytest.raises(ValueError, match="CUDA"):
        ancestral.sweep_cuda(sweep, 4, None)
    with pytest.raises(ValueError, match="int32 index"):
        ancestral.sweep_cuda(type("Huge", (), {"total": 2**31})(), 4, None)
    with pytest.raises(ValueError, match="noise"):
        ancestral.sweep_reference(sweep, 4, None, noise=torch.zeros(3, 4, dtype=torch.float32))
