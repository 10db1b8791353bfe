"""The Gibbs sweep (K6) on the CPU, and what a CPU test can see of its CUDA
route (``csrc/gibbs.cu``): the CSR tables, the level schedule and the tile
plan the wrapper hands the kernel, walked in numpy against the plain version.

Every comparison of codes is to the bit: the explicit noise is the noise the
plain version draws from its generator, and the numpy walks sum in the
tables' type in factor order, as the kernel and the plain version do.  The
logits are held to ``pgmpy_tpu``'s ``CompiledGibbs._conditional_logits`` at
rtol 1e-5 (float32 sums of a few log entries).  The chains' distribution and
the resume stay in ``tests/test_torch_gibbs.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgmpy_tpu.factors import DiscreteFactor as JaxFactor
from pgmpy_tpu.models import DiscreteMarkovNetwork as JaxMarkovNetwork
from pgmpy_tpu.sampling.gibbs import GibbsSampling as JaxGibbs
from pgmpy_tpu.utils import get_example_model as jax_example

from _torch_parity import np_values, random_bn_pair, to_port
from pgmpy_tpu_torch.factors import DiscreteFactor
from pgmpy_tpu_torch.models import DiscreteMarkovNetwork
from pgmpy_tpu_torch.ops import gibbs as gibbs_ops
from pgmpy_tpu_torch.sampling import GibbsSampling
from pgmpy_tpu_torch.utils import get_example_model
from pgmpy_tpu_torch.utils.interop import markov_network_from_numpy
from pgmpy_tpu_torch.utils.mathext import race_noise, seeded_generator

N = 200


def random_markov_tables(seed, n_vars=7, n_factors=8):
    """(scopes, cards, tables) of a random Markov network: factors over 1-3
    variables, every variable in at least one."""
    rng = np.random.default_rng(seed)
    names = [f"V{i}" for i in range(n_vars)]
    cards = {v: int(rng.integers(2, 5)) for v in names}
    scopes = [[v] for v in names[:2]]
    scopes += [list(rng.choice(names, int(rng.integers(2, 4)), replace=False))
               for _ in range(n_factors - 2)]
    covered = {v for scope in scopes for v in scope}
    scopes += [[v, names[0]] for v in names if v not in covered]
    tables = [rng.random([cards[v] for v in scope]) + 0.05 for scope in scopes]
    return scopes, cards, tables


def markov_pair(seed):
    scopes, cards, tables = random_markov_tables(seed)
    port = markov_network_from_numpy(scopes, cards, tables)
    ref = JaxMarkovNetwork()
    ref.add_nodes_from(list(dict.fromkeys(v for scope in scopes for v in scope)))
    ref.add_edges_from((a, b) for scope in scopes for i, a in enumerate(scope)
                       for b in scope[i + 1:])
    ref.add_factors(*[JaxFactor(list(scope), [cards[v] for v in scope], table)
                      for scope, table in zip(scopes, tables)])
    return port, ref


CASES = ["bn0", "bn1", "bn2", "markov0", "markov1", "alarm"]


def case_pair(name):
    if name.startswith("bn"):
        return random_bn_pair(90 + int(name[2:]), n_nodes=9)
    if name.startswith("markov"):
        return markov_pair(int(name[6:]))
    ref = jax_example("alarm")
    return to_port(ref), ref


@pytest.fixture(scope="module", params=CASES)
def pair(request):
    port, ref = case_pair(request.param)
    return GibbsSampling(port), ref


def random_codes(gibbs, n, seed):
    return torch.as_tensor(gibbs.random_state(n, seed), dtype=torch.int64)


def piece_sums(tables, flat, states, i, first, count):
    """The sums of factors ``first .. first + count - 1`` of variable ``i``
    from the padded flat tables in numpy, as the kernel reads them: per
    factor a row from the others' codes, summed from zero in the tables'
    type in factor order.  ``states``: (n, d) host codes."""
    card = tables.cards[i]
    width = -(-card // gibbs_ops.ROW_ALIGN) * gibbs_ops.ROW_ALIGN
    total = np.zeros((states.shape[0], card), dtype=flat.dtype)
    for offset, n_others, o0 in tables.specs[first: first + count]:
        row = np.zeros(states.shape[0], dtype=np.int64)
        for column, stride in tables.others[o0: o0 + n_others]:
            row += states[:, column].astype(np.int64) * stride
        total = total + flat[offset + row[:, None] * width + np.arange(card)]
    return total


def walk_logits(tables, states, i):
    """Variable ``i``'s logits from the CSR tables in numpy: its pieces'
    sums (``ops.gibbs.piece_cuts``) added in piece order."""
    flat = tables.flat_tables(torch.device("cpu")).numpy()
    first, total = int(tables.vars[i, 2]), None
    for size in gibbs_ops.piece_cuts(tables.vars[i, 3]):
        part = piece_sums(tables, flat, states, i, first, size)
        total = part if total is None else total + part
        first += size
    return total


def test_csr_tables_walked_in_numpy_give_the_conditional_logits(pair):
    gibbs, _ = pair
    compiled = gibbs._compiled
    codes = random_codes(gibbs, N, 1)
    states = codes.T.contiguous()
    for i in range(len(compiled.cards)):
        want = compiled._conditional_logits(states, i).numpy()
        np.testing.assert_array_equal(walk_logits(compiled._tables, codes.numpy(), i), want)


def test_logits_match_the_jax_package(pair):
    gibbs, ref = pair
    jax_gibbs = JaxGibbs(ref)
    assert jax_gibbs.variables == gibbs.variables
    codes = random_codes(gibbs, 64, 2)
    tables = gibbs._compiled._tables
    states = codes.T.contiguous()
    for i in range(len(tables.cards)):
        got = np_values(gibbs_ops.conditional_logits(tables.var_specs, tables.cards, states, i))
        want = np_values(jax_gibbs._compiled._conditional_logits(jnp.asarray(codes.numpy()), i))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def blanket(tables, i):
    card, _, k0, count = tables.vars[i]
    return {int(c) for _, n_others, o0 in tables.specs[k0: k0 + count]
            for c in tables.others[o0: o0 + n_others, 0]}


def assert_schedule(tables):
    d = len(tables.cards)
    level = tables.levels
    for i in range(d):
        for j in blanket(tables, i):
            assert level[i] != level[j], (i, j)  # no two neighbours in one level
            assert (level[j] < level[i]) == (j < i), (i, j)  # earlier neighbours in earlier levels
        earlier = [level[j] for j in blanket(tables, i) if j < i]
        assert level[i] == 1 + max(earlier, default=-1)
    groups = tables.groups
    for schedule, starts, items in ((tables.schedule_a, tables.starts_a, tables.pieces),
                                    (tables.schedule_b, tables.starts_b, tables.combines)):
        assert starts.shape == (tables.n_levels * groups + 1,) and starts[0] == 0
        assert sorted(schedule.tolist()) == list(range(len(items)))  # each piece once
        for lv in range(tables.n_levels):
            part = schedule[starts[lv * groups]: starts[(lv + 1) * groups]]
            assert (level[items[part, 0]] == lv).all()
    # every variable's factors once, in pieces of piece_cuts, in order
    for i in range(d):
        own = tables.pieces[tables.pieces[:, 0] == i]
        cuts = gibbs_ops.piece_cuts(tables.vars[i, 3])
        assert own[:, 2].tolist() == cuts
        assert own[:, 1].tolist() == (tables.vars[i, 2] + np.cumsum([0] + cuts[:-1])).tolist()
        comb = tables.combines[tables.combines[:, 0] == i]
        if len(cuts) == 1:
            assert own[0, 3] == -1 and len(comb) == 0
        else:  # each piece's sums in its own slots, the combine reading them in order
            assert comb.tolist() == [[i, own[0, 3], len(cuts)]]
            assert own[:, 3].tolist() == [own[0, 3] + p * tables.cards[i] for p in range(len(cuts))]
            assert own[-1, 3] + tables.cards[i] <= tables.slots


def test_level_schedule(pair):
    assert_schedule(pair[0]._compiled._tables)


def test_alarm_has_eleven_levels():
    tables = GibbsSampling(to_port(jax_example("alarm")))._compiled._tables
    # 37 variables in 11 levels: 4 groups, the nodes of an average level
    assert tables.n_levels == 11 and tables.groups == 4


def test_levels_of_a_chain_and_a_star():
    chain = markov_network_from_numpy([["a", "b"], ["b", "c"], ["c", "d"]],
                                      {v: 2 for v in "abcd"}, [np.ones((2, 2))] * 3)
    tables = GibbsSampling(chain)._compiled._tables
    assert tables.levels.tolist() == [0, 1, 2, 3] and tables.groups == 1
    # the hub first: every leaf waits for it, and no two leaves touch
    hub_first = markov_network_from_numpy([["h", x] for x in "pqrs"],
                                          {v: 2 for v in "hpqrs"}, [np.ones((2, 2))] * 4)
    tables = GibbsSampling(hub_first)._compiled._tables
    assert tables.levels.tolist() == [0, 1, 1, 1, 1] and tables.groups == 3
    assert tables.schedule_a.tolist() == [0, 1, 4, 2, 3]
    assert tables.starts_a.tolist() == [0, 1, 1, 1, 3, 4, 5]
    assert tables.schedule_b.tolist() == [] and tables.starts_b.tolist() == [0] * 7
    # the hub last: the leaves go together, the hub after them
    hub_last = DiscreteMarkovNetwork()
    hub_last.add_nodes_from(list("pqrsh"))
    hub_last.add_edges_from((x, "h") for x in "pqrs")
    hub_last.add_factors(*[DiscreteFactor([x, "h"], [2, 2], np.ones((2, 2))) for x in "pqrs"])
    gibbs = GibbsSampling(hub_last)
    assert gibbs.variables == list("pqrsh")
    assert gibbs._compiled._tables.levels.tolist() == [0, 0, 0, 0, 1]
    assert_schedule(gibbs._compiled._tables)


def test_csr_layout():
    port, _ = markov_pair(3)
    tables = GibbsSampling(port)._compiled._tables
    var_specs = tables.var_specs
    assert tables.vars.dtype == np.int32 and tables.vars.shape == (len(var_specs), 4)
    assert tables.vars[:, 0].tolist() == tables.cards
    np.testing.assert_array_equal(tables.vars[:, 1], tables.noise_offsets)
    assert tables.vars[:, 3].tolist() == [len(s) for s in var_specs]
    assert tables.specs.shape == (sum(len(s) for s in var_specs), 3)
    assert tables.total == sum(int(t.numel()) for s in var_specs for t, _, _ in s)
    flat = tables.flat_tables(torch.device("cpu"))
    assert flat.numel() == tables.padded_total and tables.padded_total % 4 == 0
    k, end = 0, 0
    for i, specs in enumerate(var_specs):
        assert tables.vars[i, 2] == k
        for table, others, strides in specs:
            offset, n_others, o0 = tables.specs[k]
            assert n_others == len(others)
            assert tables.others[o0: o0 + n_others].tolist() == [list(p) for p in
                                                                   zip(others, strides)]
            assert table.shape[1] == tables.cards[i]
            # the padded layout: rows of a multiple of 4 entries, zeros past the
            # card, every table from a multiple of 8 entries (32 bytes in float)
            rows, width = table.shape[0], -(-tables.cards[i] // 4) * 4
            assert offset == end and offset % 8 == 0
            padded = flat[offset: offset + rows * width].view(rows, width)
            assert torch.equal(padded[:, :tables.cards[i]], table)
            assert not padded[:, tables.cards[i]:].any()
            end = -(-(offset + rows * width) // 8) * 8
            assert not flat[offset + rows * width: end].any()
            k += 1
    assert end == tables.padded_total


def kernel_walk(tables, codes, noise, sms=132):
    """The kernel's sweep in numpy, float in the tables' type: the grid of
    ``plan_launch`` (block b's chains; every chain in one block), and in each
    block, level by level, first every group's pieces in schedule order
    (each sums its factors' rows of the padded flat tables from zero, and
    draws where it is the whole variable, else writes its sums to the
    block's scratch slots), then every group's combines (the pieces' sums
    added in piece order, and the draw).  The threads of a level run side
    by side; a level reads no code that it writes."""
    flat = tables.flat_tables(torch.device("cpu")).numpy()
    states = codes.numpy().astype(np.int64).copy()
    noise = noise.numpy()
    n, d = states.shape
    code_bytes = torch.empty((), dtype=tables.out_dtype).element_size()
    blocks, rows, _, _ = gibbs_ops.plan_launch(n, d, code_bytes, tables.groups, sms,
                                               tables.slots, flat.itemsize)
    q, rem = divmod(n, blocks)
    seen = np.zeros(n, dtype=np.int64)
    groups = tables.groups

    def draw(i, st, chains, logits):
        first, card = tables.noise_offsets[i], tables.cards[i]
        st[:, i] = np.argmax(logits - noise[first: first + card][:, chains].T, axis=1)

    for b in range(blocks):
        row0, count = b * q + min(b, rem), q + (b < rem)
        assert count <= rows
        chains = np.arange(row0, row0 + count)
        seen[chains] += 1
        st = states[chains]
        scratch = np.zeros((tables.slots, count), dtype=flat.dtype)
        for lv in range(tables.n_levels):
            for x in tables.schedule_a[tables.starts_a[lv * groups]:
                                       tables.starts_a[(lv + 1) * groups]]:
                i, first, size, slot = tables.pieces[x]
                sums = piece_sums(tables, flat, st, i, first, size)
                if slot < 0:
                    draw(i, st, chains, sums)
                else:
                    scratch[slot: slot + tables.cards[i]] = sums.T
            for x in tables.schedule_b[tables.starts_b[lv * groups]:
                                       tables.starts_b[(lv + 1) * groups]]:
                i, slot, n_pieces = tables.combines[x]
                card = tables.cards[i]
                total = scratch[slot: slot + card].T
                for p in range(1, n_pieces):
                    total = total + scratch[slot + p * card: slot + (p + 1) * card].T
                draw(i, st, chains, total)
        states[chains] = st
    assert (seen == 1).all()
    return states


def test_level_walk_equals_the_sequential_sweep(pair):
    gibbs, _ = pair
    tables = gibbs._compiled._tables
    codes = random_codes(gibbs, N, 3)
    dtype = tables.var_specs[0][0][0].dtype
    noise = race_noise((sum(tables.cards), N), seeded_generator(4), dtype)
    got = gibbs_ops.sweep_reference(tables, codes, None, noise=noise)
    assert got.dtype == gibbs._compiled._out_dtype and got.shape == codes.shape
    np.testing.assert_array_equal(got.long().numpy(), kernel_walk(tables, codes, noise))


def generator_noise(tables, n, seed):
    """The race noise the plain version draws from ``seeded_generator(seed)``,
    laid out as the explicit noise tensor: variable by variable."""
    gen = seeded_generator(seed)
    dtype = tables.var_specs[0][0][0].dtype
    noise = torch.zeros(sum(tables.cards), n, dtype=dtype)
    for i, card in enumerate(tables.cards):
        first = int(tables.noise_offsets[i])
        noise[first: first + card] = race_noise((n, card), gen, dtype).t()
    return noise


def test_explicit_noise_gives_the_generator_draw(pair):
    gibbs, _ = pair
    tables = gibbs._compiled._tables
    codes = random_codes(gibbs, N, 5)
    want = gibbs._compiled._sweep(codes, seeded_generator(6))
    got = gibbs._compiled._sweep(codes, None, noise=generator_noise(tables, N, 6))
    assert torch.equal(got, want)


def test_run_chains_is_one_sweep_after_another():
    port, _ = random_bn_pair(95, n_nodes=7)
    compiled = GibbsSampling(port)._compiled
    init = GibbsSampling(port).random_state(40, 0)
    traj = compiled._run_chains(seeded_generator(7), 3, init)
    gen, codes = seeded_generator(7), torch.as_tensor(init)
    for t in range(3):
        codes = gibbs_ops.sweep_reference(compiled._tables, codes, gen)
        assert torch.equal(traj[t], codes)
    # in place: out may be the input
    codes = torch.as_tensor(init).to(compiled._out_dtype)
    again = gibbs_ops.sweep_reference(compiled._tables, codes, seeded_generator(7), out=codes)
    assert again.data_ptr() == codes.data_ptr() and torch.equal(again, traj[0])


def test_a_variable_in_no_factor_is_drawn_uniform():
    table = torch.log(torch.tensor([[0.9, 0.1], [0.2, 0.8]]))
    var_specs = [[(table, (1,), (1,))], [(table.T.contiguous(), (0,), (1,))], []]
    tables = gibbs_ops.GibbsTables(var_specs, [2, 2, 3], torch.int8)
    assert tables.vars[2].tolist() == [3, 4, 2, 0]
    assert tables.levels.tolist() == [0, 1, 0]
    codes = torch.zeros((30_000, 3), dtype=torch.int8)
    out = gibbs_ops.sweep_reference(tables, codes, seeded_generator(0))
    freq = np.bincount(out[:, 2].long().numpy(), minlength=3) / 30_000
    assert np.abs(freq - 1 / 3).max() <= 5 * np.sqrt(2 / 9 / 30_000)
    noise = race_noise((7, 30_000), seeded_generator(1), torch.float32)
    np.testing.assert_array_equal(
        gibbs_ops.sweep_reference(tables, codes, None, noise=noise).long().numpy(),
        kernel_walk(tables, codes, noise))


def test_tile_plans():
    """(blocks, rows, stride, tile bytes): at least one block per
    multiprocessor where there are as many chains, at most what the shared
    budget, 1024 threads and MAX_TILE_ROWS allow."""
    # MUNIN: 1041 int8 codes a chain, padded to 261 words, 85 scratch sums
    assert gibbs_ops.plan_launch(4096, 1041, 1, 32, 132, 85, 4) == (132, 32, 1044, 44288)
    assert gibbs_ops.plan_launch(10_000, 1041, 1, 32, 132, 85, 4) == (313, 32, 1044, 44288)
    assert gibbs_ops.plan_launch(4096, 1041, 4, 32, 132, 85, 4) == (410, 10, 1041, 45056)
    # HEPAR2: 70 codes a chain, 9 scratch sums
    assert gibbs_ops.plan_launch(10_000, 70, 1, 6, 132, 9, 4) == (132, 76, 76, 8512)
    assert gibbs_ops.plan_launch(2500, 70, 1, 6, 132, 9, 4) == (132, 19, 76, 2144)
    assert gibbs_ops.plan_launch(100_000, 70, 1, 6, 132, 9, 8) == (782, 128, 76, 18944)
    assert gibbs_ops.plan_launch(4096, 37, 1, 4, 132, 0, 4) == (132, 32, 44, 1408)  # ALARM
    assert gibbs_ops.plan_launch(5, 37, 1, 4, 132, 0, 4) == (5, 1, 44, 48)
    with pytest.raises(ValueError, match="shared memory"):
        gibbs_ops.plan_launch(20_000, 20_000, 4, 8, 132, 0, 4)


@pytest.mark.parametrize("name", ["munin", "hepar2"])
def test_the_grid_covers_every_multiprocessor(name):
    """The paths' shapes (MUNIN's 4,096 chains; HEPAR2's 10,000 and a
    shard's 2,500) on the H100's 132 multiprocessors: every one holds a
    block, the chains dealt evenly, within 1024 threads and the shared
    budgets; HEPAR2's padded tables staged, MUNIN's not.  The pieces shorten
    the critical path (the sum over levels of the busiest group's load)
    against drawing whole variables with the same groups."""
    tables = GibbsSampling(get_example_model(name))._compiled._tables
    elem = 4
    for n in (2500, 4096, 10_000):
        blocks, rows, _, tile = gibbs_ops.plan_launch(n, len(tables.cards), 1, tables.groups,
                                                      132, tables.slots, elem)
        q, rem = divmod(n, blocks)
        assert blocks >= 132 and rows == q + (rem > 0) and rows * blocks >= n
        assert rows * tables.groups <= 1024 and tile <= gibbs_ops.SHARED_BUDGET
    staged = tables.padded_total * elem <= gibbs_ops.STAGE_BUDGET
    assert staged == (name == "hepar2")
    cards, counts = np.asarray(tables.cards), tables.vars[:, 3]
    whole = sum(gibbs_ops.deal(list(members), (cards[members] * (1 + counts[members])).tolist(),
                               tables.groups)[1]
                for members in (np.flatnonzero(tables.levels == lv)
                                for lv in range(tables.n_levels)))
    assert (whole, tables.critical_path) == {"munin": (1201, 845), "hepar2": (300, 223)}[name]


def star_model(n_leaves=20, seed=0):
    """A hub of 3 states drawn first and ``n_leaves`` binary leaves, one
    random positive factor each: the hub's 20 blanket factors cut into
    pieces of 7, 7 and 6."""
    rng = np.random.default_rng(seed)
    leaves = [f"x{k}" for k in range(n_leaves)]
    cards = {"h": 3, **{x: 2 for x in leaves}}
    return markov_network_from_numpy([["h", x] for x in leaves], cards,
                                     [rng.random((3, 2)) + 0.05 for _ in leaves])


def test_pieces_of_a_star():
    tables = GibbsSampling(star_model())._compiled._tables
    assert gibbs_ops.piece_cuts(20) == [7, 7, 6] and gibbs_ops.piece_cuts(8) == [8]
    assert gibbs_ops.piece_cuts(0) == [0] and gibbs_ops.piece_cuts(70) == [8] * 7 + [7] * 2
    assert tables.pieces[:3].tolist() == [[0, 0, 7, 0], [0, 7, 7, 3], [0, 14, 6, 6]]
    assert tables.combines.tolist() == [[0, 0, 3]] and tables.slots == 9
    assert_schedule(tables)
    # the plain version's association: the pieces' sums, then their sum
    codes = torch.as_tensor(GibbsSampling(star_model()).random_state(50, 1))
    states = codes.T.contiguous()
    got = gibbs_ops.conditional_logits(tables.var_specs, tables.cards, states, 0).numpy()
    np.testing.assert_array_equal(got, walk_logits(tables, codes.numpy(), 0))


@pytest.mark.parametrize("name, n", [("alarm", 500), ("alarm_markov", 500), ("hepar2", 700),
                                     ("star", 400)])
def test_kernel_walk_gives_the_plain_codes(name, n):
    """The numpy walk of the pieces, the schedule and the grid against the
    plain version, on explicit noise, to the bit."""
    model = star_model() if name == "star" else get_example_model(name.split("_")[0])
    if name == "alarm_markov":
        model = model.to_markov_model()
    gibbs = GibbsSampling(model)
    tables = gibbs._compiled._tables
    assert (len(tables.combines) > 0) == (name in ("hepar2", "star"))
    codes = random_codes(gibbs, n, 11)
    noise = race_noise((sum(tables.cards), n), seeded_generator(12), torch.float32)
    want = gibbs_ops.sweep_reference(tables, codes, None, noise=noise).long().numpy()
    np.testing.assert_array_equal(kernel_walk(tables, codes, noise), want)
    # another grid gives the same codes
    np.testing.assert_array_equal(kernel_walk(tables, codes, noise, sms=7), want)


def test_the_cuda_route_refuses(pair):
    gibbs, _ = pair
    tables = gibbs._compiled._tables
    codes = random_codes(gibbs, 4, 0)
    with pytest.raises(ValueError, match="CUDA"):
        gibbs_ops.sweep_cuda(tables, codes, None)
    with pytest.raises(ValueError, match="int32 index"):
        gibbs_ops.sweep_cuda(type("Huge", (), {"total": 2**31})(), codes, None)
    with pytest.raises(ValueError, match="noise"):
        gibbs_ops.sweep_reference(tables, codes, None, noise=torch.zeros(3, 4))
    with pytest.raises(ValueError, match="codes"):
        gibbs_ops.sweep_reference(tables, codes[:, :1], seeded_generator(0))


@pytest.mark.slow
@pytest.mark.parametrize("name,levels", [("munin", 16), ("hepar2", 13)])
def test_large_networks(name, levels):
    ref = jax_example(name)
    gibbs = GibbsSampling(to_port(ref))
    tables = gibbs._compiled._tables
    assert tables.n_levels == levels
    assert_schedule(tables)
    codes = random_codes(gibbs, 64, 8)
    by_factors = np.argsort(-tables.vars[:, 3], kind="stable")[:20]
    states = codes.T.contiguous()
    jax_gibbs = JaxGibbs(ref)._compiled
    for i in by_factors:
        want = gibbs._compiled._conditional_logits(states, int(i)).numpy()
        np.testing.assert_array_equal(walk_logits(tables, codes.numpy(), int(i)), want)
        np.testing.assert_allclose(
            want, np_values(jax_gibbs._conditional_logits(jnp.asarray(codes.numpy()), int(i))),
            rtol=1e-5, atol=1e-4)
    noise = race_noise((sum(tables.cards), 64), seeded_generator(9), torch.float32)
    np.testing.assert_array_equal(
        gibbs_ops.sweep_reference(tables, codes, None, noise=noise).long().numpy(),
        kernel_walk(tables, codes, noise))
