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


def walk_logits(tables, states, i):
    """Variable ``i``'s logits from the CSR tables in numpy, as the kernel
    reads them: per factor a row from the others' codes, summed from zero in
    the tables' type in factor order.  ``states``: (n, d) host codes."""
    flat = torch.cat([t.reshape(-1) for per_var in tables.var_specs
                      for t, _, _ in per_var]).numpy()
    card, _, k0, count = tables.vars[i]
    total = np.zeros((states.shape[0], card), dtype=flat.dtype)
    for offset, n_others, o0 in tables.specs[k0: k0 + count]:
        row = np.zeros(states.shape[0], dtype=np.int64)
        for column, stride in tables.others[o0: o0 + n_others]:
            row += states[:, column].astype(np.int64) * stride
        total = total + flat[offset + row[:, None] * card + np.arange(card)]
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
    assert tables.starts.shape == (tables.n_levels * groups + 1,) and tables.starts[0] == 0
    assert sorted(tables.schedule.tolist()) == list(range(d))  # each variable once
    for lv in range(tables.n_levels):
        part = tables.schedule[tables.starts[lv * groups]: tables.starts[(lv + 1) * groups]]
        assert (level[part] == lv).all()


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
    assert tables.schedule.tolist() == [0, 1, 4, 2, 3]
    assert tables.starts.tolist() == [0, 1, 1, 1, 3, 4, 5]
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
    k = 0
    for i, specs in enumerate(var_specs):
        assert tables.vars[i, 2] == k
        for table, others, strides in specs:
            offset, n_others, o0 = tables.specs[k]
            assert n_others == len(others)
            assert tables.others[o0: o0 + n_others].tolist() == [list(p) for p in
                                                                   zip(others, strides)]
            assert table.shape[1] == tables.cards[i]
            k += 1


def level_walk(tables, codes, noise):
    """The kernel's sweep in numpy: level by level, group by group, every
    variable of a level drawn from the states as they stood before the level
    (its threads run side by side), its logits summed from zero per state."""
    states = codes.numpy().astype(np.int64).copy()
    noise = noise.numpy()
    groups = tables.groups
    for lv in range(tables.n_levels):
        before = states.copy()
        part = tables.schedule[tables.starts[lv * groups]: tables.starts[(lv + 1) * groups]]
        for i in part:
            card, first = tables.vars[i, :2]
            logits = walk_logits(tables, before, i)
            states[:, i] = np.argmax(logits - noise[first: first + card].T, axis=1)
    return states


def test_level_walk_equals_the_sequential_sweep(pair):
    gibbs, _ = pair
    tables = gibbs._compiled._tables
    codes = random_codes(gibbs, N, 3)
    dtype = tables.var_specs[0][0][0].dtype
    noise = race_noise((sum(tables.cards), N), seeded_generator(4), dtype)
    got = gibbs_ops.sweep_reference(tables, codes, None, noise=noise)
    assert got.dtype == gibbs._compiled._out_dtype and got.shape == codes.shape
    np.testing.assert_array_equal(got.long().numpy(), level_walk(tables, codes, noise))


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
        level_walk(tables, codes, noise))


def test_tile_plans():
    # MUNIN: 1041 int8 codes a chain, padded to 261 words; 32 chains, 33 KB
    assert gibbs_ops.plan_tile(1041, 1, 16) == (32, 1044, 32 * 1044)
    assert gibbs_ops.plan_tile(1041, 1, 32) == (32, 1044, 32 * 1044)
    assert gibbs_ops.plan_tile(70, 1, 16) == (64, 76, 64 * 76)  # HEPAR2
    assert gibbs_ops.plan_tile(37, 1, 10) == (96, 44, 96 * 44)  # ALARM
    assert gibbs_ops.plan_tile(1041, 4, 16) == (11, 1041, 11 * 4164)
    with pytest.raises(ValueError, match="shared memory"):
        gibbs_ops.plan_tile(20_000, 4, 8)


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
        level_walk(tables, codes, noise))
