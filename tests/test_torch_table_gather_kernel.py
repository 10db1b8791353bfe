"""The table-gather programs (K13: ``log_probability``; K11: EM's E-step)
against pgmpy_tpu on the CPU, and what a CPU test can see of the CUDA route
(``csrc/table_gather.cu``): the node table and launch plan the wrapper hands
the kernel, emulated in numpy against the plain version.

Tolerances: K13 is a float32 sum of float32 log tables in both packages
(rtol 1e-5); the E-step weights are the port's float64 softmax against the
JAX package's float32 one (atol 1e-6); whole EM fits at atol 1e-5 as in
``tests/test_torch_em.py``; the numpy emulation of the kernel sums in float64
in node order, the plain version group by group (rtol 1e-12)."""

import itertools

import numpy as np
import pandas as pd
import pytest
import torch

import pgmpy_tpu.estimators.base as jax_base
from pgmpy_tpu.estimators import ExpectationMaximization as JaxEM
from pgmpy_tpu.metrics import BayesianModelProbability as JaxProbability
from pgmpy_tpu.models import DiscreteBayesianNetwork as JaxBN
from pgmpy_tpu.utils import get_example_model as jax_example

from _golden_data import standalone_sample
from _torch_parity import np_values, to_port
from pgmpy_tpu_torch.estimators import ExpectationMaximization
from pgmpy_tpu_torch.factors import TabularCPD
from pgmpy_tpu_torch.metrics import BayesianModelProbability
from pgmpy_tpu_torch.models import DiscreteBayesianNetwork
from pgmpy_tpu_torch.ops import table_gather as tg


# ---------------------------------------------------------------------- #
# K13 against pgmpy_tpu
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module", params=["alarm", "child"])
def network(request):
    jax_model = jax_example(request.param)
    frame = standalone_sample(jax_model, 3000, seed=31)
    return to_port(jax_model), jax_model, frame


def test_log_probability_matches_jax(network):
    port_model, jax_model, frame = network
    got = BayesianModelProbability(port_model).log_probability(frame)
    want = JaxProbability(jax_model).log_probability(frame)
    assert got.shape == (len(frame),) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _int64_codes(prob, frame):
    """The frame's codes as the int64 ``(d, n)`` matrix ``_encode`` made
    before it stored int8."""
    return torch.from_numpy(np.stack([
        pd.Index(prob.sampler.state_names[v]).get_indexer(frame[v]).astype(np.int64)
        for v in prob.sampler.variables]))


def test_int8_encode_equals_the_int64_one(network):
    port_model, _, frame = network
    prob = BayesianModelProbability(port_model)
    codes = prob._encode(frame)
    wide = _int64_codes(prob, frame)
    assert codes.dtype == torch.int8 and codes.shape == wide.shape
    assert torch.equal(codes.long(), wide)
    assert torch.equal(prob._logp(codes), prob._logp(wide))


def test_encode_is_int32_from_128_states():
    model = DiscreteBayesianNetwork([("a", "b")])
    model.add_cpds(TabularCPD("a", 128, np.full((128, 1), 1 / 128)),
                   TabularCPD("b", 2, np.full((2, 128), 0.5), evidence=["a"], evidence_card=[128]))
    frame = pd.DataFrame({"a": [0, 127, 64], "b": [1, 0, 1]})
    prob = BayesianModelProbability(model)
    codes = prob._encode(frame)
    assert codes.dtype == torch.int32 and codes[0].tolist() == [0, 127, 64]
    np.testing.assert_allclose(prob.log_probability(frame), np.log([1 / 256] * 3), rtol=1e-6)


# ---------------------------------------------------------------------- #
# K11 against pgmpy_tpu: the E-step's weights and a whole fit
# ---------------------------------------------------------------------- #
def _frame_with_missing(model, n_rows, seed, drop, missing_cols):
    frame = standalone_sample(model, n_rows, seed=seed).drop(columns=drop).astype(object)
    rng = np.random.default_rng(seed + 1)
    for col in missing_cols:
        frame.loc[rng.random(len(frame)) < 0.15, col] = np.nan
    return frame


# (network, latents and their cards, observed columns with missing codes): K = 1, 2, 5, 36
E_STEP_CASES = {
    1: ("asia", {}, ["smoke", "lung", "xray"]),
    2: ("cancer", {"Smoker": 2}, ["Xray", "Cancer"]),
    5: ("cancer", {"Smoker": 5}, ["Xray", "Dyspnoea"]),
    36: ("cancer", {"Smoker": 6, "Pollution": 6}, ["Xray"]),
}


@pytest.mark.parametrize("K", sorted(E_STEP_CASES))
def test_e_step_weights_match_jax(K, monkeypatch):
    name, latent_card, missing_cols = E_STEP_CASES[K]
    model = jax_example(name)
    latents = sorted(latent_card)
    frame = _frame_with_missing(model, 700, 5 + K, latents, missing_cols)
    edges = list(model.edges())

    seen = []
    real = jax_base._CodedData.multi_counts

    def recording(self, specs, weights=None):
        if weights is not None:
            seen.append(np.asarray(weights, dtype=np.float64))
        return real(self, specs, weights=weights)

    monkeypatch.setattr(jax_base._CodedData, "multi_counts", recording)
    kwargs = dict(max_iter=1, seed=3, init_cpds="random", show_progress=False)
    if latent_card:
        kwargs["latent_card"] = latent_card
    JaxEM(JaxBN(edges, latents=set(latents)), frame).get_parameters(**kwargs)
    assert len(seen) == 1

    em = ExpectationMaximization(DiscreteBayesianNetwork(edges, latents=set(latents)), frame)
    program, cards, names = em._program(latent_card or None)
    assert program.K == K
    prob = program.flat_of(em._initial_cpds("random", 3, cards, names))
    got = np_values(program.e_step(prob))
    assert got.shape == seen[0].shape == (len(frame) * K,)
    np.testing.assert_allclose(got, seen[0], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.reshape(-1, K).sum(axis=1), 1.0, atol=1e-12)


def test_em_fit_matches_jax_on_cancer():
    model = jax_example("cancer")
    frame = _frame_with_missing(model, 1200, 17, ["Smoker"], ["Xray"])
    kwargs = dict(latent_card={"Smoker": 5}, max_iter=6, seed=2, init_cpds="random",
                  show_progress=False)
    want = JaxEM(JaxBN(list(model.edges()), latents={"Smoker"}), frame).get_parameters(**kwargs)
    got = ExpectationMaximization(DiscreteBayesianNetwork(list(model.edges()), latents={"Smoker"}),
                                  frame).get_parameters(**kwargs)
    want = {str(c.variable): c for c in want}
    assert sorted(want) == sorted(str(c.variable) for c in got)
    for cpd in got:
        ref = want[str(cpd.variable)]
        assert cpd.variables == ref.variables
        np.testing.assert_allclose(np_values(cpd.get_values()), np_values(ref.get_values()),
                                   atol=1e-5, err_msg=str(cpd.variable))


# ---------------------------------------------------------------------- #
# what the kernel is handed: the node table and the launch plan
# ---------------------------------------------------------------------- #
def test_node_table_rows():
    nodes = tg.node_table([(0,), (1, 0), (2, 0, 1)], [(1,), (1, 3), (1, 2, 6)], [0, 3, 9])
    assert nodes.dtype == np.int32
    np.testing.assert_array_equal(nodes, [  # padded to the kernel's width of 4 columns
        [0, 1, 0, 0, 0, 0, 1, 0, 0, 0],
        [3, 2, 1, 0, 0, 0, 1, 3, 0, 0],
        [9, 3, 2, 0, 1, 0, 1, 2, 6, 0],
    ])
    five = [tuple(range(5))]
    assert tg.node_table(five, [(1,) * 5], [0]).shape == (1, 2 + 2 * 8)
    with pytest.raises(ValueError, match="at most 32"):
        tg.node_table([tuple(range(33))], [(1,) * 33], [0])


def test_launch_plans():
    # row_sums: tiles of 32 rows, 256 threads, so 8 slices of the nodes, a
    # float64 partial sum a thread; MUNIN's 50,000 rows are 1,563 tiles
    assert tg.plan_rows(50_000) == (32, 8, 256, 256 * 8, 1563)
    assert tg.plan_rows(1) == (32, 8, 256, 256 * 8, 1)
    # MUNIN with DIFFN_PATHO latent: 971 shared and 70 latent nodes of width
    # 4, K = 5: tiles of 32 rows, the latent nodes in 8 slices (one block of
    # configurations: 8 x 32 = 256 tasks)
    assert tg.plan_e_step(5, 4, 971, 70, 1) == (32, 8, 256, (256 + 8 * 5 * 32 + 64) * 8 + 5 * 4)
    # no latent: K = 1, eight latent slices would be empty, so one
    assert tg.plan_e_step(1, 4, 8, 0, 0) == (32, 1, 256, (256 + 32 + 64) * 8)
    assert tg.plan_e_step(1, 4, 8, 20, 1)[:2] == (32, 8)
    assert tg.plan_e_step(3, 4, 8, 20, 1)[:2] == (32, 8)
    assert tg.plan_e_step(9, 4, 8, 20, 1)[:2] == (32, 4)  # two blocks of configurations
    # K x 32 float64 sums past LP_BYTES: fewer rows a tile; 1,024 configurations, 4 rows
    assert tg.plan_e_step(128, 4, 10, 10, 2)[:2] == (32, 1)
    assert tg.plan_e_step(300, 4, 10, 10, 2)[:2] == (8, 1)
    assert tg.plan_e_step(1024, 4, 10, 10, 2) == (4, 1, 256, (256 + 1024 * 4 + 8) * 8
                                                   + 1024 * 2 * 4)
    with pytest.raises(ValueError, match="shared memory"):
        tg.plan_e_step(40_000, 4, 10, 10, 2)


def _random_gather(seed, n_vars=9, n_rows=257, missing=0.0, dtype=torch.float64):
    """A TableGather over random (node, parents) tables of a random code
    matrix, its flat table and codes."""
    rng = np.random.default_rng(seed)
    cards = rng.integers(2, 6, n_vars)
    cols, strides, sizes = [], [], []
    for v in range(n_vars):
        parents = list(rng.choice(n_vars, size=int(rng.integers(0, 4)), replace=False))
        parents = [p for p in parents if p != v]
        c = [v] + parents
        s = np.cumprod([1] + [int(cards[p]) for p in c[:0:-1]])[::-1]
        cols.append(tuple(c))
        strides.append(tuple(int(x) for x in s))
        sizes.append(int(np.prod([cards[p] for p in c])))
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    codes = np.stack([rng.integers(0, cards[v], n_rows) for v in range(n_vars)])
    codes[rng.random(codes.shape) < missing] = -1
    gather = tg.TableGather(cols, strides, offsets, int(sum(sizes)), torch.device("cpu"))
    table = torch.as_tensor(rng.normal(size=int(sum(sizes))), dtype=dtype)
    return gather, table, torch.from_numpy(codes.astype(np.int8))


def _emulated_row_sums(gather, table, codes, missing):
    """The node table's arithmetic in numpy: per row, node after node, a
    float64 sum (the kernel's tiles and slices: ``_emulated_row_tiles``)."""
    nodes, table, codes = gather.nodes, table.double().numpy(), codes.long().numpy()
    width = (nodes.shape[1] - 2) // 2
    assert width in tg.WIDTHS
    out = np.zeros(codes.shape[1])
    for row in nodes:
        k = row[1]
        c = codes[row[2: 2 + k]]
        flat = row[0] + (np.maximum(c, 0) * row[2 + width: 2 + width + k, None]).sum(axis=0)
        term = table[flat]
        out += np.where((c >= 0).all(axis=0), term, 0.0) if missing else term
    return out


def _shuffle_tree(values):
    """A warp's ``__shfl_xor_sync`` tree over 32 lanes (lanes past
    ``values`` hold 0): what lane 0 holds at the end."""
    v = list(values) + [0.0] * (32 - len(values))
    for o in (16, 8, 4, 2, 1):
        v = [v[lane] + v[lane ^ o] for lane in range(32)]
    return v[0]


def _emulated_row_tiles(gather, table, codes, missing):
    """``row_sums``'s schedule in numpy from the node table it is handed and
    ``plan_rows``: per tile of R rows, thread (slice, row) sums its slice of
    the nodes (``node_slice``: slice s of S gets nodes [n s / S, n (s + 1) /
    S)) for its row in node order, in float64; then row r's slices meet as
    ``combine_slices`` adds them (lane j the slices j, j + 32, ..., then the
    shuffle tree).  Asserts that the slices cover every node once and the
    tiles every row once."""
    nodes, table, codes = gather.nodes, table.double().numpy(), codes.long().numpy()
    width = (nodes.shape[1] - 2) // 2
    n_nodes, n = len(nodes), codes.shape[1]
    R, slices, threads, shared, tiles = tg.plan_rows(n)
    assert threads == R * slices and threads % 32 == 0 and threads <= 256
    assert shared == 8 * threads and tiles * R >= n > (tiles - 1) * R
    cuts = [n_nodes * s // slices for s in range(slices + 1)]
    assert cuts[0] == 0 and cuts[-1] == n_nodes and all(np.diff(cuts) >= 0)

    def term(node, r):
        k = int(node[1])
        c = codes[node[2:2 + k], r]
        value = table[int(node[0]) + int((np.maximum(c, 0) * node[2 + width:2 + width + k]).sum())]
        return 0.0 if missing and (c < 0).any() else value

    out = np.full(n, np.nan)
    seen = np.zeros(n, dtype=np.int64)
    for tile in range(tiles):
        for r in range(tile * R, min(n, tile * R + R)):
            parts = []
            for s in range(slices):
                acc = 0.0
                for i in range(cuts[s], cuts[s + 1]):
                    acc += term(nodes[i], r)
                parts.append(acc)
            lanes = [sum(parts[j::32], 0.0) for j in range(min(32, slices))]
            out[r] = _shuffle_tree(lanes)
            seen[r] += 1
    assert (seen == 1).all()
    return out


@pytest.mark.parametrize("missing", [False, True])
@pytest.mark.parametrize("n_vars,seed", [(9, 0), (9, 1), (40, 2), (3, 3)])
def test_row_tiles_walk_to_the_plain_row_sums(n_vars, seed, missing):
    """K13's tiles and slices in numpy against the plain version in float64
    (fewer nodes than slices included: empty slices), with and without
    missing codes, at a row count that leaves the last tile short."""
    gather, table, codes = _random_gather(seed, n_vars=n_vars, n_rows=77,
                                          missing=0.2 if missing else 0.0)
    want = gather.row_sums_reference(table, codes, missing=missing).numpy()
    np.testing.assert_allclose(_emulated_row_tiles(gather, table, codes, missing), want,
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("missing", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_node_table_computes_the_plain_row_sums(seed, missing):
    gather, table, codes = _random_gather(seed, missing=0.2 if missing else 0.0)
    got = gather.row_sums(table, codes, missing=missing)
    assert torch.equal(got, gather.row_sums_reference(table, codes, missing=missing))
    np.testing.assert_allclose(_emulated_row_sums(gather, table, codes, missing), got.numpy(),
                               rtol=1e-12)


def _random_latent_gather(seed, latent_cards, n_obs=7, n_rows=97, missing=0.15,
                          dtype=torch.float64):
    """A LatentGather over a random network of ``n_obs`` observed variables
    and latent ones of ``latent_cards`` states, its flat table, its observed
    codes
    (column-major, padded past the rows as ``column_major_codes`` pads), and
    the matrix of the rows expanded over the configurations (observed
    columns, then the latent ones)."""
    rng = np.random.default_rng(seed)
    n_latent = len(latent_cards)
    n_vars = n_obs + n_latent
    cards = np.concatenate([rng.integers(2, 5, n_obs), np.asarray(latent_cards, dtype=np.int64)])
    cols, expanded_cols, strides, sizes = [], [], [], []
    for v in range(n_vars):
        parents = [int(p) for p in rng.choice(n_vars, size=int(rng.integers(0, 4)), replace=False)
                   if p != v]
        c = [v] + parents
        s = np.cumprod([1] + [int(cards[p]) for p in c[:0:-1]])[::-1]
        expanded_cols.append(tuple(c))
        cols.append(tuple(u if u < n_obs else -1 - (u - n_obs) for u in c))
        strides.append(tuple(int(x) for x in s))
        sizes.append(int(np.prod([cards[p] for p in c])))
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    grid = np.array(list(itertools.product(*[range(int(cards[n_obs + j]))
                                             for j in range(n_latent)])),
                    dtype=np.int64)
    K = grid.shape[0]
    grid = grid.reshape(K, n_latent)
    obs = np.stack([rng.integers(0, cards[v], n_rows) for v in range(n_obs)])
    obs[rng.random(obs.shape) < missing] = -1
    padded = np.full((n_obs, n_rows + 11), -1, dtype=np.int8)
    padded[:, :n_rows] = obs
    expanded = np.concatenate([np.repeat(obs, K, axis=1), np.tile(grid.T, (1, n_rows))])
    gather = tg.LatentGather(cols, strides, offsets, int(sum(sizes)), grid, torch.device("cpu"))
    full = tg.TableGather(expanded_cols, strides, offsets, int(sum(sizes)), torch.device("cpu"))
    table = torch.as_tensor(rng.normal(size=int(sum(sizes))), dtype=dtype)
    return gather, full, table, torch.from_numpy(padded)[:, :n_rows], expanded


def _softmax_rows(lp):
    w = np.exp(lp - lp.max(axis=1, keepdims=True))
    return w / w.sum(axis=1, keepdims=True)


def _emulated_e_step(gather, table, codes):
    """The e_step kernel's schedule in numpy from the table it is handed
    (``gather.nodes``: shared rows, latent rows, grid) and its plan: per tile
    of R rows, each thread's slice of the shared nodes for its row, each (p,
    block of configurations, row) task's slice of the latent nodes (node by
    node, each configuration's own sum), then per row the shared slices in
    order, lp[k] = that plus the latent slices in order, and the softmax."""
    K, L = gather.K, gather.L
    n_shared, n_latent = len(gather.shared_nodes), len(gather.latent_nodes)
    width = gather.width
    row_words = 2 + 2 * width
    nodes = gather.nodes[: (n_shared + n_latent) * row_words].reshape(-1, row_words)
    grid = gather.nodes[(n_shared + n_latent) * row_words:].reshape(K, L)
    R, P, threads, _ = tg.plan_e_step(K, width, n_shared, n_latent, L)
    assert threads % R == 0 and threads % 32 == 0
    table, codes = table.double().numpy(), codes.long().numpy()
    n = codes.shape[1]

    def term(node, r, k):
        flat, valid = int(node[0]), True
        for j in range(int(node[1])):
            col = int(node[2 + j])
            code = int(codes[col, r]) if col >= 0 else int(grid[k, -1 - col])
            valid &= code >= 0
            flat += max(code, 0) * int(node[2 + width + j])
        return table[flat] if valid else 0.0

    slices = threads // R
    out = np.zeros((n, K))
    for r in range(n):
        parts = []
        for slice_ in range(slices):
            lo, hi = n_shared * slice_ // slices, n_shared * (slice_ + 1) // slices
            parts.append(sum((term(nodes[i], r, 0) for i in range(lo, hi)), 0.0))
        shared = sum(parts, 0.0)
        for k in range(K):
            lp = shared
            for p in range(P):
                lo, hi = n_shared + n_latent * p // P, n_shared + n_latent * (p + 1) // P
                lp += sum((term(nodes[i], r, k) for i in range(lo, hi)), 0.0)
            out[r, k] = lp
    return _softmax_rows(out).ravel()


# (latent cards, seed): no latent (K = 1), one of 3 and of 7 states, two (K = 6, 21)
LATENT_CASES = [((), 0), ((3,), 1), ((7,), 2), ((3, 2), 3), ((7, 3), 4)]


@pytest.mark.parametrize("latent_cards,seed", LATENT_CASES)
def test_latent_gather_splits_shared_and_latent_nodes(latent_cards, seed):
    gather, _, _, _, _ = _random_latent_gather(seed, latent_cards)
    n_latent = len(latent_cards)
    assert (gather.K, gather.L) == (int(np.prod(latent_cards)), n_latent)
    n_nodes = len(gather.shared_nodes) + len(gather.latent_nodes)
    assert sorted(gather.shared_nodes + gather.latent_nodes) == list(range(n_nodes))
    width = gather.width
    rows = gather.nodes[: n_nodes * (2 + 2 * width)].reshape(n_nodes, -1)
    for i, row in zip(gather.shared_nodes + gather.latent_nodes, rows):
        used = row[2: 2 + row[1]]
        assert (i in gather.latent_nodes) == bool((used < 0).any())
        assert (used >= -n_latent).all()
    grid = gather.nodes[n_nodes * (2 + 2 * width):].reshape(gather.K, n_latent)
    np.testing.assert_array_equal(grid, gather.grid)
    assert len(gather.latent_nodes) >= n_latent  # each latent's own CPD at least


@pytest.mark.parametrize("missing", [0.0, 0.2])
@pytest.mark.parametrize("latent_cards,seed", LATENT_CASES)
def test_latent_gather_plain_matches_the_expanded_rows(latent_cards, seed, missing):
    """The plain version over the observed codes against the softmax of the
    masked row sums of the expanded rows (the layout the E-step read before)."""
    gather, full, table, codes, expanded = _random_latent_gather(seed, latent_cards,
                                                                 missing=missing)
    got = gather.e_step(table, codes, torch.float64)
    assert got.dtype == torch.float64 and got.shape == (codes.shape[1] * gather.K,)
    lp = full.row_sums_reference(table, torch.from_numpy(expanded.astype(np.int8)), missing=True)
    want = _softmax_rows(lp.numpy().reshape(-1, gather.K)).ravel()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14)
    f32 = gather.e_step(table, codes, torch.float32)
    assert f32.dtype == torch.float32
    np.testing.assert_allclose(f32.numpy(), want, atol=1e-7)


@pytest.mark.parametrize("latent_cards,seed", LATENT_CASES)
def test_e_step_tables_walk_to_the_plain_version(latent_cards, seed):
    gather, _, table, codes, _ = _random_latent_gather(seed, latent_cards, n_rows=41)
    got = _emulated_e_step(gather, table, codes)
    want = gather.e_step_reference(table, codes, torch.float64).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("K", [1, 3, 7])
def test_e_step_is_the_softmax_of_the_masked_row_sums(K):
    """One latent of K states (K = 1: no latent) beside six observed
    variables, missing codes among them."""
    rng = np.random.default_rng(K)
    n_obs, n_rows = 6, 40
    cards = list(rng.integers(2, 5, n_obs)) + [K]
    cols, strides, sizes = [], [], []
    for v in range(n_obs + (K > 1)):
        parents = [int(p) for p in rng.choice(n_obs + (K > 1), size=2, replace=False) if p != v]
        c = [v] + parents
        s = np.cumprod([1] + [int(cards[p]) for p in c[:0:-1]])[::-1]
        cols.append(tuple(u if u < n_obs else -1 for u in c))
        strides.append(tuple(int(x) for x in s))
        sizes.append(int(np.prod([cards[p] for p in c])))
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    grid = np.arange(K).reshape(K, 1) if K > 1 else np.zeros((1, 0), dtype=np.int64)
    gather = tg.LatentGather(cols, strides, offsets, int(sum(sizes)), grid, torch.device("cpu"))
    codes = np.stack([rng.integers(0, cards[v], n_rows) for v in range(n_obs)])
    codes[rng.random(codes.shape) < 0.1] = -1
    table = torch.as_tensor(rng.normal(size=int(sum(sizes))), dtype=torch.float64)
    got = gather.e_step(table, torch.from_numpy(codes.astype(np.int8)), torch.float32)
    assert got.dtype == torch.float32 and got.shape == (K * n_rows,)
    lp = np.zeros((n_rows, K))
    for c, s, off in zip(cols, strides, offsets):
        for k in range(K):
            rows = [codes[u] if u >= 0 else np.full(n_rows, k) for u in c]
            flat = off + sum(np.maximum(r, 0) * st for r, st in zip(rows, s))
            valid = np.all([r >= 0 for r in rows], axis=0)
            lp[:, k] += np.where(valid, table.numpy()[flat], 0.0)
    np.testing.assert_allclose(got.numpy(), _softmax_rows(lp).ravel(), atol=1e-7)


def test_cuda_entry_points_refuse_cpu_tensors():
    gather, table, codes = _random_gather(0)
    with pytest.raises(ValueError, match="CUDA"):
        gather.row_sums_cuda(table, codes)
    latent, _, table, codes, _ = _random_latent_gather(0, (2,))
    with pytest.raises(ValueError, match="CUDA"):
        latent.e_step_cuda(table, codes, torch.float32)
