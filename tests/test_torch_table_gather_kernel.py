"""The table-gather programs (K13: ``log_probability``; K11: EM's E-step)
against pgmpy_tpu on the CPU, and what a CPU test can see of the CUDA route
(``csrc/table_gather.cu``): the node table and launch plan the wrapper hands
the kernel, emulated in numpy against the plain version.

Tolerances: K13 is a float32 sum of float32 log tables in both packages
(rtol 1e-5); the E-step weights are the port's float64 softmax against the
JAX package's float32 one (atol 1e-6); whole EM fits at atol 1e-5 as in
``tests/test_torch_em.py``; the numpy emulation of the kernel sums in float64
in node order, the plain version group by group (rtol 1e-12)."""

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
    # a chunk of node rows: 2048 int32 entries, 204 rows of width 4
    assert tg.chunk_nodes(4) == 204 and tg.chunk_nodes(8) == 113 and tg.chunk_nodes(32) == 31
    assert tg.plan_rows(50_000, 4) == (128, 391, 204 * 10 * 4)
    assert tg.plan_rows(1, 32) == (128, 1, 31 * 66 * 4)
    chunk = 204 * 10 * 4
    # MUNIN with DIFFN_PATHO latent: 25 whole rows of 5 a block
    assert tg.plan_e_step(50_000, 5, 4) == (25, 128, 2000, (125 + 50) * 8 + chunk)
    assert tg.plan_e_step(10, 1, 4) == (128, 128, 1, (128 + 256) * 8 + chunk)
    assert tg.plan_e_step(7, 128, 4) == (1, 128, 7, (128 + 2) * 8 + chunk)
    # two latents of 32 states: one row a block, its sums in 8 KB
    assert tg.plan_e_step(100, 1024, 4) == (1, 128, 100, (1024 + 2) * 8 + chunk)
    with pytest.raises(ValueError, match="shared memory"):
        tg.plan_e_step(10, 40_000, 4)


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
    """The kernel's arithmetic in numpy from the node table it is handed:
    per row, node after node, a float64 sum."""
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


@pytest.mark.parametrize("missing", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_node_table_computes_the_plain_row_sums(seed, missing):
    gather, table, codes = _random_gather(seed, missing=0.2 if missing else 0.0)
    got = gather.row_sums(table, codes, missing=missing)
    assert torch.equal(got, gather.row_sums_reference(table, codes, missing=missing))
    np.testing.assert_allclose(_emulated_row_sums(gather, table, codes, missing), got.numpy(),
                               rtol=1e-12)


@pytest.mark.parametrize("K", [1, 3, 7])
def test_e_step_is_the_softmax_of_the_masked_row_sums(K):
    gather, table, codes = _random_gather(K, n_rows=K * 40, missing=0.1)
    got = gather.e_step(table, codes, K, torch.float32)
    assert got.dtype == torch.float32 and got.shape == (K * 40,)
    lp = _emulated_row_sums(gather, table, codes, True).reshape(-1, K)
    want = np.exp(lp - lp.max(axis=1, keepdims=True))
    want /= want.sum(axis=1, keepdims=True)
    np.testing.assert_allclose(got.numpy(), want.ravel(), atol=1e-7)


def test_cuda_entry_points_refuse_cpu_tensors():
    gather, table, codes = _random_gather(0)
    with pytest.raises(ValueError, match="CUDA"):
        gather.row_sums_cuda(table, codes)
    with pytest.raises(ValueError, match="CUDA"):
        gather.e_step_cuda(table, codes, 1, torch.float32)
