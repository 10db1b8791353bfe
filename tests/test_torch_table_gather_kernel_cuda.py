"""K13 and K11 on the card: both entry points of ``csrc/table_gather.cu``
(``row_sums`` and ``e_step``) against their plain PyTorch versions on the same
card (``e_step`` at K from 1 to 1,024 and at MUNIN's shape), their launch
counters, and the paths that call them
(``BayesianModelProbability.log_probability``, ``ExpectationMaximization``).
Every test here needs a CUDA device and skips without one; on a GPU machine:
``python -m pytest tests/test_torch_table_gather_kernel_cuda.py -m cuda``.

Tolerances: the kernel sums in float64 in node order, the plain version in
the table's type group by group.  With a float64 table they agree to rtol
1e-12; with a float32 table to rtol 1e-5 of the sum of the terms' magnitudes
(the plain version's float32 rounding).  The E-step's softmax is float64 on
both sides: float64 weights agree to atol 1e-12, float32 ones to atol 1e-7
(one rounding of each)."""

import itertools

import numpy as np
import pytest
import torch

from _torch_parity import random_bn_tables
from pgmpy_tpu_torch.config import config
from pgmpy_tpu_torch.estimators import ExpectationMaximization
from pgmpy_tpu_torch.metrics import BayesianModelProbability
from pgmpy_tpu_torch.models import DiscreteBayesianNetwork
from pgmpy_tpu_torch.ops import table_gather as tg
from pgmpy_tpu_torch.utils import get_example_model
from pgmpy_tpu_torch.utils.interop import bn_from_numpy


@pytest.fixture
def on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    previous = config.DEVICE
    config.set_device("cuda")
    try:
        yield
    finally:
        config.set_device(previous)


def _gather(seed, n_vars=12, n_rows=5000, missing=0.0, code_dtype=torch.int8,
            table_dtype=torch.float64, ld_pad=0):
    """A TableGather over random (node, parents) tables, its flat table and a
    column-major code matrix on the card (``ld_pad`` extra columns: a view
    whose leading dimension exceeds its rows)."""
    rng = np.random.default_rng(seed)
    cards = rng.integers(2, 22, n_vars)
    cols, strides, sizes = [], [], []
    for v in range(n_vars):
        parents = [int(p) for p in rng.choice(n_vars, size=int(rng.integers(0, 4)), replace=False)
                   if p != v]
        c = [v] + parents
        s = np.cumprod([1] + [int(cards[p]) for p in c[:0:-1]])[::-1]
        cols.append(tuple(c))
        strides.append(tuple(int(x) for x in s))
        sizes.append(int(np.prod([cards[p] for p in c])))
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    codes = np.full((n_vars, n_rows + ld_pad), -1, dtype=np.int64)
    codes[:, :n_rows] = np.stack([rng.integers(0, cards[v], n_rows) for v in range(n_vars)])
    codes[:, :n_rows][rng.random((n_vars, n_rows)) < missing] = -1
    device = torch.device("cuda")
    gather = tg.TableGather(cols, strides, offsets, int(sum(sizes)), device)
    table = torch.as_tensor(rng.normal(size=int(sum(sizes))), dtype=table_dtype, device=device)
    codes = torch.from_numpy(codes).to(device=device, dtype=code_dtype)[:, :n_rows]
    return gather, table, codes


def _assert_sums_close(got, want, magnitude):
    if got.dtype == torch.float64:
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    else:
        assert float(((got.double() - want.double()).abs() / magnitude).max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("code_dtype", [torch.int8, torch.int16, torch.int32, torch.int64])
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("missing", [False, True])
@pytest.mark.parametrize("n_rows", [1, 257, 50_000])
def test_row_sums_match_plain(on_cuda, code_dtype, table_dtype, missing, n_rows):
    gather, table, codes = _gather(n_rows, n_rows=n_rows, missing=0.2 if missing else 0.0,
                                   code_dtype=code_dtype, table_dtype=table_dtype, ld_pad=13)
    before = tg.LAUNCHES["row_sums"]
    got = gather.row_sums(table, codes, missing=missing)
    assert tg.LAUNCHES["row_sums"] == before + 1
    want = gather.row_sums_reference(table, codes, missing=missing)
    magnitude = gather.row_sums_reference(table.abs(), codes, missing=missing).double() + 1e-30
    torch.cuda.synchronize()
    assert got.dtype == table_dtype and got.shape == (n_rows,)
    _assert_sums_close(got, want, magnitude)
    assert torch.equal(got, gather.row_sums(table, codes, missing=missing))  # run to run


@pytest.mark.cuda
@pytest.mark.parametrize("tile,block", [(32, 256), (16, 256), (32, 128), (8, 64), (1, 32)])
def test_row_sums_tile_settings(on_cuda, tile, block, monkeypatch):
    """K13 under other tiles and blocks (rows a tile, threads a block: the
    slices of the nodes are block / tile), as the stamp tool times them."""
    monkeypatch.setattr(tg, "ROW_TILE", tile)
    monkeypatch.setattr(tg, "ROW_BLOCK", block)
    gather, table, codes = _gather(7, n_vars=40, n_rows=5003, missing=0.1)
    got = gather.row_sums(table, codes, missing=True)
    want = gather.row_sums_reference(table, codes, missing=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def _latent_gather(latent_cards, n_obs=12, n_rows=5000, missing=0.1, table_dtype=torch.float64,
                   seed=0):
    """A LatentGather over random (node, parents) tables of ``n_obs``
    observed variables and latent ones of ``latent_cards`` states, its flat
    table and the observed codes, int8 and column-major with a padded
    leading dimension, on the card."""
    rng = np.random.default_rng(seed)
    n_latent = len(latent_cards)
    cards = np.concatenate([rng.integers(2, 22, n_obs), np.asarray(latent_cards, dtype=np.int64)])
    cols, strides, sizes = [], [], []
    for v in range(n_obs + n_latent):
        parents = [int(p) for p in rng.choice(n_obs + n_latent, size=int(rng.integers(0, 4)),
                                              replace=False) if p != v]
        c = [v] + parents
        s = np.cumprod([1] + [int(cards[p]) for p in c[:0:-1]])[::-1]
        cols.append(tuple(u if u < n_obs else n_obs - 1 - u for u in c))
        strides.append(tuple(int(x) for x in s))
        sizes.append(int(np.prod([cards[p] for p in c])))
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    grid = np.array(list(itertools.product(*[range(int(k)) for k in latent_cards])),
                    dtype=np.int64)
    grid = grid.reshape(grid.shape[0], n_latent)
    codes = np.full((n_obs, n_rows + 13), -1, dtype=np.int8)
    codes[:, :n_rows] = np.stack([rng.integers(0, cards[v], n_rows) for v in range(n_obs)])
    codes[:, :n_rows][rng.random((n_obs, n_rows)) < missing] = -1
    device = torch.device("cuda")
    gather = tg.LatentGather(cols, strides, offsets, int(sum(sizes)), grid, device)
    table = torch.as_tensor(rng.normal(size=int(sum(sizes))), dtype=table_dtype, device=device)
    return gather, table, torch.from_numpy(codes).to(device)[:, :n_rows]


# latent cards -> K: 1 (no latent), 2, 5, 36, 300 and 1,024 (two latents of 32)
E_STEP_LATENTS = [(), (2,), (5,), (6, 6), (20, 15), (32, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("latent_cards", E_STEP_LATENTS)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.float64])
def test_e_step_matches_plain(on_cuda, latent_cards, out_dtype):
    K = int(np.prod(latent_cards))
    n_rows = max(2, 60_000 // K)
    gather, table, codes = _latent_gather(latent_cards, n_rows=n_rows, seed=K)
    assert gather.K == K
    before = tg.LAUNCHES["e_step"]
    got = gather.e_step(table, codes, out_dtype)
    assert tg.LAUNCHES["e_step"] == before + 1
    want = gather.e_step_reference(table, codes, out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (n_rows * K,)
    atol = 1e-12 if out_dtype == torch.float64 else 1e-7
    torch.testing.assert_close(got, want, rtol=0, atol=atol)
    assert torch.equal(got, gather.e_step(table, codes, out_dtype))  # run to run


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.float64])
def test_e_step_at_munins_shape(on_cuda, out_dtype, table_dtype):
    """MUNIN's E-step with DIFFN_PATHO latent at 5 states: 1041 nodes (971
    shared, 70 latent), 50,000 rows of its simulated codes with 10% missing."""
    from pgmpy_tpu_torch.estimators.em import _EMProgram
    from pgmpy_tpu_torch.estimators.base import _CodedData

    model = get_example_model("munin")
    frame = model.simulate(50_000, seed=3, show_progress=False).drop(columns=["DIFFN_PATHO"])
    frame = frame.astype(object)
    rng = np.random.default_rng(5)
    frame = frame.mask(rng.random(frame.shape) < 0.1)
    coded = _CodedData(frame)
    var_order = sorted(model.nodes(), key=str)
    parents = {v: sorted(model.get_parents(v), key=str) for v in var_order}
    cards = dict(coded.cards, DIFFN_PATHO=5)
    names = dict(coded.state_names, DIFFN_PATHO=list(range(5)))
    program = _EMProgram(coded, var_order, parents, ["DIFFN_PATHO"], cards, names, 1000)
    gather = program.gather
    assert (len(gather.shared_nodes), len(gather.latent_nodes), gather.K) == (971, 70, 5)
    table = torch.as_tensor(np.log(np.random.default_rng(1).random(gather.total) + 1e-3),
                            dtype=table_dtype, device="cuda")
    codes = coded._column_codes()[:, : coded.n]
    got = gather.e_step(table, codes, out_dtype)
    want = gather.e_step_reference(table, codes, out_dtype)
    torch.cuda.synchronize()
    atol = 1e-12 if out_dtype == torch.float64 else 1e-7
    torch.testing.assert_close(got, want, rtol=0, atol=atol)


@pytest.mark.cuda
def test_cuda_route_refuses_bad_inputs(on_cuda):
    gather, table, codes = _gather(0, n_rows=100)
    with pytest.raises(ValueError, match="one CUDA device"):
        gather.row_sums_cuda(table, codes.cpu())
    with pytest.raises(TypeError):
        gather.row_sums_cuda(table.half(), codes)
    latent, table64, latent_codes = _latent_gather((2,), n_rows=100)
    with pytest.raises(TypeError, match="float32 or float64 weights"):
        latent.e_step_cuda(table64, latent_codes, torch.float16)
    with pytest.raises(ValueError, match="one CUDA device"):
        latent.e_step_cuda(table64, latent_codes.cpu(), torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        gather.row_sums_cuda(table, codes.t().contiguous().t())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["alarm", "child"])
def test_log_probability_is_one_launch(on_cuda, name):
    model = get_example_model(name)
    frame = model.simulate(4000, seed=1, show_progress=False)
    prob = BayesianModelProbability(model)
    tg.reset_launches()
    got = prob.log_probability(frame)
    assert tg.LAUNCHES == {"row_sums": 1, "e_step": 0}
    codes = prob._encode(frame)
    assert codes.is_cuda and codes.dtype == torch.int8
    want = prob._gather.row_sums_reference(prob._table, codes).double().cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.cuda
def test_em_is_one_e_step_launch_per_iteration(on_cuda):
    names, edges, tuples = random_bn_tables(3, n_nodes=9)
    model = bn_from_numpy(edges, tuples, nodes=names)
    frame = model.simulate(6000, seed=2, show_progress=False)
    latent = names[2]
    data = frame.drop(columns=[latent])
    kwargs = dict(latent_card={latent: 3}, max_iter=4, atol=0.0, seed=0, init_cpds="random",
                  show_progress=False)
    em = ExpectationMaximization(DiscreteBayesianNetwork(edges, latents={latent}), data)
    tg.reset_launches()
    got = em.get_parameters(**kwargs)
    assert tg.LAUNCHES == {"row_sums": 0, "e_step": 4}
    previous = config.DEVICE
    config.set_device("cpu")
    try:
        want = ExpectationMaximization(DiscreteBayesianNetwork(edges, latents={latent}),
                                       data).get_parameters(**kwargs)
    finally:
        config.set_device(previous)
    want = {c.variable: c for c in want}
    for cpd in got:
        np.testing.assert_allclose(np.asarray(cpd.get_values()),
                                   np.asarray(want[cpd.variable].get_values()), atol=1e-5)
