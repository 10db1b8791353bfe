"""The port's count tables against pgmpy_tpu on the same numpy-seeded data.

``_CodedData.counts``, ``multi_counts`` and ``multi_counts_padded`` of the
port (on the CPU, through the plain version of the table-count op) must equal
the JAX package's exactly for unweighted data (the JAX side runs its scatter
path on the CPU) and to atol 1e-3 / rtol 1e-5 with f32 weights, whose sums are
taken in another order.  The plain table-count version is also held against a
loop of ``weighted_bincount_reference``, and the launch plan that the CUDA
wrapper hands its kernel is checked for the properties the kernel relies on.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

from pgmpy_tpu.estimators.base import _CodedData as JaxCoded

import _torch_parity  # noqa: F401  (puts the port on the CPU)
from pgmpy_tpu_torch.config import as_tensor
from pgmpy_tpu_torch.estimators.base import _CodedData
from pgmpy_tpu_torch.ops import bincount as bc

N_ROWS = 2003  # not a multiple of 16: the column-major copy is padded


def _frame(seed, missing=False):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 3, N_ROWS)
    b = (a + rng.integers(0, 2, N_ROWS)) % 4
    c = rng.integers(0, 2, N_ROWS)
    d = (b + c + rng.integers(0, 3, N_ROWS)) % 5
    e = rng.integers(0, 6, N_ROWS)
    df = pd.DataFrame({k: v.astype(str) for k, v in dict(A=a, B=b, C=c, D=d, E=e).items()})
    if missing:
        for col in ["B", "D"]:
            df.loc[rng.random(N_ROWS) < 0.15, col] = np.nan
    return df


@pytest.fixture(scope="module", params=[False, True], ids=["complete", "nan_rows"])
def coded(request):
    df = _frame(11, missing=request.param)
    return _CodedData(df), JaxCoded(df)


SPECS = [
    ("A", ()),
    ("B", ("A",)),
    ("D", ("B", "C")),
    ("A", ("B", "C", "D")),  # three parents
    ("E", ("A", "D")),
]
# the structure-search shape: a 20-spec list with repeats
MANY_SPECS = [("A", ("B",)), ("C", ("D",)), ("B", ()), ("D", ("A", "C"))] * 5
METHODS = ["multi_counts", "multi_counts_padded"]


def _weights():
    return np.random.default_rng(5).random(N_ROWS).astype(np.float32)


@pytest.mark.parametrize("variable,parents", SPECS)
def test_counts_exact(coded, variable, parents):
    port, ref = coded
    got = port.counts(variable, parents)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(ref.counts(variable, parents)))


@pytest.mark.parametrize("variable,parents", SPECS)
def test_counts_weighted(coded, variable, parents):
    port, ref = coded
    w = _weights()
    got = port.counts(variable, parents, weights=as_tensor(w))
    expect = np.asarray(ref.counts(variable, parents, weights=jnp.asarray(w)))
    np.testing.assert_allclose(got, expect, atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize("variable,parents", SPECS[:3])
def test_counts_device_tensor(coded, variable, parents):
    port, ref = coded
    got = port.counts(variable, parents, device=True)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref.counts(variable, parents)))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("specs", [SPECS, MANY_SPECS, SPECS[3:4]], ids=["mixed", "twenty", "one"])
def test_multi_counts_exact(coded, method, specs):
    port, ref = coded
    before = port.n_dispatches
    got = getattr(port, method)(specs)
    assert port.n_dispatches == before + 1
    expect = getattr(ref, method)(specs)
    assert len(got) == len(expect) == len(specs)
    for a, b in zip(got, expect):
        assert a.shape == np.asarray(b).shape
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("method", METHODS)
def test_multi_counts_weighted(coded, method):
    port, ref = coded
    w = _weights()
    got = getattr(port, method)(SPECS, weights=as_tensor(w))
    expect = getattr(ref, method)(SPECS, weights=jnp.asarray(w))
    for a, b in zip(got, expect):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize("method", METHODS)
def test_multi_counts_empty_list(coded, method):
    port, _ = coded
    assert getattr(port, method)([]) == []


def test_multi_counts_equals_single_counts(coded):
    port, _ = coded
    for (variable, parents), table in zip(SPECS, port.multi_counts_padded(SPECS)):
        np.testing.assert_array_equal(table, port.counts(variable, parents))


def test_nan_rows_are_skipped_not_counted():
    df = _frame(3, missing=True)
    port = _CodedData(df)
    complete = int((df["B"].notna() & df["D"].notna()).sum())
    assert port.counts("D", ("B",)).sum() == complete
    assert port.counts("A").sum() == N_ROWS


def test_codes_stay_row_major_int32_and_column_copy_is_narrow(coded):
    port, ref = coded
    assert port.codes.dtype == torch.int32 and tuple(port.codes.shape) == (N_ROWS, 5)
    np.testing.assert_array_equal(port.codes.numpy(), np.asarray(ref.codes))
    cm = port._column_codes()
    assert cm.dtype == torch.int8 and cm.shape == (5, 2016) and cm.is_contiguous()
    np.testing.assert_array_equal(cm[:, :N_ROWS].numpy(), port.codes.numpy().T)
    assert bool((cm[:, N_ROWS:] == -1).all())


@pytest.mark.parametrize("max_card,dtype", [(127, torch.int8), (128, torch.int16),
                                            (32767, torch.int16), (32768, torch.int32)])
def test_column_major_dtype_follows_cardinality(max_card, dtype):
    codes = torch.zeros((5, 2), dtype=torch.int32)
    assert bc.column_major_codes(codes, max_card).dtype == dtype


# --------------------------------------------------------------------------- #
# the op itself
# --------------------------------------------------------------------------- #
def _op_inputs(seed, n_rows=777, cards=(3, 4, 2, 5)):
    rng = np.random.default_rng(seed)
    codes = np.stack([rng.integers(-1, c, n_rows) for c in cards], axis=1).astype(np.int32)
    col_lists = [[0], [1, 0], [3, 1, 2], [0, 1, 2, 3]]
    card_lists = [[cards[c] for c in cols] for cols in col_lists]
    return codes, col_lists, card_lists


@pytest.mark.parametrize("weighted", [False, True])
def test_plain_table_counts_equal_loop_of_bincounts(weighted):
    codes, col_lists, card_lists = _op_inputs(2)
    n_rows = codes.shape[0]
    specs = bc.table_specs(col_lists, card_lists)
    cm = bc.column_major_codes(torch.from_numpy(codes), 5)
    w = torch.from_numpy(np.random.default_rng(9).random(n_rows)) if weighted else None
    got = bc.table_counts(cm, n_rows, specs, w)
    assert got.dtype == (torch.float64 if weighted else torch.int32)
    assert got.numel() == specs.total == sum(int(np.prod(c)) for c in card_lists)
    for cols, cards, off, size in zip(col_lists, card_lists, specs.offsets, specs.sizes):
        sub = torch.from_numpy(codes[:, cols]).long()
        flat = torch.zeros(n_rows, dtype=torch.long)
        for j, card in enumerate(cards):
            flat = flat * card + sub[:, j]
        flat = torch.where((sub >= 0).all(dim=1), flat, int(size))  # padding index
        values = w if weighted else torch.ones(n_rows, dtype=torch.float64)
        expect = bc.weighted_bincount_reference(flat, values, int(size))
        torch.testing.assert_close(got[off : off + size].double(), expect, rtol=1e-12, atol=0)


def test_table_specs_strides_and_offsets():
    specs = bc.table_specs([[4], [2, 0, 1]], [[3], [2, 5, 7]])
    assert specs.n_cols.tolist() == [1, 3]
    assert specs.strides.tolist() == [[1, 0, 0], [35, 7, 1]]
    assert specs.sizes.tolist() == [3, 70] and specs.offsets.tolist() == [0, 3]
    assert specs.total == 73 and len(specs) == 2
    assert len(bc.table_specs([], [])) == 0


def test_table_specs_rejects_oversized_tables_and_too_many_columns():
    with pytest.raises(ValueError):
        bc.table_specs([[0, 1, 2, 3]], [[256, 256, 256, 256]])
    with pytest.raises(ValueError):
        bc.table_specs([list(range(33))], [[1] * 33])


def test_table_counts_rejects_bad_inputs():
    specs = bc.table_specs([[0]], [[3]])
    row_major = torch.zeros((10, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        bc.table_counts(row_major, 10, specs)  # ld not a multiple of 16
    cm = bc.column_major_codes(row_major, 3)
    with pytest.raises(TypeError):
        bc.table_counts(cm.long(), 10, specs)
    with pytest.raises(ValueError):
        bc.table_counts(cm, 10, bc.table_specs([[2]], [[3]]))  # no such column
    with pytest.raises(TypeError):
        bc.table_counts(cm, 10, specs, torch.ones(10, dtype=torch.int32))
    with pytest.raises(ValueError):
        bc.table_counts_cuda(cm, 10, specs)  # a CPU tensor never reaches the kernel


def test_cpu_dispatch_launches_nothing():
    codes, col_lists, card_lists = _op_inputs(4)
    cm = bc.column_major_codes(torch.from_numpy(codes), 5)
    bc.reset_launches()
    bc.table_counts(cm, codes.shape[0], bc.table_specs(col_lists, card_lists))
    assert (bc.LAUNCHES, bc.TABLE_LAUNCHES) == (0, 0)


# (n_rows, sizes, n_specs, code_bytes, elem_bytes): a MUNIN-like fit, single histograms
# at the shapes the GPU smoke run times, and tables too large for shared memory
# The last entry says which tables are built in shared memory: not the ones
# beyond the budget (100,000 rows x 20,000 f64 bins) or with more bins than a
# tile has rows.
PLANS = [
    (50_000, [4, 60, 600, 21, 2, 540], 1041, 1, 4, [True] * 6),
    (50_000, [600], 1, 4, 4, [True]),
    (1_000_003, [600], 1, 4, 4, [True]),
    (1_000_003, [200_000], 1, 8, 4, [False]),
    (100_000, [20_000], 1, 4, 8, [False]),
    (100_000, [10_000], 1, 4, 4, [True]),
    (5000, [1], 1, 4, 4, [True]),
    (100, [600], 1, 4, 4, [False]),
    (50_000, [160_000, 8], 2, 2, 4, [False, True]),
]


@pytest.mark.parametrize("n_rows,sizes,n_specs,code,elem,in_shared", PLANS)
def test_launch_plan_covers_rows_and_fits_shared_memory(n_rows, sizes, n_specs, code, elem, in_shared):
    sizes = np.asarray(sizes, dtype=np.int64)
    tiles, rows, repl = bc._plan_tiles(sizes, n_rows, n_specs, code, elem, 132)
    assert (repl >= 0).tolist() == in_shared
    assert (rows % 16 == 0).all()  # 16-byte loads of int8 codes
    assert (tiles >= 1).all() and tiles.max() <= 65535  # gridDim.y
    assert (tiles * rows >= n_rows).all() and ((tiles - 1) * rows < n_rows).all()
    shared = repl >= 0
    assert (repl[shared] <= 5).all()
    assert ((sizes[shared] << repl[shared]) * elem <= bc.SHARED_BUDGET_BYTES).all()
    assert (sizes[shared] <= rows[shared]).all()  # no more bins than rows in a tile
    assert bc._shared_bytes(sizes, repl, elem) <= bc.SHARED_BUDGET_BYTES


def test_launch_plan_of_the_fit_shape():
    """50,000 rows x 600 bins, one histogram: shared memory, one pass of a
    block per tile, and no more histogram entries than the tile has rows."""
    tiles, rows, repl = bc._plan_tiles(np.array([600]), 50_000, 1, 4, 4, 132)
    assert repl[0] >= 0 and rows[0] == 1024
    assert tiles[0] * (600 << repl[0]) <= 50_000 + 16 * tiles[0]
