"""K1 on the card: both entry points of the hand-written CUDA kernel
(``weighted_bincount`` and ``table_counts``) against their plain PyTorch
versions, and their launch counters.  Every test here needs a CUDA device and
skips without one; on a GPU machine:
``python -m pytest tests/test_torch_bincount_cuda.py -m cuda``.

Tolerances: unweighted counts must be exact (``table_counts`` counts in
int32; ``weighted_bincount`` sums integer-valued f32 below 2^24); weighted
f32 sums are accumulated by atomics in a run-dependent order, so they agree
to rtol 1e-5 (``table_counts`` against the plain version on f64 copies of the
weights, so that only the kernel's rounding is measured)."""

import numpy as np
import pytest
import torch

from pgmpy_tpu_torch.ops import bincount as bc


@pytest.mark.cuda
class TestCudaKernel:
    """The hand-written kernel against the plain version, on the card."""

    @pytest.fixture(autouse=True)
    def _needs_card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")

    @pytest.mark.parametrize("n,length", [(50_000, 600), (1_000_003, 600), (1_000_003, 200_000),
                                          (5000, 1), (1537, 300)])
    @pytest.mark.parametrize("weighted", [False, True])
    def test_kernel_matches_plain(self, n, length, weighted):
        gen = torch.Generator(device="cuda").manual_seed(n)
        idx = torch.randint(0, length + 1, (n,), generator=gen, device="cuda", dtype=torch.int32)
        w = (torch.rand(n, generator=gen, device="cuda") if weighted
             else torch.ones(n, device="cuda"))
        before = bc.LAUNCHES
        got = bc.weighted_bincount(idx, w, length)
        assert bc.LAUNCHES == before + 1
        ref = bc.weighted_bincount_reference(idx, w, length)
        torch.cuda.synchronize()
        if weighted:
            torch.testing.assert_close(got, ref, rtol=1e-5, atol=0)
        else:
            assert torch.equal(got, ref)

    @pytest.mark.parametrize("length", [600, 20_000])  # shared-memory and global paths
    def test_f64_int64(self, length):
        gen = torch.Generator(device="cuda").manual_seed(1)
        idx = torch.randint(-1, length + 1, (100_000,), generator=gen, device="cuda",
                            dtype=torch.int64)
        w = torch.rand(100_000, generator=gen, device="cuda", dtype=torch.float64)
        got = bc.weighted_bincount_cuda(idx, w, length)
        torch.testing.assert_close(got, bc.weighted_bincount_reference(idx, w, length))


def _table_case(n_rows, cards, col_lists, seed, missing=0.0):
    rng = np.random.default_rng(seed)
    codes = np.stack([rng.integers(0, c, n_rows) for c in cards], axis=1).astype(np.int32)
    if missing:
        codes[rng.random(codes.shape) < missing] = -1
    cm = bc.column_major_codes(torch.from_numpy(codes).cuda(), max(cards))
    specs = bc.table_specs(col_lists, [[cards[c] for c in cols] for cols in col_lists])
    return cm, specs


FAMILIES = [[0], [1, 0], [2, 0, 1], [3, 2], [4, 3, 1, 0], [5], [5, 4]]


@pytest.mark.cuda
class TestTableCountKernel:
    """One launch for a whole spec list, against the plain version."""

    @pytest.fixture(autouse=True)
    def _needs_card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")

    @pytest.mark.parametrize("n_rows", [1, 15, 4097, 50_000, 1_000_003])
    @pytest.mark.parametrize("cards", [(2, 3, 4, 5, 6, 21), (2, 3, 4, 5, 6, 300), (2, 3, 4, 5, 6, 40_000)],
                             ids=["int8", "int16", "int32"])
    @pytest.mark.parametrize("missing", [0.0, 0.1])
    def test_unweighted_is_exact(self, n_rows, cards, missing):
        cm, specs = _table_case(n_rows, cards, FAMILIES, seed=n_rows, missing=missing)
        bc.reset_launches()
        got = bc.table_counts(cm, n_rows, specs)
        torch.cuda.synchronize()
        assert (bc.TABLE_LAUNCHES, bc.LAUNCHES) == (1, 0)
        assert got.dtype == torch.int32
        assert torch.equal(got, bc.table_counts_reference(cm, n_rows, specs))

    @pytest.mark.parametrize("n_rows", [15, 50_000, 1_000_003])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    def test_weighted(self, n_rows, dtype):
        cm, specs = _table_case(n_rows, (2, 3, 4, 5, 6, 21), FAMILIES, seed=n_rows, missing=0.05)
        gen = torch.Generator(device="cuda").manual_seed(n_rows)
        w = torch.rand(n_rows, generator=gen, device="cuda", dtype=dtype)
        got = bc.table_counts(cm, n_rows, specs, w)
        torch.cuda.synchronize()
        assert got.dtype == dtype
        ref = bc.table_counts_reference(cm, n_rows, specs, w.double())
        torch.testing.assert_close(got.double(), ref, rtol=1e-5 if dtype == torch.float32 else 1e-12,
                                   atol=0)

    def test_many_specs_one_launch(self):
        cm, specs = _table_case(20_000, (2, 3, 4, 5, 6, 21), FAMILIES * 300, seed=0)
        bc.reset_launches()
        got = bc.table_counts(cm, 20_000, specs)
        torch.cuda.synchronize()
        assert bc.TABLE_LAUNCHES == 1
        assert torch.equal(got, bc.table_counts_reference(cm, 20_000, specs))

    @pytest.mark.parametrize("n_cond", [1, 2])
    def test_pc_level_shape(self, n_cond):
        """A PC level: hundreds of (X, Y, Z...) specs of 3-4 columns over
        37 ALARM-like columns (cardinalities 2-4) and 50,000 rows, in one
        launch, equal to the plain version."""
        rng = np.random.default_rng(n_cond)
        cards = tuple(int(c) for c in rng.integers(2, 5, 37))
        col_lists = [list(rng.choice(37, 2 + n_cond, replace=False)) for _ in range(600)]
        cm, specs = _table_case(50_000, cards, col_lists, seed=n_cond, missing=0.01)
        bc.reset_launches()
        got = bc.table_counts(cm, 50_000, specs)
        torch.cuda.synchronize()
        assert bc.TABLE_LAUNCHES == 1
        assert torch.equal(got, bc.table_counts_reference(cm, 50_000, specs))

    def test_table_beyond_shared_memory(self):
        # [5, 4] has 21 * 40,000 = 840,000 bins and [5] has 40,000: global
        # atomics; the small tables are built in shared memory beside them
        cm, specs = _table_case(100_000, (2, 3, 4, 5, 21, 40_000), [[5, 4], [0], [3, 2, 1], [5]], seed=1)
        got = bc.table_counts_cuda(cm, 100_000, specs)
        torch.cuda.synchronize()
        assert torch.equal(got, bc.table_counts_reference(cm, 100_000, specs))

    def test_empty_spec_list_launches_nothing(self):
        cm, _ = _table_case(100, (2, 3), [[0]], seed=0)
        bc.reset_launches()
        got = bc.table_counts(cm, 100, bc.table_specs([], []))
        assert got.numel() == 0 and bc.TABLE_LAUNCHES == 0

    def test_counters_are_separate_and_reset(self):
        cm, specs = _table_case(1000, (2, 3), [[0], [1, 0]], seed=0)
        bc.reset_launches()
        bc.table_counts(cm, 1000, specs)
        bc.weighted_bincount(torch.zeros(10, dtype=torch.int32, device="cuda"),
                             torch.ones(10, device="cuda"), 3)
        bc.weighted_bincount(torch.zeros(10, dtype=torch.int32, device="cuda"),
                             torch.ones(10, device="cuda"), 3)
        assert (bc.TABLE_LAUNCHES, bc.LAUNCHES) == (1, 2)
        bc.reset_launches()
        assert (bc.TABLE_LAUNCHES, bc.LAUNCHES) == (0, 0)

    def test_coded_data_runs_on_the_kernel(self):
        import pandas as pd

        from pgmpy_tpu_torch.config import config
        from pgmpy_tpu_torch.estimators.base import _CodedData

        rng = np.random.default_rng(0)
        df = pd.DataFrame({c: rng.integers(0, 4, 5000).astype(str) for c in "ABCD"})
        previous = config.DEVICE
        config.set_device("cuda")
        try:
            coded = _CodedData(df)
            bc.reset_launches()
            tables = coded.multi_counts_padded([("A", ()), ("B", ("A",)), ("D", ("B", "C"))])
            on_device = coded.counts("B", ("A",), device=True)
        finally:
            config.set_device(previous)
        assert bc.TABLE_LAUNCHES == 2 and coded.n_dispatches == 2
        assert on_device.device.type == "cuda"
        np.testing.assert_array_equal(on_device.cpu().numpy(), tables[1])
        a, b = df["A"].astype(int).to_numpy(), df["B"].astype(int).to_numpy()
        np.testing.assert_array_equal(tables[1], np.bincount(b * 4 + a, minlength=16).reshape(4, 4))
