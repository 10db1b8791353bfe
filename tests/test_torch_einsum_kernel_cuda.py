"""K3 on the card: ``plan_block`` and ``plan_grid`` (``csrc/einsum_plan.cu``)
against the plain version (``sum_product_reference``: one ``torch.einsum``
per plan step) on the same card, the dispatch of ``sum_product_planned`` and
its launch counters.  Every test here needs a CUDA device and skips without
one; on a GPU machine:
``python -m pytest tests/test_torch_einsum_kernel_cuda.py -m cuda``.

Tolerances: float32 at rtol 1e-5 / atol 1e-6 (the kernel sums in float64,
the plain version in float32, over at most a few thousand products of
numbers in [0.1, 1.1]); float64 at rtol 1e-12."""

import numpy as np
import pytest
import torch

from _torch_einsum_walk import random_signature
from pgmpy_tpu_torch.ops import einsum as E

SEEDS = range(16)
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6), torch.float64: dict(rtol=1e-12, atol=0)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    E.reset_launches()
    return torch.device("cuda")


def forced(axes, out, tensors, schedule):
    shapes = tuple(tuple(t.shape) for t in tensors)
    strides = tuple(tuple(t.stride()) for t in tensors)
    axes = tuple(tuple(ax) for ax in axes)
    plan = E.contraction_plan(axes, tuple(out), shapes)
    table = E.PlanTable(axes, tuple(out), shapes, strides, tensors[0].element_size(), plan,
                        schedule=schedule)
    return E.launch_plan(table, tensors)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("schedule", ["plan_block", "plan_grid"])
@pytest.mark.parametrize("batch", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_schedule_matches_plain(cuda, seed, batch, schedule, dtype):
    axes, out, arrays = random_signature(seed, batch)
    tensors = [torch.tensor(a, dtype=dtype, device=cuda) for a in arrays]
    got = forced(axes, out, tensors, schedule)
    want = E.sum_product_reference(axes, out, tensors)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape and got.device == want.device
    torch.testing.assert_close(got, want, **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["plan_block", "plan_grid"])
@pytest.mark.parametrize("case", ["transposed", "broadcast", "scalar_only", "copy", "permute",
                                  "diagonal", "zero_output", "zero_reduced", "one_operand_sum",
                                  "long_reduction", "many_operands", "many_outputs",
                                  "query_batch"])
def test_edge_cases(cuda, case, schedule):
    gen = torch.Generator(device="cuda").manual_seed(0)

    def t(*shape):
        return torch.rand(shape, generator=gen, device=cuda, dtype=torch.float64) + 0.1

    axes, out, tensors = {
        "transposed": ([(0, 1), (1, 2)], (2, 0), [t(4, 3).t(), t(4, 5)]),
        "broadcast": ([(0, 1), (1, 2)], (2, 0), [t(1, 4).expand(3, 4), t(4, 5)]),
        "scalar_only": ([(), ()], (), [t(), t()]),
        "copy": ([(0, 1)], (0, 1), [t(3, 4)]),
        "permute": ([(0, 1, 2)], (2, 0, 1), [t(2, 3, 4)]),
        "diagonal": ([(0, 0), (0, 1)], (1,), [t(3, 3), t(3, 2)]),
        "zero_output": ([(5, 1, 2), (2, 3), (3,)], (1,), [t(3, 0, 4), t(4, 5), t(5)]),
        "zero_reduced": ([(5, 1, 2), (2, 3), (3,)], (5,), [t(3, 4, 0), t(0, 5), t(5)]),
        "one_operand_sum": ([(0, 1, 2)], (1,), [t(30, 3, 40)]),
        # 3 outputs, 141,120 reduced entries each: lanes over the block
        "long_reduction": ([(0, 1, 2), (1, 2)], (0,), [t(3, 336, 420), t(336, 420)]),
        # past the parameter block's MAX_OPERANDS pointers
        "many_operands": ([(i, i + 1) for i in range(E.MAX_OPERANDS + 20)],
                          (0, E.MAX_OPERANDS + 20), [t(2, 2) for _ in range(E.MAX_OPERANDS + 20)]),
        # 1,000,000 outputs of 4 reduced entries: more tasks than the grid's
        # threads, so each thread strides over several rounds
        "many_outputs": ([(0, 1), (1, 2)], (0, 2), [t(1000, 4), t(4, 1000)]),
        # the shape of a 2,048-row MUNIN query_batch: a batch label on the
        # evidence, unions of ~10^6 entries over a chain of steps
        "query_batch": ([(9, 0), (0, 1, 2), (1, 2, 3, 4), (3, 4, 5), (5, 6)], (9, 6),
                        [t(2048, 4), t(4, 6, 6), t(6, 6, 9, 4), t(9, 4, 5), t(5, 3)]),
    }[case]
    if case == "many_operands":
        tensors = [x / x.sum(0, keepdim=True) for x in tensors]  # no overflow along the chain
    got = forced(axes, out, tensors, schedule)
    want = E.sum_product_reference(axes, out, tensors)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-300)


@pytest.mark.cuda
def test_dispatch_and_launch_counts(cuda, monkeypatch):
    rng = np.random.default_rng(1)
    small = [torch.tensor(rng.random(s), device=cuda) for s in ((4, 8), (8, 16), (16,))]
    got = E.sum_product_planned([(0, 1), (1, 2), (2,)], (0,), small)
    assert E.LAUNCHES == {"plan_block": 1, "plan_grid": 0}
    torch.testing.assert_close(got, E.sum_product_reference([(0, 1), (1, 2), (2,)], (0,), small),
                               rtol=1e-12, atol=0)
    big = [torch.tensor(rng.random(s), device=cuda) for s in ((3, 300, 400), (300, 400), (400,))]
    axes = [(0, 1, 2), (1, 2), (2,)]
    steps = len(E.contraction_plan(tuple(axes), (0,), ((3, 300, 400), (300, 400), (400,))))
    got = E.sum_product_planned(axes, (0,), big)
    assert steps > 1 and E.LAUNCHES == {"plan_block": 1, "plan_grid": 1}
    torch.testing.assert_close(got, E.sum_product_reference(axes, (0,), big), rtol=1e-12, atol=0)
    # the intermediates in global memory instead of shared
    monkeypatch.setattr(E, "SHARED_ARENA_BYTES", 0)
    E.plan_table.cache_clear()
    got = E.sum_product_planned([(0, 1), (1, 2), (2,)], (0,), small)
    torch.testing.assert_close(got, E.sum_product_reference([(0, 1), (1, 2), (2,)], (0,), small),
                               rtol=1e-12, atol=0)
    E.plan_table.cache_clear()
    assert E.LAUNCHES["plan_block"] == 2 and E.SCAN_LAUNCHES == 0


@pytest.mark.cuda
def test_refusals(cuda):
    n = E.MAX_LABELS + 1
    first = torch.rand((2,) * n, device=cuda)
    second = first.permute(*reversed(range(n)))
    with pytest.raises(ValueError, match="MAX_LABELS"):
        E.sum_product_planned([tuple(range(n)), tuple(range(n))], (), [first, second])
    with pytest.raises(TypeError):
        E.sum_product_planned([(0,)], (0,), [torch.ones(3, dtype=torch.int64, device=cuda)])
    with pytest.raises(ValueError):
        E.sum_product_planned([(0,), (0,)], (0,), [torch.ones(3, device=cuda),
                                                   torch.ones(3, dtype=torch.float64, device=cuda)])
