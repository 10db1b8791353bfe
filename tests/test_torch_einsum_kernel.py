"""The planned contraction (K3) on the CPU, and what a CPU test can see of its
CUDA route (``csrc/einsum_plan.cu``): the step tables ``plan_block`` and
``plan_grid`` read, walked in numpy (``tests/_torch_einsum_walk.py``) against
the plain version, and the choice between the two schedules.

Tolerances: the plain version against ``pgmpy_tpu``'s jitted einsum in
float32 at atol 1e-5 / rtol 1e-5 (sums of a few hundred products in
another order); in float64 against numpy's einsum at 1e-12 (relative); the
numpy walk sums in float64, so it is held to the float64 plain version at
1e-12 (relative).  The kernels on a card: ``tests/test_torch_einsum_kernel_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_einsum_walk import random_signature, walk_plan
import _torch_parity  # noqa: F401  (sets the port to the CPU)
from pgmpy_tpu.ops.einsum import sum_product_planned as jax_sum_product_planned
from pgmpy_tpu_torch.ops import einsum as E

SEEDS = range(24)


def numpy_einsum(axes, out, arrays):
    dense = {a: i for i, a in enumerate(dict.fromkeys(a for ax in axes for a in ax))}
    args = []
    for arr, ax in zip(arrays, axes):
        args += [arr, [dense[a] for a in ax]]
    return np.einsum(*args, [dense[a] for a in out], optimize=True)


def table_of(axes, out, tensors, schedule=None):
    shapes = tuple(tuple(t.shape) for t in tensors)
    strides = tuple(tuple(t.stride()) for t in tensors)
    axes = tuple(tuple(ax) for ax in axes)
    plan = E.contraction_plan(axes, tuple(out), shapes)
    return E.PlanTable(axes, tuple(out), shapes, strides, 8, plan, schedule=schedule)


@pytest.mark.parametrize("batch", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_plain_matches_jax(seed, batch):
    axes, out, arrays = random_signature(seed, batch)
    got = E.sum_product_planned(axes, out, [torch.tensor(a, dtype=torch.float32) for a in arrays])
    want = jax_sum_product_planned(axes, out, [jnp.asarray(a, dtype=jnp.float32) for a in arrays])
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("seed", SEEDS)
def test_plain_float64_matches_numpy(seed):
    axes, out, arrays = random_signature(seed, batch=seed % 2 == 1)
    got = E.sum_product_planned(axes, out, [torch.tensor(a) for a in arrays])
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), numpy_einsum(axes, out, arrays), rtol=1e-12,
                               atol=0)


def test_more_than_52_labels():
    """A chain of 60 factors over 61 labels: more than torch.einsum's sublist
    form takes in one call; each step is renumbered."""
    rng = np.random.default_rng(3)
    axes = [(3 * i, 3 * i + 3) for i in range(60)]
    arrays = [rng.random((2, 2)) + 0.1 for _ in axes]
    out = (0, 180)
    got = E.sum_product_planned(axes, out, [torch.tensor(a, dtype=torch.float32) for a in arrays])
    want = jax_sum_product_planned(axes, out, [jnp.asarray(a, dtype=jnp.float32) for a in arrays])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    tensors = [torch.tensor(a) for a in arrays]
    walked = walk_plan(table_of(axes, out, tensors), tensors, (2, 2))
    np.testing.assert_allclose(walked, E.sum_product_planned(axes, out, tensors).numpy(),
                               rtol=1e-12)


@pytest.mark.parametrize("schedule", ["plan_block", "plan_grid"])
@pytest.mark.parametrize("batch", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_table_walk_matches_plain(seed, batch, schedule):
    axes, out, arrays = random_signature(seed, batch)
    tensors = [torch.tensor(a) for a in arrays]
    want = E.sum_product_planned(axes, out, tensors).numpy()
    got = walk_plan(table_of(axes, out, tensors, schedule), tensors, want.shape)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("schedule", ["plan_block", "plan_grid"])
@pytest.mark.parametrize("case", ["transposed", "broadcast", "scalar_only", "copy", "permute",
                                  "diagonal", "zero_output", "zero_reduced", "one_operand_sum"])
def test_table_walk_edge_cases(case, schedule):
    rng = np.random.default_rng(5)

    def t(*shape):
        return torch.tensor(rng.random(shape) + 0.1)

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
    }[case]
    want = E.sum_product_planned(axes, out, tensors).numpy()
    got = walk_plan(table_of(axes, out, tensors, schedule), tensors, want.shape)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_schedule_is_decided_from_the_plan():
    """The schedule follows ``BLOCK_UNION`` from the plan alone: one step of
    3 x m union entries, m on either side of ``BLOCK_UNION / 3``."""
    assert E.plan_table(((0, 1), (1, 2)), (2,), ((4, 8), (8, 16)), ((8, 1), (16, 1)),
                        4).schedule == "plan_block"
    for over in (False, True):
        m = E.BLOCK_UNION // 3 + (1 if over else 0)
        table = E.plan_table(((0, 1), (1,)), (0,), ((3, m), (m,)), ((m, 1), (1,)), 4)
        assert (int(table.unions.max()) > E.BLOCK_UNION) == over
        assert table.schedule == ("plan_grid" if over else "plan_block")
    # the long reduction is spread over a block's lanes, not 3 threads, and
    # the grid is what the largest step's tasks fill
    assert int(table.steps[-1, 8]) == E.step_lanes(3, m, E.GRID_THREADS, E.GRID_LANE_ENTRIES)
    assert table.grid == -(-3 * int(table.steps[-1, 8]) // E.GRID_THREADS)
    assert E.choose_schedule([E.BLOCK_UNION]) == "plan_block"
    assert E.choose_schedule([1, E.BLOCK_UNION + 1]) == "plan_grid"


@pytest.mark.parametrize("out_count,red_count,threads", [
    (1, 1, 512), (3, 141_120, 256), (3, 141_120, 512), (6144, 47_040, 256), (1_000_000, 4, 256),
    (5, 0, 512), (0, 9, 512), (100, 100, 512)])
def test_lanes(out_count, red_count, threads):
    lanes = E.step_lanes(out_count, red_count, threads)
    assert lanes >= 1 and lanes & (lanes - 1) == 0 and lanes <= threads
    assert lanes <= max(1, 1 << max(red_count - 1, 0).bit_length())
    if red_count >= threads * E.LANE_ENTRIES:
        assert lanes == threads


def test_too_many_labels_raise():
    """Thirteen reduced labels that no two tensors walk alike (the second
    operand's axes reversed): beyond MAX_LABELS after merging."""
    n = E.MAX_LABELS + 1
    first = tuple(range(n))
    second = tuple(reversed(range(n)))
    shapes = ((2,) * n, (2,) * n)
    strides = tuple(tuple(2 ** (n - 1 - k) for k in range(n)) for _ in range(2))
    with pytest.raises(ValueError, match="MAX_LABELS"):
        E.plan_table((first, second), (), shapes, strides, 4)


def test_merged_labels_stay_within_the_limit():
    """Twenty labels walked alike by both operands merge into one."""
    axes = (tuple(range(20)), tuple(range(20)))
    shapes = ((2,) * 20,) * 2
    strides = (tuple(2 ** (19 - k) for k in range(20)),) * 2
    table = E.plan_table(axes, (), shapes, strides, 8)
    assert int(table.steps[0, 5]) == 1  # one reduced label of 2^20 entries
    tensors = [torch.rand((2,) * 20, dtype=torch.float64) for _ in range(2)]
    got = walk_plan(table, tensors, ())
    np.testing.assert_allclose(got, E.sum_product_planned(axes, (), tensors).numpy(), rtol=1e-12)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """A CPU tensor never reaches the CUDA launcher."""
    def refuse(*args, **kwargs):
        raise AssertionError("the CUDA route ran for CPU tensors")

    monkeypatch.setattr(E, "_run_plan_cuda", refuse)
    E.reset_launches()
    got = E.sum_product(((0, 1), (1,)), (0,), torch.ones(2, 3), torch.ones(3))
    assert torch.equal(got, torch.full((2,), 3.0))
    assert E.LAUNCHES == {"plan_block": 0, "plan_grid": 0} and E.SCAN_LAUNCHES == 0


@pytest.mark.slow
def test_munin_query_contractions():
    """Every contraction of a MUNIN VariableElimination query and a
    BeliefPropagation query (captured from the port on the CPU): the plain
    version against ``pgmpy_tpu``'s einsum in float32, the table walk against
    the plain version in float64."""
    from pgmpy_tpu_torch.inference import VariableElimination, bp, ve
    from pgmpy_tpu_torch.utils import get_example_model

    calls = []

    def recording(axes, out, arrays, optimize="greedy"):
        calls.append((tuple(map(tuple, axes)), tuple(out), [a.detach().clone() for a in arrays]))
        return E.sum_product_planned(axes, out, arrays, optimize)

    model = get_example_model("munin")
    evidence = {v: model.states[v][0] for v in sorted(model.nodes())[:21]
                if not model.get_children(v)}
    query = sorted(model.nodes())[200]
    mp = pytest.MonkeyPatch()
    mp.setattr(ve, "sum_product_planned", recording)
    mp.setattr(bp, "sum_product_planned", recording)
    try:
        VariableElimination(model).query([query], evidence=evidence, show_progress=False)
        bp.BeliefPropagation(model).query([query], evidence=evidence, show_progress=False)
    finally:
        mp.undo()
    assert calls
    for axes, out, arrays in calls:
        f32 = E.sum_product_planned(axes, out, [a.float() for a in arrays])
        want = jax_sum_product_planned(axes, out, [jnp.asarray(a.float().numpy()) for a in arrays])
        np.testing.assert_allclose(f32.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
        f64 = [a.double() for a in arrays]
        plain = E.sum_product_planned(axes, out, f64).numpy()
        np.testing.assert_allclose(walk_plan(table_of(axes, out, f64), f64, plain.shape), plain,
                                   rtol=1e-12, atol=0)
