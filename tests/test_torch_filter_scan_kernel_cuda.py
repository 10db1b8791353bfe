"""K10 on the card: ``forward_scan``'s one ``filter_scan`` launch
(``csrc/einsum_plan.cu``) against the plain version (the host loop of plain
planned contractions, ``DBNInference._forward_scan(..., kernel=False)``) on
the same card, and its launch counter.  Every test here needs a CUDA device
and skips without one; on a GPU machine:
``python -m pytest tests/test_torch_filter_scan_kernel_cuda.py -m cuda``.

The kernel folds the evidence into its steps (an observed label pinned to
the slice's code) and runs each slice level by level; the plain version
multiplies one-hot deltas.  Tolerances: float32 marginals at atol 1e-5 (the
kernel sums in float64, the plain version in float32, and alpha carries the
difference on from slice to slice); float64 at 1e-12."""

import numpy as np
import pytest
import torch

from _torch_parity import random_2tbn
from pgmpy_tpu_torch.config import config
from pgmpy_tpu_torch.inference import DBNInference
from pgmpy_tpu_torch.ops import einsum as E
from pgmpy_tpu_torch.utils.interop import dbn_from_numpy

ATOL = {"float32": 1e-5, "float64": 1e-12}


@pytest.fixture
def on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    previous, dtype = config.DEVICE, config.DTYPE
    config.set_device("cuda")
    E.reset_launches()
    try:
        yield
    finally:
        config.set_device(previous)
        config.set_dtype(dtype)


def rain(emission=((0.8, 0.1), (0.2, 0.9)), transition=((0.7, 0.3), (0.3, 0.7))):
    states = {("rain", t): ["dry", "wet"] for t in (0, 1)}
    states.update({("umbrella", t): ["no", "yes"] for t in (0, 1)})
    emission, transition = np.asarray(emission), np.asarray(transition)

    def names(*keys):
        return {k: states[k] for k in keys}

    tuples = [(("rain", 0), 2, np.array([[0.5], [0.5]]), [], [], names(("rain", 0))),
              (("umbrella", 0), 2, emission, [("rain", 0)], [2],
               names(("umbrella", 0), ("rain", 0))),
              (("rain", 1), 2, transition, [("rain", 0)], [2], names(("rain", 1), ("rain", 0))),
              (("umbrella", 1), 2, emission, [("rain", 1)], [2],
               names(("umbrella", 1), ("rain", 1)))]
    return dbn_from_numpy([(("rain", 0), ("umbrella", 0)), (("rain", 0), ("rain", 1))], tuples)


def model(name):
    return rain() if name == "rain" else dbn_from_numpy(*random_2tbn(int(name[6:]), n_vars=7))


def names_of(dbn):
    return sorted({v for v, _ in dbn.nodes()})


def check_same(got, want, atol):
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=atol, rtol=0, err_msg=str(key))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", ["rain", "random0", "random1", "random2", "random3"])
def test_kernel_matches_plain_with_one_launch(on_cuda, name, dtype):
    config.set_dtype(dtype)
    dbn = model(name)
    variables = names_of(dbn)
    rng = np.random.default_rng(4)
    evidence = {(v, t): int(rng.integers(2)) for t in range(40) for v in variables
                if rng.random() < 0.2}
    infer = DBNInference(dbn)
    before = E.SCAN_LAUNCHES
    got = infer.forward_scan(variables, evidence, n_time_slices=40)
    assert E.SCAN_LAUNCHES == before + 1
    want = infer._forward_scan(variables, evidence, 40, kernel=False)
    assert E.SCAN_LAUNCHES == before + 1
    check_same(got, want, ATOL[dtype])
    assert all(v.dtype == np.dtype(dtype) for v in got.values())


@pytest.mark.cuda
@pytest.mark.parametrize("setting", ["global_arena", "unmerged", "global_tables"])
def test_other_layouts(on_cuda, monkeypatch, setting):
    """The arena in global memory when it would not fit the shared budget;
    each output's own plan when the joint would pass ``SCAN_JOINT``, with
    the slice-0 contractions on ``plan_grid`` (``BLOCK_UNION`` 1); the step
    tables read from global memory when they would pass
    ``SCAN_STAGE_BYTES``."""
    if setting == "global_arena":
        monkeypatch.setattr(E, "SHARED_ARENA_BYTES", 0)
    elif setting == "global_tables":
        monkeypatch.setattr(E, "SCAN_STAGE_BYTES", 0)
    else:
        monkeypatch.setattr(E, "SCAN_JOINT", 1)
        monkeypatch.setattr(E, "BLOCK_UNION", 1)
        E.plan_table.cache_clear()  # the slice-0 contractions' tables follow the limit too
    dbn = model("random1")
    variables = names_of(dbn)
    infer = DBNInference(dbn)
    evidence = {(variables[0], 3): 1}
    got = infer.forward_scan(variables, evidence, n_time_slices=12)
    programs = list(infer._scan_programs.values())
    assert programs and all(p.shared == (setting != "global_arena") for p in programs)
    assert all(p.layout((0,))[0] == (setting != "global_tables") for p in programs)
    assert all(p.merged == (setting != "unmerged") for p in programs)
    check_same(got, infer._forward_scan(variables, evidence, 12, kernel=False), 1e-5)
    E.plan_table.cache_clear()


@pytest.mark.cuda
def test_impossible_evidence_gives_nan_as_the_plain_version(on_cuda):
    """A normalising sum of 0 gives NaN, not a clamp."""
    dbn = rain(emission=((1.0, 0.0), (0.0, 1.0)), transition=((1.0, 0.0), (0.0, 1.0)))
    evidence = {("umbrella", 2): 1, ("umbrella", 3): 0}
    infer = DBNInference(dbn)
    got = infer.forward_scan(["rain"], evidence, n_time_slices=6)
    want = infer._forward_scan(["rain"], evidence, 6, kernel=False)
    for t in range(3, 6):
        assert np.isnan(want[("rain", t)]).all() and np.isnan(got[("rain", t)]).all()
    check_same({k: v for k, v in got.items() if k[1] < 3},
               {k: v for k, v in want.items() if k[1] < 3}, 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("observed", ["V0", "V3"])
def test_slice0_interface_evidence(on_cuda, observed):
    dbn = model("random0")
    variables = names_of(dbn)
    evidence = {(observed, 0): 1, (variables[-1], 4): 0}
    infer = DBNInference(dbn)
    got = infer.forward_scan(variables, evidence, n_time_slices=10)
    check_same(got, infer._forward_scan(variables, evidence, 10, kernel=False), 1e-5)
    assert got[(observed, 0)][1] == 1.0


@pytest.mark.cuda
def test_launches_do_not_grow_with_the_horizon(on_cuda):
    from torch.profiler import ProfilerActivity, profile

    dbn = model("random2")
    variables = names_of(dbn)
    infer = DBNInference(dbn)
    counts = []
    for n in (2, 2, 30):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            infer.forward_scan(variables, {(variables[0], 1): 0}, n_time_slices=n)
            torch.cuda.synchronize()
        counts.append(sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events()))
    # a profiling session can lose device records: the longer call never
    # shows more than the warm short one
    assert counts[2] <= max(counts[:2])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_rain_at_200_slices(on_cuda, dtype):
    """The smoke's rain / umbrella filter: 200 slices, the umbrella observed
    in every third, one launch, against the plain version."""
    config.set_dtype(dtype)
    dbn = rain()
    evidence = {("umbrella", t): t % 2 for t in range(0, 200, 3)}
    infer = DBNInference(dbn)
    before = E.SCAN_LAUNCHES
    got = infer.forward_scan(["rain"], evidence, n_time_slices=200)
    assert E.SCAN_LAUNCHES == before + 1
    want = infer._forward_scan(["rain"], evidence, 200, kernel=False)
    check_same(got, want, ATOL[dtype])
    program = next(iter(infer._scan_programs.values()))
    assert 1 <= program.n_levels <= len(program.steps)


@pytest.mark.cuda
def test_run_to_run_and_unobserved_evidence(on_cuda):
    """The same call twice gives equal marginals (no atomics: a fixed order),
    and a call with no evidence after slice 0 runs the unpinned rows."""
    dbn = model("random3")
    variables = names_of(dbn)
    infer = DBNInference(dbn)
    evidence = {(variables[1], t): 0 for t in range(1, 20, 4)}
    first = infer.forward_scan(variables, evidence, n_time_slices=20)
    again = infer.forward_scan(variables, evidence, n_time_slices=20)
    for key in first:
        np.testing.assert_array_equal(first[key], again[key])
    bare = infer.forward_scan(variables, {}, n_time_slices=20)
    check_same(bare, infer._forward_scan(variables, {}, 20, kernel=False), ATOL["float32"])
