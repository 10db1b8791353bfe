"""K2 on the card: the junction-tree calibration kernels of
``csrc/jt_calibrate.cu`` against their plain PyTorch version on the same card,
and their launch counter.  Every test here needs a CUDA device and skips
without one; on a GPU machine:
``python -m pytest tests/test_torch_jt_kernel_cuda.py -m cuda``.

Tolerances: both sides multiply in the same order within a wave; the kernels
sum in float64 and the plain version in the tables' type, so float32 results
agree to rtol 1e-5 (atol 1e-7) and float64 ones to rtol 1e-12 (atol 1e-15)."""

import numpy as np
import pytest
import torch

from pgmpy_tpu_torch.inference.bp import JunctionTreeProgram
from pgmpy_tpu_torch.ops import jt
from pgmpy_tpu_torch.utils import get_example_model

TOL = {torch.float32: dict(rtol=1e-5, atol=1e-7), torch.float64: dict(rtol=1e-12, atol=1e-15)}


def _tables(name, normalize, dtype, seed=0, suffix=""):
    """(factor scopes, cardinalities, factor tables on the card) of a network's
    CPDs; with ``normalize`` the tables are scaled by random positive factors."""
    factors = [cpd.to_factor() for cpd in get_example_model(name).get_cpds()]
    scopes = [[v + suffix for v in f.variables] for f in factors]
    cards = {v + suffix: int(c) for f in factors for v, c in zip(f.variables, f.cardinality)}
    rng = np.random.default_rng(seed)
    arrays = [f.values.to(device="cuda", dtype=dtype)
              * (float(rng.uniform(0.25, 4.0)) if normalize else 1.0) for f in factors]
    return scopes, cards, arrays


def _wide_tables(normalize, dtype, seed=0):
    """One clique of 18 binary axes beside three small ones: a tree wider than
    MUNIN's, laid out at the kernels' 24-axis width."""
    names = [f"W{i:02d}" for i in range(21)]
    scopes = [names[:18], [names[0], names[18]], [names[17], names[19]], [names[18], names[20]]]
    rng = np.random.default_rng(seed)
    arrays = [torch.from_numpy(rng.random((2,) * len(s))).to(device="cuda", dtype=dtype)
              * (float(rng.uniform(0.25, 4.0)) if normalize else 1.0) for s in scopes]
    return scopes, {v: 2 for v in names}, arrays


def _split_tables(normalize, dtype, seed=0):
    """One clique of 4^10 = 1,048,576 entries (ten 4-state axes) beside two
    small ones: its messages onto 4-entry sepsets are cut into chunks."""
    names = [f"S{i:02d}" for i in range(12)]
    scopes = [names[:10], [names[0], names[10]], [names[9], names[11]]]
    rng = np.random.default_rng(seed)
    arrays = [torch.from_numpy(rng.random((4,) * len(s))).to(device="cuda", dtype=dtype)
              * (float(rng.uniform(0.25, 4.0)) if normalize else 1.0) for s in scopes]
    return scopes, {v: 4 for v in names}, arrays


def _case(name, normalize, dtype):
    """(program, factor tables); "forest" is ASIA beside a renamed CANCER,
    "wide" a clique of 18 axes (the kernels' 24-axis instances), "split" a
    clique of 1 M entries whose messages are cut into chunks."""
    if name == "split":
        scopes, cards, arrays = _split_tables(normalize, dtype)
    elif name == "wide":
        scopes, cards, arrays = _wide_tables(normalize, dtype)
    elif name == "forest":
        a = _tables("asia", normalize, dtype)
        b = _tables("cancer", normalize, dtype, seed=1, suffix="_2")
        scopes, cards, arrays = a[0] + b[0], {**a[1], **b[1]}, a[2] + b[2]
    else:
        scopes, cards, arrays = _tables(name, normalize, dtype)
    return JunctionTreeProgram.from_factors(scopes, cards, normalize_messages=normalize), arrays


@pytest.mark.cuda
class TestCudaKernels:
    """The hand-written kernels against the plain version, on the card."""

    @pytest.fixture(autouse=True)
    def _needs_card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("normalize", [False, True])
    @pytest.mark.parametrize("operation", ["marginalize", "maximize"])
    @pytest.mark.parametrize("name", ["asia", "alarm", "insurance", "child", "forest", "wide",
                                      "split"])
    def test_kernels_match_plain(self, name, operation, normalize, dtype):
        program, arrays = _case(name, normalize, dtype)
        plan = program.wave_plan()
        assert plan.width == (jt.WIDTHS[1] if name == "wide" else jt.WIDTHS[0])
        jt.reset_launches()
        arena, sepsets = jt.calibrate_waves(plan, arrays, operation, normalize)
        assert jt.JT_LAUNCHES == 1 + 2 * plan.n_waves
        assert jt.LAUNCHES == {"clique_potentials": 1, "sepset_wave": plan.n_waves,
                               "absorb_wave": plan.n_waves}
        ref_arena, ref_sepsets = jt.calibrate_waves_reference(plan, arrays, operation, normalize)
        torch.cuda.synchronize()
        assert arena.dtype == dtype and arena.is_cuda
        torch.testing.assert_close(arena, ref_arena, **TOL[dtype])
        torch.testing.assert_close(sepsets, ref_sepsets, **TOL[dtype])
        assert bool(torch.isfinite(arena).all())

    @pytest.mark.parametrize("normalize", [False, True])
    @pytest.mark.parametrize("operation", ["marginalize", "maximize"])
    def test_split_messages_same_run_to_run(self, operation, normalize):
        """Messages cut into chunks combine their partials in a fixed order:
        two calibrations are equal to the bit, and agree with the plain
        version; the tickets are left at 0."""
        program, arrays = _case("split", normalize, torch.float32)
        plan = program.wave_plan()
        assert (plan.messages[:, jt.MSG_CHUNKS] > 1).any()
        first = jt.calibrate_waves(plan, arrays, operation, normalize)
        again = jt.calibrate_waves(plan, arrays, operation, normalize)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, again))
        tickets = plan.device_tables[first[0].device]["tickets"]
        assert all(int(t.abs().sum()) == 0 for t in tickets.values())
        ref = jt.calibrate_waves_reference(plan, arrays, operation, normalize)
        for got, want in zip(first, ref):
            torch.testing.assert_close(got, want, **TOL[torch.float32])

    def test_same_result_run_to_run(self):
        program, arrays = _case("alarm", False, torch.float32)
        first = [b.clone() for b in program.calibrate(arrays)[0]]
        again = program.calibrate(arrays)[0]
        assert all(torch.equal(a, b) for a, b in zip(first, again))

    def test_belief_propagation_on_the_card(self):
        """BeliefPropagation on the card launches the kernels and agrees with
        its own CPU run."""
        from pgmpy_tpu_torch.config import config
        from pgmpy_tpu_torch.inference import BeliefPropagation

        previous = config.DEVICE
        try:
            config.set_device("cuda")
            bp = BeliefPropagation(get_example_model("alarm"))
            before = jt.JT_LAUNCHES
            gpu = bp.query(["HISTORY"], evidence={"CVP": "LOW", "HR": "HIGH"})
            assert jt.JT_LAUNCHES > before
            config.set_device("cpu")
            cpu = BeliefPropagation(get_example_model("alarm")).query(
                ["HISTORY"], evidence={"CVP": "LOW", "HR": "HIGH"})
        finally:
            config.set_device(previous)
        np.testing.assert_allclose(gpu.values.cpu().numpy(), cpu.values.numpy(), atol=1e-5)

    def test_refuses_other_types(self):
        program, arrays = _case("asia", False, torch.float32)
        with pytest.raises(TypeError):
            jt.calibrate_waves_cuda(program.wave_plan(), [a.half() for a in arrays])
