"""The model-parallel calibration on the card: every part of
``ShardedJunctionTreeCalibration`` runs K2's kernels (``csrc/jt_calibrate.cu``)
on its part plan.  Every test here needs a CUDA device and skips without
one; on a GPU machine:
``python -m pytest tests/test_torch_jt_mesh_kernel_cuda.py -m cuda``.

Tolerances: against the same part plans run through the plain version (on the
card or on the CPU) both sides multiply in one order and the kernels sum in
float64, as in ``tests/test_torch_jt_kernel_cuda.py``: rtol 1e-5 (atol 1e-7)
in float32, rtol 1e-12 (atol 1e-15) in float64.  Against the single-device
K2 path the products round in another order: rtol 1e-5 (atol 1e-6) in
float32, rtol 1e-11 (atol 1e-15) in float64."""

import numpy as np
import pytest
import torch

from pgmpy_tpu_torch.inference.bp import JunctionTreeProgram
from pgmpy_tpu_torch.ops import jt
from pgmpy_tpu_torch.parallel.jt_mesh import ShardedJunctionTreeCalibration
from pgmpy_tpu_torch.parallel.mesh import Mesh
from pgmpy_tpu_torch.utils import get_example_model

SAME_PLAN = {torch.float32: dict(rtol=1e-5, atol=1e-7),
             torch.float64: dict(rtol=1e-12, atol=1e-15)}
OTHER_PLAN = {torch.float32: dict(rtol=1e-5, atol=1e-6),
              torch.float64: dict(rtol=1e-11, atol=1e-15)}
CASES = [("alarm", 4), ("insurance", 8), ("alarm_markov", 4)]


def _case(name, dtype):
    """(program, factor tables on the CPU): a network's CPDs, or with
    ``alarm_markov`` random tables from a numpy seed on ALARM's scopes with
    normalised messages."""
    base = name.split("_")[0]
    factors = [cpd.to_factor() for cpd in get_example_model(base).get_cpds()]
    scopes = [list(f.variables) for f in factors]
    cards = {v: int(c) for f in factors for v, c in zip(f.variables, f.cardinality)}
    normalize = name.endswith("markov")
    if normalize:
        rng = np.random.default_rng(0)
        arrays = [torch.from_numpy(rng.random(tuple(f.cardinality)) * 50 + 0.1) for f in factors]
    else:
        arrays = [f.values for f in factors]
    program = JunctionTreeProgram.from_factors(scopes, cards, normalize_messages=normalize)
    return program, [a.to(dtype).cpu() for a in arrays]


def _chain(dtype):
    """Two one-clique parts, (x, y) and (y, z): boundary messages with no
    reduced axis."""
    rng = np.random.default_rng(3)
    program = JunctionTreeProgram.from_factors([["x", "y"], ["y", "z"]], {"x": 2, "y": 3, "z": 2},
                                               normalize_messages=True)
    return program, [torch.from_numpy(rng.random(s) * 4 + 0.1).to(dtype) for s in ((2, 3), (3, 2))]


def _close(got, want, tol):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.to(b.device), b, **tol)


@pytest.mark.cuda
class TestShardedOnTheCard:
    """Part plans on the card against their plain version and the
    single-device K2 path."""

    @pytest.fixture(autouse=True)
    def _needs_card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("name, n_parts", CASES)
    def test_parts_run_the_kernels(self, name, n_parts, dtype):
        program, host = _case(name, dtype)
        card = torch.device("cuda", 0)
        arrays = [a.to(card) for a in host]
        sharded = ShardedJunctionTreeCalibration(program, Mesh([card] * n_parts))
        jt.reset_launches()
        beliefs, mu = sharded.calibrate(arrays)
        waves = sum(p["plan"].n_waves for p in sharded.parts)
        assert jt.JT_LAUNCHES == sharded.launches() == sharded.n_parts + 2 * waves
        assert jt.LAUNCHES == {"clique_potentials": sharded.n_parts, "sepset_wave": waves,
                               "absorb_wave": waves}
        assert all(b.is_cuda and b.dtype == dtype for b in beliefs + mu)
        # the plain version of the same part plans, on the card and on the CPU
        jt.reset_launches()
        plain = sharded.calibrate(arrays, kernel=False)
        assert jt.JT_LAUNCHES == 0
        on_cpu = ShardedJunctionTreeCalibration(
            program, Mesh([torch.device("cpu")] * n_parts)).calibrate(host)
        torch.cuda.synchronize()
        for got in (plain, on_cpu):
            _close(beliefs, got[0], SAME_PLAN[dtype])
            _close(mu, got[1], SAME_PLAN[dtype])
        # the single-device program on the kernels
        ref_beliefs, ref_mu = program.calibrate(arrays)
        _close(beliefs, ref_beliefs, OTHER_PLAN[dtype])
        _close(mu, ref_mu, OTHER_PLAN[dtype])
        assert all(bool(torch.isfinite(b).all()) for b in beliefs + mu)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    def test_boundary_message_with_no_reduced_axis(self, dtype):
        """``sepset_wave`` on a message that reduces nothing (16 sepset
        entries a lane), normalised: the boundary clique's values over their
        sum, multiplied into the receiving clique; and two one-clique parts
        against the plain version."""
        program, host = _chain(dtype)
        card = torch.device("cuda", 0)
        arrays = [a.to(card) for a in host]
        sharded = ShardedJunctionTreeCalibration(program, Mesh([card] * 2))
        root = next(p for p in sharded.parts if p["out_up"] is None)
        plan = root["plan"]
        (_, recv, bc, e, _), = root["in_up"]
        m = next(m for m, s in enumerate(plan.message_specs) if s[:2] == (bc, recv))
        assert plan.messages[m, jt.MSG_NRED] == 0 and plan.messages[m, jt.MSG_REDUCED] == 1
        local = [arrays[i] for i in root["factor_ids"]]
        arena, sepsets = jt.stage0(plan, local, kernel=True)
        beliefs, mu = jt.arena_views(plan, arena, sepsets)
        stage = beliefs[recv].clone()
        values = torch.rand(plan.clique_shapes[bc], generator=torch.Generator().manual_seed(1),
                            dtype=dtype).to(card) + 0.5
        beliefs[bc].copy_(values)
        jt.run_waves(plan, arena, sepsets, [0], "marginalize", True, kernel=True)
        torch.cuda.synchronize()
        sigma = values / values.sum()
        torch.testing.assert_close(mu[e], sigma, **SAME_PLAN[dtype])
        shape = [3 if v == "y" else 1 for v in root["program"].cliques[recv]]
        torch.testing.assert_close(beliefs[recv], stage * sigma.reshape(shape), **SAME_PLAN[dtype])
        got = sharded.calibrate(arrays)
        want = sharded.calibrate(arrays, kernel=False)
        torch.cuda.synchronize()
        _close(got[0], want[0], SAME_PLAN[dtype])
        _close(got[1], want[1], SAME_PLAN[dtype])

    def test_same_result_run_to_run(self):
        program, host = _case("alarm_markov", torch.float32)
        arrays = [a.cuda() for a in host]
        sharded = ShardedJunctionTreeCalibration(program, Mesh([torch.device("cuda", 0)] * 4))
        first = [b.clone() for b in sharded.calibrate(arrays)[0]]
        again = sharded.calibrate(arrays)[0]
        assert all(torch.equal(a, b) for a, b in zip(first, again))

    def test_across_cards(self):
        """One part per card: every belief stays on its part's card, and the
        beliefs equal the single-device program's."""
        if torch.cuda.device_count() < 2:
            pytest.skip("needs two CUDA cards")
        program, host = _case("insurance", torch.float32)
        cards = [torch.device("cuda", k) for k in range(torch.cuda.device_count())]
        arrays = [a.to(cards[0]) for a in host]
        sharded = ShardedJunctionTreeCalibration(program, Mesh(cards))
        assert len(set(sharded.device_of_part)) > 1
        jt.reset_launches()
        beliefs, mu = sharded.calibrate(arrays)
        assert jt.JT_LAUNCHES == sharded.launches()
        for p_idx, part in enumerate(sharded.parts):
            for c in part["cliques"]:
                assert beliefs[c].device == sharded.device_of_part[p_idx]
        for c in range(len(beliefs)):
            beliefs[c] = beliefs[c].to(cards[0])
        ref_beliefs, ref_mu = program.calibrate(arrays)
        torch.cuda.synchronize()
        _close(beliefs, ref_beliefs, OTHER_PLAN[torch.float32])
        _close(mu, ref_mu, OTHER_PLAN[torch.float32])
