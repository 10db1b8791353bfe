"""K5 on the card: the sweep kernel of ``csrc/ancestral.cu`` against its plain
PyTorch version on the same card, its launch counter, and its Philox draws by
distribution.  Every test here needs a CUDA device and skips without one; on
a GPU machine:
``python -m pytest tests/test_torch_ancestral_kernel_cuda.py -m cuda``.

Tolerances: on the same explicit noise (one float64 uniform per node and
row) the kernel's codes and log weights equal the plain version's to the bit
(both count the same CDF entries at or below the uniform, and add the
evidence's log probabilities in the tables' type in node order).  Philox draws are held to the exact marginals
within 5 standard errors plus 1e-4 per state."""

import numpy as np
import pytest
import torch

from _torch_parity import random_bn_tables
from pgmpy_tpu_torch.config import config
from pgmpy_tpu_torch.factors import TabularCPD
from pgmpy_tpu_torch.inference import VariableElimination
from pgmpy_tpu_torch.models import DiscreteBayesianNetwork
from pgmpy_tpu_torch.ops import ancestral
from pgmpy_tpu_torch.sampling import CompiledAncestralSampler
from pgmpy_tpu_torch.utils import get_example_model
from pgmpy_tpu_torch.utils.interop import bn_from_numpy
from pgmpy_tpu_torch.utils.mathext import seeded_generator


@pytest.fixture
def on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    previous, dtype = config.DEVICE, config.DTYPE
    config.set_device("cuda")
    try:
        yield
    finally:
        config.set_device(previous)
        config.set_dtype(dtype)


def _model(name):
    if name == "wide":  # a 130-state root: int32 codes
        model = DiscreteBayesianNetwork([("a", "b"), ("b", "c")])
        rng = np.random.default_rng(0)
        model.add_cpds(TabularCPD("a", 130, rng.dirichlet(np.ones(130))[:, None]),
                       TabularCPD("b", 3, rng.dirichlet(np.ones(3), 130).T, evidence=["a"],
                                  evidence_card=[130]),
                       TabularCPD("c", 2, rng.dirichlet(np.ones(2), 3).T, evidence=["b"],
                                  evidence_card=[3]))
        return model
    if name == "random":
        names, edges, tuples = random_bn_tables(11, n_nodes=12)
        return bn_from_numpy(edges, tuples, nodes=names)
    if name == "long":  # 400 binary nodes after a 130-state root: int32 rows past 48 KB
        model = DiscreteBayesianNetwork([("a", "n0")] + [(f"n{k}", f"n{k + 1}")
                                                          for k in range(399)])
        rng = np.random.default_rng(1)
        model.add_cpds(TabularCPD("a", 130, rng.dirichlet(np.ones(130))[:, None]),
                       TabularCPD("n0", 2, rng.dirichlet(np.ones(2), 130).T, evidence=["a"],
                                  evidence_card=[130]),
                       *[TabularCPD(f"n{k + 1}", 2, rng.dirichlet(np.ones(2), 2).T,
                                    evidence=[f"n{k}"], evidence_card=[2]) for k in range(399)])
        return model
    return get_example_model(name.split("_")[0])


def _call(sampler, kind, n, seed):
    d = len(sampler.variables)
    rng = np.random.default_rng(seed)
    given, partial, evidence = None, None, None
    if kind == "clamp":
        given = np.full(d, -1)
        for i in rng.choice(d, 2, replace=False):
            given[i] = rng.integers(0, sampler.cards[i])
    elif kind == "partial":
        codes = np.stack([rng.integers(0, c, n) for c in sampler.cards], axis=1)
        codes[rng.random(codes.shape) < 0.8] = -1
        partial = torch.from_numpy(codes).cuda()
    elif kind == "evidence":
        evidence = {int(i): int(rng.integers(0, sampler.cards[i]))
                    for i in rng.choice(d, 3, replace=False)}
    return given, partial, evidence


# MUNIN in float32, its working type, at 4,096 rows and at the smoke's
# simulate (52,048 rows); the others in both types; "long" opts its blocks
# into more than 48 KB of shared memory
NETWORKS = [("random", "float32"), ("random", "float64"), ("alarm", "float32"),
            ("alarm", "float64"), ("munin", "float32"), ("munin_simulate", "float32"),
            ("wide", "float32"), ("wide", "float64"), ("long", "float32")]
ROWS = {"munin": 4096, "munin_simulate": 52_048}


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtype", NETWORKS)
@pytest.mark.parametrize("kind", ["draw", "clamp", "partial", "evidence"])
def test_explicit_noise_matches_plain_to_the_bit(on_cuda, name, dtype, kind):
    config.set_dtype(dtype)
    sampler = CompiledAncestralSampler(_model(name))
    n = ROWS.get(name, 3001)
    given, partial, evidence = _call(sampler, kind, n, 7)
    sweep = sampler._sweep_tables
    if name == "long":
        rows, _, shared = ancestral.plan_tile(401, 4, sweep.groups, n)
        assert rows == 32 and shared > 48 * 1024
    noise = torch.rand((len(sweep.cards), n), generator=seeded_generator(3),
                       dtype=torch.float64, device="cuda")
    before = ancestral.LAUNCHES
    codes, logw = ancestral.sweep_cuda(sweep, n, None, given, partial, evidence, noise)
    assert ancestral.LAUNCHES == before + 1
    want_codes, want_logw = ancestral.sweep_reference(sweep, n, None, given, partial, evidence,
                                                      noise)
    torch.cuda.synchronize()
    assert codes.dtype == sampler._out_dtype and codes.shape == (n, len(sampler.variables))
    assert torch.equal(codes, want_codes)
    if evidence:
        assert torch.equal(logw, want_logw)
    else:
        assert logw is None and want_logw is None


@pytest.mark.cuda
def test_forward_and_likelihood_weighted_are_one_launch(on_cuda):
    sampler = CompiledAncestralSampler(get_example_model("alarm"))
    ancestral.reset_launches()
    torch.manual_seed(123)
    expected = torch.rand(3)
    torch.manual_seed(123)
    first = sampler.forward(20_000, seed=4)
    assert ancestral.LAUNCHES == 1
    assert torch.equal(first, sampler.forward(20_000, seed=4))
    assert not torch.equal(first, sampler.forward(20_000, seed=5))
    codes, logw = sampler.likelihood_weighted(5000, {sampler.variables[-1]: 1}, seed=2)
    assert ancestral.LAUNCHES == 4 and torch.equal(torch.rand(3), expected)
    # the weight is log p(evidence | its parents' drawn states)
    i = len(sampler.variables) - 1
    parents, strides, table = sampler._node_specs[i]
    flat = sum(codes[:, p].long() * s for p, s in zip(parents, strides))
    assert torch.equal(logw, table[flat, 1] if parents else table[0, 1].expand(5000))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["random", "asia", "wide"])
def test_philox_draws_match_the_exact_marginals(on_cuda, name):
    model = _model(name)
    n = 200_000
    df = model.simulate(n, seed=9, show_progress=False)
    ve = VariableElimination(model)
    for var in model.nodes():
        p = ve.query([var]).values.double().cpu().numpy()
        codes = df[var].cat.codes.to_numpy()
        freq = np.bincount(codes, minlength=len(p)) / n
        assert (np.abs(freq - p) <= 5 * np.sqrt(p * (1 - p) / n) + 1e-4).all(), (var, freq, p)


@pytest.mark.cuda
def test_zero_probability_states_are_never_drawn(on_cuda):
    model = DiscreteBayesianNetwork([("a", "b")])
    model.add_cpds(
        TabularCPD("a", 3, [[0.0], [1.0], [0.0]]),
        TabularCPD("b", 3, [[0.0, 0.5, 0.0], [0.0, 0.0, 1.0], [1.0, 0.5, 0.0]],
                   evidence=["a"], evidence_card=[3]))
    codes = CompiledAncestralSampler(model).forward(1_000_000, seed=0)
    assert (codes[:, 0] == 1).all()
    assert set(codes[:, 1].unique().tolist()) == {0, 2}


@pytest.mark.cuda
def test_partial_codes_outside_their_states_raise(on_cuda):
    sampler = CompiledAncestralSampler(get_example_model("asia"))
    partial = np.full((4, len(sampler.variables)), -1)
    partial[0, 0] = 2
    with pytest.raises(ValueError, match="partial"):
        sampler.forward(4, seed=0, partial=partial)
