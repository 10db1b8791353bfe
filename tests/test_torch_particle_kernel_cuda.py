"""K9 on the card: the particle filter's slice sweep (K5's kernel of
``csrc/ancestral.cu`` reading the previous slice and writing the count
kernel's column-major matrix) against its plain PyTorch version on the same
card, its launch counter, the same seed, and the filter against the exact
``forward_scan``.  Every test here needs a CUDA device and skips without one;
on a GPU machine:
``python -m pytest tests/test_torch_particle_kernel_cuda.py -m cuda``.

Tolerances: on the same explicit noise the kernel's codes and log weights
equal the plain version's to the bit (both subtract, compare and add in the
tables' type in node order).  Filtered marginals are held to ``forward_scan``
within 5 standard errors at the slice's effective sample size plus 1e-4, as
``tests/test_torch_smc.py`` holds them."""

import numpy as np
import pytest
import torch

from _torch_parity import random_2tbn
from pgmpy_tpu_torch.config import config
from pgmpy_tpu_torch.inference import DBNInference
from pgmpy_tpu_torch.ops import ancestral
from pgmpy_tpu_torch.sampling.smc import ParticleFilter
from pgmpy_tpu_torch.utils.interop import dbn_from_numpy
from pgmpy_tpu_torch.utils.mathext import race_noise, seeded_generator


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


def rain_tuples():
    states = {("rain", t): ["dry", "wet"] for t in (0, 1)}
    states.update({("umbrella", t): ["no", "yes"] for t in (0, 1)})
    emission = np.array([[0.8, 0.1], [0.2, 0.9]])

    def names(*keys):
        return {k: states[k] for k in keys}

    return [(("rain", 0), 2, np.array([[0.5], [0.5]]), [], [], names(("rain", 0))),
            (("umbrella", 0), 2, emission, [("rain", 0)], [2], names(("umbrella", 0), ("rain", 0))),
            (("rain", 1), 2, np.array([[0.7, 0.3], [0.3, 0.7]]), [("rain", 0)], [2],
             names(("rain", 1), ("rain", 0))),
            (("umbrella", 1), 2, emission, [("rain", 1)], [2], names(("umbrella", 1), ("rain", 1)))]


RAIN_EDGES = [(("rain", 0), ("umbrella", 0)), (("rain", 0), ("rain", 1))]


def _model(name):
    if name == "rain":
        return dbn_from_numpy(RAIN_EDGES, rain_tuples())
    if name == "wide":  # a 130-state variable that persists: int32 codes
        rng = np.random.default_rng(0)
        w, x = rng.dirichlet(np.ones(130)), rng.dirichlet(np.ones(3), 130).T
        stay = 0.8 * np.eye(130) + 0.2 * w[:, None]
        states = {("w", t): [f"w{k}" for k in range(130)] for t in (0, 1)}
        states.update({("x", t): list("abc") for t in (0, 1)})
        tuples = [(("w", 0), 130, w[:, None], [], [], {("w", 0): states[("w", 0)]}),
                  (("x", 0), 3, x, [("w", 0)], [130], {k: states[k] for k in [("x", 0), ("w", 0)]}),
                  (("w", 1), 130, stay, [("w", 0)], [130],
                   {k: states[k] for k in [("w", 1), ("w", 0)]}),
                  (("x", 1), 3, x, [("w", 1)], [130], {k: states[k] for k in [("x", 1), ("w", 1)]})]
        return dbn_from_numpy([(("w", 0), ("x", 0)), (("w", 0), ("w", 1))], tuples)
    return dbn_from_numpy(*random_2tbn(int(name[6:]), n_vars=8))


NETWORKS = [("rain", "float32"), ("rain", "float64"), ("random3", "float32"),
            ("random4", "float64"), ("wide", "float32"), ("wide", "float64")]


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtype", NETWORKS)
@pytest.mark.parametrize("observed", [0, 1])
def test_explicit_noise_matches_plain_to_the_bit(on_cuda, name, dtype, observed):
    config.set_dtype(dtype)
    n = 5003
    pf = ParticleFilter(_model(name), n_particles=n)
    rng = np.random.default_rng(7)
    prev = torch.as_tensor(np.stack([rng.integers(0, pf.cards[v], n) for v in pf.variables]),
                           device="cuda")
    ev_codes = np.full(len(pf.variables), -1)
    if observed:
        ev_codes[-1] = 1
    for tables in (pf._start_specs, pf._trans_specs):
        evidence = {i: int(ev_codes[c]) for i, c in enumerate(tables.columns) if ev_codes[c] >= 0}
        noise = race_noise((sum(tables.cards), n), seeded_generator(3), config.DTYPE)
        before = ancestral.PARTICLE_LAUNCHES
        got, got_lw = ancestral.sweep_cuda(tables, n, None, evidence=evidence, noise=noise,
                                           prev=prev, out=pf._code_matrix())
        assert ancestral.PARTICLE_LAUNCHES == before + 1
        out = pf._code_matrix()
        want, want_lw = ancestral.sweep_reference(tables, n, None, evidence=evidence,
                                                  noise=noise, prev=prev, out=out)
        torch.cuda.synchronize()
        assert got.dtype == pf._out_dtype and tuple(got.shape) == (len(pf.variables), n)
        assert torch.equal(got, want)
        if evidence:
            assert torch.equal(got_lw, want_lw)
        else:
            assert got_lw is None and want_lw is None
        # the padding of the count kernel's matrix stays -1
        got_out = pf._code_matrix()
        ancestral.sweep_cuda(tables, n, None, evidence=evidence, noise=noise, prev=prev,
                             out=got_out)
        assert torch.equal(got_out, out) and (got_out[:, n:] == -1).all()


@pytest.mark.cuda
def test_one_launch_per_slice_and_the_same_seed(on_cuda):
    pf = ParticleFilter(_model("random3"), n_particles=50_000)
    evidence = {(pf.variables[0], t): 1 for t in range(0, 12, 2)}
    ancestral.reset_launches()
    torch.manual_seed(123)
    expected = torch.rand(3)
    torch.manual_seed(123)
    first = pf.filter(evidence, n_time_slices=12, seed=4)
    assert ancestral.PARTICLE_LAUNCHES == 12 and ancestral.LAUNCHES == 0
    again = pf.filter(evidence, n_time_slices=12, seed=4)
    assert np.array_equal(first[1], again[1]) and np.array_equal(first[2], again[2])
    for key in first[0]:  # the marginals are float atomics: equal to 1e-6
        np.testing.assert_allclose(first[0][key], again[0][key], atol=1e-6)
    assert not np.array_equal(first[1], pf.filter(evidence, n_time_slices=12, seed=5)[1])
    assert torch.equal(torch.rand(3), expected)


@pytest.mark.cuda
# evidence on a leaf outside the interface; "rain_slice0" also observes the
# interface variable at slice 0, which forward_scan keeps in alpha as a mask
@pytest.mark.parametrize("name", ["rain", "wide", "rain_slice0"])
def test_filtered_marginals_match_forward_scan(on_cuda, name):
    model = _model(name.split("_")[0])
    pf = ParticleFilter(model, n_particles=100_000)
    leaf = pf.variables[-1]
    evidence = {(leaf, t): t % 2 for t in range(0, 20, 3)}
    if name.endswith("slice0"):
        evidence[(pf.variables[0], 0)] = 1
    marginals, _, ess = pf.filter(evidence, n_time_slices=20, seed=0)
    queries = [v for v in pf.variables if v != leaf]
    exact = DBNInference(model).forward_scan(queries, evidence, n_time_slices=20)
    ess = np.minimum.accumulate(ess)  # persistent variables inherit their lineage
    for (v, t), want in exact.items():
        want = np.asarray(want, dtype=np.float64)
        limit = 5 * np.sqrt(want * (1 - want) / ess[t]) + 1e-4
        assert (np.abs(marginals[(v, t)] - want) <= limit).all(), (v, t)
