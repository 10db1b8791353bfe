"""The port's particle filter against pgmpy_tpu on the CPU.

The two packages draw from different random streams, so samples are never
compared: the filtered marginals of the port are held to the JAX package's
exact ``forward_scan`` within 5 standard errors at the slice's effective
sample size.  Deterministic pieces (systematic resampling, the weighted
marginals that go through ``table_counts``) are held to numpy.
"""

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (puts the port on the CPU)
from pgmpy_tpu.factors import TabularCPD as JaxCPD
from pgmpy_tpu.inference import DBNInference as JaxDBNInference
from pgmpy_tpu.models import DynamicBayesianNetwork as JaxDBN
from pgmpy_tpu_torch.config import config
from pgmpy_tpu_torch.sampling import smc
from pgmpy_tpu_torch.sampling.smc import ParticleFilter
from pgmpy_tpu_torch.utils.interop import dbn_from_numpy
from pgmpy_tpu_torch.utils.mathext import seeded_generator

EDGES = [(("rain", 0), ("umbrella", 0)), (("rain", 0), ("rain", 1))]


def rain_tuples(emission=((0.8, 0.1), (0.2, 0.9))):
    states = {("rain", t): ["dry", "wet"] for t in (0, 1)}
    states.update({("umbrella", t): ["no", "yes"] for t in (0, 1)})
    emission = np.asarray(emission, dtype=np.float64)
    transition = np.array([[0.7, 0.3], [0.3, 0.7]])

    def names(*keys):
        return {k: states[k] for k in keys}

    return [
        (("rain", 0), 2, np.array([[0.5], [0.5]]), [], [], names(("rain", 0))),
        (("umbrella", 0), 2, emission, [("rain", 0)], [2], names(("umbrella", 0), ("rain", 0))),
        (("rain", 1), 2, transition, [("rain", 0)], [2], names(("rain", 1), ("rain", 0))),
        (("umbrella", 1), 2, emission, [("rain", 1)], [2], names(("umbrella", 1), ("rain", 1))),
    ]


def jax_dbn(tuples):
    dbn = JaxDBN()
    dbn.add_edges_from(EDGES)
    dbn.add_cpds(*[
        JaxCPD(var, card, values, evidence=ev or None, evidence_card=ec or None, state_names=sn)
        for var, card, values, ev, ec, sn in tuples
    ])
    return dbn


@pytest.fixture(scope="module")
def rain():
    tuples = rain_tuples()
    return dbn_from_numpy(EDGES, tuples), jax_dbn(tuples)


def within_ess_error(got, exact, ess):
    return np.abs(got - exact) <= 5 * np.sqrt(exact * (1 - exact) / ess) + 1e-4


def test_filtered_marginals_within_mc_error_of_jax_forward_scan(rain):
    port, jax_model = rain
    n_slices = 30
    evidence = {("umbrella", t): "yes" if t % 6 else "no" for t in range(0, n_slices, 3)}
    exact = JaxDBNInference(jax_model).forward_scan(["rain"], evidence, n_time_slices=n_slices)
    marginals, particles, ess = ParticleFilter(port, n_particles=8192).filter(
        evidence, n_time_slices=n_slices, seed=0)
    assert particles.shape == (8192, 2) and particles.dtype == np.int32
    assert set(np.unique(particles)) <= {0, 1}
    assert ess.shape == (n_slices,)
    assert ((ess > 0) & (ess <= 8192 * (1 + 1e-5))).all()
    assert set(marginals) == {(v, t) for v in ("rain", "umbrella") for t in range(n_slices)}
    for t in range(n_slices):
        got = marginals[("rain", t)]
        assert got.shape == (2,) and abs(got.sum() - 1) < 1e-4
        assert within_ess_error(got, np.asarray(exact[("rain", t)], dtype=np.float64),
                                ess[t]).all(), (t, got, exact[("rain", t)], ess[t])
    # an observed variable's marginal is its evidence (a float32 sum of n weights)
    np.testing.assert_allclose(marginals[("umbrella", 3)], [0.0, 1.0], atol=8192 * 2.0**-24)
    np.testing.assert_allclose(marginals[("umbrella", 6)], [1.0, 0.0], atol=8192 * 2.0**-24)


def test_same_seed_equal_other_seed_differs(rain):
    pf = ParticleFilter(rain[0], n_particles=2048)
    evidence = {("umbrella", t): 1 for t in range(0, 10, 2)}
    first = pf.filter(evidence, n_time_slices=10, seed=4)
    again = pf.filter(evidence, n_time_slices=10, seed=4)
    other = pf.filter(evidence, n_time_slices=10, seed=5)
    for key in first[0]:
        np.testing.assert_array_equal(first[0][key], again[0][key])
    np.testing.assert_array_equal(first[1], again[1])
    np.testing.assert_array_equal(first[2], again[2])
    assert not np.array_equal(first[1], other[1])


def test_resample_branch_taken_and_skipped(rain):
    """Slices without evidence keep ESS = n and skip the resample; a run of
    observations drops ESS under the threshold, the resample resets the
    weights, and the next slice without evidence is back at ESS = n."""
    n = 4096
    pf = ParticleFilter(rain[0], n_particles=n, ess_threshold=0.75)
    evidence = {("umbrella", t): "yes" for t in (3, 4, 5, 9)}
    _, _, ess = pf.filter(evidence, n_time_slices=12, seed=1)
    np.testing.assert_allclose(ess[:3], n, rtol=1e-4)  # no weights yet: skipped
    assert ess[3] < 0.75 * n  # one observation: taken
    np.testing.assert_allclose(ess[6], n, rtol=1e-4)  # weights were reset by a resample
    # without the resample the weights of slices 3..5 would still be there
    pf_never = ParticleFilter(rain[0], n_particles=n, ess_threshold=0.0)
    _, _, ess_never = pf_never.filter(evidence, n_time_slices=12, seed=1)
    assert ess_never[6] < 0.75 * n
    assert ((ess > 0) & (ess <= n * (1 + 1e-5))).all()


def test_systematic_resample_matches_numpy(rain):
    n = 64
    pf = ParticleFilter(rain[0], n_particles=n)
    rng = np.random.default_rng(2)
    logw = rng.normal(size=n) * 2
    particles = np.stack([np.arange(n), rng.integers(0, 2, n)])
    offset = 0.37
    got = pf._systematic_resample(
        torch.as_tensor(particles), torch.as_tensor(logw, dtype=torch.float64), offset).numpy()
    w = np.exp(logw - logw.max())
    w /= w.sum()
    positions = (offset + np.arange(n)) / n
    idx = np.clip(np.searchsorted(np.cumsum(w), positions), 0, n - 1)
    np.testing.assert_array_equal(got, particles[:, idx])
    # each particle is kept floor(n w) or ceil(n w) times
    copies = np.bincount(got[0], minlength=n)
    assert ((copies >= np.floor(n * w)) & (copies <= np.ceil(n * w))).all()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["float64", "float32"])
def test_weighted_marginals_equal_w_at_one_hot(dtype, monkeypatch):
    """The marginals of a slice, which go through ``table_counts``, equal
    ``w @ one_hot(states)`` computed with numpy in float64: to 1e-6 (in fact
    1e-12) when the filter runs in float64; in float32 the plain version adds
    the n weights one after the other, each addition rounding a partial sum
    of at most 1, so the limit there is n 2^-24."""
    config.set_dtype(dtype)
    try:
        weighted_marginals_case(dtype, monkeypatch)
    finally:
        config.set_dtype(torch.float32)


def weighted_marginals_case(dtype, monkeypatch):
    seen = []
    real = smc.table_counts

    def spy(codes_cm, n_rows, specs, weights):
        out = real(codes_cm, n_rows, specs, weights)
        seen.append((codes_cm[:, :n_rows].clone(), weights.clone(), out.clone()))
        return out

    monkeypatch.setattr(smc, "table_counts", spy)
    n = 1000  # not a multiple of 16: the count kernel's view is padded
    atol = 1e-12 if dtype == torch.float64 else n * 2.0**-24
    pf = ParticleFilter(dbn_from_numpy(EDGES, rain_tuples()), n_particles=n)
    marginals, _, _ = pf.filter({("umbrella", 1): "yes", ("umbrella", 2): "yes"},
                                n_time_slices=4, seed=0)
    assert len(seen) == 4
    for t, (codes, w, out) in enumerate(seen):
        assert codes.dtype == torch.int8 and w.dtype == dtype and out.dtype == dtype
        w64 = w.double().numpy()
        np.testing.assert_allclose(w64.sum(), 1.0, atol=1e-5)
        want = np.concatenate([w64 @ np.eye(2)[codes[j].numpy()] for j in range(2)])
        np.testing.assert_allclose(out.double().numpy(), want, atol=atol)
        np.testing.assert_allclose(
            np.concatenate([marginals[("rain", t)], marginals[("umbrella", t)]]), want, atol=atol)


def test_one_table_count_call_per_slice(rain, monkeypatch):
    calls = []
    real = smc.table_counts
    monkeypatch.setattr(smc, "table_counts",
                        lambda *a, **k: calls.append(a[2]) or real(*a, **k))
    pf = ParticleFilter(rain[0], n_particles=256)
    pf.filter({("umbrella", 2): 1}, n_time_slices=7, seed=0)
    assert len(calls) == 7
    # the spec table is built once, in __init__
    assert all(specs is pf._marginal_specs for specs in calls)
    assert len(pf._marginal_specs) == 2 and pf._marginal_specs.total == 4


def test_impossible_evidence_gives_uniform_weights_not_nan():
    """Evidence of probability 0 for every particle: the log tables are
    clamped at 1e-38, so the weights are uniform and nothing is NaN."""
    tuples = rain_tuples(emission=((1.0, 1.0), (0.0, 0.0)))  # the umbrella is never out
    pf = ParticleFilter(dbn_from_numpy(EDGES, tuples), n_particles=512)
    marginals, particles, ess = pf.filter({("umbrella", 1): "yes"}, n_time_slices=3, seed=0)
    assert np.isfinite(ess).all()
    np.testing.assert_allclose(ess[1], 512, rtol=1e-4)
    for value in marginals.values():
        assert np.isfinite(value).all()
    np.testing.assert_allclose(marginals[("umbrella", 1)], [0.0, 1.0], atol=1e-6)


def test_evidence_is_validated_on_the_host(rain):
    pf = ParticleFilter(rain[0], n_particles=64)
    with pytest.raises(ValueError):
        pf.filter({("umbrella", 1): 2}, n_time_slices=3)
    with pytest.raises(ValueError):
        pf.filter({("snow", 1): 0}, n_time_slices=3)
    with pytest.raises(ValueError):
        pf.filter({("umbrella", 5): 0}, n_time_slices=3)
    with pytest.raises(ValueError):
        ParticleFilter(rain[0].get_constant_bn())


def test_particle_state_is_in_the_count_kernels_layout(rain, monkeypatch):
    """(d, ld) column-major, ld a multiple of 16, padding -1."""
    seen = []
    real = smc.table_counts
    monkeypatch.setattr(smc, "table_counts",
                        lambda cm, *a, **k: seen.append(cm.clone()) or real(cm, *a, **k))
    ParticleFilter(rain[0], n_particles=100).filter(n_time_slices=2, seed=0)
    for cm in seen:
        assert tuple(cm.shape) == (2, 112) and cm.is_contiguous()
        assert (cm[:, 100:] == -1).all() and (cm[:, :100] >= 0).all()


def test_sweep_draws_follow_the_transition_table(rain):
    """One transition sweep from a fixed previous slice: the share of wet
    particles is the transition table's, within 5 standard errors."""
    n = 20_000
    pf = ParticleFilter(rain[0], n_particles=n)
    prev = torch.zeros((2, n), dtype=torch.int64)
    prev[pf.var_index["rain"]] = 1
    cur, logw = pf._sweep(seeded_generator(0), prev, pf._trans_specs, np.array([-1, -1]))
    assert tuple(cur.shape) == (2, n) and cur.dtype == torch.int64
    assert float(logw.abs().max()) == 0.0
    wet = float((cur[pf.var_index["rain"]] == 1).double().mean())
    assert abs(wet - 0.7) <= 5 * np.sqrt(0.7 * 0.3 / n)
    # with the umbrella observed, each particle's log weight is its emission's
    cur, logw = pf._sweep(seeded_generator(0), prev, pf._trans_specs,
                          np.array([-1, 1] if pf.var_index["umbrella"] == 1 else [1, -1]))
    rain_now = cur[pf.var_index["rain"]].numpy()
    np.testing.assert_allclose(logw.numpy(), np.log(np.where(rain_now == 1, 0.9, 0.2)), rtol=1e-5)
