"""HMC, the host NUTS and VectorizedNUTS of the port.

Deterministic parts are held to ``pgmpy_tpu`` on identical numpy inputs, both
packages in float32: leapfrog steps and gradients (rtol 1e-5 of the largest
entry per step taken), the bit helpers of the checkpoint scheme exactly, the
deterministic fields of ``VectorizedNUTS._build_subtree`` (chains batched
here, ``vmap``ped there; rtol 1e-4 after at most 8 float32 leapfrog steps),
and the host-recursive NUTS, whose every draw comes from
``np.random.default_rng(seed)`` in both packages, step for step over its first
transitions (atol 1e-3: float32 leapfrog errors grow along the trajectory).
Samplers whose draws come from the device are compared by distribution, with
the limits of the JAX package's own tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgmpy_tpu.factors import LinearGaussianCPD as JaxCPD
from pgmpy_tpu.models import LinearGaussianBayesianNetwork as JaxLGBN
from pgmpy_tpu.sampling import hmc as jax_hmc
from pgmpy_tpu.sampling import nuts_jax

from _torch_parity import np_values, to_port_lgbn
from pgmpy_tpu_torch.config import as_tensor
from pgmpy_tpu_torch.sampling import (BaseGradLogPDF, GradLogPDFGaussian, HamiltonianMC,
                                      HamiltonianMCDA, LeapFrog, ModifiedEuler,
                                      NoUTurnSampler, NoUTurnSamplerDA, VectorizedNUTS)
from pgmpy_tpu_torch.sampling import nuts
from pgmpy_tpu_torch.utils.mathext import normal_draw, seeded_generator


def jax_chain():
    model = JaxLGBN([("x1", "x2"), ("x2", "x3")])
    model.add_cpds(JaxCPD("x1", [1], 4), JaxCPD("x2", [-5, 0.5], 4, evidence=["x1"]),
                   JaxCPD("x3", [4, -1], 3, evidence=["x2"]))
    return model


def jax_pair2d(mean1=1.0, std1=2.0, coef=1.0):
    model = JaxLGBN([("x1", "x2")])
    model.add_cpds(JaxCPD("x1", [mean1], std1), JaxCPD("x2", [0, coef], 1, evidence=["x1"]))
    return model


@pytest.fixture(scope="module")
def chain():
    ref = jax_chain()
    return to_port_lgbn(ref), ref


def points(seed, n, dim, scale=3.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, dim)) * scale).astype(np.float32), \
        rng.normal(size=(n, dim)).astype(np.float32)


def assert_close(got, want, rtol, what=""):
    want = np.asarray(want, dtype=np.float64)
    np.testing.assert_allclose(np_values(got), want, rtol=0,
                               atol=rtol * max(float(np.abs(want).max()), 1.0), err_msg=what)


# ---------------------------------------------------------------------- #
# deterministic parity
# ---------------------------------------------------------------------- #
def test_log_pdf_and_gradient_match(chain):
    port, ref = chain
    q, _ = points(0, 5, 3)
    a, b = HamiltonianMC(port), jax_hmc.HamiltonianMC(ref)
    assert a.variables == b.variables == ["x1", "x2", "x3"]
    for row in q:
        assert_close(a.log_pdf(as_tensor(row)), b.log_pdf(jnp.asarray(row)), 1e-5)
        assert_close(a._grad(as_tensor(row)), b._grad(jnp.asarray(row)), 1e-5)
        for cls, jax_cls in ((BaseGradLogPDF, jax_hmc.BaseGradLogPDF),
                             (GradLogPDFGaussian, jax_hmc.GradLogPDFGaussian)):
            got = cls(row, port).get_gradient_log_pdf()
            want = jax_cls(row, ref).get_gradient_log_pdf()
            assert_close(got[0], want[0], 1e-5)
            assert_close(got[1], want[1], 1e-5)
    # the chains are a batch axis
    assert_close(a._grad(as_tensor(q)), jax.vmap(b._grad)(jnp.asarray(q)), 1e-5)
    with pytest.raises(ValueError, match="log-density"):
        HamiltonianMC(3)


def test_a_callable_or_an_object_with_log_pdf_is_a_target():
    def log_pdf(x):
        return -0.5 * torch.sum(x**2) - 0.25 * torch.sum(x**4)

    class Target:
        variables = ["u", "v"]

        @staticmethod
        def log_pdf(x):
            return log_pdf(x)

    by_call, by_object = HamiltonianMC(log_pdf), HamiltonianMC(Target())
    assert by_call.variables is None and by_object.variables == ["u", "v"]
    x = as_tensor([0.5, -2.0])
    assert_close(by_call._grad(x), [-0.5 - 0.125, 2.0 + 8.0], 1e-6)
    assert_close(by_object._grad(x[None]), [[-0.5 - 0.125, 2.0 + 8.0]], 1e-6)
    df = by_object.sample([0.0, 0.0], num_samples=5, stepsize=0.2, trajectory_length=1.0, seed=0)
    assert list(df.columns) == ["u", "v"] and len(df) == 5
    assert list(by_call.sample([0.0, 0.0], num_samples=2, stepsize=0.2, trajectory_length=1.0,
                               seed=0).columns) == ["x0", "x1"]


@pytest.mark.parametrize("n_steps", [1, 4])
def test_hmc_leapfrog_matches(chain, n_steps):
    port, ref = chain
    q, p = points(1, 6, 3)
    a, b = HamiltonianMC(port), jax_hmc.HamiltonianMC(ref)
    got = a._leapfrog(as_tensor(q), as_tensor(p), a._grad(as_tensor(q)), 0.3, n_steps)
    for i in range(len(q)):
        want = b._leapfrog(jnp.asarray(q[i]), jnp.asarray(p[i]), b._grad(jnp.asarray(q[i])),
                           0.3, n_steps)
        one = a._leapfrog(as_tensor(q[i]), as_tensor(p[i]), a._grad(as_tensor(q[i])), 0.3, n_steps)
        for k in range(3):
            assert_close(got[k][i], want[k], 1e-5 * n_steps, f"chain {i} field {k}")
            assert_close(one[k], want[k], 1e-5 * n_steps, f"single chain {i} field {k}")


@pytest.mark.parametrize("name", ["LeapFrog", "ModifiedEuler"])
def test_integrator_classes_match(chain, name):
    port, ref = chain
    q, p = points(2, 4, 3)
    for i in range(len(q)):
        got = {"LeapFrog": LeapFrog, "ModifiedEuler": ModifiedEuler}[name](
            port, q[i], p[i], 0.25).get_proposed_values()
        want = getattr(jax_hmc, name)(ref, q[i], p[i], 0.25).get_proposed_values()
        assert_close(got.new_position, want.new_position, 1e-5)
        assert_close(got.new_momentum, want.new_momentum, 1e-5)
        assert_close(got.new_grad_logp, want.new_grad_logp, 1e-5)


def test_host_nuts_matches_step_for_step(chain):
    port, ref = chain
    a, b = NoUTurnSampler(port, max_depth=5), jax_hmc.NoUTurnSampler(ref, max_depth=5)
    start = np.array([0.0, -3.0, 7.0])
    got = a.sample(start, num_samples=6, stepsize=0.6, seed=3, return_type="array")
    want = b.sample(start, num_samples=6, stepsize=0.6, seed=3, return_type="array")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    assert len({tuple(np.round(row, 3)) for row in got}) == 6  # the chain moves
    gen = a.generate_sample(start, num_samples=2, stepsize=0.6, seed=3)
    np.testing.assert_allclose(np.stack(list(gen)), want[:2], rtol=0, atol=1e-3)
    # the acceptance statistics of one transition (Alg. 6)
    q1, alpha, n_alpha = a._nuts_step_stats(start, 0.6, np.random.default_rng(5))
    q2, alpha2, n_alpha2 = b._nuts_step_stats(start, 0.6, np.random.default_rng(5))
    np.testing.assert_allclose(q1, q2, rtol=0, atol=1e-4)
    assert n_alpha == n_alpha2 and alpha == pytest.approx(alpha2, abs=1e-4)


def test_host_nuts_with_dual_averaging_matches(chain):
    port, ref = chain
    a = NoUTurnSamplerDA(port, max_depth=4)
    b = jax_hmc.NoUTurnSamplerDA(ref, max_depth=4)
    start = np.array([1.0, -4.0, 8.0])
    got = a.sample(start, num_adapt=4, num_samples=3, stepsize=0.5, seed=1, return_type="array")
    want = b.sample(start, num_adapt=4, num_samples=3, stepsize=0.5, seed=1, return_type="array")
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    assert list(a.sample(start, 1, 2, stepsize=0.5, seed=1).columns) == ["x1", "x2", "x3"]


def test_reasonable_stepsize_sits_on_the_acceptable_side(chain):
    """A heuristic (the probe momentum's seed differs between the packages):
    three leapfrog steps of the returned size keep the acceptance ratio of
    the probe above 0.5, and four times the size (twice the size the search
    stopped at) does not."""
    port, _ = chain
    hmc = HamiltonianMC(port)
    for start in ([1.0, -4.5, 8.5], [3.0, 0.0, 0.0]):
        eps = hmc._find_reasonable_stepsize(np.asarray(start))
        assert eps == hmc._find_reasonable_stepsize(np.asarray(start)) and 0 < eps < 10
        q = as_tensor(start)
        p = normal_draw(q.shape, seeded_generator(0), q.dtype)

        def log_ratio(step):
            q1, p1, _ = hmc._leapfrog(q, p, hmc._grad(q), step, 3)
            return float(hmc.log_pdf(q1) - 0.5 * (p1**2).sum() - hmc.log_pdf(q) + 0.5 * (p**2).sum())

        assert log_ratio(eps) > np.log(0.5)
        assert log_ratio(2 * eps) > np.log(0.5)
        assert not log_ratio(4 * eps) > np.log(0.5)


def test_checkpoint_bit_helpers_match_for_every_leaf():
    ns = np.arange(64)
    want_pop = np.asarray(nuts_jax._popcount(jnp.asarray(ns, dtype=jnp.int32)))
    want_min, want_max = (np.asarray(x) for x in nuts_jax._ckpt_range(jnp.asarray(ns, jnp.int32)))
    assert want_pop.tolist() == [bin(n).count("1") for n in ns]
    for dtype in (torch.int32, torch.int64):
        t = torch.arange(64, dtype=dtype)
        assert nuts._popcount(t).tolist() == want_pop.tolist()
        lo, hi = nuts._ckpt_range(t)
        assert lo.tolist() == want_min.tolist() and hi.tolist() == want_max.tolist()
    for n in ns.tolist():  # the host integers the subtree loop uses
        assert nuts._popcount(n) == want_pop[n]
        assert nuts._ckpt_range(n) == (want_min[n], want_max[n])
    assert nuts._popcount(2**32 - 1) == 32 and nuts._popcount(torch.tensor(2**31 - 1)) == 31


def test_is_turning_matches():
    rng = np.random.default_rng(0)
    a, b, rho = (rng.normal(size=(200, 3)).astype(np.float32) for _ in range(3))
    want = np.asarray(jax.vmap(nuts_jax._is_turning)(jnp.asarray(a), jnp.asarray(b),
                                                     jnp.asarray(rho)))
    got = nuts._is_turning(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(rho))
    assert got.tolist() == want.tolist() and 0 < want.sum() < 200


def test_vectorized_leapfrog_matches(chain):
    port, ref = chain
    z, r = points(3, 8, 3)
    a, b = VectorizedNUTS(port), nuts_jax.VectorizedNUTS(ref)
    got = a._leapfrog(as_tensor(z), as_tensor(r), a._grad(as_tensor(z)), 0.4)
    want = jax.vmap(lambda z, r: b._leapfrog(z, r, b._grad(z), 0.4))(jnp.asarray(z), jnp.asarray(r))
    for k in range(3):
        assert_close(got[k], want[k], 1e-5)


SUBTREE_FIELDS = ["z", "r", "g", "rho", "n", "turning", "diverging", "sum_accept", "n_leaf"]


@pytest.mark.parametrize("max_depth,eps", [(3, 0.5), (4, 1.1), (4, 4.5)])
def test_build_subtree_deterministic_fields_match(chain, max_depth, eps):
    """Every field of the subtree carry but ``z_prop`` (which alone depends on
    the random stream), for 24 chains and every subtree size the depth allows,
    one size for all chains and a size per chain.  The step sizes make some
    chains finish, some turn inside the subtree and, at 4.5, some diverge."""
    port, ref = chain
    a = VectorizedNUTS(port, max_depth=max_depth)
    b = nuts_jax.VectorizedNUTS(ref, max_depth=max_depth)
    n_chains = 24
    z, r = points(4, n_chains, 3, scale=4.0)
    z = z + np.asarray([1.0, -4.5, 8.5], dtype=np.float32)
    g = np.asarray(jax.vmap(b._grad)(jnp.asarray(z)))
    energy0 = np.asarray(jax.vmap(b.log_pdf)(jnp.asarray(z))) - 0.5 * (r**2).sum(axis=1)
    keys = jax.random.split(jax.random.PRNGKey(0), n_chains)
    build = jax.jit(jax.vmap(
        lambda n, z, r, g, e0, k: b._build_subtree(n, z, r, g, eps, e0, k)))
    sizes = [np.full(n_chains, 2**d, dtype=np.int32) for d in range(max_depth)]
    sizes.append(np.asarray([2 ** (i % max_depth) for i in range(n_chains)], dtype=np.int32))
    sizes.append(np.asarray([i % 3 for i in range(n_chains)], dtype=np.int32))  # 0 leaves too
    seen = {"turning": 0, "diverging": 0, "complete": 0}
    for n_leaves in sizes:
        want = build(jnp.asarray(n_leaves), jnp.asarray(z), jnp.asarray(r), jnp.asarray(g),
                     jnp.asarray(energy0), keys)
        same_for_all = len(set(n_leaves.tolist())) == 1
        got = a._build_subtree(int(n_leaves[0]) if same_for_all else torch.as_tensor(n_leaves),
                               as_tensor(z), as_tensor(r), as_tensor(g), eps,
                               as_tensor(energy0), seeded_generator(0))
        for field in ("n", "turning", "diverging", "n_leaf"):
            assert np_values(got[field]).tolist() == np_values(want[field]).tolist(), field
        ok = np.isfinite(np_values(want["z"])).all(axis=1)
        assert ok.sum() >= n_chains // 2
        for field in ("z", "r", "g", "rho", "sum_accept"):
            assert_close(got[field][torch.as_tensor(ok)], np.asarray(want[field])[ok], 1e-4, field)
        seen["turning"] += int(np.asarray(want["turning"]).sum())
        seen["diverging"] += int(np.asarray(want["diverging"]).sum())
        seen["complete"] += int((np.asarray(want["n"]) == n_leaves).sum())
    assert seen["complete"] > 0 and seen["turning"] > 0
    assert (seen["diverging"] > 0) == (eps == 4.5)
    assert set(SUBTREE_FIELDS) <= set(got)


def test_axis_name_waits_for_the_parallel_package(chain):
    """``axis_name`` has no effect on a NUTS step (the JAX package uses it only
    to mark loop carries for ``shard_map``); ``sample`` with an axis name that
    no initialized process group carries raises ValueError."""
    port, _ = chain
    a = VectorizedNUTS(port, max_depth=4)
    z = as_tensor(points(5, 16, 3, scale=2.0)[0])
    plain = a._nuts_step(seeded_generator(3), z, 0.4)
    named = a._nuts_step(seeded_generator(3), z, 0.4, axis_name="chains")
    for got, want in zip(named, plain):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="chains"):
        a.sample(np.zeros(3), num_samples=1, axis_name="chains")


# ---------------------------------------------------------------------- #
# by distribution, against the closed-form joint
# ---------------------------------------------------------------------- #
def test_hmc_moments():
    ref = jax_pair2d()
    hmc = HamiltonianMC(to_port_lgbn(ref))
    samples = hmc.sample(np.zeros(2), num_samples=900, trajectory_length=6, n_chains=16,
                         seed=0, return_type="array")
    assert samples.shape == (900, 16, 2)
    pooled = samples[200:].reshape(-1, 2)
    _, mean, cov = ref.joint_gaussian()
    np.testing.assert_allclose(pooled.mean(axis=0), mean, atol=0.25)
    np.testing.assert_allclose(np.cov(pooled.T), cov, atol=0.6)
    assert hmc.acceptance_rate > 0.5
    assert hmc.accepted_proposals == pytest.approx(hmc.acceptance_rate * 900 * 16)


def test_hmcda_adapts(chain):
    port, ref = chain
    hmc = HamiltonianMCDA(port)
    samples = hmc.sample(np.zeros(3), num_adapt=100, num_samples=800, trajectory_length=8,
                         n_chains=8, seed=0, return_type="array")
    pooled = samples[200:].reshape(-1, 3)
    _, mean, _ = ref.joint_gaussian()
    np.testing.assert_allclose(pooled.mean(axis=0), mean, atol=0.4)
    assert 0.3 < hmc.acceptance_rate <= 1.0


def test_host_nuts_moments():
    ref = jax_pair2d(0.0, 1.0, 0.8)
    sampler = NoUTurnSampler(to_port_lgbn(ref), max_depth=6)
    samples = sampler.sample(np.zeros(2), num_samples=600, seed=0, return_type="array")
    _, mean, cov = ref.joint_gaussian()
    np.testing.assert_allclose(samples[100:].mean(axis=0), mean, atol=0.3)
    np.testing.assert_allclose(np.cov(samples[100:].T), cov, atol=0.6)


def test_vectorized_nuts_moments_and_adaptation():
    ref = jax_pair2d()
    sampler = VectorizedNUTS(to_port_lgbn(ref), max_depth=6)
    samples = sampler.sample(np.zeros(2), num_samples=200, num_adapt=80, stepsize=0.1,
                             n_chains=64, seed=0)
    assert samples.shape == (200, 64, 2) and samples.dtype == np.float32
    pooled = samples[50:].reshape(-1, 2)
    _, mean, cov = ref.joint_gaussian()
    np.testing.assert_allclose(pooled.mean(axis=0), mean, atol=0.2)
    np.testing.assert_allclose(np.cov(pooled.T), cov, atol=0.6)
    assert 0.6 < sampler.acceptance_rate <= 1.0
    assert 0.1 < sampler.final_stepsize < 3.0
    # one read per leaf iteration, one more where each subtree ends, one per
    # doubling and one per step
    assert sampler.leaf_iterations > 280
    assert sampler.leaf_iterations < sampler.host_reads <= 2 * sampler.leaf_iterations + 2 * 280 * 7


def test_vectorized_nuts_matches_the_joint_on_three_dimensions(chain):
    port, ref = chain
    sampler = VectorizedNUTS(port, max_depth=6)
    samples = sampler.sample(np.zeros(3), num_samples=200, num_adapt=80, n_chains=32, seed=0)
    pooled = samples[50:].reshape(-1, 3)
    _, mean, cov = ref.joint_gaussian()
    np.testing.assert_allclose(pooled.mean(axis=0), mean, atol=0.3)
    np.testing.assert_allclose(np.sqrt(np.diag(np.cov(pooled.T))), np.sqrt(np.diag(cov)),
                               rtol=0.15)
    frame = sampler.sample(np.zeros(3), num_samples=3, n_chains=2, seed=0,
                           return_type="dataframe")
    assert list(frame.columns) == ["x1", "x2", "x3"] and len(frame) == 3


def test_same_seed_same_draws(chain):
    port, _ = chain
    sampler = VectorizedNUTS(port, max_depth=4)
    a = sampler.sample(np.zeros(3), num_samples=5, num_adapt=3, n_chains=8, seed=2)
    assert np.array_equal(a, sampler.sample(np.zeros(3), num_samples=5, num_adapt=3,
                                            n_chains=8, seed=2))
    assert not np.array_equal(a, sampler.sample(np.zeros(3), num_samples=5, num_adapt=3,
                                                n_chains=8, seed=3))
    hmc = HamiltonianMC(port)
    b = hmc.sample(np.zeros(3), 5, trajectory_length=2, stepsize=0.5, n_chains=4, seed=1,
                   return_type="array")
    assert np.array_equal(b, hmc.sample(np.zeros(3), 5, trajectory_length=2, stepsize=0.5,
                                        n_chains=4, seed=1, return_type="array"))
    # one start position per chain is taken as given
    starts = np.arange(12.0).reshape(4, 3)
    c = hmc.sample(starts, 1, trajectory_length=0.01, stepsize=0.01, seed=1, return_type="array")
    np.testing.assert_allclose(c[0], starts, atol=0.2)
