"""K8 on the CPU: the NUTS transition and the HMC trajectory of the port
(``ops/hmc.py``) against ``pgmpy_tpu``, and what a CPU test can see of the
kernels of ``csrc/hmc.cu``.

* JAX parity on JAX's own draws: the test splits each chain's key as
  ``nuts_jax.py``'s ``_nuts_step`` (``:187``, ``:211``) and
  ``_build_subtree`` (``:117``) do, with ``bernoulli(k)`` as ``uniform(k) <
  0.5``, and feeds the draws as explicit noise to the port's plain
  ``nuts_step_reference``; HMC likewise against ``HamiltonianMC._kernel``
  (``hmc.py:136``).  Both packages in float32: the proposals at rtol 1e-5
  (atol 1e-5), the accept flags equal, the NUTS acceptance statistics
  within 1e-5 and the HMC rates within 1e-4 (numbers in [0, 1], each
  ``exp`` of a difference of float32 energies, whose rounding grows with
  the energies: a diverging tree's, or ecoli70's 46 dimensions).  Each case first asserts its
  premise: no decision of the run (a direction, a take or bias uniform
  against its probability, a U-turn dot product against 0, a divergence
  against -1000, an HMC accept) lies within 1e-4 of its threshold, so a
  mismatch is a fault and not a rounding.
* The kernel's schedule walked in numpy, float64, one chain at a time (the
  leaf loop, checkpoint slots from the bit count, the noise read at (depth,
  leaf)) and in its order of sums (each coordinate of the product as four
  partial sums over the rows i mod 4, every dot product as the lanes' sums
  and a butterfly), held to the batched plain version at 1e-12 relative on
  explicit noise.  It is the only CPU check of what the kernel computes; the walk
  also gives the parity cases their decision margins.
* ``GaussianTarget``: value and closed-form gradient against ``torch.func``
  on the log-density closure it replaced (1e-6 in float32, 1e-12 in
  float64); routing (a callable still samples, on the plain version; a
  GaussianTarget on the CPU takes the plain version); the kernels' dimension
  limit.

One JAX compile per target dimension serves both step sizes (the step size
is an argument of the jitted step)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgmpy_tpu.sampling import hmc as jax_hmc
from pgmpy_tpu.sampling import nuts_jax

from _torch_parity import random_lgbn_pair, to_port_lgbn
from pgmpy_tpu_torch.ops import hmc as hmc_ops
from pgmpy_tpu_torch.ops.hmc import GaussianTarget, HmcNoise, NutsNoise
from pgmpy_tpu_torch.sampling import HamiltonianMC, VectorizedNUTS
from pgmpy_tpu_torch.utils import get_example_model
from pgmpy_tpu_torch.utils.mathext import seeded_generator

CHAINS = 64
MAX_DEPTH = 6
MARGIN = 1e-4


def jax_chain():
    from pgmpy_tpu.factors import LinearGaussianCPD as JaxCPD
    from pgmpy_tpu.models import LinearGaussianBayesianNetwork as JaxLGBN

    model = JaxLGBN([("x1", "x2"), ("x2", "x3")])
    model.add_cpds(JaxCPD("x1", [1], 4), JaxCPD("x2", [-5, 0.5], 4, evidence=["x1"]),
                   JaxCPD("x3", [4, -1], 3, evidence=["x2"]))
    return model


@pytest.fixture(scope="module")
def targets():
    """name -> (mean, cov, the JAX package's log-density, stable and
    diverging step sizes, start scale).  The chain and the random network
    come through ``pgmpy_tpu``'s own ``_resolve_log_pdf``; ecoli70's joint
    through the same closure built from the port's copy of the network."""
    out = {}
    ref = jax_chain()
    _, mean, cov = to_port_lgbn(ref).joint_gaussian()
    out["chain3"] = (mean, cov, jax_hmc._resolve_log_pdf(ref)[0], (1.1, 4.4), 4.0)
    port, ref = random_lgbn_pair(5)
    variables, mean, cov = port.joint_gaussian()
    assert variables == list(ref.joint_gaussian()[0])
    out["random12"] = (mean, cov, jax_hmc._resolve_log_pdf(ref)[0], (0.3, 0.65), 3.0)
    _, mean, cov = get_example_model("ecoli70").joint_gaussian()
    prec, mu = jnp.asarray(np.linalg.inv(cov)), jnp.asarray(mean)
    out["ecoli70"] = (mean, cov, lambda x: -0.5 * (x - mu) @ prec @ (x - mu), (0.17, 0.3), 1.0)
    return out


def starts(seed, mean, cov, scale):
    rng = np.random.default_rng(seed)
    return mean + scale * rng.normal(size=(CHAINS, len(mean))) * np.sqrt(np.diag(cov))


# ---------------------------------------------------------------------- #
# the kernel's schedule, one chain at a time, in numpy float64
# ---------------------------------------------------------------------- #
def lanes(v):
    """A vector as the kernel's warp holds it: lane l keeps coordinates l,
    l + 32, ... (zeros past the end), (32, K)."""
    k = hmc_ops.lane_coords(len(v))
    return np.concatenate([v, np.zeros(32 * k - len(v))]).reshape(k, 32).T


def warp_dot(a, b):
    """a . b in the kernel's order: each lane's products summed over its
    coordinates, then the butterfly of five shuffle rounds."""
    va, vb = lanes(a), lanes(b)
    v = np.zeros(32)
    for k in range(va.shape[1]):
        v = v + va[:, k] * vb[:, k]
    for offset in (16, 8, 4, 2, 1):
        v = v + v[np.arange(32) ^ offset]
    return v[0]


def kernel_gradient(mean, prec):
    """(g, log-density) at x in the kernel's order: g_j = -((s_0 + s_1) +
    (s_2 + s_3)), s_m the products P[i, j] (x - mu)_i over the rows i = m
    mod 4 in increasing i; the log-density half the warp sum of (x - mu) . g."""
    dim = len(mean)
    parts = [np.arange(m, dim, 4) for m in range(4)]

    def grad_value(x):
        d = x - mean
        s = []
        for rows in parts:
            acc = np.zeros(dim)
            for i in rows:
                acc = acc + prec[i] * d[i]
            s.append(acc)
        g = -((s[0] + s[1]) + (s[2] + s[3]))
        return g, 0.5 * warp_dot(d, g)

    return grad_value


def walk_nuts(mean, prec, z, eps, max_depth, noise, margins=None):
    """Per chain, the kernel's control flow: the doublings, the leaf loop,
    the checkpoint slot ``popcount(leaf >> 1)``, the closed subtrees from the
    trailing ones of ``leaf``, the noise read at (depth, leaf).  Appends to
    ``margins`` each decision's distance from its threshold (a take or bias
    probability strictly between 0 and 1 only).  Returns (proposals,
    acceptance statistics, leapfrog counts, turned, diverged)."""
    prec = 0.5 * (prec + prec.T)
    r0, dir_u, bias_u, take_u = (np.asarray(t, dtype=np.float64) for t in noise)
    record = margins.append if margins is not None else (lambda _: None)
    grad_value = kernel_gradient(mean, prec)

    def turning(a, b, rho):
        x, y = warp_dot(rho, a), warp_dot(rho, b)
        record(abs(x))
        record(abs(y))
        return x <= 0 or y <= 0

    out = []
    for c in range(z.shape[0]):
        g0, logp0 = grad_value(z[c])
        energy0 = logp0 - 0.5 * warp_dot(r0[c], r0[c])
        zl = zr = zp = z[c]
        rl = rr = rho = r0[c]
        gl = gr = g0
        logw, sum_accept, n_leaf = 0.0, 0.0, 0
        stopped = turned = diverged = False
        for depth in range(max_depth):
            if stopped:
                break
            record(abs(dir_u[c, depth] - 0.5))
            right = dir_u[c, depth] < 0.5
            d = 1.0 if right else -1.0
            x, r, g = (zr, d * rr, gr) if right else (zl, d * rl, gl)
            rho_s, x_prop = np.zeros_like(x), x
            r_ck, rho_ck = np.zeros((max_depth, len(x))), np.zeros((max_depth, len(x)))
            logw_s, sub_accept, leaves = -np.inf, 0.0, 0
            sub_turning = sub_diverging = False
            for leaf in range(2**depth):
                if sub_turning or sub_diverging:
                    break
                r = r + 0.5 * eps * g
                x = x + eps * r
                g, logp = grad_value(x)
                r = r + 0.5 * eps * g
                delta = logp - 0.5 * warp_dot(r, r) - energy0
                record(abs(delta + hmc_ops.DELTA_MAX))
                diverging = delta < -hmc_ops.DELTA_MAX
                logw_leaf = -np.inf if diverging else delta
                logw_new = np.logaddexp(logw_s, logw_leaf)
                p_leaf = 0.0 if logw_new == -np.inf else np.exp(logw_leaf - logw_new)
                if 0.0 < p_leaf < 1.0:
                    record(abs(take_u[c, depth, leaf] - p_leaf))
                rho_s = rho_s + r
                idx_max = bin(leaf >> 1).count("1")
                if leaf % 2 == 0:
                    r_ck[idx_max], rho_ck[idx_max] = r, rho_s
                else:
                    closes = bin(leaf ^ (leaf + 1)).count("1") - 1
                    for i in range(idx_max, idx_max - closes, -1):
                        if turning(r_ck[i], r, rho_s - rho_ck[i] + r_ck[i]):
                            sub_turning = True
                            break
                if take_u[c, depth, leaf] < p_leaf:
                    x_prop = x
                logw_s = logw_new
                sub_diverging = sub_diverging or diverging
                sub_accept += min(np.exp(delta), 1.0)
                leaves += 1
            valid = not (sub_turning or sub_diverging)
            accept_p = np.exp(min(logw_s - logw, 0.0))
            if valid:
                if 0.0 < accept_p < 1.0:
                    record(abs(bias_u[c, depth] - accept_p))
                if bias_u[c, depth] < accept_p:
                    zp = x_prop
                logw = np.logaddexp(logw, logw_s)
                if right:
                    zr, rr, gr = x, d * r, g
                else:
                    zl, rl, gl = x, d * r, g
                rho = rho + d * rho_s
            whole = turning(rl, rr, rho)
            turned = turned or sub_turning or (valid and whole)
            diverged = diverged or sub_diverging
            stopped = not valid or whole
            sum_accept += sub_accept
            n_leaf += leaves
        out.append((zp, sum_accept / max(n_leaf, 1), n_leaf, turned, diverged))
    return tuple(np.array(field) for field in zip(*out))


def walk_hmc(mean, prec, z, eps, n_steps, momentum, accept_u, margins=None):
    """Per chain, the HMC kernel's loop: ``n_steps`` leapfrog steps and the
    accept; returns (positions, accept flags, rates)."""
    prec = 0.5 * (prec + prec.T)
    grad_value = kernel_gradient(mean, prec)
    out = []
    for c in range(z.shape[0]):
        g, logp = grad_value(z[c])
        current_h = logp - 0.5 * warp_dot(momentum[c], momentum[c])
        q, p = z[c], momentum[c]
        for _ in range(n_steps):
            p = p + 0.5 * eps * g
            q = q + eps * p
            g, logp = grad_value(q)
            p = p + 0.5 * eps * g
        log_accept = min(logp - 0.5 * warp_dot(p, p) - current_h, 0.0)
        if margins is not None and log_accept < 0:
            margins.append(abs(np.log(accept_u[c]) - log_accept))
        accept = np.log(accept_u[c]) < log_accept
        out.append((q if accept else z[c], accept, np.exp(log_accept)))
    return tuple(np.array(field) for field in zip(*out))


def numpy_nuts_noise(seed, n, dim, max_depth):
    rng = np.random.default_rng(seed)
    return NutsNoise(*(torch.as_tensor(a) for a in (
        rng.normal(size=(n, dim)), rng.random((n, max_depth)), rng.random((n, max_depth)),
        rng.random((n, max_depth, 2 ** (max_depth - 1))))))


@pytest.mark.parametrize("name", ["chain3", "random12", "ecoli70"])
def test_numpy_walk_of_the_kernel_matches_the_plain_version(targets, name):
    """float64, explicit noise, both step sizes: the proposals, acceptance
    statistics, leapfrog counts and flags of every chain."""
    mean, cov, _, steps, scale = targets[name]
    prec = np.linalg.inv(cov)
    target = GaussianTarget(mean, prec, dtype=torch.float64, device="cpu")
    z = starts(1, mean, cov, scale)
    seen = {"turned": 0, "diverged": 0}
    for k, eps in enumerate(steps):
        noise = numpy_nuts_noise(10 + k, CHAINS, len(mean), MAX_DEPTH)
        got = hmc_ops.nuts_step_reference(target, torch.as_tensor(z), eps, MAX_DEPTH, noise)
        want = walk_nuts(mean, prec, z, eps, MAX_DEPTH, noise)
        assert got.leapfrogs.tolist() == want[2].tolist()
        assert got.turned.tolist() == want[3].tolist()
        assert got.diverged.tolist() == want[4].tolist()
        scale_z = np.abs(want[0]).max(axis=1, keepdims=True)
        np.testing.assert_allclose(got.z.numpy(), want[0], rtol=0, atol=1e-12 * scale_z.max())
        np.testing.assert_allclose(got.accept.numpy(), want[1], rtol=1e-12, atol=1e-15)
        seen["turned"] += int(want[3].sum())
        seen["diverged"] += int(want[4].sum())
    assert seen["turned"] > 0 and seen["diverged"] > 0

    momentum = np.random.default_rng(3).normal(size=(CHAINS, len(mean)))
    accept_u = np.random.default_rng(4).random(CHAINS)
    got = hmc_ops.hmc_step_reference(target, torch.as_tensor(z), steps[0], 7,
                                     HmcNoise(torch.as_tensor(momentum), torch.as_tensor(accept_u)))
    want = walk_hmc(mean, prec, z, steps[0], 7, momentum, accept_u)
    np.testing.assert_allclose(got.z[0].numpy(), want[0], rtol=1e-12, atol=1e-12)
    assert got.accepted[0].tolist() == want[1].tolist()
    np.testing.assert_allclose(got.rate[0].numpy(), want[2], rtol=1e-12, atol=1e-15)


# ---------------------------------------------------------------------- #
# parity with pgmpy_tpu on its own draws
# ---------------------------------------------------------------------- #
def jax_nuts_draws(keys, dim, max_depth):
    """The draws ``_nuts_step`` makes from each chain's key, as NutsNoise:
    ``key, key_r = split(key)`` and ``r0 = normal(key_r, (dim,))``; per
    doubling ``key, key_dir, key_tree, key_bias = split(key, 4)``; per leaf of
    the subtree ``key_tree, key_take = split(key_tree)``."""
    width = 2 ** (max_depth - 1)

    def one(key):
        key, key_r = jax.random.split(key)

        def doubling(key, _):
            key, key_dir, key_tree, key_bias = jax.random.split(key, 4)

            def leaf(k, _):
                k, key_take = jax.random.split(k)
                return k, jax.random.uniform(key_take)

            _, takes = jax.lax.scan(leaf, key_tree, None, length=width)
            return key, (jax.random.uniform(key_dir), jax.random.uniform(key_bias), takes)

        _, (dirs, biases, takes) = jax.lax.scan(doubling, key, None, length=max_depth)
        return jax.random.normal(key_r, (dim,)), dirs, biases, takes

    return NutsNoise(*(torch.as_tensor(np.asarray(a)) for a in jax.jit(jax.vmap(one))(keys)))


@pytest.fixture(scope="module")
def jax_steps(targets):
    """name -> the jitted, chain-vmapped JAX ``_nuts_step`` of the target."""
    steps = {}
    for name, (_, _, log_pdf, _, _) in targets.items():
        sampler = nuts_jax.VectorizedNUTS(log_pdf, max_depth=MAX_DEPTH)
        steps[name] = jax.jit(jax.vmap(lambda k, z, eps, s=sampler: s._nuts_step(k, z, eps),
                                       in_axes=(0, 0, None)))
    return steps


@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("name", ["chain3", "random12", "ecoli70"])
def test_nuts_step_matches_jax_on_its_draws(targets, jax_steps, name, step):
    """The stable step size, and the one past stability where some chains
    diverge."""
    mean, cov, _, steps, scale = targets[name]
    eps = steps[step]
    dim = len(mean)
    z = starts(2, mean, cov, scale).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), CHAINS)
    noise = jax_nuts_draws(keys, dim, MAX_DEPTH)

    margins = []
    walked = walk_nuts(mean, np.linalg.inv(cov), z.astype(np.float64), eps, MAX_DEPTH,
                       NutsNoise(*(t.double() for t in noise)), margins)
    assert min(margins) > MARGIN, f"premise: a decision {min(margins):.2e} from its threshold"
    if step == 1:
        assert walked[4].any() and not walked[4].all()  # some chains diverge
    else:
        assert not walked[4].any()

    want_z, want_accept = (np.asarray(a) for a in jax_steps[name](keys, jnp.asarray(z), eps))
    target = GaussianTarget(mean, np.linalg.inv(cov), dtype=torch.float32, device="cpu")
    got = hmc_ops.nuts_step_reference(target, torch.as_tensor(z), eps, MAX_DEPTH, noise)
    assert got.leapfrogs.tolist() == walked[2].tolist()
    np.testing.assert_allclose(got.z.numpy(), want_z, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.accept.numpy(), want_accept, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["chain3", "random12", "ecoli70"])
def test_hmc_step_matches_jax_on_its_draws(targets, name):
    """``HamiltonianMC._kernel`` vmapped over chains: ``key_mom, key_acc =
    split(key)``, the momentum ``normal(key_mom)``, the uniform
    ``uniform(key_acc)``."""
    mean, cov, log_pdf, steps, _ = targets[name]
    n_steps = 5
    # starts drawn from the joint, where some proposals are rejected
    z = np.random.default_rng(3).multivariate_normal(mean, cov, size=CHAINS).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(1), CHAINS)

    def draws(key):
        key_mom, key_acc = jax.random.split(key)
        return jax.random.normal(key_mom, (len(mean),)), jax.random.uniform(key_acc)

    momentum, accept_u = (np.asarray(a) for a in jax.vmap(draws)(keys))
    margins = []
    walk_hmc(mean, np.linalg.inv(cov), z.astype(np.float64), steps[0], n_steps,
             momentum.astype(np.float64), accept_u.astype(np.float64), margins)
    assert min(margins) > MARGIN, f"premise: an accept {min(margins):.2e} from its threshold"

    sampler = jax_hmc.HamiltonianMC(log_pdf)
    kernel = jax.vmap(lambda k, q: sampler._kernel(k, q, steps[0], n_steps))
    want = [np.asarray(a) for a in kernel(keys, jnp.asarray(z))]
    target = GaussianTarget(mean, np.linalg.inv(cov), dtype=torch.float32, device="cpu")
    got = hmc_ops.hmc_step_reference(target, torch.as_tensor(z), steps[0], n_steps,
                                     HmcNoise(torch.as_tensor(momentum), torch.as_tensor(accept_u)))
    assert got.accepted[0].tolist() == want[1].tolist() and 0 < want[1].sum() < CHAINS
    np.testing.assert_allclose(got.z[0].numpy(), want[0], rtol=1e-5, atol=1e-5)
    # the rate is exp(dH), dH the difference of two float32 energies of
    # about dim in size: its rounding is about 1e-5 at ecoli70's 46
    np.testing.assert_allclose(got.rate[0].numpy(), want[2], rtol=0, atol=1e-4)


# ---------------------------------------------------------------------- #
# GaussianTarget, routing, limits
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6), (torch.float64, 1e-12)])
def test_gaussian_target_matches_autodiff_of_the_closure(targets, dtype, tol):
    """The closure ``_resolve_log_pdf`` built before (``-0.5 diff @ P @
    diff`` with the unsymmetrised inverse) through ``torch.func``."""
    mean, cov, _, _, scale = targets["ecoli70"]
    prec = torch.as_tensor(np.linalg.inv(cov), dtype=dtype)
    mu = torch.as_tensor(mean, dtype=dtype)

    def closure(x):
        diff = x - mu
        return -0.5 * diff @ prec @ diff

    target = GaussianTarget(mean, np.linalg.inv(cov), dtype=dtype, device="cpu")
    x = torch.as_tensor(starts(4, mean, cov, scale), dtype=dtype)
    g, value = target.grad_and_value(x)
    want_g, want_value = torch.func.vmap(torch.func.grad_and_value(closure))(x)
    assert torch.allclose(g, want_g, rtol=tol, atol=tol * float(want_g.abs().max()))
    assert torch.allclose(value, want_value, rtol=tol, atol=tol * float(want_value.abs().max()))
    assert torch.allclose(target(x[0]), closure(x[0]), rtol=tol)
    assert torch.allclose(torch.func.grad(target)(x[0]), want_g[0], rtol=tol,
                          atol=tol * float(want_g.abs().max()))


def test_routing_follows_the_model(targets, monkeypatch):
    mean, cov, _, _, _ = targets["chain3"]
    calls = {"reference": 0}
    reference = hmc_ops.nuts_step_reference

    def counted(*args, **kwargs):
        calls["reference"] += 1
        return reference(*args, **kwargs)

    monkeypatch.setattr(hmc_ops, "nuts_step_reference", counted)
    model = to_port_lgbn(jax_chain())
    nuts = VectorizedNUTS(model, max_depth=4)
    assert isinstance(nuts.log_pdf, GaussianTarget) and nuts._density is nuts.log_pdf
    nuts.sample(mean, num_samples=3, n_chains=4, seed=0)  # a GaussianTarget on the CPU
    assert calls["reference"] == 3
    # a raw callable has no kernel: it samples on the plain version with torch.func
    prec, mu = torch.as_tensor(np.linalg.inv(cov), dtype=torch.float32), torch.as_tensor(
        mean, dtype=torch.float32)
    raw = VectorizedNUTS(lambda x: -0.5 * (x - mu) @ prec @ (x - mu), max_depth=4)
    assert not isinstance(raw.log_pdf, GaussianTarget)
    samples = raw.sample(mean, num_samples=5, n_chains=8, seed=0)
    assert samples.shape == (5, 8, 3) and np.isfinite(samples).all()
    assert calls["reference"] == 8 and 1 <= raw.leaf_iterations <= 15
    hmc = HamiltonianMC(lambda x: -0.5 * (x - mu) @ prec @ (x - mu))
    out = hmc.sample(mean, 4, trajectory_length=1.0, stepsize=0.25, n_chains=3, seed=0,
                     return_type="array")
    assert out.shape == (4, 3, 3) and 0 <= hmc.acceptance_rate <= 1
    # no fallback: the kernel's wrapper takes CUDA tensors only
    target = GaussianTarget(mean, np.linalg.inv(cov), device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        hmc_ops.nuts_step_cuda(target, target.mean[None], 0.1, 4, gen=seeded_generator(0))
    with pytest.raises(TypeError, match="GaussianTarget"):
        hmc_ops.hmc_step_cuda(raw._density, target.mean[None], 0.1, 3, gen=seeded_generator(0))


def test_dimension_limit():
    assert [hmc_ops.lane_coords(d) for d in (1, 32, 33, 46, 64, 65, 129, 256)] == \
        [1, 1, 2, 2, 2, 4, 8, 8]
    # float32: 227 KB hold P padded to 256 columns for 214 rows and one
    # warp's row and 12 checkpoints (max_depth 6); float64 at most 4 a lane
    assert hmc_ops.max_dim("nuts_step", torch.float32, 6) == 214
    assert hmc_ops.max_dim("hmc_step", torch.float32) == 226
    assert hmc_ops.max_dim("nuts_step", torch.float64, 6) == 128
    # ecoli70's 46 dimensions: P in the lanes' registers (64 rows x 2
    # columns), shared memory only for 4 warps' 12 checkpoints
    assert hmc_ops.plan("nuts_step", 46, torch.float32, 6) == (2, 4, 4 * 64 * 4 * 12, True)
    assert hmc_ops.plan("hmc_step", 46, torch.float32) == (2, 4, 0, True)
    assert hmc_ops.plan("nuts_step", 32, torch.float64, 6) == (1, 4, 8 * 32 * 4 * 12, True)
    # wider targets keep P in shared memory
    assert hmc_ops.plan("nuts_step", 65, torch.float32, 6) == (4, 4, 4 * 128 * (65 + 4 * 13),
                                                               False)
    assert not hmc_ops.plan("nuts_step", 33, torch.float64, 6)[3]
    assert hmc_ops.plan("nuts_step", 200, torch.float32, 6)[1:4:2] == (2, False)
    assert [hmc_ops.register_form(d, 4) for d in (1, 46, 64, 65)] == [True, True, True, False]
    with pytest.raises(ValueError, match="limit of 214"):
        hmc_ops.plan("nuts_step", 215, torch.float32, 6)
    with pytest.raises(ValueError, match="limit of 128"):
        hmc_ops.plan("hmc_step", 129, torch.float64)
    lo, hi = hmc_ops.nuts_bound_ms(GaussianTarget(np.zeros(46), np.eye(46), device="cpu"),
                                   torch.full((1024,), 20))
    assert hi == "operations" and lo == pytest.approx(1024 * 21 * (2 * 46**2 + 12 * 46) / 67e9)
