"""K8 on the card: the NUTS and HMC kernels of ``csrc/hmc.cu`` against their
plain PyTorch versions on the same card, their launch counters, their
Philox draws (the same seed, and the moments of the joint) and the
dimension limit.  Every test here needs a CUDA device and skips without one;
on a GPU machine: ``python -m pytest tests/test_torch_nuts_kernel_cuda.py -m
cuda -s``.

Targets: a 3-dimensional chain, a random 12-node linear-Gaussian network and
ecoli70 (46 dimensions), 1,024 chains each, at a stable step size and one
past stability where some chains diverge.  Tolerances, on the same explicit
noise:

* float64: every chain's leapfrog count, U-turn and divergence flags equal,
  positions and acceptance statistics within 1e-9 (of each chain's scale);
* float32: where a chain's leapfrog count agrees, positions within 1e-4 of
  the chain's scale and acceptance statistics within 1e-4.  A U-turn test
  is the sign of a dot product, which another summation order (the kernel's
  warp butterfly, the plain version's cuBLAS product) can flip near 0, so up
  to 1 chain in 256 may take another count; the test prints how many did.
"""

import numpy as np
import pytest
import torch

from _torch_parity import random_lgbn_tuples
from pgmpy_tpu_torch.config import config
from pgmpy_tpu_torch.models import LinearGaussianBayesianNetwork
from pgmpy_tpu_torch.ops import hmc as hmc_ops
from pgmpy_tpu_torch.ops.hmc import GaussianTarget, HmcNoise, nuts_noise
from pgmpy_tpu_torch.sampling import HamiltonianMC, HamiltonianMCDA, VectorizedNUTS
from pgmpy_tpu_torch.utils import get_example_model
from pgmpy_tpu_torch.utils.interop import lgbn_from_numpy
from pgmpy_tpu_torch.utils.mathext import seeded_generator

CHAINS = 1024
MAX_DEPTH = 6
# name -> (stable step size, step size past stability)
STEPS = {"chain3": (1.1, 4.4), "random12": (0.3, 0.65), "ecoli70": (0.17, 0.3)}


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
    if name == "chain3":
        return lgbn_from_numpy([("x1", "x2"), ("x2", "x3")],
                               [("x1", [], np.array([1.0]), 4.0),
                                ("x2", ["x1"], np.array([-5.0, 0.5]), 4.0),
                                ("x3", ["x2"], np.array([4.0, -1.0]), 3.0)])
    if name == "random12":
        names, edges, cpds = random_lgbn_tuples(5)
        return lgbn_from_numpy(edges, cpds, nodes=names)
    return get_example_model(name)


def _case(name, dtype):
    """(target, starts (CHAINS, dim) on the card: the mean plus 1.5 joint
    standard deviations of noise per coordinate)."""
    model = _model(name)
    assert isinstance(model, LinearGaussianBayesianNetwork)
    _, mean, cov = model.joint_gaussian()
    target = GaussianTarget(mean, np.linalg.inv(cov), dtype=dtype, device="cuda")
    rng = np.random.default_rng(7)
    z = mean + 1.5 * rng.normal(size=(CHAINS, len(mean))) * np.sqrt(np.diag(cov))
    return target, torch.as_tensor(z, dtype=dtype, device="cuda")


def _scale(z):
    return z.abs().amax(dim=1, keepdim=True).clamp_min(1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["chain3", "random12", "ecoli70"])
def test_nuts_kernel_matches_plain(on_cuda, name, dtype, step):
    target, z = _case(name, dtype)
    eps = STEPS[name][step]
    noise = nuts_noise(CHAINS, target.dim, MAX_DEPTH, seeded_generator(3, "cuda"), dtype)
    got = hmc_ops.nuts_step_cuda(target, z, eps, MAX_DEPTH, noise)
    want = hmc_ops.nuts_step_reference(target, z, eps, MAX_DEPTH, noise)
    torch.cuda.synchronize()
    same = ((got.leapfrogs == want.leapfrogs) & (got.turned == want.turned)
            & (got.diverged == want.diverged))
    differ = int((~same).sum())
    err = float(((got.z - want.z).abs() / _scale(want.z))[same].max())
    acc_err = float((got.accept - want.accept).abs()[same].max())
    print(f"nuts {name} {dtype} eps {eps}: {differ} of {CHAINS} chains took another leapfrog "
          f"count or flag; positions max rel err {err:.3e}, acceptance {acc_err:.3e}; "
          f"diverged {int(want.diverged.sum())}, turned {int(want.turned.sum())}, mean "
          f"leapfrogs {float(want.leapfrogs.float().mean()):.2f}")
    if dtype == torch.float64:
        assert differ == 0 and err <= 1e-9 and acc_err <= 1e-9
    else:
        assert differ <= CHAINS // 256 and err <= 1e-4 and acc_err <= 1e-4
    if step == 1:
        assert bool(want.diverged.any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["chain3", "random12", "ecoli70"])
def test_hmc_kernel_matches_plain(on_cuda, name, dtype):
    """Three transitions of 8 leapfrog steps in one launch; accept flags
    equal but for 1 chain in 256 in float32 (a rounding of dH near log u)."""
    target, z = _case(name, dtype)
    gen = seeded_generator(4, "cuda")
    noise = HmcNoise(torch.randn((3, CHAINS, target.dim), generator=gen, dtype=dtype,
                                 device="cuda"),
                     torch.rand((3, CHAINS), generator=gen, dtype=dtype, device="cuda"))
    eps = STEPS[name][0]
    got = hmc_ops.hmc_step_cuda(target, z, eps, 8, noise, transitions=3)
    want = hmc_ops.hmc_step_reference(target, z, eps, 8, noise, transitions=3)
    same = (got.accepted == want.accepted).all(dim=0)
    differ = int((~same).sum())
    err = float(((got.z - want.z).abs() / _scale(want.z))[:, same].max())
    rate_err = float((got.rate - want.rate).abs()[:, same].max())
    print(f"hmc {name} {dtype}: {differ} of {CHAINS} chains accepted otherwise; positions max "
          f"rel err {err:.3e}, rates {rate_err:.3e}; accepted {float(want.accepted.float().mean()):.3f}")
    if dtype == torch.float64:
        assert differ == 0 and err <= 1e-9 and rate_err <= 1e-9
    else:
        assert differ <= CHAINS // 256 and err <= 1e-4 and rate_err <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("name, dtype", [("chain3", torch.float64), ("chain3", torch.float32),
                                         ("random12", torch.float64),
                                         ("random12", torch.float32),
                                         ("ecoli70", torch.float32)])
def test_precision_in_shared_memory_matches_the_register_form(on_cuda, name, dtype,
                                                             monkeypatch):
    """The two places of P (``ops.hmc.register_form``) sum the same
    products in the same order: the kernels' results are equal to the bit,
    NUTS and HMC, on every target that fits the registers."""
    assert hmc_ops.register_form(len(_model(name).nodes()), torch.empty((), dtype=dtype)
                                 .element_size())
    target, z = _case(name, dtype)
    noise = nuts_noise(CHAINS, target.dim, MAX_DEPTH, seeded_generator(5, "cuda"), dtype)
    gen = seeded_generator(6, "cuda")
    hmc_noise = HmcNoise(torch.randn((2, CHAINS, target.dim), generator=gen, dtype=dtype,
                                     device="cuda"),
                         torch.rand((2, CHAINS), generator=gen, dtype=dtype, device="cuda"))
    eps = STEPS[name][0]
    runs = []
    for form in (True, False):
        monkeypatch.setattr(hmc_ops, "register_form", lambda dim, elem, form=form: form)
        runs.append((hmc_ops.nuts_step_cuda(target, z, eps, MAX_DEPTH, noise),
                     hmc_ops.hmc_step_cuda(target, z, eps, 8, hmc_noise, transitions=2)))
    (nuts_a, hmc_a), (nuts_b, hmc_b) = runs
    for a, b in zip(tuple(nuts_a)[:5] + tuple(hmc_a), tuple(nuts_b)[:5] + tuple(hmc_b)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_same_seed_same_samples(on_cuda):
    model = _model("random12")
    _, mean, _ = model.joint_gaussian()
    nuts = VectorizedNUTS(model, max_depth=MAX_DEPTH)
    run = dict(num_samples=4, num_adapt=3, stepsize=0.3, n_chains=256)
    first = nuts.sample(mean, seed=1, **run)
    assert np.array_equal(first, nuts.sample(mean, seed=1, **run))
    assert not np.array_equal(first, nuts.sample(mean, seed=2, **run))
    hmc = HamiltonianMC(model)
    run = dict(trajectory_length=2.0, stepsize=0.25, n_chains=256, return_type="array")
    first = hmc.sample(mean, 5, seed=1, **run)
    assert np.array_equal(first, hmc.sample(mean, 5, seed=1, **run))
    assert not np.array_equal(first, hmc.sample(mean, 5, seed=2, **run))


def _moments_ok(samples, mean, cov, n_effective):
    """Pooled means within 6 standard errors and standard deviations within
    6 / sqrt(2 n) of the joint's, at ``n_effective`` independent draws."""
    sd = np.sqrt(np.diag(cov))
    mean_err = np.abs((samples.mean(axis=0) - mean) / sd).max()
    sd_err = np.abs(samples.std(axis=0) / sd - 1).max()
    assert mean_err <= 6 / np.sqrt(n_effective), mean_err
    assert sd_err <= 6 / np.sqrt(2 * n_effective), sd_err


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["random12", "ecoli70"])
def test_moments_against_the_joint(on_cuda, name):
    """Kernel draws (Philox) by distribution; an autocorrelation time of 10
    transitions is allowed for NUTS, each HMC chain counts as one draw."""
    model = _model(name)
    _, mean, cov = model.joint_gaussian()
    nuts = VectorizedNUTS(model, max_depth=MAX_DEPTH)
    samples = nuts.sample(mean, num_samples=60, num_adapt=40, stepsize=STEPS[name][0],
                          n_chains=CHAINS, seed=0)
    pooled = samples.reshape(-1, len(mean)).astype(np.float64)
    _moments_ok(pooled, mean, cov, pooled.shape[0] / 10)
    assert 0.6 < nuts.acceptance_rate <= 1.0 and nuts.host_reads == 100
    hmc = HamiltonianMCDA(model)
    samples = hmc.sample(mean, num_adapt=30, num_samples=100, trajectory_length=3.0,
                         stepsize=STEPS[name][0], n_chains=256, seed=0, return_type="array")
    _moments_ok(samples[30:].reshape(-1, len(mean)).astype(np.float64), mean, cov, 256)


@pytest.mark.cuda
def test_one_launch_per_transition(on_cuda):
    model = _model("ecoli70")
    _, mean, _ = model.joint_gaussian()
    hmc_ops.reset_launches()
    nuts = VectorizedNUTS(model, max_depth=MAX_DEPTH)
    nuts.sample(mean, num_samples=5, num_adapt=4, stepsize=0.17, n_chains=CHAINS, seed=0)
    assert hmc_ops.LAUNCHES == {"nuts_step": 9, "hmc_step": 0} and nuts.host_reads == 9
    HamiltonianMC(model).sample(mean, 7, trajectory_length=1.0, stepsize=0.17, n_chains=64,
                                seed=0)
    assert hmc_ops.LAUNCHES["hmc_step"] == 1
    HamiltonianMCDA(model).sample(mean, num_adapt=5, num_samples=7, trajectory_length=1.0,
                                  stepsize=0.17, n_chains=64, seed=0)
    assert hmc_ops.LAUNCHES["hmc_step"] == 1 + 5 + 1


@pytest.mark.cuda
def test_a_dimension_past_the_limit_raises(on_cuda):
    for kernel, dtype, dim in (("nuts_step", torch.float32, 215), ("hmc_step", torch.float64, 129)):
        limit = hmc_ops.max_dim(kernel, dtype, MAX_DEPTH)
        assert dim == limit + 1
        target = GaussianTarget(np.zeros(dim), np.eye(dim), dtype=dtype, device="cuda")
        z = torch.zeros((4, dim), dtype=dtype, device="cuda")
        with pytest.raises(ValueError, match=f"limit of {limit}"):
            if kernel == "nuts_step":
                hmc_ops.nuts_step(target, z, 0.1, MAX_DEPTH, gen=seeded_generator(0, "cuda"))
            else:
                hmc_ops.hmc_step(target, z, 0.1, 3, gen=seeded_generator(0, "cuda"))
    # at the limit it runs
    dim = hmc_ops.max_dim("nuts_step", torch.float32, MAX_DEPTH)
    target = GaussianTarget(np.zeros(dim), np.eye(dim), dtype=torch.float32, device="cuda")
    out = hmc_ops.nuts_step(target, torch.zeros((64, dim), device="cuda"), 0.5, MAX_DEPTH,
                            gen=seeded_generator(0, "cuda"))
    assert bool(torch.isfinite(out.z).all()) and int(out.leapfrogs.min()) >= 1
