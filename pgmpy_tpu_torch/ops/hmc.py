"""The NUTS transition and the HMC trajectory (K8) of a Gaussian target.

The model that reaches these programs is a linear-Gaussian network, turned
into ``log p(x) = -0.5 (x - mu)^T P (x - mu)`` with ``P = inv(cov)``
(symmetrised, from float64 on the host): :class:`GaussianTarget`.  Its
gradient is the closed form ``g = -P (x - mu)`` and its value ``0.5 (x - mu)
. g``; nothing needs autograd.

* :func:`nuts_step`: one multinomial No-U-Turn transition of every chain
  (Betancourt 2017: progressive doublings in a random direction, each grown
  leaf by leaf with one leapfrog step per leaf, the progressive multinomial
  proposal inside a subtree and the biased one between halves, the
  momentum-checkpoint U-turn checks at odd leaves, the whole-tree check
  after each doubling, divergence below -1000).  Returns a
  :class:`Transition`: the proposals, each chain's mean leaf acceptance
  statistic, its leapfrog count and whether its tree ended on a U-turn or a
  divergence.
* :func:`hmc_step`: ``transitions`` HMC transitions of every chain, each
  ``n_steps`` leapfrog steps and a Metropolis accept with
  ``log(u) < min(0, dH)``.  Returns an :class:`HmcSteps`: the positions
  after each transition ``(transitions, n, dim)``, the accept flags and
  ``exp(min(0, dH))``.

On a CUDA tensor each is ONE launch of a hand-written kernel of
``csrc/hmc.cu`` (built with ``nvcc`` at first use; one warp per chain, the
precision matrix in the lanes' registers where it fits, else in shared
memory: :func:`register_form`), random numbers from Philox keyed on one
64-bit draw from the call's generator.  A build or launch failure raises.
On a CPU tensor each is its plain version, :func:`nuts_step_reference` /
:func:`hmc_step_reference`: batched masked torch ops, the chains that are
done frozen by ``torch.where``, one host read of ``any`` per leaf.  The
plain versions also take any object with ``grad_and_value`` (a density that
no kernel computes: ``sampling/hmc.py`` sends a raw callable there on every
device).

Both take an explicit ``noise`` in place of the generator:
:class:`NutsNoise` (``r0 (n, dim)`` normals; ``dir_u (n, max_depth)``,
``bias_u (n, max_depth)`` and ``take_u (n, max_depth, 2**(max_depth-1))``
uniforms: the direction of doubling ``depth`` is right where ``dir_u <
0.5``, its half is taken where ``bias_u`` is below ``min(1, W_new / W_old)``,
and leaf ``k`` of it becomes the subtree's proposal where ``take_u[depth, k]``
is below the leaf's share of the subtree's weight) and :class:`HmcNoise`
(``momentum (transitions, n, dim)``, ``accept_u (transitions, n)``).

It replaces ``pgmpy_tpu/sampling/nuts_jax.py:88`` ``_build_subtree``,
``:185`` ``_nuts_step`` and the chains' ``vmap`` of ``:266`` ``sample``, and
``pgmpy_tpu/sampling/hmc.py:121`` ``_leapfrog``, ``:135`` ``_kernel`` and the
``scan`` of ``:147`` ``sample``.  ``LAUNCHES`` counts each kernel's launches;
:func:`reset_launches` zeroes them.
"""

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from pgmpy_tpu_torch.config import config
from pgmpy_tpu_torch.ops._build import load_library

DELTA_MAX = 1000.0  # a leaf whose energy falls more than this below the start diverges
SHARED_LIMIT = 232_448  # bytes of shared memory one block may use on Hopper (227 KB)
MAX_LANE_COORDS = {4: 8, 8: 4}  # coordinates a lane holds at most, by element size
WARPS = 4  # chains a block at most (one warp each)
# published peak of one H100 SXM for float32 outside the tensor cores, and
# operations per leapfrog step and chain beyond the matrix-vector product
PLAIN_OPS_PER_S = 67e12
LEAPFROG_EXTRA_OPS = 12

LAUNCHES = {"nuts_step": 0, "hmc_step": 0}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class GaussianTarget:
    """``log p(x) = -0.5 (x - mu)^T P (x - mu)`` on one device in one float
    type, with its closed-form gradient ``-P (x - mu)``.  ``P`` is
    symmetrised in float64 before it is cast.  Callable as a log-density of
    one ``(dim,)`` point or of ``(n, dim)`` points, and differentiable by
    ``torch.func`` like any torch function."""

    def __init__(self, mean, precision, dtype=None, device=None):
        precision = np.asarray(precision, dtype=np.float64)
        dtype = config.DTYPE if dtype is None else dtype
        device = config.DEVICE if device is None else device
        self.mean = torch.as_tensor(np.asarray(mean, dtype=np.float64), dtype=dtype,
                                    device=device)
        self.precision = torch.as_tensor(0.5 * (precision + precision.T), dtype=dtype,
                                         device=device)
        self.dim = int(self.mean.shape[0])
        if tuple(self.precision.shape) != (self.dim, self.dim):
            raise ValueError(f"GaussianTarget: precision {tuple(self.precision.shape)} for a "
                             f"mean of {self.dim}")

    @property
    def dtype(self):
        return self.mean.dtype

    @property
    def device(self):
        return self.mean.device

    def grad_and_value(self, x):
        """(gradient, log-density) of ``(dim,)`` or ``(n, dim)`` points."""
        diff = x - self.mean
        g = -(diff @ self.precision)
        return g, 0.5 * (diff * g).sum(-1)

    def value(self, x):
        return self.grad_and_value(x)[1]

    def grad(self, x):
        return self.grad_and_value(x)[0]

    def __call__(self, x):
        return self.value(x)


class NutsNoise(NamedTuple):
    r0: torch.Tensor  # (n, dim) standard normals: the start momentum
    dir_u: torch.Tensor  # (n, max_depth) uniforms: doubling to the right where < 0.5
    bias_u: torch.Tensor  # (n, max_depth) uniforms: the new half's proposal taken
    take_u: torch.Tensor  # (n, max_depth, 2**(max_depth-1)) uniforms: a leaf's proposal


class HmcNoise(NamedTuple):
    momentum: torch.Tensor  # (transitions, n, dim) standard normals
    accept_u: torch.Tensor  # (transitions, n) uniforms


class Transition(NamedTuple):
    z: torch.Tensor  # (n, dim) the proposals
    accept: torch.Tensor  # (n,) mean leaf acceptance statistic
    leapfrogs: torch.Tensor  # (n,) int32 leapfrog steps taken
    turned: torch.Tensor  # (n,) bool: the tree stopped on a U-turn
    diverged: torch.Tensor  # (n,) bool: a subtree diverged
    host_reads: int  # device-to-host reads the call made


class HmcSteps(NamedTuple):
    z: torch.Tensor  # (transitions, n, dim) the positions after each transition
    accepted: torch.Tensor  # (transitions, n) bool
    rate: torch.Tensor  # (transitions, n) exp(min(0, dH))


def nuts_noise(n, dim, max_depth, gen, dtype):
    """The draws of one NUTS transition of ``n`` chains from ``gen``, in the
    order r0, dir_u, bias_u, take_u."""
    kw = {"generator": gen, "dtype": dtype, "device": gen.device}
    return NutsNoise(torch.randn((n, dim), **kw), torch.rand((n, max_depth), **kw),
                     torch.rand((n, max_depth), **kw),
                     torch.rand((n, max_depth, 2 ** (max_depth - 1)), **kw))


def is_turning(r_first, r_last, rho):
    """Generalized no-U-turn criterion on the momentum sum ``rho``, over the
    last axis."""
    return ((rho * r_first).sum(-1) <= 0) | ((rho * r_last).sum(-1) <= 0)


def popcount(n):
    """Number of one-bits of ``n`` in [0, 2**32): a Python int or an integer
    tensor (torch has no population-count op; this is the parallel bit
    count)."""
    n = n - ((n >> 1) & 0x55555555)
    n = (n & 0x33333333) + ((n >> 2) & 0x33333333)
    n = (n + (n >> 4)) & 0x0F0F0F0F
    n = n + (n >> 8)
    return (n + (n >> 16)) & 0x3F


def ckpt_range(n):
    """Checkpoint indices whose subtrees END at odd leaf ``n``.

    A checkpoint is stored at every even leaf (index ``popcount(n >> 1)``);
    leaf ``n`` with ``t`` trailing one-bits closes ``t`` nested power-of-two
    subtrees, checked against checkpoints ``idx_max - t + 1 .. idx_max``.
    """
    idx_max = popcount(n >> 1)
    trailing_ones = popcount(n ^ (n + 1)) - 1
    return idx_max - trailing_ones + 1, idx_max


def leapfrog(density, z, r, g, eps):
    """One forward leapfrog step of every chain and the log-density at the
    new position: (z, r, g, log_pdf(z)) after the step."""
    r_half = r + 0.5 * eps * g
    z_new = z + eps * r_half
    g_new, logp = density.grad_and_value(z_new)
    return z_new, r_half + 0.5 * eps * g_new, g_new, logp


# ---------------------------------------------------------------------- #
# plain versions
# ---------------------------------------------------------------------- #
def build_subtree(density, n_leaves, z, r, g, eps, energy0, max_depth, take_u):
    """Grow, for every chain, a subtree of up to ``n_leaves`` leapfrog steps
    (a number, or one per chain; 0 leaves a chain untouched) from (z, r, g),
    each ``(n_chains, dim)`` with momenta in forward-time orientation (the
    caller flips signs for backward growth).  A chain stops early on an
    internal U-turn or a divergence.  ``take_u[:, k]`` decides whether leaf
    ``k`` becomes the proposal.  Returns the dict of the JAX package's loop
    carry, every field with a leading chain axis (without ``key`` and
    ``r_first``, which nothing reads), and ``reads``: the host reads made."""
    n_chains, dim = z.shape
    dt, device = z.dtype, z.device
    n_leaves = torch.as_tensor(n_leaves, device=device).expand(n_chains)
    s = {
        "n": torch.zeros(n_chains, dtype=torch.int64, device=device),
        "z": z, "r": r, "g": g,
        "z_prop": z,
        "logw": torch.full((n_chains,), -torch.inf, dtype=dt, device=device),
        "rho": torch.zeros((n_chains, dim), dtype=dt, device=device),
        "r_ckpts": torch.zeros((n_chains, max_depth, dim), dtype=dt, device=device),
        "rho_ckpts": torch.zeros((n_chains, max_depth, dim), dtype=dt, device=device),
        "turning": torch.zeros(n_chains, dtype=torch.bool, device=device),
        "diverging": torch.zeros(n_chains, dtype=torch.bool, device=device),
        "sum_accept": torch.zeros(n_chains, dtype=dt, device=device),
        "n_leaf": torch.zeros(n_chains, dtype=dt, device=device),
        "reads": 0,
    }
    leaf = 0  # == s["n"] of every active chain
    while True:
        active = (s["n"] < n_leaves) & ~s["turning"] & ~s["diverging"]
        s["reads"] += 1
        if not bool(active.any()):
            return s
        act = active[:, None]  # a column that broadcasts over (n_chains, dim)

        z_new, r_new, g_new, logp = leapfrog(density, s["z"], s["r"], s["g"], eps)
        delta_energy = logp - 0.5 * torch.sum(r_new**2, dim=-1) - energy0
        diverging = delta_energy < -DELTA_MAX
        logw_leaf = torch.where(diverging, -torch.inf, delta_energy)
        accept_stat = torch.clamp_max(torch.exp(delta_energy), 1.0)

        # progressive multinomial proposal within the subtree; where both
        # weights are -inf the ratio is NaN and the guard picks 0
        logw_new = torch.logaddexp(s["logw"], logw_leaf)
        p_leaf = torch.where(torch.isneginf(logw_new), 0.0, torch.exp(logw_leaf - logw_new))
        take = take_u[:, leaf] < p_leaf
        rho_new = s["rho"] + r_new

        idx_min, idx_max = ckpt_range(leaf)
        if leaf % 2 == 0:
            s["r_ckpts"][:, idx_max] = torch.where(act, r_new, s["r_ckpts"][:, idx_max])
            s["rho_ckpts"][:, idx_max] = torch.where(act, rho_new, s["rho_ckpts"][:, idx_max])
        else:
            # every power-of-two subtree that this odd leaf closes, at once
            r_ck = s["r_ckpts"][:, idx_min:idx_max + 1]
            rho_sub = rho_new[:, None] - s["rho_ckpts"][:, idx_min:idx_max + 1] + r_ck
            closed = is_turning(r_ck, r_new[:, None], rho_sub).any(dim=1)
            s["turning"] = s["turning"] | (active & closed)

        s["n"] = s["n"] + active
        s["z"] = torch.where(act, z_new, s["z"])
        s["r"] = torch.where(act, r_new, s["r"])
        s["g"] = torch.where(act, g_new, s["g"])
        s["z_prop"] = torch.where((active & take)[:, None], z_new, s["z_prop"])
        s["logw"] = torch.where(active, logw_new, s["logw"])
        s["rho"] = torch.where(act, rho_new, s["rho"])
        s["diverging"] = s["diverging"] | (active & diverging)
        s["sum_accept"] = s["sum_accept"] + torch.where(active, accept_stat, 0.0)
        s["n_leaf"] = s["n_leaf"] + active
        leaf += 1


def _check_nuts_noise(noise, n, dim, max_depth, dtype, device):
    want = {"r0": (n, dim), "dir_u": (n, max_depth), "bias_u": (n, max_depth),
            "take_u": (n, max_depth, 2 ** (max_depth - 1))}
    for name, shape in want.items():
        t = getattr(noise, name)
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != device:
            raise ValueError(f"nuts_step: noise {name} must be {dtype} {shape} on {device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def nuts_step_reference(target, z, eps, max_depth, noise=None, gen=None):
    """Plain version: one NUTS transition of every chain of ``z`` (n, dim)
    with step size ``eps`` and at most ``max_depth`` doublings, on ``z``'s
    device.  ``target``: anything with ``grad_and_value`` over ``(n, dim)``.
    ``noise`` (:class:`NutsNoise`) replaces draws from ``gen``.  Returns a
    :class:`Transition`; one host read per doubling and per leaf."""
    n, dim = z.shape
    dt, device = z.dtype, z.device
    max_depth = int(max_depth)
    if noise is None:
        noise = nuts_noise(n, dim, max_depth, gen, dt)
    _check_nuts_noise(noise, n, dim, max_depth, dt, device)
    r0 = noise.r0
    g0, logp0 = target.grad_and_value(z)
    energy0 = logp0 - 0.5 * torch.sum(r0**2, dim=-1)

    z_left = z_right = z_prop = z
    r_left = r_right = rho = r0
    g_left = g_right = g0
    logw = torch.zeros(n, dtype=dt, device=device)
    stopped = torch.zeros(n, dtype=torch.bool, device=device)
    turned = torch.zeros(n, dtype=torch.bool, device=device)
    diverged = torch.zeros(n, dtype=torch.bool, device=device)
    sum_accept = torch.zeros(n, dtype=dt, device=device)
    n_leaf = torch.zeros(n, dtype=dt, device=device)
    reads = 0

    for depth in range(max_depth):
        reads += 1
        if bool(stopped.all()):
            break
        go_right = noise.dir_u[:, depth] < 0.5
        right = go_right[:, None]
        d = torch.where(right, 1.0, -1.0).to(dt)

        # backward growth = forward integration with negated momentum
        sub = build_subtree(
            target, torch.where(stopped, 0, 2**depth),
            torch.where(right, z_right, z_left),
            d * torch.where(right, r_right, r_left),
            torch.where(right, g_right, g_left),
            eps, energy0, max_depth, noise.take_u[:, depth],
        )
        reads += sub["reads"]
        valid = ~stopped & ~sub["turning"] & ~sub["diverging"]

        # biased progressive coupling: take the new half's proposal
        # w.p. min(1, W_new / W_old)
        accept_p = torch.exp(torch.clamp_max(sub["logw"] - logw, 0.0))
        take = valid & (noise.bias_u[:, depth] < accept_p)
        z_prop = torch.where(take[:, None], sub["z_prop"], z_prop)
        logw = torch.where(valid, torch.logaddexp(logw, sub["logw"]), logw)

        # update the grown end (forward-time momentum = d * signed)
        upd = (valid & go_right)[:, None]
        z_right = torch.where(upd, sub["z"], z_right)
        r_right = torch.where(upd, d * sub["r"], r_right)
        g_right = torch.where(upd, sub["g"], g_right)
        upd = (valid & ~go_right)[:, None]
        z_left = torch.where(upd, sub["z"], z_left)
        r_left = torch.where(upd, d * sub["r"], r_left)
        g_left = torch.where(upd, sub["g"], g_left)

        rho = torch.where(valid[:, None], rho + d * sub["rho"], rho)
        whole = is_turning(r_left, r_right, rho)
        turned = turned | (~stopped & (sub["turning"] | (valid & whole)))
        diverged = diverged | sub["diverging"]
        stopped = stopped | ~valid | whole
        sum_accept = sum_accept + sub["sum_accept"]
        n_leaf = n_leaf + sub["n_leaf"]

    return Transition(z_prop, sum_accept / torch.clamp_min(n_leaf, 1.0),
                      n_leaf.to(torch.int32), turned, diverged, reads)


def _hmc_noise(noise, transitions, n, dim, dtype, device):
    momentum, accept_u = noise
    if momentum.dim() == 2:  # one transition: (n, dim) and (n,)
        momentum, accept_u = momentum[None], accept_u[None]
    for name, t, shape in (("momentum", momentum, (transitions, n, dim)),
                           ("accept_u", accept_u, (transitions, n))):
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != device:
            raise ValueError(f"hmc_step: noise {name} must be {dtype} {shape} on {device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return HmcNoise(momentum, accept_u)


def hmc_step_reference(target, z, eps, n_steps, noise=None, gen=None, transitions=1):
    """Plain version: ``transitions`` HMC transitions of every chain of ``z``
    (n, dim), each ``n_steps`` leapfrog steps of size ``eps`` and a
    Metropolis accept.  ``target``: anything with ``grad_and_value``.
    ``noise`` (:class:`HmcNoise`; one transition may give ``(n, dim)`` and
    ``(n,)``) replaces draws from ``gen``: per transition, the momentum, then
    the accept uniform.  Returns an :class:`HmcSteps`."""
    n, dim = z.shape
    dt, device = z.dtype, z.device
    if noise is not None:
        noise = _hmc_noise(noise, transitions, n, dim, dt, device)
    out = torch.empty((transitions, n, dim), dtype=dt, device=device)
    accepted = torch.empty((transitions, n), dtype=torch.bool, device=device)
    rates = torch.empty((transitions, n), dtype=dt, device=device)
    for t in range(int(transitions)):
        if noise is None:
            momentum = torch.randn((n, dim), generator=gen, dtype=dt, device=device)
        else:
            momentum = noise.momentum[t]
        g, log_p = target.grad_and_value(z)
        current_h = log_p - 0.5 * torch.sum(momentum**2, dim=-1)
        q, p = z, momentum
        for _ in range(int(n_steps)):
            q, p, g, log_p = leapfrog(target, q, p, g, eps)
        log_accept = torch.clamp_max(log_p - 0.5 * torch.sum(p**2, dim=-1) - current_h, 0.0)
        if noise is None:
            uniform = torch.rand((n,), generator=gen, dtype=dt, device=device)
        else:
            uniform = noise.accept_u[t]
        accept = torch.log(uniform) < log_accept  # a NaN energy never accepts
        z = torch.where(accept[:, None], q, z)
        out[t], accepted[t], rates[t] = z, accept, torch.exp(log_accept)
    return HmcSteps(out, accepted, rates)


# ---------------------------------------------------------------------- #
# the kernels
# ---------------------------------------------------------------------- #
def lane_coords(dim):
    """Coordinates each lane of a chain's warp holds: the least power of two
    with ``32 *`` it at least ``dim``."""
    k = 1
    while 32 * k < dim:
        k *= 2
    return k


def register_form(dim, elem):
    """Whether a lane keeps its columns of the precision matrix in registers:
    at most 128 registers of them (float32 up to 64 dimensions, float64 up
    to 32); wider targets keep P in shared memory."""
    k = lane_coords(dim)
    return k * 32 * k * elem <= 128 * 4


def shared_bytes(kernel, dim, elem, max_depth, warps, reg=False):
    """Dynamic shared memory of one block: for NUTS ``max_depth``
    checkpoints of ``r`` and of ``rho`` per warp; in the shared form also
    the precision matrix with its columns padded to the lanes' width and a
    row of ``x - mu`` per warp."""
    k = lane_coords(dim)
    checkpoints = 2 * int(max_depth) if kernel == "nuts_step" else 0
    rows = warps * checkpoints if reg else dim + warps * (1 + checkpoints)
    return elem * 32 * k * rows


def max_dim(kernel, dtype, max_depth=0):
    """The widest target ``kernel`` ("nuts_step" or "hmc_step") takes in
    ``dtype``: a lane holds at most ``MAX_LANE_COORDS`` coordinates, and one
    warp's block must fit ``SHARED_LIMIT`` in the shared form."""
    elem = torch.empty((), dtype=dtype).element_size()
    dim = 32 * MAX_LANE_COORDS[elem]
    while dim > 0 and shared_bytes(kernel, dim, elem, max_depth, 1) > SHARED_LIMIT:
        dim -= 1
    return dim


def plan(kernel, dim, dtype, max_depth=0):
    """(coordinates per lane, warps a block, shared bytes, P in registers) of
    a launch, or ValueError past :func:`max_dim`."""
    limit = max_dim(kernel, dtype, max_depth)
    if dim < 1 or dim > limit:
        raise ValueError(f"{kernel}: a {dim}-dimensional target in {dtype} (max_depth "
                         f"{max_depth}) is past the kernel's limit of {limit} dimensions")
    elem = torch.empty((), dtype=dtype).element_size()
    reg = register_form(dim, elem)
    warps = WARPS
    while shared_bytes(kernel, dim, elem, max_depth, warps, reg) > SHARED_LIMIT:
        warps //= 2
    return lane_coords(dim), warps, shared_bytes(kernel, dim, elem, max_depth, warps, reg), reg


def _library():
    lib = load_library("hmc", ["hmc.cu"])
    vp, i32, i64, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
    lib.pgmpy_nuts_step.argtypes = [i32, i32, i32, i64, i32, i32, vp, vp, vp, f64, vp, vp, vp,
                                    vp, vp, vp, vp, vp, vp, i32, i64, vp]
    lib.pgmpy_nuts_step.restype = ctypes.c_int
    lib.pgmpy_hmc_step.argtypes = [i32, i32, i32, i64, i32, i32, i32, vp, vp, vp, f64, vp, vp,
                                   vp, vp, vp, vp, i32, i64, vp]
    lib.pgmpy_hmc_step.restype = ctypes.c_int
    return lib


def _check_target(name, target, z):
    if not isinstance(target, GaussianTarget):
        raise TypeError(f"{name}: the kernel computes a GaussianTarget, got {type(target)}")
    if z.dim() != 2 or z.shape[1] != target.dim:
        raise ValueError(f"{name}: z must be (n, {target.dim}), got {tuple(z.shape)}")
    if z.device != target.device or z.dtype != target.dtype:
        raise ValueError(f"{name}: z is {z.dtype} on {z.device}, the target {target.dtype} on "
                         f"{target.device}")
    if z.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {z.device}")


def _key(gen, device):
    return torch.randint(-2**63, 2**63 - 1, (1,), generator=gen, dtype=torch.int64,
                         device=device)


def nuts_step_cuda(target, z, eps, max_depth, noise=None, gen=None):
    """ONE launch of the NUTS kernel on the current stream of ``z``'s card;
    the arguments and result are those of :func:`nuts_step_reference`.
    Without ``noise`` the kernel's Philox key is one 64-bit draw from
    ``gen``."""
    _check_target("nuts_step", target, z)
    n, dim = z.shape
    max_depth = int(max_depth)
    if not 1 <= max_depth <= 30:
        raise ValueError(f"nuts_step: max_depth {max_depth} outside 1..30")
    lanes, warps, shared, reg = plan("nuts_step", dim, z.dtype, max_depth)
    device = z.device
    with torch.cuda.device(device):
        z = z.contiguous()
        if noise is not None:
            _check_nuts_noise(noise, n, dim, max_depth, z.dtype, device)
            noise = NutsNoise(*(t.contiguous() for t in noise))
            key = None
        else:
            key = _key(gen, device)
        z_out = torch.empty_like(z)
        accept = torch.empty(n, dtype=z.dtype, device=device)
        leapfrogs = torch.empty(n, dtype=torch.int32, device=device)
        flags = torch.empty(n, dtype=torch.int8, device=device)
        if n:
            err = _library().pgmpy_nuts_step(
                z.element_size(), lanes, int(reg), n, dim, max_depth, target.mean.data_ptr(),
                target.precision.data_ptr(), z.data_ptr(), float(eps),
                *((0,) * 4 if noise is None else (t.data_ptr() for t in noise)),
                0 if key is None else key.data_ptr(), z_out.data_ptr(), accept.data_ptr(),
                leapfrogs.data_ptr(), flags.data_ptr(), warps, shared,
                torch.cuda.current_stream(device).cuda_stream)
            if err != 0:
                raise RuntimeError(f"nuts_step launch failed: cudaError_t {err}")
            LAUNCHES["nuts_step"] += 1
    return Transition(z_out, accept, leapfrogs, (flags & 1) != 0, (flags & 2) != 0, 0)


def hmc_step_cuda(target, z, eps, n_steps, noise=None, gen=None, transitions=1):
    """ONE launch of the HMC kernel, every transition of the call in it, on
    the current stream of ``z``'s card; the arguments and result are those
    of :func:`hmc_step_reference`.  Without ``noise`` the kernel's Philox key
    is one 64-bit draw from ``gen``."""
    _check_target("hmc_step", target, z)
    n, dim = z.shape
    transitions, n_steps = int(transitions), int(n_steps)
    lanes, warps, shared, reg = plan("hmc_step", dim, z.dtype)
    device = z.device
    with torch.cuda.device(device):
        z = z.contiguous()
        if noise is not None:
            noise = HmcNoise(*(t.contiguous() for t in
                               _hmc_noise(noise, transitions, n, dim, z.dtype, device)))
            key = None
        else:
            key = _key(gen, device)
        out = torch.empty((transitions, n, dim), dtype=z.dtype, device=device)
        accepted = torch.empty((transitions, n), dtype=torch.bool, device=device)
        rate = torch.empty((transitions, n), dtype=z.dtype, device=device)
        if n and transitions:
            err = _library().pgmpy_hmc_step(
                z.element_size(), lanes, int(reg), n, dim, n_steps, transitions,
                target.mean.data_ptr(),
                target.precision.data_ptr(), z.data_ptr(), float(eps),
                *((0,) * 2 if noise is None else (t.data_ptr() for t in noise)),
                0 if key is None else key.data_ptr(), out.data_ptr(), accepted.data_ptr(),
                rate.data_ptr(), warps, shared, torch.cuda.current_stream(device).cuda_stream)
            if err != 0:
                raise RuntimeError(f"hmc_step launch failed: cudaError_t {err}")
            LAUNCHES["hmc_step"] += 1
    return HmcSteps(out, accepted, rate)


def nuts_step(target, z, eps, max_depth, noise=None, gen=None):
    """Dispatch on ``z``'s device: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if z.device.type == "cuda":
        return nuts_step_cuda(target, z, eps, max_depth, noise, gen)
    if z.device.type == "cpu":
        return nuts_step_reference(target, z, eps, max_depth, noise, gen)
    raise ValueError(f"nuts_step: unsupported device {z.device}")


def hmc_step(target, z, eps, n_steps, noise=None, gen=None, transitions=1):
    """Dispatch on ``z``'s device, as :func:`nuts_step`."""
    if z.device.type == "cuda":
        return hmc_step_cuda(target, z, eps, n_steps, noise, gen, transitions)
    if z.device.type == "cpu":
        return hmc_step_reference(target, z, eps, n_steps, noise, gen, transitions)
    raise ValueError(f"hmc_step: unsupported device {z.device}")


# ---------------------------------------------------------------------- #
# bounds
# ---------------------------------------------------------------------- #
def leapfrog_operations(dim):
    """Operations of one leapfrog step of one chain: the matrix-vector
    product and about a dozen per coordinate (the updates, dot products and
    energies)."""
    return 2 * dim * dim + LEAPFROG_EXTRA_OPS * dim


def _bound(nbytes, operations, hbm_bytes_per_s=3.35e12, ops_per_s=PLAIN_OPS_PER_S):
    by_bytes = nbytes / hbm_bytes_per_s * 1e3
    by_ops = operations / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def nuts_bound_ms(target, leapfrogs):
    """(bound_ms, bound_by) of one :func:`nuts_step` that took ``leapfrogs``
    (one count per chain, as it returned them) on the card: every leapfrog
    the step took and each chain's start gradient at 67e12 float32
    operations per second, against the target, the positions in and out and
    the per-chain results moved once at 3.35 TB/s."""
    leapfrogs = torch.as_tensor(leapfrogs)
    n, dim, elem = int(leapfrogs.shape[0]), target.dim, target.mean.element_size()
    total = int(leapfrogs.to(torch.int64).sum())
    nbytes = elem * (dim * dim + dim + 2 * n * dim + n) + 5 * n
    return _bound(nbytes, (total + n) * leapfrog_operations(dim))


def hmc_bound_ms(target, n, n_steps, transitions=1):
    """(bound_ms, bound_by) of one :func:`hmc_step` launch: ``n_steps + 1``
    gradients per chain and transition, against the target, the start, the
    trajectory, the flags and rates moved once."""
    dim, elem = target.dim, target.mean.element_size()
    nbytes = elem * (dim * dim + dim + n * dim + transitions * n * (dim + 1)) + transitions * n
    return _bound(nbytes, n * transitions * (int(n_steps) + 1) * leapfrog_operations(dim))
