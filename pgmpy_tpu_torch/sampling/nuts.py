"""VectorizedNUTS: multinomial No-U-Turn sampler over many chains at once.

Port of ``pgmpy_tpu/sampling/nuts_jax.py`` (this module is its counterpart;
the name drops the ``_jax``).  The host-recursive NUTS in ``hmc.py`` keeps
reference-style semantics but runs one chain.  Here the trajectory tree is
built ITERATIVELY (progressive doublings outside, leaf-at-a-time subtree
growth inside) with the chains as the leading axis of every carried tensor:
each leaf iteration advances ALL chains with one batched leapfrog step, and
the chains whose own loop condition is false (subtree complete, internal
U-turn, divergence, tree stopped) are frozen by ``torch.where`` masks.  Both
loops run on the host and end when no chain is active, which costs one
device-to-host read per iteration; ``host_reads`` and ``leaf_iterations``
count them.

Every chain that is still growing a subtree stands at the same leaf, so the
leaf index, its parity and its checkpoint slots are host integers, and only
the masks are per chain.  Within-subtree U-turn checks use the
O(log n)-memory momentum-checkpoint scheme (store a checkpoint at every even
leaf, check each completed power-of-two subtree at every odd leaf).

Algorithm: multinomial NUTS (Betancourt 2017) with progressive biased
proposal sampling, the generalized momentum-sum no-U-turn criterion,
divergence cap 1000, and Hoffman-Gelman dual averaging on the mean leaf
acceptance statistic pooled over the chains.
"""

import numpy as np
import torch

from pgmpy_tpu_torch.sampling.hmc import _Density, _initial_chains, _resolve_log_pdf
from pgmpy_tpu_torch.utils.mathext import normal_draw, seeded_generator

_DELTA_MAX = 1000.0


def _is_turning(r_first, r_last, rho):
    """Generalized no-U-turn criterion on the momentum sum ``rho``, over the
    last axis."""
    return ((rho * r_first).sum(-1) <= 0) | ((rho * r_last).sum(-1) <= 0)


def _popcount(n):
    """Number of one-bits of ``n`` in [0, 2**32): a Python int or an integer
    tensor (torch has no population-count op; this is the parallel bit
    count)."""
    n = n - ((n >> 1) & 0x55555555)
    n = (n & 0x33333333) + ((n >> 2) & 0x33333333)
    n = (n + (n >> 4)) & 0x0F0F0F0F
    n = n + (n >> 8)
    return (n + (n >> 16)) & 0x3F


def _ckpt_range(n):
    """Checkpoint indices whose subtrees END at odd leaf ``n``.

    A checkpoint is stored at every even leaf (index ``popcount(n >> 1)``);
    leaf ``n`` with ``t`` trailing one-bits closes ``t`` nested power-of-two
    subtrees, checked against checkpoints ``idx_max - t + 1 .. idx_max``.
    """
    idx_max = _popcount(n >> 1)
    trailing_ones = _popcount(n ^ (n + 1)) - 1
    return idx_max - trailing_ones + 1, idx_max


class _StepSize:
    """Hoffman-Gelman dual averaging of the log step size on the mean
    acceptance statistic, on the host: ``update(m, accept)`` after step ``m``
    adapts while ``m < num_adapt``, and fixes the averaged step size after."""

    def __init__(self, stepsize, num_adapt, delta):
        self.mu = np.log(10.0 * stepsize)
        self.num_adapt = int(num_adapt)
        self.delta = delta
        self.log_eps = self.log_eps_bar = float(np.log(stepsize))
        self.h_bar = 0.0

    @property
    def eps(self):
        return float(np.exp(self.log_eps))

    def update(self, m, mean_accept):
        gamma, t0, kappa = 0.05, 10.0, 0.75
        if m < self.num_adapt:
            self.h_bar = ((1 - 1 / (m + 1 + t0)) * self.h_bar
                          + (self.delta - mean_accept) / (m + 1 + t0))
            self.log_eps = self.mu - np.sqrt(m + 1) / gamma * self.h_bar
            eta = (m + 1) ** -kappa
            self.log_eps_bar = eta * self.log_eps + (1 - eta) * self.log_eps_bar
        else:
            self.log_eps = self.log_eps_bar


class VectorizedNUTS:
    def __init__(self, model, max_depth=6, delta=0.8):
        self.log_pdf, self.variables = _resolve_log_pdf(model)
        self._density = _Density(self.log_pdf)
        self._grad = self._density.grad
        self.max_depth = int(max_depth)
        self.delta = float(delta)
        # of the host loops since the last ``sample`` began: batched leapfrog
        # steps taken, and device-to-host reads made
        self.leaf_iterations = 0
        self.host_reads = 0

    # ------------------------------------------------------------------ #
    def _leapfrog_energy(self, z, r, g, eps):
        """One forward leapfrog step of every chain and the log-density at
        the new position: (z, r, g, log_pdf(z)) after the step."""
        r_half = r + 0.5 * eps * g
        z_new = z + eps * r_half
        g_new, logp = self._density.grad_and_value(z_new)
        r_new = r_half + 0.5 * eps * g_new
        return z_new, r_new, g_new, logp

    def _leapfrog(self, z, r, g, eps):
        """One forward leapfrog step (momenta already time-oriented)."""
        return self._leapfrog_energy(z, r, g, eps)[:3]

    def _build_subtree(self, n_leaves, z, r, g, eps, energy0, gen, axis_name=None):
        """Grow, for every chain, a subtree of up to ``n_leaves`` leapfrog
        steps (a number, or one per chain; 0 leaves a chain untouched) from
        (z, r, g), each ``(n_chains, dim)`` with momenta in forward-time
        orientation (the caller flips signs for backward growth).  A chain
        stops early on an internal U-turn or a divergence.  Returns the dict
        of the JAX package's loop carry, every field with a leading chain
        axis (without ``key`` and ``r_first``, which nothing reads).

        ``axis_name`` is accepted and has no effect: the JAX package uses it
        only to mark loop carries as device-varying under ``shard_map``."""
        n_chains, dim = z.shape
        md = self.max_depth
        dt, device = z.dtype, z.device
        n_leaves = torch.as_tensor(n_leaves, device=device).expand(n_chains)

        s = {
            "n": torch.zeros(n_chains, dtype=torch.int64, device=device),
            "z": z, "r": r, "g": g,
            "z_prop": z,
            "logw": torch.full((n_chains,), -torch.inf, dtype=dt, device=device),
            "rho": torch.zeros((n_chains, dim), dtype=dt, device=device),
            "r_ckpts": torch.zeros((n_chains, md, dim), dtype=dt, device=device),
            "rho_ckpts": torch.zeros((n_chains, md, dim), dtype=dt, device=device),
            "turning": torch.zeros(n_chains, dtype=torch.bool, device=device),
            "diverging": torch.zeros(n_chains, dtype=torch.bool, device=device),
            "sum_accept": torch.zeros(n_chains, dtype=dt, device=device),
            "n_leaf": torch.zeros(n_chains, dtype=dt, device=device),
        }
        leaf = 0  # == s["n"] of every active chain
        while True:
            active = (s["n"] < n_leaves) & ~s["turning"] & ~s["diverging"]
            self.host_reads += 1
            if not bool(active.any()):
                return s
            self.leaf_iterations += 1
            act = active[:, None]  # a column that broadcasts over (n_chains, dim)

            z_new, r_new, g_new, logp = self._leapfrog_energy(s["z"], s["r"], s["g"], eps)
            delta_energy = logp - 0.5 * torch.sum(r_new**2, dim=-1) - energy0
            diverging = delta_energy < -_DELTA_MAX
            logw_leaf = torch.where(diverging, -torch.inf, delta_energy)
            accept_stat = torch.clamp_max(torch.exp(delta_energy), 1.0)

            # progressive multinomial proposal within the subtree; where both
            # weights are -inf the ratio is NaN and the guard picks 0
            logw_new = torch.logaddexp(s["logw"], logw_leaf)
            p_leaf = torch.where(torch.isneginf(logw_new), 0.0, torch.exp(logw_leaf - logw_new))
            take = torch.rand(n_chains, generator=gen, dtype=dt, device=device) < p_leaf
            rho_new = s["rho"] + r_new

            idx_min, idx_max = _ckpt_range(leaf)
            if leaf % 2 == 0:
                s["r_ckpts"][:, idx_max] = torch.where(act, r_new, s["r_ckpts"][:, idx_max])
                s["rho_ckpts"][:, idx_max] = torch.where(act, rho_new, s["rho_ckpts"][:, idx_max])
            else:
                # every power-of-two subtree that this odd leaf closes, at once
                r_ck = s["r_ckpts"][:, idx_min:idx_max + 1]
                rho_sub = rho_new[:, None] - s["rho_ckpts"][:, idx_min:idx_max + 1] + r_ck
                closed = _is_turning(r_ck, r_new[:, None], rho_sub).any(dim=1)
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

    # ------------------------------------------------------------------ #
    def _nuts_step(self, gen, z, eps, axis_name=None):
        """One NUTS transition of every chain: z (n_chains, dim) ->
        (new positions, mean leaf acceptance statistic per chain).
        ``axis_name`` has no effect, as in :meth:`_build_subtree`."""
        n_chains = z.shape[0]
        dt, device = z.dtype, z.device
        r0 = normal_draw(z.shape, gen, dt)
        g0, logp0 = self._density.grad_and_value(z)
        energy0 = logp0 - 0.5 * torch.sum(r0**2, dim=-1)

        z_left = z_right = z_prop = z
        r_left = r_right = rho = r0
        g_left = g_right = g0
        logw = torch.zeros(n_chains, dtype=dt, device=device)
        stopped = torch.zeros(n_chains, dtype=torch.bool, device=device)
        sum_accept = torch.zeros(n_chains, dtype=dt, device=device)
        n_leaf = torch.zeros(n_chains, dtype=dt, device=device)

        for depth in range(self.max_depth):
            self.host_reads += 1
            if bool(stopped.all()):
                break
            go_right = torch.rand(n_chains, generator=gen, dtype=dt, device=device) < 0.5
            right = go_right[:, None]
            d = torch.where(right, 1.0, -1.0).to(dt)

            # backward growth = forward integration with negated momentum
            sub = self._build_subtree(
                torch.where(stopped, 0, 2**depth),
                torch.where(right, z_right, z_left),
                d * torch.where(right, r_right, r_left),
                torch.where(right, g_right, g_left),
                eps, energy0, gen, axis_name=axis_name,
            )
            valid = ~stopped & ~sub["turning"] & ~sub["diverging"]

            # biased progressive coupling: take the new half's proposal
            # w.p. min(1, W_new / W_old)
            accept_p = torch.exp(torch.clamp_max(sub["logw"] - logw, 0.0))
            take = valid & (torch.rand(n_chains, generator=gen, dtype=dt, device=device) < accept_p)
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
            stopped = stopped | ~valid | _is_turning(r_left, r_right, rho)
            sum_accept = sum_accept + sub["sum_accept"]
            n_leaf = n_leaf + sub["n_leaf"]

        return z_prop, sum_accept / torch.clamp_min(n_leaf, 1.0)

    # ------------------------------------------------------------------ #
    def sample(
        self,
        initial_pos,
        num_samples,
        num_adapt=0,
        stepsize=0.1,
        n_chains=1,
        seed=0,
        return_type="array",
        axis_name=None,
    ):
        """Run ``n_chains`` NUTS chains on ``config.DEVICE``.

        Warmup (``num_adapt`` steps of dual averaging on the pooled mean
        acceptance) and sampling run in one loop.  Returns a
        (num_samples, n_chains, dim) array (or a chain-0 DataFrame), and
        sets ``acceptance_rate`` and ``final_stepsize``.

        ``axis_name`` names a mesh axis that spans processes
        (:mod:`pgmpy_tpu_torch.parallel.distributed`): each step's mean
        acceptance is averaged over that axis's process group before dual
        averaging, so every process adapts to the same step size.  Without
        an initialized group carrying the axis it raises ``ValueError``.
        """
        group = None
        if axis_name is not None:
            from pgmpy_tpu_torch.parallel.distributed import axis_group

            group = axis_group(axis_name)
        positions = _initial_chains(initial_pos, n_chains)
        gen = seeded_generator(seed)
        self.leaf_iterations = 0
        self.host_reads = 0

        num_adapt, num_samples = int(num_adapt), int(num_samples)
        adapt = _StepSize(stepsize, num_adapt, self.delta)
        samples = torch.empty((num_samples,) + tuple(positions.shape),
                              dtype=positions.dtype, device=positions.device)
        accepts = []
        for m in range(num_adapt + num_samples):
            positions, accept_stats = self._nuts_step(gen, positions, adapt.eps)
            mean_accept = accept_stats.mean()
            if group is not None:
                mean_accept = _group_mean(mean_accept, group)
            mean_accept = float(mean_accept)
            self.host_reads += 1
            adapt.update(m, mean_accept)
            if m >= num_adapt:
                samples[m - num_adapt] = positions
                accepts.append(mean_accept)
        self.acceptance_rate = float(np.mean(accepts)) if accepts else float("nan")
        self.final_stepsize = adapt.eps
        samples = samples.cpu().numpy()
        if return_type == "dataframe":
            import pandas as pd

            cols = self.variables or [f"x{i}" for i in range(samples.shape[-1])]
            return pd.DataFrame(samples[:, 0, :], columns=cols)
        return samples


def _group_mean(value, group):
    """The mean of a scalar tensor over the processes of ``group``."""
    from pgmpy_tpu_torch.parallel.mesh import _all_reduce
    import torch.distributed as dist

    return _all_reduce(value, group, dist.ReduceOp.SUM) / dist.get_world_size(group)
