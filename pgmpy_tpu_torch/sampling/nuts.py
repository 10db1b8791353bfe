"""VectorizedNUTS: multinomial No-U-Turn sampler over many chains at once.

Port of ``pgmpy_tpu/sampling/nuts_jax.py`` (this module is its counterpart;
the name drops the ``_jax``).  The host-recursive NUTS in ``hmc.py`` keeps
reference-style semantics but runs one chain.  Here every chain takes one
transition at a time: ``ops/hmc.py:nuts_step`` builds each chain's
trajectory tree ITERATIVELY (progressive doublings outside, leaf-at-a-time
subtree growth inside, the O(log n)-memory momentum-checkpoint U-turn
checks), and the step size adapts between transitions on the host.

The route follows the model, never a failure.  A linear-Gaussian network is
a :class:`~pgmpy_tpu_torch.ops.hmc.GaussianTarget`: on a CUDA device each
transition of every chain is ONE launch of the kernel of ``csrc/hmc.cu``,
and ``sample`` reads the device once per transition (the pooled mean
acceptance and mean leapfrog count together); on the CPU it is the plain
version.  A raw callable or a ``log_pdf`` object is a density no kernel
computes: its transitions run the plain version on every device (batched
masked torch ops, gradients through ``torch.func``, one host read per leaf
and per doubling).  ``host_reads`` counts the device-to-host reads of the
last ``sample``; ``leaf_iterations`` is its mean number of leapfrog steps
per chain and transition.

Algorithm: multinomial NUTS (Betancourt 2017) with progressive biased
proposal sampling, the generalized momentum-sum no-U-turn criterion,
divergence cap 1000, and Hoffman-Gelman dual averaging on the mean leaf
acceptance statistic pooled over the chains.
"""

import numpy as np
import torch

from pgmpy_tpu_torch.ops import hmc as hmc_ops
from pgmpy_tpu_torch.ops.hmc import GaussianTarget
from pgmpy_tpu_torch.sampling.hmc import _density, _initial_chains, _resolve_log_pdf
from pgmpy_tpu_torch.utils.mathext import seeded_generator


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
        self._density = _density(self.log_pdf)
        self._grad = self._density.grad
        self.max_depth = int(max_depth)
        self.delta = float(delta)
        # of the last ``sample``: mean leapfrog steps per chain and
        # transition, and device-to-host reads made
        self.leaf_iterations = 0.0
        self.host_reads = 0

    # ------------------------------------------------------------------ #
    def _leapfrog(self, z, r, g, eps):
        """One forward leapfrog step (momenta already time-oriented)."""
        return hmc_ops.leapfrog(self._density, z, r, g, eps)[:3]

    def _build_subtree(self, n_leaves, z, r, g, eps, energy0, gen, axis_name=None):
        """The plain version's subtree (``ops.hmc.build_subtree``) of up to
        ``n_leaves`` leapfrog steps from (z, r, g), its take uniforms drawn
        from ``gen``.  ``axis_name`` has no effect: the JAX package uses it
        only to mark loop carries as device-varying under ``shard_map``."""
        width = max(int(torch.as_tensor(n_leaves).max()), 1)
        take_u = torch.rand((z.shape[0], width), generator=gen, dtype=z.dtype, device=z.device)
        sub = hmc_ops.build_subtree(self._density, n_leaves, z, r, g, eps, energy0,
                                    self.max_depth, take_u)
        self.host_reads += sub["reads"]
        return sub

    # ------------------------------------------------------------------ #
    def _transition(self, gen, z, eps):
        """One NUTS transition of every chain of ``z`` (n_chains, dim): an
        ``ops.hmc.Transition``.  A GaussianTarget takes ``ops.hmc.nuts_step``
        (one kernel launch on a CUDA device); any other density its plain
        version."""
        if isinstance(self.log_pdf, GaussianTarget):
            step = hmc_ops.nuts_step(self.log_pdf, z, eps, self.max_depth, gen=gen)
        else:
            step = hmc_ops.nuts_step_reference(self._density, z, eps, self.max_depth, gen=gen)
        self.host_reads += step.host_reads
        return step

    def _nuts_step(self, gen, z, eps, axis_name=None):
        """One NUTS transition of every chain: z (n_chains, dim) ->
        (new positions, mean leaf acceptance statistic per chain).
        ``axis_name`` has no effect, as in :meth:`_build_subtree`."""
        step = self._transition(gen, z, eps)
        return step.z, step.accept

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
        acceptance) and sampling run in one loop, one host read per
        transition.  Returns a (num_samples, n_chains, dim) array (or a
        chain-0 DataFrame), and sets ``acceptance_rate`` and
        ``final_stepsize``.

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
        self.host_reads = 0

        num_adapt, num_samples = int(num_adapt), int(num_samples)
        adapt = _StepSize(stepsize, num_adapt, self.delta)
        samples = torch.empty((num_samples,) + tuple(positions.shape),
                              dtype=positions.dtype, device=positions.device)
        accepts, leapfrogs = [], 0.0
        for m in range(num_adapt + num_samples):
            step = self._transition(gen, positions, adapt.eps)
            positions = step.z
            # the pooled mean acceptance and leapfrog count, read together
            stats = torch.stack([step.accept.mean(), step.leapfrogs.to(step.accept.dtype).mean()])
            if group is not None:
                stats = _group_mean(stats, group)
            mean_accept, mean_leapfrogs = stats.tolist()
            self.host_reads += 1
            leapfrogs += mean_leapfrogs
            adapt.update(m, mean_accept)
            if m >= num_adapt:
                samples[m - num_adapt] = positions
                accepts.append(mean_accept)
        self.leaf_iterations = leapfrogs / max(num_adapt + num_samples, 1)
        self.acceptance_rate = float(np.mean(accepts)) if accepts else float("nan")
        self.final_stepsize = adapt.eps
        samples = samples.cpu().numpy()
        if return_type == "dataframe":
            import pandas as pd

            cols = self.variables or [f"x{i}" for i in range(samples.shape[-1])]
            return pd.DataFrame(samples[:, 0, :], columns=cols)
        return samples


def _group_mean(value, group):
    """The mean of a tensor over the processes of ``group``."""
    from pgmpy_tpu_torch.parallel.mesh import _all_reduce
    import torch.distributed as dist

    return _all_reduce(value, group, dist.ReduceOp.SUM) / dist.get_world_size(group)
