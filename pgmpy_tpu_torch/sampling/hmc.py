"""Hamiltonian Monte Carlo and NUTS samplers.

Port of ``pgmpy_tpu/sampling/hmc.py`` (the reference ships only integrator
scaffolding with no public sampler, ``pgmpy/sampling/base.py:162-616``):

* ``HamiltonianMC`` / ``HamiltonianMCDA``: leapfrog trajectories of many
  chains at once (``ops/hmc.py:hmc_step``); dual-averaging step-size
  adaptation (Hoffman & Gelman 2014, Alg. 5).  The route follows the model,
  never a failure: a linear-Gaussian network is a
  :class:`~pgmpy_tpu_torch.ops.hmc.GaussianTarget` (closed-form gradient),
  whose transitions run on the hand-written kernel of ``csrc/hmc.cu`` on a
  CUDA device (``sample``: every transition in one launch) and on the plain
  version on the CPU.  A raw callable or a ``log_pdf`` object is a density
  no kernel computes: it keeps the plain version on every device, with
  gradients through ``torch.func.grad`` batched over the chains by
  ``torch.func.vmap``.
* ``NoUTurnSampler`` / ``NoUTurnSamplerDA``: recursive tree doubling
  (Alg. 3/6) on the host, drawing from one ``np.random.default_rng(seed)``,
  with the leapfrog + gradient inner step on the device.
  ``sampling/nuts.py`` holds the sampler that runs many chains at once.

``model`` may be a LinearGaussianBayesianNetwork (log-density from its
closed-form joint), any object with a ``log_pdf(x) -> scalar`` torch
callable, or a raw callable taking one ``(dim,)`` tensor.
``_find_reasonable_stepsize`` and the host NUTS stay plain torch ops.
"""

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from pgmpy_tpu_torch.config import as_tensor
from pgmpy_tpu_torch.ops import hmc as hmc_ops
from pgmpy_tpu_torch.ops.hmc import GaussianTarget
from pgmpy_tpu_torch.utils.mathext import normal_draw, seeded_generator


# ---------------------------------------------------------------------- #
# log-density adapters + reference-parity scaffolding classes
# ---------------------------------------------------------------------- #
def _resolve_log_pdf(model):
    from pgmpy_tpu_torch.models.linear_gaussian_bn import LinearGaussianBayesianNetwork

    if callable(model) and not hasattr(model, "to_joint_gaussian"):
        return model, None
    if isinstance(model, LinearGaussianBayesianNetwork) or hasattr(
        model, "to_joint_gaussian"
    ):
        variables, mean, cov = model.joint_gaussian()
        return GaussianTarget(mean, np.linalg.inv(cov)), variables
    if hasattr(model, "log_pdf"):
        return model.log_pdf, getattr(model, "variables", None)
    raise ValueError(f"Cannot extract a log-density from {type(model)}")


def _density(log_pdf):
    """The gradient provider of ``log_pdf``: a :class:`GaussianTarget` is its
    own (closed form), anything else goes through :class:`_Density`."""
    return log_pdf if isinstance(log_pdf, GaussianTarget) else _Density(log_pdf)


class _Density:
    """A log-density of one ``(dim,)`` point with its gradient, each also
    over a leading chain axis: ``(n, dim) -> (n,)`` and ``(n, dim)``, through
    ``torch.func``."""

    def __init__(self, log_pdf):
        self.log_pdf = log_pdf
        self._grad = torch.func.grad(log_pdf)
        self._batch_log_pdf = vmap(log_pdf)
        self._batch_grad = vmap(self._grad)
        self._batch_grad_and_value = vmap(grad_and_value(log_pdf))

    def value(self, x):
        return self.log_pdf(x) if x.ndim == 1 else self._batch_log_pdf(x)

    def grad(self, x):
        return self._grad(x) if x.ndim == 1 else self._batch_grad(x)

    def grad_and_value(self, x):
        """(gradient, value) from one pass."""
        if x.ndim == 1:
            x = x[None]
            g, v = self._batch_grad_and_value(x)
            return g[0], v[0]
        return self._batch_grad_and_value(x)


class BaseGradLogPDF:
    """Parity shim for the reference gradient-provider API: subclasses
    provide ``get_gradient_log_pdf``; here autodiff does the work."""

    def __init__(self, variable_assignments, model):
        self.variable_assignments = as_tensor(variable_assignments)
        self.model = model
        log_pdf, _ = _resolve_log_pdf(model)
        self._log_pdf = log_pdf

    def get_gradient_log_pdf(self):
        x = self.variable_assignments
        return _density(self._log_pdf).grad(x), self._log_pdf(x)


class GradLogPDFGaussian(BaseGradLogPDF):
    pass


class BaseSimulateHamiltonianDynamics:
    """One integrator step: subclasses implement ``get_proposed_values``."""

    def __init__(self, model, position, momentum, stepsize, grad_log_pdf=None, grad_log_position=None):
        self.model = model
        self.position = as_tensor(position)
        self.momentum = as_tensor(momentum)
        self.stepsize = stepsize
        log_pdf, _ = _resolve_log_pdf(model)
        self._log_pdf = log_pdf
        if grad_log_position is None:
            grad_log_position = torch.func.grad(log_pdf)(self.position)
        self.grad_log_position = grad_log_position

    def get_proposed_values(self):
        raise NotImplementedError


class LeapFrog(BaseSimulateHamiltonianDynamics):
    def get_proposed_values(self):
        grad_fn = torch.func.grad(self._log_pdf)
        momentum_half = self.momentum + 0.5 * self.stepsize * self.grad_log_position
        position = self.position + self.stepsize * momentum_half
        new_grad = grad_fn(position)
        momentum = momentum_half + 0.5 * self.stepsize * new_grad
        self.new_position, self.new_momentum, self.new_grad_logp = position, momentum, new_grad
        return self


class ModifiedEuler(BaseSimulateHamiltonianDynamics):
    def get_proposed_values(self):
        grad_fn = torch.func.grad(self._log_pdf)
        momentum = self.momentum + self.stepsize * self.grad_log_position
        position = self.position + self.stepsize * momentum
        self.new_position, self.new_momentum = position, momentum
        self.new_grad_logp = grad_fn(position)
        return self


def _initial_chains(initial_pos, n_chains):
    """(n_chains, dim) start positions on ``config.DEVICE``: one ``(dim,)``
    position for every chain, or one row per chain as given."""
    initial_pos = np.asarray(initial_pos, dtype=np.float64)
    if initial_pos.ndim == 1:
        initial_pos = np.tile(initial_pos, (n_chains, 1))
    return as_tensor(initial_pos)


def _hamiltonian(log_p, momentum):
    return log_p - 0.5 * torch.sum(momentum**2, dim=-1)


# ---------------------------------------------------------------------- #
# HMC with the chains as a batch axis
# ---------------------------------------------------------------------- #
class HamiltonianMC:
    """Fixed-stepsize HMC; every chain advances in the same tensor ops."""

    def __init__(self, model, grad_log_pdf=None, simulate_dynamics=None):
        self.model = model
        self.log_pdf, self.variables = _resolve_log_pdf(model)
        self._density = _density(self.log_pdf)
        self._grad = self._density.grad
        self.accepted_proposals = 0.0
        self.acceptance_rate = 0.0

    def _leapfrog(self, position, momentum, grad, stepsize, n_steps):
        """``n_steps`` leapfrog steps from (position, momentum, grad), each
        ``(dim,)`` or ``(n_chains, dim)``."""
        q, p, g = position, momentum, grad
        for _ in range(int(n_steps)):
            p_half = p + 0.5 * stepsize * g
            q = q + stepsize * p_half
            g = self._grad(q)
            p = p_half + 0.5 * stepsize * g
        return q, p, g

    def _transitions(self, gen, position, stepsize, n_steps, transitions=1):
        """``transitions`` HMC transitions of every chain of ``position``
        (n_chains, dim): an ``ops.hmc.HmcSteps`` of the positions after each
        (transitions, n_chains, dim), the accept flags and the acceptance
        probabilities.  A GaussianTarget takes ``ops.hmc.hmc_step`` (one
        kernel launch on a CUDA device); any other density its plain
        version."""
        if isinstance(self.log_pdf, GaussianTarget):
            return hmc_ops.hmc_step(self.log_pdf, position, stepsize, n_steps, gen=gen,
                                    transitions=transitions)
        return hmc_ops.hmc_step_reference(self._density, position, stepsize, n_steps, gen=gen,
                                          transitions=transitions)

    def _kernel(self, gen, position, stepsize, n_steps):
        """One HMC transition of every chain: position (n_chains, dim) ->
        (new position, accepted (n_chains,) bool, acceptance probability)."""
        steps = self._transitions(gen, position, stepsize, n_steps)
        return steps.z[0], steps.accepted[0], steps.rate[0]

    def sample(
        self,
        initial_pos,
        num_samples,
        trajectory_length=10.0,
        stepsize=None,
        n_chains=1,
        seed=None,
        return_type="dataframe",
    ):
        """Draw ``num_samples`` per chain.  Returns a DataFrame (chain 0)
        or the raw (num_samples, n_chains, dim) array."""
        initial_pos = np.asarray(initial_pos, dtype=np.float64)
        if stepsize is None:
            stepsize = self._find_reasonable_stepsize(initial_pos)
        n_steps = max(1, int(trajectory_length / stepsize))
        gen = seeded_generator(seed)
        positions = _initial_chains(initial_pos, n_chains)

        num_samples = int(num_samples)
        steps = self._transitions(gen, positions, stepsize, n_steps, transitions=num_samples)
        trajectory = steps.z
        self.accepted_proposals = float(steps.accepted.sum())
        self.acceptance_rate = self.accepted_proposals / max(positions.shape[0] * num_samples, 1)

        trajectory = trajectory.cpu().numpy()
        if return_type == "dataframe":
            import pandas as pd

            cols = self.variables or [f"x{i}" for i in range(trajectory.shape[-1])]
            return pd.DataFrame(trajectory[:, 0, :], columns=cols)
        return trajectory

    def _find_reasonable_stepsize(self, position):
        """Heuristic from Hoffman & Gelman Alg. 4.  The probe momentum comes
        from a generator with the fixed seed 0, so the result is a function
        of the position alone."""
        position = as_tensor(np.asarray(position, dtype=np.float64).reshape(-1))
        momentum = normal_draw(position.shape, seeded_generator(0), position.dtype)
        stepsize = 1.0
        grad0, log_p = self._density.grad_and_value(position)
        h0 = _hamiltonian(log_p, momentum)

        def ratio_at(eps):
            # probe with a few steps: single-step probes miss the leapfrog
            # instability threshold on ill-conditioned targets
            q_new, p_new, _ = self._leapfrog(position, momentum, grad0, eps, 3)
            return float(_hamiltonian(self._density.value(q_new), p_new) - h0)

        ratio = ratio_at(stepsize)
        a = 1.0 if (np.isfinite(ratio) and ratio > np.log(0.5)) else -1.0
        for _ in range(50):
            new_stepsize = stepsize * 2.0**a
            ratio = ratio_at(new_stepsize)
            # stop BEFORE accepting a step that crosses the 0.5 threshold,
            # so the returned stepsize sits on the acceptable side
            if not np.isfinite(ratio) or a * ratio <= a * np.log(0.5):
                break
            stepsize = new_stepsize
        # safety margin: sit clearly inside the stable region
        return float(stepsize) / 2.0


class HamiltonianMCDA(HamiltonianMC):
    """HMC with dual-averaging stepsize adaptation during warmup."""

    def __init__(self, model, grad_log_pdf=None, simulate_dynamics=None, delta=0.65):
        super().__init__(model, grad_log_pdf, simulate_dynamics)
        self.delta = delta

    def sample(
        self,
        initial_pos,
        num_adapt,
        num_samples,
        trajectory_length=10.0,
        stepsize=None,
        n_chains=1,
        seed=None,
        return_type="dataframe",
    ):
        initial_pos = np.asarray(initial_pos, dtype=np.float64)
        if stepsize is None:
            stepsize = self._find_reasonable_stepsize(initial_pos)

        # dual averaging on chain 0 (host loop over warmup only)
        mu = np.log(10 * stepsize)
        log_eps_bar, h_bar = 0.0, 0.0
        gamma, t0, kappa = 0.05, 10.0, 0.75
        position = as_tensor(initial_pos if initial_pos.ndim == 1 else initial_pos[0])[None]
        gen = seeded_generator(seed)
        for m in range(1, int(num_adapt) + 1):
            n_steps = max(1, int(trajectory_length / stepsize))
            position, _, rate = self._kernel(gen, position, stepsize, n_steps)
            h_bar = (1 - 1 / (m + t0)) * h_bar + (self.delta - float(rate)) / (m + t0)
            log_eps = mu - np.sqrt(m) / gamma * h_bar
            eta = m**-kappa
            log_eps_bar = eta * log_eps + (1 - eta) * log_eps_bar
            stepsize = float(np.exp(log_eps))
        stepsize = float(np.exp(log_eps_bar)) if num_adapt > 0 else stepsize

        return super().sample(
            position[0].cpu().numpy(),
            num_samples,
            trajectory_length=trajectory_length,
            stepsize=stepsize,
            n_chains=n_chains,
            seed=None if seed is None else seed + 1,
            return_type=return_type,
        )


# ---------------------------------------------------------------------- #
# NUTS (recursive tree on host; leapfrog inner step on the device)
# ---------------------------------------------------------------------- #
class NoUTurnSampler(HamiltonianMC):
    """Hoffman & Gelman Algorithm 3 (efficient NUTS, slice variant)."""

    def __init__(self, model, grad_log_pdf=None, simulate_dynamics=None, max_depth=10):
        super().__init__(model, grad_log_pdf, simulate_dynamics)
        self.max_depth = max_depth

    def _leap(self, q, p, g, eps):
        """One leapfrog step of one chain: (q, p, g, log_pdf(q)) after it."""
        p_half = p + 0.5 * eps * g
        q_new = q + eps * p_half
        g_new, logp = self._density.grad_and_value(q_new)
        p_new = p_half + 0.5 * eps * g_new
        return q_new, p_new, g_new, logp

    def _build_tree(self, q, p, g, log_u, v, depth, eps, rng, joint0=0.0):
        """Returns (q-, p-, g-, q+, p+, g+, q', n', s', alpha', n_alpha').

        alpha'/n_alpha' are the Hoffman & Gelman Alg. 6 acceptance
        statistics consumed by dual averaging: the per-leaf
        ``min(1, exp(joint - joint0))`` sum and leaf count.
        """
        if depth == 0:
            q1, p1, g1, logp1 = self._leap(q, p, g, v * eps)
            joint = float(logp1) - 0.5 * float(torch.sum(p1**2))
            n1 = int(log_u <= joint)
            s1 = int(log_u < joint + 1000.0)
            alpha1 = min(1.0, np.exp(min(joint - joint0, 0.0))) if np.isfinite(joint) else 0.0
            return q1, p1, g1, q1, p1, g1, q1, n1, s1, alpha1, 1
        (qm, pm, gm, qp, pp, gp, q1, n1, s1, a1, na1) = self._build_tree(
            q, p, g, log_u, v, depth - 1, eps, rng, joint0
        )
        if s1 == 1:
            if v == -1:
                qm, pm, gm, _, _, _, q2, n2, s2, a2, na2 = self._build_tree(
                    qm, pm, gm, log_u, v, depth - 1, eps, rng, joint0
                )
            else:
                _, _, _, qp, pp, gp, q2, n2, s2, a2, na2 = self._build_tree(
                    qp, pp, gp, log_u, v, depth - 1, eps, rng, joint0
                )
            if n1 + n2 > 0 and rng.random() < n2 / (n1 + n2):
                q1 = q2
            diff = qp - qm
            s1 = (
                s2
                * int(float(diff @ pm) >= 0)
                * int(float(diff @ pp) >= 0)
            )
            n1 = n1 + n2
            a1, na1 = a1 + a2, na1 + na2
        return qm, pm, gm, qp, pp, gp, q1, n1, s1, a1, na1

    def _nuts_step_stats(self, position, eps, rng):
        """One NUTS transition; returns (new_position, alpha, n_alpha)."""
        p0 = rng.normal(size=position.shape)
        q0 = as_tensor(position)
        g0, logp0 = self._density.grad_and_value(q0)
        joint0 = float(logp0) - 0.5 * float(p0 @ p0)
        log_u = joint0 + np.log(rng.random() + 1e-300)

        qm = qp = q0
        pm = pp = as_tensor(p0)
        gm = gp = g0
        q_out = q0
        n, s, depth = 1, 1, 0
        alpha, n_alpha = 0.0, 1
        while s == 1 and depth < self.max_depth:
            v = -1 if rng.random() < 0.5 else 1
            if v == -1:
                qm, pm, gm, _, _, _, q1, n1, s1, a1, na1 = self._build_tree(
                    qm, pm, gm, log_u, v, depth, eps, rng, joint0
                )
            else:
                _, _, _, qp, pp, gp, q1, n1, s1, a1, na1 = self._build_tree(
                    qp, pp, gp, log_u, v, depth, eps, rng, joint0
                )
            if s1 == 1 and rng.random() < min(1.0, n1 / max(n, 1)):
                q_out = q1
            n += n1
            alpha, n_alpha = a1, na1  # stats from the LAST doubling (Alg. 6)
            diff = qp - qm
            s = s1 * int(float(diff @ pm) >= 0) * int(float(diff @ pp) >= 0)
            depth += 1
        return q_out.cpu().numpy().astype(np.float64), alpha, max(n_alpha, 1)

    def _nuts_step(self, position, eps, rng):
        q, _, _ = self._nuts_step_stats(position, eps, rng)
        return q

    def _frame(self, out, return_type):
        if return_type == "dataframe":
            import pandas as pd

            cols = self.variables or [f"x{i}" for i in range(out.shape[1])]
            return pd.DataFrame(out, columns=cols)
        return out

    def sample(self, initial_pos, num_samples, stepsize=None, seed=None, return_type="dataframe"):
        position = np.asarray(initial_pos, dtype=np.float64)
        if stepsize is None:
            stepsize = self._find_reasonable_stepsize(position)
        rng = np.random.default_rng(seed)
        out = np.empty((int(num_samples), position.size))
        for i in range(int(num_samples)):
            position = self._nuts_step(position, stepsize, rng)
            out[i] = position
        return self._frame(out, return_type)

    def generate_sample(self, initial_pos, num_samples, stepsize=None, seed=None):
        position = np.asarray(initial_pos, dtype=np.float64)
        if stepsize is None:
            stepsize = self._find_reasonable_stepsize(position)
        rng = np.random.default_rng(seed)
        for _ in range(int(num_samples)):
            position = self._nuts_step(position, stepsize, rng)
            yield position.copy()


class NoUTurnSamplerDA(NoUTurnSampler):
    """NUTS with dual-averaging stepsize adaptation (Alg. 6)."""

    def __init__(self, model, grad_log_pdf=None, simulate_dynamics=None, delta=0.65, max_depth=10):
        super().__init__(model, grad_log_pdf, simulate_dynamics, max_depth=max_depth)
        self.delta = delta

    def sample(self, initial_pos, num_adapt, num_samples, stepsize=None, seed=None, return_type="dataframe"):
        position = np.asarray(initial_pos, dtype=np.float64)
        if stepsize is None:
            stepsize = self._find_reasonable_stepsize(position)
        rng = np.random.default_rng(seed)

        mu = np.log(10 * stepsize)
        log_eps_bar, h_bar = 0.0, 0.0
        gamma, t0, kappa = 0.05, 10.0, 0.75
        for m in range(1, int(num_adapt) + 1):
            # Alg. 6 acceptance statistic: mean leaf MH ratio from the tree
            # (an end-to-end log-prob proxy saturates at 1.0 once in the
            # typical set and drives the stepsize to infinity)
            position, alpha, n_alpha = self._nuts_step_stats(position, stepsize, rng)
            rate = alpha / n_alpha
            h_bar = (1 - 1 / (m + t0)) * h_bar + (self.delta - rate) / (m + t0)
            log_eps = mu - np.sqrt(m) / gamma * h_bar
            eta = m**-kappa
            log_eps_bar = eta * log_eps + (1 - eta) * log_eps_bar
            stepsize = float(np.exp(log_eps))
        stepsize = float(np.exp(log_eps_bar)) if num_adapt > 0 else stepsize

        out = np.empty((int(num_samples), position.size))
        for i in range(int(num_samples)):
            position = self._nuts_step(position, stepsize, rng)
            out[i] = position
        return self._frame(out, return_type)
