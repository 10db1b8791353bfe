"""Generic optimisation loop + pseudo-inverse.

Port of ``pgmpy_tpu/utils/optimizer.py``, which runs optax in ``lax.scan``
chunks.  Here the optimiser is ``torch.optim`` set to optax's defaults, and
the loop keeps the JAX package's stopping rule to the step:

* steps run in chunks of ``min(64, max_iter)``; the chunk's losses stay in a
  device tensor and are read once, at its end;
* the loop stops after a chunk whose last loss is not finite, or whose last
  two losses differ by less than ``exit_delta``; so ``max_iter=2000`` runs
  2048 steps, as in the JAX package.

``_OPTIMIZERS`` takes each optax constructor's defaults (optax 0.2.6).
Where torch's rule with those values equals optax's (``adam``, ``adamw``,
``sgd``, ``adadelta``, ``adamax``) it is the torch class; ``adagrad`` and
``rmsprop`` put ``eps`` inside the square root and ``nadam`` is Adam with a
Nesterov mean and no momentum schedule, so those three are written out below.
``lbfgs`` is ``torch.optim.LBFGS`` with optax's memory of 10 pairs, a
strong-Wolfe line search and one iteration per step: optax's zoom line search
differs, so it reaches the same optimum, not the same steps.
"""

import numpy as np
import torch

from pgmpy_tpu_torch.config import as_tensor

CHUNK = 64


class _ElementwiseRule(torch.optim.Optimizer):
    """An optax rule ``params -= lr * direction(grad, state)``, one tensor at
    a time; a subclass writes ``_direction``."""

    def __init__(self, params, lr, **hyper):
        super().__init__(params, dict(lr=lr, **hyper))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    p.sub_(group["lr"] * self._direction(p.grad, self.state[p], group))
        return loss


class _Adagrad(_ElementwiseRule):
    """``optax.adagrad``: the sum of squares starts at 0.1 and ``eps`` (1e-7)
    is added inside the square root."""

    def __init__(self, params, lr, initial_accumulator_value=0.1, eps=1e-7):
        super().__init__(params, lr, initial=initial_accumulator_value, eps=eps)

    def _direction(self, g, state, group):
        if not state:
            state["sum"] = torch.full_like(g, group["initial"])
        total = state["sum"].add_(g * g)
        return torch.where(total > 0, torch.rsqrt(total + group["eps"]), 0.0) * g


class _RMSprop(_ElementwiseRule):
    """``optax.rmsprop``: decay 0.9, ``eps`` (1e-8) inside the square root."""

    def __init__(self, params, lr, decay=0.9, eps=1e-8):
        super().__init__(params, lr, decay=decay, eps=eps)

    def _direction(self, g, state, group):
        if not state:
            state["nu"] = torch.zeros_like(g)
        decay = group["decay"]
        nu = state["nu"].mul_(decay).add_((1 - decay) * g * g)
        return torch.rsqrt(nu + group["eps"]) * g


class _NAdam(_ElementwiseRule):
    """``optax.nadam``: Adam whose bias-corrected mean takes a Nesterov step,
    ``b1 * mu / (1 - b1^(t+1)) + (1 - b1) * g / (1 - b1^t)``."""

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8):
        super().__init__(params, lr, b1=b1, b2=b2, eps=eps)

    def _direction(self, g, state, group):
        b1, b2 = group["b1"], group["b2"]
        if not state:
            state.update(t=0, mu=torch.zeros_like(g), nu=torch.zeros_like(g))
        state["t"] += 1
        t = state["t"]
        mu = state["mu"].mul_(b1).add_((1 - b1) * g)
        nu = state["nu"].mul_(b2).add_((1 - b2) * g * g)
        mu_hat = b1 * mu / (1 - b1 ** (t + 1)) + (1 - b1) * g / (1 - b1**t)
        return mu_hat / (torch.sqrt(nu / (1 - b2**t)) + group["eps"])


_OPTIMIZERS = {
    "adam": lambda p, lr: torch.optim.Adam(p, lr=lr, betas=(0.9, 0.999), eps=1e-8),
    "adamw": lambda p, lr: torch.optim.AdamW(p, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                             weight_decay=1e-4),
    "sgd": lambda p, lr: torch.optim.SGD(p, lr=lr),
    "adagrad": _Adagrad,
    "adadelta": lambda p, lr: torch.optim.Adadelta(p, lr=lr, rho=0.9, eps=1e-6),
    "rmsprop": _RMSprop,
    "nadam": _NAdam,
    "adamax": lambda p, lr: torch.optim.Adamax(p, lr=lr, betas=(0.9, 0.999), eps=1e-8),
    "lbfgs": lambda p, lr: torch.optim.LBFGS(p, lr=lr, max_iter=1, history_size=10,
                                             line_search_fn="strong_wolfe"),
}


def optimize(
    loss_fn,
    params={},
    loss_args={},
    opt="adam",
    lr=0.01,
    max_iter=10000,
    exit_delta=1e-4,
):
    """Minimize ``loss_fn(params, loss_args)`` over the dict of tensors
    ``params``.

    ``opt`` is a name of ``_OPTIMIZERS`` or, where the JAX package takes an
    optax transformation, a callable that turns the list of parameter
    tensors into a ``torch.optim.Optimizer``.  Tensors keep their dtype and
    device, anything else goes to ``config.DTYPE`` on ``config.DEVICE``.
    Returns the optimized params (same keys, detached tensors).
    """
    if isinstance(opt, str):
        if opt.lower() not in _OPTIMIZERS:
            raise ValueError(f"Unknown optimizer: {opt}. Options: {sorted(_OPTIMIZERS)}")
        make = lambda leaves: _OPTIMIZERS[opt.lower()](leaves, lr)
    else:
        make = opt

    params = {
        k: (v.detach() if isinstance(v, torch.Tensor) else as_tensor(v)).clone()
        for k, v in params.items()
    }
    for leaf in params.values():
        leaf.requires_grad_(True)
    optimizer = make(list(params.values()))

    def closure():
        optimizer.zero_grad()
        loss = loss_fn(params, loss_args)
        loss.backward()
        return loss

    # One host read per chunk: the chunk's losses are written into a device
    # tensor, and only its last two decide whether to stop.
    chunk = max(1, min(CHUNK, int(max_iter)))
    losses = None
    steps_done = 0
    while steps_done < int(max_iter):
        for i in range(chunk):
            loss = optimizer.step(closure).detach()
            if losses is None:
                losses = torch.empty(chunk, dtype=loss.dtype, device=loss.device)
            losses[i] = loss
        steps_done += chunk
        tail = losses[-2:].cpu().numpy().astype(np.float64)
        if not np.isfinite(tail[-1]):
            break
        if tail.size >= 2 and abs(tail[-2] - tail[-1]) < exit_delta:
            break
    return {k: v.detach() for k, v in params.items()}


def pinverse(t):
    """Moore-Penrose pseudo-inverse, with ``jnp.linalg.pinv``'s cut-off
    (``10 * max(M, N) * eps`` of the largest singular value)."""
    matrix = t if isinstance(t, torch.Tensor) else as_tensor(t)
    rtol = 10.0 * max(matrix.shape[-2:]) * torch.finfo(matrix.dtype).eps
    return torch.linalg.pinv(matrix, rtol=rtol)
