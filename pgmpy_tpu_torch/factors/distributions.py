"""Distribution objects for functional CPDs.

Port of ``pgmpy_tpu/factors/distributions.py``.  Each distribution draws with
``sample(generator, shape)`` from a ``torch.Generator`` and scores with
``log_prob(x)``, both plain tensor code on the generator's device (or
``config.DEVICE``) that broadcasts the parameters against ``shape`` and ``x``:
one call covers a whole column of rows.  The log-densities use no in-place
operation, so ``torch.func.grad`` and ``vmap`` can trace them (the MCMC fit
differentiates through them).

A parameter may be a Python number, an array or a tensor (one that carries
the gradient in a fit).  Numbers stay Python floats, so a distribution built
on constants launches no host-to-device copy; arrays become tensors on
``config.DEVICE``.

``Gamma`` and ``Beta`` draw with ``torch._standard_gamma``, the one torch op
that takes a generator for gamma variates (``torch.distributions.Gamma``
draws from the global stream); Beta is ``X / (X + Y)`` of two such draws.
"""

import math

import numpy as np
import torch

from pgmpy_tpu_torch.config import TINY, as_tensor, config

_HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)


def _t(value):
    """``value`` as a tensor: a tensor is kept (with its autograd history),
    anything else goes to ``config.DTYPE`` on ``config.DEVICE``."""
    return value if isinstance(value, torch.Tensor) else as_tensor(value)


def _param(value):
    """A distribution parameter: a tensor is kept, a number (or 0-d array)
    becomes a Python float, any other array a tensor."""
    if isinstance(value, torch.Tensor):
        return value
    if np.ndim(value) == 0:
        return float(value)
    return as_tensor(value)


def _log(value):
    return torch.log(value) if isinstance(value, torch.Tensor) else math.log(value)


def _lgamma(value):
    return torch.lgamma(value) if isinstance(value, torch.Tensor) else math.lgamma(value)


def _noise(shape, gen, fill):
    """A tensor of ``shape`` on ``gen``'s device filled in place by
    ``fill(tensor, generator)``."""
    out = torch.empty(tuple(shape), dtype=config.DTYPE, device=gen.device)
    return fill(out, gen)


def _standard_gamma(concentration, shape, gen):
    """Gamma(concentration, 1) draws of ``shape`` broadcast against the
    concentration, from ``gen``."""
    a = _t(concentration).to(gen.device)
    a = torch.broadcast_to(a, torch.broadcast_shapes(tuple(shape), a.shape)).contiguous()
    return torch._standard_gamma(a, generator=gen)


class Distribution:
    #: support tag consumed by the MCMC reparametrization in
    #: FunctionalBayesianNetwork.fit: "real", "positive", or
    #: ("interval", low, high)
    support = "real"

    def sample(self, generator, shape=()):
        raise NotImplementedError

    def log_prob(self, x):
        raise NotImplementedError


class Normal(Distribution):
    def __init__(self, loc, scale):
        self.loc = _param(loc)
        self.scale = _param(scale)

    def sample(self, generator, shape=()):
        return self.loc + self.scale * _noise(shape, generator, lambda t, g: t.normal_(generator=g))

    def log_prob(self, x):
        z = (_t(x) - self.loc) / self.scale
        return -0.5 * z**2 - _log(self.scale) - _HALF_LOG_2PI


class LogNormal(Distribution):
    support = "positive"

    def __init__(self, loc, scale):
        self.loc = _param(loc)
        self.scale = _param(scale)

    def sample(self, generator, shape=()):
        return torch.exp(
            self.loc + self.scale * _noise(shape, generator, lambda t, g: t.normal_(generator=g))
        )

    def log_prob(self, x):
        logx = torch.log(_t(x))
        z = (logx - self.loc) / self.scale
        return -0.5 * z**2 - _log(self.scale) - _HALF_LOG_2PI - logx


class Exponential(Distribution):
    support = "positive"

    def __init__(self, rate):
        self.rate = _param(rate)

    def sample(self, generator, shape=()):
        return _noise(shape, generator, lambda t, g: t.exponential_(generator=g)) / self.rate

    def log_prob(self, x):
        return _log(self.rate) - self.rate * _t(x)


class Gamma(Distribution):
    support = "positive"

    def __init__(self, concentration, rate):
        self.concentration = _param(concentration)
        self.rate = _param(rate)

    def sample(self, generator, shape=()):
        return _standard_gamma(self.concentration, shape, generator) / self.rate

    def log_prob(self, x):
        a, b, x = self.concentration, self.rate, _t(x)
        return a * _log(b) - _lgamma(a) + (a - 1) * torch.log(x) - b * x


class Beta(Distribution):
    support = ("interval", 0.0, 1.0)

    def __init__(self, a, b):
        self.a = _param(a)
        self.b = _param(b)

    def sample(self, generator, shape=()):
        x = _standard_gamma(self.a, shape, generator)
        y = _standard_gamma(self.b, shape, generator)
        return x / (x + y)

    def log_prob(self, x):
        a, b, x = self.a, self.b, _t(x)
        return (
            (a - 1) * torch.log(x)
            + (b - 1) * torch.log1p(-x)
            + _lgamma(a + b)
            - _lgamma(a)
            - _lgamma(b)
        )


class Categorical(Distribution):
    def __init__(self, probs):
        self.probs = _t(probs)

    def sample(self, generator, shape=()):
        from pgmpy_tpu_torch.utils.mathext import categorical_draw

        logits = torch.log(torch.clamp_min(self.probs, TINY)).to(generator.device)
        return categorical_draw(logits.expand(tuple(shape) + logits.shape[-1:]), generator)

    def log_prob(self, x):
        return torch.log(torch.clamp_min(self.probs[_t(x).long()], TINY))


class Uniform(Distribution):
    def __init__(self, low=0.0, high=1.0):
        self.low = _param(low)
        self.high = _param(high)
        self.support = ("interval", float(low), float(high))

    def sample(self, generator, shape=()):
        u = _noise(shape, generator, lambda t, g: t.uniform_(generator=g))
        return torch.maximum(u * (self.high - self.low) + self.low, _t(self.low))

    def log_prob(self, x):
        x = _t(x)
        outside = (x < self.low) | (x > self.high)
        return torch.zeros_like(x).masked_fill(outside, -math.inf) - _log(self.high - self.low)


class HalfNormal(Distribution):
    """|N(0, scale)| — the standard scale prior in the reference's
    FunctionalBN docstrings."""

    support = "positive"

    def __init__(self, scale):
        self.scale = _param(scale)

    def sample(self, generator, shape=()):
        return torch.abs(self.scale * _noise(shape, generator, lambda t, g: t.normal_(generator=g)))

    def log_prob(self, x):
        z = _t(x) / self.scale
        return 0.5 * math.log(2.0 / math.pi) - _log(self.scale) - 0.5 * z**2
