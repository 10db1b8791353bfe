"""Math helpers: cartesian products, categorical draws, powersets.

Port of ``pgmpy_tpu/utils/mathext.py``.  ``cartesian`` and ``powerset`` are
host code.  The categorical helpers draw on ``config.DEVICE`` from an explicit
``torch.Generator`` seeded from ``seed``, never from the global generator;
the compiled sampler in ``pgmpy_tpu_torch.sampling.core`` is the performance
path.
"""

from collections import namedtuple
from itertools import chain, combinations

import numpy as np
import torch

from pgmpy_tpu_torch.config import TINY, config

# (variable, state) pair used in evidence lists and samples; the factor
# module takes it from here
State = namedtuple("State", ["var", "state"])


def cartesian(arrays, out=None):
    """Cartesian product of input arrays as an (N, len(arrays)) matrix."""
    arrays = [np.asarray(a) for a in arrays]
    dtype = arrays[0].dtype
    n = int(np.prod([a.size for a in arrays]))
    if out is None:
        out = np.zeros((n, len(arrays)), dtype=dtype)
    m = n // arrays[0].size
    out[:, 0] = np.repeat(arrays[0], m)
    if arrays[1:]:
        cartesian(arrays[1:], out=out[0:m, 1:])
        for j in range(1, arrays[0].size):
            out[j * m : (j + 1) * m, 1:] = out[0:m, 1:]
    return out


def seeded_generator(seed, device=None):
    """A ``torch.Generator`` on ``device`` (default ``config.DEVICE``) seeded
    from ``seed``; ``None`` takes a seed from numpy's global stream."""
    device = config.DEVICE if device is None else device
    if seed is None:
        seed = np.random.randint(0, 2**31)
    return torch.Generator(device=device).manual_seed(int(seed))


def race_noise(shape, gen, dtype=None):
    """``log(E)`` with ``E ~ Exp(1)`` drawn from ``gen`` on its device, in
    ``dtype`` (default ``config.DTYPE``): ``argmax(logits - race_noise)`` is a
    categorical draw.  The noise is kept finite (``E >= 1e-20``)."""
    noise = torch.empty(shape, dtype=config.DTYPE if dtype is None else dtype, device=gen.device)
    return noise.exponential_(generator=gen).clamp_min_(1e-20).log_()


def categorical_draw(logits, gen):
    """One categorical draw per row of ``logits`` (n, k), unnormalised log
    probabilities: the exponential-race form of the Gumbel-max trick,
    ``argmax_j(logits_j - log(E_j))`` with ``E_j ~ Exp(1)`` drawn from
    ``gen``.  The noise is kept finite, so a state whose log probability sits
    at a clamp such as ``log(1e-38)`` never beats a state of real mass."""
    return torch.argmax(logits - race_noise(logits.shape, gen, logits.dtype), dim=-1)


def normal_draw(shape, gen, dtype=None):
    """Standard normal draws of ``shape`` from ``gen`` on its device, in
    ``dtype`` (default ``config.DTYPE``)."""
    return torch.randn(shape, generator=gen, dtype=config.DTYPE if dtype is None else dtype,
                       device=gen.device)


def _log_weights(weights):
    weights = torch.as_tensor(np.asarray(weights, dtype=np.float64), device=config.DEVICE)
    return torch.log(torch.clamp_min(weights, TINY))


def sample_discrete(values, weights, size=1, seed=None):
    """Draw from a categorical distribution; ``weights`` may be a single
    distribution or one distribution per sample row."""
    values = np.asarray(values)
    logits = _log_weights(weights)
    if logits.ndim == 1:
        logits = logits.expand(int(size), -1)
    return values[categorical_draw(logits, seeded_generator(seed)).cpu().numpy()]


def sample_discrete_maps(states, weight_indices, index_to_weight, size=1, seed=None):
    """Categorical draws with a per-row pointer into a weight table."""
    states = np.asarray(states)
    keys = sorted(index_to_weight)
    position = {k: i for i, k in enumerate(keys)}
    table = _log_weights(np.stack([index_to_weight[k] for k in keys]))
    rows = torch.as_tensor(
        np.asarray([position[k] for k in np.asarray(weight_indices).tolist()], dtype=np.int64),
        device=config.DEVICE,
    )
    return states[categorical_draw(table[rows], seeded_generator(seed)).cpu().numpy()]


def powerset(iterable):
    """All subsets of the iterable as tuples."""
    s = list(iterable)
    return chain.from_iterable(combinations(s, r) for r in range(len(s) + 1))
