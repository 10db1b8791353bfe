"""FunctionalCPD: a CPD given as parents -> distribution function.

Port of ``pgmpy_tpu/factors/hybrid.py``.  ``fn`` maps a dict of parent
values to a :mod:`pgmpy_tpu_torch.factors.distributions` object.  The port
calls ``fn`` ONCE per CPD on whole parent columns (tensors on
``config.DEVICE``) and draws or scores all rows in that one call, where the
JAX package loops over rows in Python.  So ``fn`` must be written on
arrays: a ``fn`` that branches in Python on one parent value
(``if parents["x"] > 0``) runs per row in ``pgmpy_tpu`` and raises here.
"""

import numpy as np
import torch

from pgmpy_tpu_torch.config import as_tensor
from pgmpy_tpu_torch.utils.mathext import seeded_generator


class _ParamStore:
    """pyro-param-store analogue for SVI-style fitting.

    CPD functions declare learnable parameters with :func:`param`; during
    ``FunctionalBayesianNetwork.fit(estimator="SVI")`` the store is switched
    to "collect" (gather names/inits/constraints by tracing each CPD once)
    and then "apply" (feed optimizer-controlled values into the same trace).
    Outside a fit, :func:`param` returns the last fitted value, so
    ``simulate()`` after ``fit()`` uses the learned parameters — the same
    global-store behavior reference scripts rely on
    (``FunctionalBayesianNetwork.py:525-528``).
    """

    def __init__(self):
        self.mode = None  # None | "collect" | "apply"
        self.values = {}
        self.inits = {}
        self.constraints = {}


_PARAM_STORE = _ParamStore()


def param(name, init=None, constraint=None, **kwargs):
    """Declare/fetch a named learnable parameter (pyro.param shape).

    ``constraint``: the string ``"positive"``,
    ``torch.distributions.constraints.positive`` or any
    ``constraints.greater_than(0.0)`` selects a softplus parametrization
    during optimization.

    In "collect" mode this returns the init as a tensor on ``config.DEVICE``;
    in "apply" mode the constrained parameter, which carries the gradient;
    outside a fit the stored value (detached) or, failing that, the init.
    """
    st = _PARAM_STORE
    if st.mode == "collect":
        if name not in st.inits:
            if init is None:
                raise ValueError(f"param {name!r} needs an init value")
            st.inits[name] = as_tensor(init)
            st.constraints[name] = constraint
        return st.inits[name]
    if st.mode == "apply":
        return st.values[name]
    if name in st.values:
        return st.values[name]
    if init is None:
        raise KeyError(f"param {name!r} has no stored value and no init")
    return as_tensor(init)


def get_param_store():
    """Current fitted parameter values, {name: tensor}."""
    return dict(_PARAM_STORE.values)


def clear_param_store():
    _PARAM_STORE.values.clear()
    _PARAM_STORE.inits.clear()
    _PARAM_STORE.constraints.clear()


def _column(values):
    """A parent or value column as a tensor on ``config.DEVICE``: a tensor is
    kept, anything else (a numpy array, a pandas Series) goes to
    ``config.DTYPE``."""
    if isinstance(values, torch.Tensor):
        return values
    return as_tensor(np.array(values, dtype=np.float64))


class FunctionalCPD:
    def __init__(self, variable, fn, parents=[]):
        if not callable(fn):
            raise ValueError(f"fn must be a callable. Got: {type(fn)}")
        self.variable = variable
        self.fn = fn
        self.parents = list(parents)
        self.variables = [variable] + self.parents

    def is_valid_cpd(self):
        """Functional CPDs are valid by construction (reference's BaseFactor
        hook, ref factors/base.py:16, is an empty stub)."""
        return True

    def _draw(self, n_samples, parent_columns, seed):
        """``n_samples`` draws as a tensor on ``config.DEVICE``: ``fn`` called
        once on the parent columns, the distribution sampled with shape
        ``(n_samples,)`` from a generator seeded with ``seed``."""
        dist = self.fn({p: parent_columns[p] for p in self.parents})
        return dist.sample(seeded_generator(seed), (int(n_samples),))

    def sample(self, n_samples=100, parent_sample=None, seed=None):
        """Draw samples; ``parent_sample`` is a DataFrame (or dict of columns)
        of parent values, row-aligned, when the CPD has parents.  Returns a
        host numpy array."""
        if self.parents:
            if parent_sample is None:
                raise ValueError("parent_sample must be provided when the CPD has parents")
            columns = {p: _column(parent_sample[p]) for p in self.parents}
            if any(c.shape[0] != n_samples for c in columns.values()):
                raise ValueError("parent_sample must have n_samples rows")
        else:
            columns = {}
        return self._draw(n_samples, columns, seed).detach().cpu().numpy()

    def log_prob(self, values, parent_values=None):
        """log p(values | parents), every row in one call; a host numpy
        array."""
        parents = {p: _column(parent_values[p]) for p in self.parents}
        return self.fn(parents).log_prob(_column(values)).detach().cpu().numpy()

    def __repr__(self):
        if self.parents:
            return f"<FunctionalCPD: P({self.variable} | {', '.join(map(str, self.parents))}) at {hex(id(self))}>"
        return f"<FunctionalCPD: P({self.variable}) at {hex(id(self))}>"
