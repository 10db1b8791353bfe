"""DiscreteFactor: a dense tensor with named axes, resident on a device.

Port of ``pgmpy_tpu/factors/discrete.py``:

* ``values`` is a torch tensor of shape ``cardinality`` on
  ``config.DEVICE``; variable names / cardinalities / state names are host
  metadata.
* Every numeric op (product, marginalize, maximize, reduce, divide,
  normalize) is one or two torch ops; inference code works on the raw
  ``.values`` tensors and only uses this class at the user-facing boundary.

Semantics follow the reference: the flat ``values`` vector is C-ordered with
the *right-most* variable cycling fastest, binary ops keep the left operand's
axis order and append new variables, and ``0/0 == 0`` in division.
"""

import numpy as np
import torch

from pgmpy_tpu_torch.config import as_tensor, config, logger, to_numpy
from pgmpy_tpu_torch.utils.mathext import State
from pgmpy_tpu_torch.utils.state_name import StateNameMixin


class DiscreteFactor(StateNameMixin):
    """A factor phi(X1, .., Xn) over discrete variables.

    Parameters
    ----------
    variables : list
        Scope of the factor.
    cardinality : list of int
        Number of states of each variable, aligned with ``variables``.
    values : array-like
        ``prod(cardinality)`` values in C order (right-most variable fastest)
        or an array already shaped to ``cardinality``.
    state_names : dict, optional
        Mapping variable -> list of state names.

    Examples
    --------
    >>> import numpy as np
    >>> from pgmpy_tpu_torch.factors import DiscreteFactor
    >>> phi = DiscreteFactor(["a", "b"], [2, 3],
    ...                      [1.0, 1.0, 1.0, 1.0, 1.0, 4.0])
    >>> phi.get_cardinality(["a", "b"])
    {'a': 2, 'b': 3}
    >>> marg = phi.marginalize(["b"], inplace=False)
    >>> (marg.variables, np.asarray(marg.values).round(1).tolist())
    (['a'], [3.0, 6.0])
    >>> red = phi.reduce([("a", 1)], inplace=False)
    >>> np.asarray(red.values).round(1).tolist()
    [1.0, 1.0, 4.0]
    >>> psi = DiscreteFactor(["b"], [3], [2.0, 1.0, 1.0])
    >>> prod = phi * psi  # axis order: left operand's, new vars appended
    >>> (prod.variables, np.asarray(prod.values).round(1).tolist())
    (['a', 'b'], [[2.0, 1.0, 1.0], [2.0, 1.0, 4.0]])
    >>> np.asarray(
    ...     prod.normalize(inplace=False).values).sum().round(2).item()
    1.0
    """

    def __init__(self, variables, cardinality, values, state_names={}):
        if isinstance(variables, str):
            raise TypeError("Variables: Expected type list or array like, got string")
        variables = list(variables)
        if len(variables) != len(set(variables)):
            raise ValueError("Variable names cannot be same")
        cardinality = [int(c) for c in cardinality]
        if len(cardinality) != len(variables):
            raise ValueError(
                "Number of elements in cardinality must be equal to number of variables"
            )

        values = as_tensor(values)
        expected = int(np.prod(cardinality)) if cardinality else 1
        if values.numel() != expected:
            raise ValueError(f"Values array must be of size: {expected}")

        self.variables = variables
        self.cardinality = np.asarray(cardinality, dtype=np.int64)
        self.values = values.reshape(tuple(cardinality))
        self.store_state_names(variables, cardinality, state_names)

    # ------------------------------------------------------------------ #
    # values: property so every in-place mutation (including direct user
    # assignment ``factor.values = ...``) bumps a counter that model-level
    # compiled-program caches key on, and invalidates the cached CPD
    # validity bit.
    # ------------------------------------------------------------------ #
    @property
    def values(self):
        return self._values

    @values.setter
    def values(self, new_values):
        self._values = new_values
        self.__dict__["_mutation"] = self.__dict__.get("_mutation", 0) + 1
        self.__dict__.pop("_is_valid_cpd", None)

    # ------------------------------------------------------------------ #
    # introspection
    # ------------------------------------------------------------------ #
    def scope(self):
        return self.variables

    def get_cardinality(self, variables):
        if isinstance(variables, str):
            raise TypeError("variables: Expected type list or array-like, got type str")
        missing = set(variables) - set(self.variables)
        if missing:
            raise ValueError(f"Variable not in scope: {missing}")
        return {
            var: int(self.cardinality[self.variables.index(var)]) for var in variables
        }

    def get_value(self, **kwargs):
        """phi value for a full assignment given by state *names*."""
        index = []
        for var in self.variables:
            if var not in kwargs:
                raise ValueError(f"Variable: {var} not found in arguments")
            index.append(self.get_state_no(var, kwargs[var]))
        return float(self.values[tuple(index)])

    def set_value(self, value, **kwargs):
        index = tuple(self.get_state_no(var, kwargs[var]) for var in self.variables)
        new_values = self.values.clone()
        new_values[index] = value
        self.values = new_values

    def assignment(self, index):
        """Assignments (as (var, state-name) lists) of flat indices."""
        index = np.asarray(index)
        max_index = int(np.prod(self.cardinality)) - 1
        if index.size and index.max() > max_index:
            raise IndexError(f"Index greater than max possible index {max_index}")
        unraveled = np.stack(
            np.unravel_index(index, tuple(self.cardinality)), axis=-1
        )
        return [
            [
                State(var, self.get_state_names(var, int(code)))
                for var, code in zip(self.variables, row)
            ]
            for row in unraveled
        ]

    def identity_factor(self):
        return DiscreteFactor(
            self.variables,
            self.cardinality,
            torch.ones(
                tuple(int(c) for c in self.cardinality), dtype=config.DTYPE, device=config.DEVICE
            ),
            self.state_names,
        )

    # ------------------------------------------------------------------ #
    # reductions
    # ------------------------------------------------------------------ #
    def _axes_of(self, variables):
        for var in variables:
            if var not in self.variables:
                raise ValueError(f"{var} not in scope.")
        return [self.variables.index(var) for var in variables]

    def _drop_vars(self, phi, variables):
        index = sorted(phi._axes_of(variables))
        phi.variables = [v for v in phi.variables if v not in set(variables)]
        phi.cardinality = np.delete(phi.cardinality, index)
        phi.del_state_names(variables)
        return index

    def marginalize(self, variables, inplace=True):
        """Sum out ``variables``."""
        if isinstance(variables, str):
            raise TypeError("variables: Expected type list or array-like, got type str")
        phi = self if inplace else self.copy()
        axes = self._drop_vars(phi, variables)
        if axes:  # torch.sum(dim=()) would reduce every axis
            phi.values = torch.sum(phi.values, dim=tuple(axes))
        if not inplace:
            return phi

    def maximize(self, variables, inplace=True):
        """Max out ``variables``."""
        if isinstance(variables, str):
            raise TypeError("variables: Expected type list or array-like, got type str")
        phi = self if inplace else self.copy()
        axes = self._drop_vars(phi, variables)
        if axes:
            phi.values = torch.amax(phi.values, dim=tuple(axes))
        if not inplace:
            return phi

    def normalize(self, inplace=True):
        """Scale so values sum to 1."""
        phi = self if inplace else self.copy()
        phi.values = phi.values / torch.sum(phi.values)
        if not inplace:
            return phi

    def reduce(self, values, inplace=True, show_warnings=True):
        """Condition on evidence: ``values`` is a list of (var, state) where
        state may be a state name or an integer state number (reference
        semantics, ``DiscreteFactor.py:535-618``)."""
        if isinstance(values, str):
            raise TypeError("values: Expected type list or array-like, got type str")
        if any(isinstance(value, str) for value in values):
            raise TypeError("values: must contain tuples or array-like elements")

        phi = self if inplace else self.copy()
        var_index_to_keep = list(range(len(phi.variables)))
        slice_ = [slice(None)] * len(phi.variables)
        reduced_vars = []
        for var, state in values:
            if var not in phi.variables:
                raise ValueError(f"The variable: {var} is not in the factor")
            if isinstance(state, (int, np.integer)) and state not in phi.name_to_no[var]:
                state_no = int(state)
                if state_no >= int(phi.cardinality[phi.variables.index(var)]):
                    raise ValueError(f"Invalid state number {state} for {var}")
                if show_warnings:
                    logger.warning(
                        f"Using {state} state as number instead of name for variable {var}."
                    )
            else:
                state_no = phi.get_state_no(var, state)
            axis = phi.variables.index(var)
            slice_[axis] = state_no
            var_index_to_keep.remove(axis)
            reduced_vars.append(var)

        phi.variables = [phi.variables[i] for i in var_index_to_keep]
        phi.cardinality = phi.cardinality[var_index_to_keep]
        phi.del_state_names(reduced_vars)
        phi.values = phi.values[tuple(slice_)]
        if not inplace:
            return phi

    # ------------------------------------------------------------------ #
    # binary ops
    # ------------------------------------------------------------------ #
    def _align_other(self, phi1):
        """Broadcast-align ``phi1`` to a union scope with self.

        Returns (self_values, other_values, out_variables, out_cardinality)
        where both value arrays are transposed/reshaped to the output axis
        order: self's variables first, then phi1's extra variables.
        """
        extra = [v for v in phi1.variables if v not in self.variables]
        out_vars = list(self.variables) + extra
        axis = {v: i for i, v in enumerate(out_vars)}
        n = len(out_vars)

        # self: already a prefix of out_vars; append singleton axes.
        self_vals = self.values.reshape(
            tuple(self.values.shape) + (1,) * len(extra)
        )

        # other: transpose into out order then insert singleton axes.
        other_axes = sorted(range(len(phi1.variables)), key=lambda i: axis[phi1.variables[i]])
        other_vals = phi1.values.permute(other_axes)
        shape = [1] * n
        for i in other_axes:
            shape[axis[phi1.variables[i]]] = int(phi1.values.shape[i])
        other_vals = other_vals.reshape(tuple(shape))

        out_card = np.zeros(n, dtype=np.int64)
        out_card[: len(self.cardinality)] = self.cardinality
        for v in extra:
            out_card[axis[v]] = int(phi1.cardinality[phi1.variables.index(v)])
        return self_vals, other_vals, out_vars, out_card

    def _binary_op(self, phi1, op, inplace):
        phi = self if inplace else self.copy()
        if isinstance(phi1, (int, float)):
            phi.values = op(phi.values, phi1)
        else:
            if set(self.variables) & set(phi1.variables):
                # check cardinality/state-name agreement on shared vars
                for var in set(self.variables) & set(phi1.variables):
                    if int(self.cardinality[self.variables.index(var)]) != int(
                        phi1.cardinality[phi1.variables.index(var)]
                    ):
                        raise ValueError(
                            f"Cardinality of variable {var} does not match in both factors"
                        )
            a, b, out_vars, out_card = phi._align_other(phi1)
            phi.variables = out_vars
            phi.cardinality = out_card
            phi.values = op(a, b)
            phi.add_state_names(phi1)
        if not inplace:
            return phi

    def sum(self, phi1, inplace=True):
        return self._binary_op(phi1, torch.add, inplace)

    def product(self, phi1, inplace=True):
        return self._binary_op(phi1, torch.mul, inplace)

    def divide(self, phi1, inplace=True):
        if isinstance(phi1, (int, float)):
            raise TypeError("phi1: Expected type DiscreteFactor, got scalar")
        if set(phi1.variables) - set(self.variables):
            raise ValueError("Scope of divisor should be a subset of dividend")

        def safe_div(a, b):
            out = a / b
            return torch.where(torch.isnan(out), torch.zeros_like(out), out)

        return self._binary_op(phi1, safe_div, inplace)

    # ------------------------------------------------------------------ #
    # sampling / misc
    # ------------------------------------------------------------------ #
    def sample(self, n, seed=None):
        """Draw ``n`` joint assignments proportional to the factor values."""
        import pandas as pd

        p = to_numpy(self.values).astype(np.float64).ravel()
        p = p / p.sum()
        rng = np.random.default_rng(seed)
        idx = rng.choice(p.size, size=n, p=p)
        codes = np.stack(np.unravel_index(idx, tuple(self.cardinality)), axis=-1)
        df = pd.DataFrame(codes, columns=self.variables)
        for var in self.variables:
            df[var] = df[var].map(self.no_to_name[var])
        return df

    def is_valid_cpd(self):
        cached = self.__dict__.get("_is_valid_cpd")
        if cached is not None:
            return cached
        v = to_numpy(self.values).astype(np.float64)
        marg = v.reshape(v.shape[0], -1).sum(axis=0)
        result = bool(np.allclose(marg, 1.0, atol=0.01))
        self._is_valid_cpd = result  # cache the device->host reduction
        return result

    def copy(self):
        copy = DiscreteFactor.__new__(DiscreteFactor)
        copy.variables = list(self.variables)
        copy.cardinality = self.cardinality.copy()
        copy.values = self.values
        copy.state_names = {k: list(v) for k, v in self.state_names.items()}
        copy.name_to_no = {k: dict(v) for k, v in self.name_to_no.items()}
        copy.no_to_name = {k: dict(v) for k, v in self.no_to_name.items()}
        return copy

    # ------------------------------------------------------------------ #
    # operators / equality
    # ------------------------------------------------------------------ #
    def __mul__(self, other):
        return self.product(other, inplace=False)

    __rmul__ = __mul__

    def __add__(self, other):
        return self.sum(other, inplace=False)

    __radd__ = __add__

    def __truediv__(self, other):
        return self.divide(other, inplace=False)

    __div__ = __truediv__

    def __str__(self):
        return self._str(phi_or_p="phi", tablefmt="grid")

    def _str(self, phi_or_p="phi", tablefmt="grid", print_state_names=True):
        from pgmpy_tpu_torch.utils.tabulate import tabulate

        string_header = list(map(str, self.scope()))
        string_header.append(
            f"{phi_or_p}({','.join(string_header)})"
        )
        value_index = 0
        factor_table = []
        vals = to_numpy(self.values).astype(np.float64).ravel()
        import itertools

        for prob in itertools.product(*[range(int(card)) for card in self.cardinality]):
            if print_state_names:
                prob_list = [
                    "{var}({state})".format(
                        var=list(self.variables)[i],
                        state=self.state_names[list(self.variables)[i]][prob[i]],
                    )
                    for i in range(len(self.variables))
                ]
            else:
                prob_list = [
                    f"{list(self.variables)[i]}_{prob[i]}"
                    for i in range(len(self.variables))
                ]
            prob_list.append(float(vals[value_index]))
            factor_table.append(prob_list)
            value_index += 1
        return tabulate(factor_table, headers=string_header, tablefmt=tablefmt, floatfmt=".4f")

    def __repr__(self):
        var_card = ", ".join(
            f"{var}:{int(card)}" for var, card in zip(self.variables, self.cardinality)
        )
        return f"<DiscreteFactor representing phi({var_card}) at {hex(id(self))}>"

    def __eq__(self, other, atol=None):
        if not isinstance(other, DiscreteFactor):
            return False
        if atol is None:
            # float32 device values need a looser default than the
            # reference's float64 1e-8.
            atol = 1e-8 if self.values.dtype == torch.float64 else 1e-5
        if set(self.scope()) != set(other.scope()):
            return False
        # align other's axis order to self's
        axes = [other.variables.index(var) for var in self.variables]
        other_values = np.transpose(to_numpy(other.values), axes)
        other_card = other.cardinality[axes]
        if not np.array_equal(other_card, self.cardinality):
            return False
        # align state-name ordering per axis
        for i, var in enumerate(self.variables):
            if self.state_names[var] != other.state_names[var]:
                try:
                    perm = [other.state_names[var].index(s) for s in self.state_names[var]]
                except ValueError:
                    return False
                other_values = np.take(other_values, perm, axis=i)
        return np.allclose(to_numpy(self.values), other_values, atol=atol)

    def __ne__(self, other):
        return not self.__eq__(other)

    def __hash__(self):
        # a factor is a graph node of factor graphs and cluster graphs, hashed
        # at every lookup: the hash is kept until the values are rebound
        # (``_mutation``) or edited in place (the tensor's ``_version``), so
        # a graph of tens of thousands of factors does not copy each factor's
        # values to the host at every lookup
        key = (tuple(self.variables), self.__dict__.get("_mutation", 0), self._values._version)
        cached = self.__dict__.get("_hash")
        if cached is None or cached[0] != key:
            cached = (key, hash((
                tuple(map(str, self.variables)),
                tuple(int(c) for c in self.cardinality),
                to_numpy(self.values).tobytes(),
            )))
            self.__dict__["_hash"] = cached
        return cached[1]

