"""LinearGaussianCPD: variable = beta . [1, evidence] + N(0, std^2).

The port's own copy of ``pgmpy_tpu/factors/continuous.py`` (host numpy only;
reference: ``pgmpy/factors/continuous/LinearGaussianCPD.py:6-191``).
"""

import numpy as np


class LinearGaussianCPD:
    def __init__(self, variable, beta, std, evidence=[]):
        self.variable = variable
        self.beta = np.asarray(beta, dtype=np.float64)
        std = float(std)
        if std <= 0 and not np.isclose(std, 0):
            raise ValueError(f"std must be a positive number. Got: {std}")
        self.std = std
        self.evidence = list(evidence)
        self.variables = [variable] + list(evidence)
        if len(self.beta) != len(self.evidence) + 1:
            raise ValueError(
                f"beta must have length len(evidence)+1. Got {len(self.beta)} "
                f"for {len(self.evidence)} evidence variables."
            )

    @property
    def mean(self):
        return self.beta

    @property
    def variance(self):
        return self.std**2

    def scope(self):
        return self.variables

    def is_valid_cpd(self):
        """Finite coefficients and positive noise scale (the reference's
        BaseFactor hook, ref factors/base.py:16, is an empty stub)."""
        return bool(np.isfinite(self.beta).all() and self.std >= 0)

    def copy(self):
        return LinearGaussianCPD(
            self.variable, self.beta.copy(), self.std, list(self.evidence)
        )

    def __str__(self):
        if self.evidence and len(self.beta) > 1:
            terms = [f"{coef:0.3f}*{ev}" for coef, ev in zip(self.beta[1:], self.evidence)]
            mean = " + ".join([f"{self.beta[0]:0.3f}"] + terms)
            return f"P({self.variable} | {', '.join(map(str, self.evidence))}) = N({mean}; {self.std:0.3f})"
        return f"P({self.variable}) = N({self.beta[0]:0.3f}; {self.std:0.3f})"

    __repr__ = __str__

    def __eq__(self, other):
        if not isinstance(other, LinearGaussianCPD):
            return False
        if self.variable != other.variable or set(self.evidence) != set(other.evidence):
            return False
        perm = [0] + [other.evidence.index(e) + 1 for e in self.evidence]
        return np.allclose(self.beta, other.beta[perm], atol=1e-6) and np.isclose(
            self.std, other.std, atol=1e-6
        )

    def __hash__(self):
        return hash((self.variable, tuple(self.evidence)))

    @staticmethod
    def get_random(variable, evidence=None, loc=0.0, scale=1.0, seed=None):
        gen = np.random.default_rng(seed)
        evidence = list(evidence) if evidence else []
        beta = gen.normal(loc=loc, scale=scale, size=len(evidence) + 1)
        std = abs(gen.normal(loc=loc, scale=scale))
        if np.isclose(std, 0):
            std = 1e-3
        return LinearGaussianCPD(variable, beta, std, evidence=evidence)
