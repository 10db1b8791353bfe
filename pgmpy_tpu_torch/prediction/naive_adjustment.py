"""NaiveAdjustmentRegressor: sklearn-compatible causal-effect regressor.

Port of ``pgmpy_tpu/prediction/naive_adjustment.py`` (reference:
``pgmpy/prediction/NaiveAdjustmentRegressor.py``).  Feature selection is
role-driven exactly like the reference: the design matrix is
``[exposure] + adjustment-role + pretreatment-role`` columns of the causal
graph (roles are taken as given, not re-derived).  The default base
estimator is an ordinary least-squares fit (the reference uses sklearn's
``LinearRegression`` — identical numerics), solved in float64 on
``config.DEVICE`` by the shared minimum-norm solve (``ops/lstsq.py``) where
the JAX package calls host ``np.linalg.lstsq``; any object with sklearn's
``fit(X, y)`` / ``predict(X)`` protocol can be passed instead (``sklearn``
is imported only to clone such an object).

Known divergence (by design, see COVERAGE.md): the sklearn
metadata-routing plumbing (``get_metadata_routing``, ``set_fit_request``,
...) comes from sklearn's ``BaseEstimator``/``RegressorMixin`` in the
reference; ours implements the estimator protocol without inheriting
sklearn.
"""

import numpy as np
import pandas as pd

from pgmpy_tpu_torch.ops.lstsq import lstsq


class _LstsqRegressor:
    """Default base estimator: intercept + least squares (equals sklearn's
    LinearRegression on full-rank designs)."""

    def fit(self, X, y, sample_weight=None):
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        A = np.column_stack([np.ones(X.shape[0]), X])
        if sample_weight is not None:
            w = np.sqrt(np.asarray(sample_weight, dtype=np.float64))
            A = A * w[:, None]
            y = y * w
        beta = lstsq(A, y).cpu().numpy()
        self.intercept_ = float(beta[0])
        self.coef_ = beta[1:]
        return self

    def predict(self, X):
        X = np.asarray(X, dtype=np.float64)
        return self.intercept_ + X @ self.coef_


class NaiveAdjustmentRegressor:
    """Regressor that predicts the outcome from the exposure plus the
    graph-declared adjustment and pretreatment variables (reference
    ``NaiveAdjustmentRegressor.py:17-292``).

    Parameters
    ----------
    causal_graph : DAG (or any roled graph)
        Must declare exactly one ``exposure`` and one ``outcome`` role;
        ``adjustment`` and ``pretreatment`` roles are optional.
    estimator : sklearn-protocol estimator, optional
        Base estimator; default is ordinary least squares.
    """

    def __init__(self, causal_graph=None, estimator=None):
        self.causal_graph = causal_graph
        self.estimator = estimator

    # -- sklearn estimator protocol ------------------------------------ #
    def get_params(self, deep=True):
        return {"causal_graph": self.causal_graph, "estimator": self.estimator}

    def set_params(self, **params):
        for k, v in params.items():
            setattr(self, k, v)
        return self

    # ------------------------------------------------------------------ #
    def _prepare_feature_df(self, X):
        """Strict column selection: names must match the graph variables
        (numpy input gets integer column names, ref :118-175)."""
        if isinstance(X, pd.DataFrame):
            X_df = X
        else:
            arr = np.asarray(X)
            if arr.ndim == 1:
                raise ValueError(
                    "Reshape your data: X must be 2D. If using a 1D array, "
                    "reshape it to (n_samples, 1)."
                )
            X_df = pd.DataFrame(arr, columns=range(arr.shape[1]))
        missing = set(self.feature_columns_) - set(X_df.columns)
        if missing:
            raise ValueError(
                f"Missing required columns in input data: {list(missing)}. "
                f"DAG expects columns: {self.feature_columns_}, but got: "
                f"{list(X_df.columns)}"
            )
        return X_df[self.feature_columns_]

    def fit(self, X, y, sample_weight=None):
        if self.causal_graph is None or not hasattr(self.causal_graph, "get_role"):
            raise ValueError("causal_graph with variable roles is required")
        exposure_vars = list(self.causal_graph.get_role("exposure"))
        outcome_vars = list(self.causal_graph.get_role("outcome"))
        adjustment_vars = list(self.causal_graph.get_role("adjustment"))
        pretreatment_vars = list(self.causal_graph.get_role("pretreatment"))
        if len(exposure_vars) != 1:
            raise ValueError(
                f"Exactly one exposure variable must be defined. "
                f"Found {len(exposure_vars)}: {exposure_vars}"
            )
        if len(outcome_vars) != 1:
            raise ValueError(
                f"Exactly one outcome variable must be defined. "
                f"Found {len(outcome_vars)}: {outcome_vars}"
            )
        self.exposure_var_ = exposure_vars[0]
        self.outcome_var_ = outcome_vars[0]
        self.adjustment_vars_ = adjustment_vars
        self.pretreatment_vars_ = pretreatment_vars
        self.feature_columns_ = (
            [self.exposure_var_] + adjustment_vars + pretreatment_vars
        )

        if isinstance(X, pd.DataFrame):
            self.feature_names_in_ = np.asarray(list(X.columns), dtype=object)
            self.n_features_in_ = X.shape[1]
        else:
            self.n_features_in_ = np.asarray(X).shape[1]

        X_features = self._prepare_feature_df(X)
        if self.estimator is None:
            self.estimator_ = _LstsqRegressor()
        else:
            try:
                from sklearn.base import clone

                self.estimator_ = clone(self.estimator)
            except Exception:
                import copy

                self.estimator_ = copy.deepcopy(self.estimator)
        if sample_weight is not None:
            self.estimator_.fit(X_features, y, sample_weight=sample_weight)
        else:
            self.estimator_.fit(X_features, y)

        adj = ", ".join(map(str, adjustment_vars)) if adjustment_vars else "none"
        pre = (
            ", ".join(map(str, pretreatment_vars)) if pretreatment_vars else "none"
        )
        self.explanation_ = (
            f"NaiveAdjustmentRegressor(exposure={self.exposure_var_}, "
            f"outcome={self.outcome_var_}, adjustment=[{adj}], "
            f"pretreatment=[{pre}], "
            f"estimator={type(self.estimator_).__name__})"
        )
        return self

    def predict(self, X):
        if not hasattr(self, "estimator_"):
            raise ValueError("This NaiveAdjustmentRegressor is not fitted yet.")
        return np.asarray(
            self.estimator_.predict(self._prepare_feature_df(X))
        ).ravel()

    def score(self, X, y, sample_weight=None):
        """R^2 of the predictions (sklearn RegressorMixin semantics)."""
        pred = self.predict(X)
        y = np.asarray(y, dtype=np.float64)
        if sample_weight is not None:
            w = np.asarray(sample_weight, dtype=np.float64)
        else:
            w = np.ones_like(y)
        ss_res = float(np.sum(w * (y - pred) ** 2))
        mean = float(np.sum(w * y) / np.sum(w))
        ss_tot = float(np.sum(w * (y - mean) ** 2))
        return 1.0 - ss_res / ss_tot if ss_tot else 0.0

    def get_feature_names_out(self, input_features=None):
        return np.asarray(self.feature_columns_, dtype=object)