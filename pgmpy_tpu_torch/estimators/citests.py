"""Conditional-independence tests.

Port of ``pgmpy_tpu/estimators/citests.py``.  The discrete tests build the
full (X, Y, Z-config) contingency tensor with one call of the count kernel
(``ops/bincount.py:table_counts``) and evaluate the Cressie-Read
power-divergence family in one host float64 reduction vectorized over all Z
slices; ``power_divergence_batch`` serves a whole list of tests from one
launch.  Counts reach the statistic as float64 made from the kernel's int32,
never through float32: PC decides on ``p >= significance_level``.

Continuous / mixed tests are residual-based host numpy float64 code, as in
the JAX package.  ``pillai_trace`` implements the mixed-data test of Ankan &
Textor (AAAI 2024): boosted-tree predictions of X and Y from Z (classifier
``predict_proba`` for categoricals), one-hot residuals with the last column
dropped, canonical correlations of the residual blocks, and the
Muller-Peterson F approximation of Pillai's trace.  ``sklearn`` is imported
only by the calls that need it (``pillai_trace`` and ``gcm`` with a
regressor).  Categorical columns are integer-coded (never float-coerced)
everywhere, so the tests work on the string-state DataFrames that
``model.simulate`` produces.

Examples
--------
>>> import numpy as np
>>> import pandas as pd
>>> from pgmpy_tpu_torch.estimators.citests import chi_square
>>> rng = np.random.default_rng(0)
>>> z = rng.integers(0, 2, 2000)
>>> df = pd.DataFrame({
...     "z": z,
...     "x": np.where(rng.random(2000) < 0.8, z, 1 - z),
...     "y": np.where(rng.random(2000) < 0.8, z, 1 - z)})
>>> chi_square("x", "y", ["z"], df)   # conditionally independent given z
True
>>> chi_square("x", "z", [], df)      # marginally dependent
False
>>> stat, p, dof = chi_square("x", "y", ["z"], df, boolean=False)
>>> dof
2
"""

import numpy as np
import pandas as pd
from scipy import special, stats

from pgmpy_tpu_torch.config import config
from pgmpy_tpu_torch.estimators.base import _CodedData


def get_callable_ci_test(ci_test, data=None):
    tests = {
        "chi_square": chi_square,
        "g_sq": g_sq,
        "log_likelihood": log_likelihood,
        "modified_log_likelihood": modified_log_likelihood,
        "pearsonr": pearsonr,
        "pillai": pillai_trace,
        "gcm": gcm,
        "independence_match": independence_match,
    }
    if callable(ci_test):
        return ci_test
    if isinstance(ci_test, str):
        if ci_test not in tests:
            raise ValueError(f"Unknown ci_test: {ci_test}. Options: {sorted(tests)}")
        return tests[ci_test]
    if ci_test is None:
        # infer a suitable default from the data's variable types
        # (ref CITests.py:46-55: continuous->pearsonr, discrete->chi_square,
        # mixed->pillai)
        if data is None:
            raise ValueError(
                "Cannot determine a suitable CI test as data is None."
            )
        from pgmpy_tpu_torch.utils.utils import get_dataset_type

        return {
            "continuous": pearsonr,
            "discrete": chi_square,
            "mixed": pillai_trace,
        }[get_dataset_type(data)]
    raise ValueError("ci_test must be a string or callable")


# --------------------------------------------------------------------------
# Discrete family: one count launch + one host float64 statistic
# --------------------------------------------------------------------------


# The coded copy of a frame is kept on the frame itself, under a name of this
# package's own (the JAX package keeps its own under another name, and the
# same frame may reach both) and per device: a frame first coded on the CPU is
# not counted on the card, nor the reverse.
_FRAME_CACHE = "_pgmpy_tpu_torch_coded"


def _frame_coded(data):
    """The frame's ``_CodedData`` on ``config.DEVICE``, made once."""
    per_device = data.__dict__.get(_FRAME_CACHE)
    if per_device is None:
        per_device = {}
        try:
            data.__dict__[_FRAME_CACHE] = per_device
        except Exception:
            pass
    key = str(config.DEVICE)
    coded = per_device.get(key)
    if coded is None:
        coded = per_device[key] = _CodedData(data)
    return coded


def _contingency(X, Y, Z, data):
    """(cx, cy, n_z_configs) float64 count tensor from one count launch."""
    coded = _frame_coded(data)
    table = coded.counts(X, [Y] + list(Z), dtype=np.float64)
    return table.reshape(coded.cards[X], coded.cards[Y], -1)


# scipy's named Cressie-Read family members (stats.power_divergence)
_LAMBDA_BY_NAME = {
    "pearson": 1.0,
    "log-likelihood": 0.0,
    "freeman-tukey": -0.5,
    "mod-log-likelihood": -1.0,
    "neyman": -2.0,
    "cressie-read": 2.0 / 3.0,
}


def _power_divergence_stat(table, lam):
    """Summed power-divergence statistic + dof over all Z slices at once
    (vectorized over the (cx, cy, nz) tensor — no per-Z Python loop).

    Per slice, zero rows/columns are masked out (the reference's per-slice
    ``np.unique`` tables only contain observed states,
    ``CITests.py:470-493``); slices whose observed table is smaller than
    2x2 contribute nothing.  dof per kept slice is
    (nnz_rows-1)(nnz_cols-1), exactly scipy's.  Slices with dof == 1 get
    scipy's default Yates continuity correction (observed pulled toward
    expected by min(0.5, |E-O|)) — the reference calls
    ``chi2_contingency`` WITHOUT ``correction=False``.

    Runs on the host in float64 on purpose, expression for expression as in
    the JAX package: the O(n_rows) work is the count launch; the statistic is
    a small reduction over the count tensor, and float32 would lose the
    reference's last digits.
    """
    with np.errstate(divide="ignore", invalid="ignore"):
        O = table
        row = O.sum(axis=1, keepdims=True)  # (cx, 1, nz)
        col = O.sum(axis=0, keepdims=True)  # (1, cy, nz)
        tot = O.sum(axis=(0, 1))  # (nz,)
        nnz_r = (row[:, 0, :] > 0).sum(axis=0)
        nnz_c = (col[0, :, :] > 0).sum(axis=0)
        valid = (nnz_r >= 2) & (nnz_c >= 2)
        E = row * col / np.where(tot > 0, tot, 1.0)[None, None, :]
        mask = E > 0  # cells of the stripped table; E>0 there by construction
        dof_z = (nnz_r - 1) * (nnz_c - 1)
        # Yates continuity correction on 2x2 (dof==1) slices, scipy default
        yates = (dof_z == 1)[None, None, :] & mask
        diff = E - O
        O = np.where(
            yates, O + np.sign(diff) * np.minimum(0.5, np.abs(diff)), O
        )
        Esafe = np.where(mask, E, 1.0)
        Osafe = np.where(O > 0, O, 1.0)
        if lam == 1.0:  # pearson
            terms = (O - E) ** 2 / Esafe
        elif lam == 0.0:  # log-likelihood (G-test); O=0 contributes 0
            terms = 2.0 * O * np.log(Osafe / Esafe)
        elif lam == -1.0:  # mod-log-likelihood; O=0 with E>0 -> inf (scipy)
            terms = 2.0 * E * np.log(Esafe / Osafe)
            terms = np.where(mask & (O == 0), np.inf, terms)
        else:
            # generic Cressie-Read, literal scipy semantics: only lambda in
            # {1, 0, -1} are special-cased there, so e.g. freeman-tukey /
            # neyman with an interior O=0 cell produce 0*inf = nan like scipy
            terms = 2.0 / (lam * (lam + 1.0)) * O * ((O / Esafe) ** lam - 1.0)
        terms = np.where(mask, terms, 0.0)
        stat_z = terms.sum(axis=(0, 1))
        stat = np.where(valid, stat_z, 0.0).sum()
        dof = int(np.where(valid, dof_z, 0).sum())
    return stat, dof


def _pd_result(table, lam, n_z):
    """(stat, p_value, dof) from a (cx, cy, nz) contingency tensor."""
    stat, dof = _power_divergence_stat(table, lam)
    stat_total, dof_total = float(stat), int(dof)
    if dof_total == 0:
        stat_total = 0.0
        # reference semantics: the conditional path computes
        # 1 - chi2.cdf(0, df=0) = NaN (every slice degenerate -> the
        # boolean test comes out "dependent", keeping the edge), while the
        # unconditional path goes through scipy.chi2_contingency which
        # returns p=1.0 for a 1xk table (ref CITests.py:458-493)
        p_value = float("nan") if n_z > 0 else 1.0
    else:
        # the function ``stats.chi2.sf`` evaluates, bit for bit, without its
        # argument handling, which costs more than the function itself
        p_value = float(special.chdtrc(dof_total, stat_total))
    return stat_total, p_value, dof_total


def _power_divergence(X, Y, Z, data, boolean, significance_level, lambda_):
    table = _contingency(X, Y, list(Z), data)
    lam = _LAMBDA_BY_NAME.get(lambda_, lambda_)
    if not isinstance(lam, float):
        lam = float(lam)
    stat_total, p_value, dof_total = _pd_result(table, lam, len(Z))
    if boolean:
        return p_value >= significance_level
    return stat_total, p_value, dof_total


def power_divergence_batch(triples, data=None, lambda_="cressie-read", coded=None):
    """Evaluate MANY discrete CI tests from ONE count launch.

    ``triples`` is a list of (X, Y, Z) with Z an iterable of conditioning
    variables.  The distinct (X, [Y] + Z) specs go to one
    ``multi_counts_padded`` call (one ``table_counts`` launch, none for an
    empty list; the call does not deduplicate, so this function does), then
    the Cressie-Read statistic is evaluated on the host in float64 exactly as
    the per-test path does: the results equal ``power_divergence`` per
    triple.  ``coded`` is the ``_CodedData`` to count from (an estimator's
    own); without it the frame's cached copy on ``config.DEVICE`` is used.

    Returns a list of (stat, p_value, dof) tuples aligned with ``triples``.
    """
    if coded is None:
        if data is None:
            raise ValueError("power_divergence_batch needs data or coded")
        coded = _frame_coded(data)
    lam = _LAMBDA_BY_NAME.get(lambda_, lambda_)
    if not isinstance(lam, float):
        lam = float(lam)

    specs = [(X, tuple([Y] + list(Z))) for X, Y, Z in triples]
    uniq_index, order = {}, []
    for s in specs:
        if s not in uniq_index:
            uniq_index[s] = len(order)
            order.append(s)
    tables = coded.multi_counts_padded(order, dtype=np.float64)

    results = []
    for (X, Y, Z), s in zip(triples, specs):
        tensor = tables[uniq_index[s]].reshape(coded.cards[X], coded.cards[Y], -1)
        results.append(_pd_result(tensor, lam, len(list(Z))))
    return results


# CI tests whose statistics the batched path can serve, mapped to their
# Cressie-Read lambda (None = caller-supplied via the lambda_ kwarg)
BATCHABLE_DISCRETE_TESTS = {
    "chi_square": "pearson",
    "g_sq": "log-likelihood",
    "log_likelihood": "log-likelihood",
    "modified_log_likelihood": "mod-log-likelihood",
    "power_divergence": None,
}


def power_divergence(X, Y, Z, data, boolean=True, significance_level=0.05, lambda_="cressie-read", **kwargs):
    """Cressie-Read power-divergence family (lambda_ selects the member)."""
    return _power_divergence(X, Y, Z, data, boolean, significance_level, lambda_)


def chi_square(X, Y, Z, data, boolean=True, significance_level=0.05, **kwargs):
    return _power_divergence(X, Y, Z, data, boolean, significance_level, "pearson")


def g_sq(X, Y, Z, data, boolean=True, significance_level=0.05, **kwargs):
    return _power_divergence(
        X, Y, Z, data, boolean, significance_level, "log-likelihood"
    )


def log_likelihood(X, Y, Z, data, boolean=True, significance_level=0.05, **kwargs):
    return g_sq(X, Y, Z, data, boolean=boolean, significance_level=significance_level)


def modified_log_likelihood(X, Y, Z, data, boolean=True, significance_level=0.05, **kwargs):
    return _power_divergence(
        X, Y, Z, data, boolean, significance_level, "mod-log-likelihood"
    )


# --------------------------------------------------------------------------
# Residual-based tests (continuous / mixed data)
# --------------------------------------------------------------------------


def _is_categorical(col):
    """Categorical for CI purposes: category/object/string/bool dtypes.
    (The reference keys on dtype == 'category' only, which crashes its
    regressors on the string-state frames ``simulate`` returns.)"""
    return (
        isinstance(col.dtype, pd.CategoricalDtype)
        or pd.api.types.is_bool_dtype(col)
        or not pd.api.types.is_numeric_dtype(col)
    )


def _as_float_column(col):
    """Numeric passthrough; categorical columns become integer codes —
    never float-coerce state strings."""
    if _is_categorical(col):
        codes, _ = pd.factorize(col, sort=True)
        return codes.astype(np.float64)
    return col.to_numpy(dtype=np.float64)


def _residualize(target, Z, data, intercept=True):
    """Least-squares residuals of ``target`` on Z, host float64.  These
    regressions are tiny and sit inside host search loops, and f32 would
    cost ~7 digits of test-statistic parity.  Categorical columns are integer-coded (the reference
    float-coerces and crashes on strings)."""
    y = _as_float_column(data[target])
    if not Z:
        return y - y.mean() if intercept else y
    cols = [_as_float_column(data[z]) for z in Z]
    if intercept:
        cols = [np.ones(len(y))] + cols
    X = np.column_stack(cols)
    beta, _, _, _ = np.linalg.lstsq(X, y, rcond=None)
    return y - X @ beta


def pearsonr(X, Y, Z, data, boolean=True, significance_level=0.05, **kwargs):
    """Partial correlation: Pearson r of the Z-residuals.

    Matches the reference numerics (``CITests.py:502-572``): the
    residualization has NO intercept column, and the p-value is scipy's
    plain two-sided Pearson test on the residuals (n-2 dof, not adjusted
    for |Z|)."""
    Z = list(Z)
    rx = _residualize(X, Z, data, intercept=False)
    ry = _residualize(Y, Z, data, intercept=False)
    r, p_value = stats.pearsonr(rx, ry)
    if boolean:
        return p_value >= significance_level
    return float(r), float(p_value)


def _feature_matrix(Z, data):
    """(n, |Z|) float matrix for the boosted regressors, with categorical
    columns integer-coded; returns the categorical feature indices so the
    trees treat them as unordered."""
    cols, cat_idx = [], []
    for j, z in enumerate(Z):
        col = data[z]
        if _is_categorical(col):
            codes, _ = pd.factorize(col, sort=True)
            cols.append(codes.astype(np.float64))
            cat_idx.append(j)
        else:
            cols.append(col.to_numpy(dtype=np.float64))
    if not cols:
        return np.zeros((data.shape[0], 0)), []
    return np.column_stack(cols), cat_idx


def _boosted_residuals(target, Z, data, seed=None, classifier_factory=None, regressor_factory=None):
    """Residual block for one variable after regressing on Z with
    gradient-boosted trees (reference ``CITests.py:574-637`` uses XGBoost;
    this environment has none, so sklearn HistGradientBoosting* is the
    default — same model family, native categorical splits).

    Categorical target: one-hot(X) - predict_proba(Z), last column dropped
    (multicollinearity, ref ``CITests.py:706-722``).  Continuous target:
    X - predict(Z), one column.
    """
    col = data[target]
    Zmat, cat_idx = _feature_matrix(Z, data)
    n = data.shape[0]
    constant_z = Zmat.shape[1] == 0 or bool(np.all(Zmat == Zmat[:1, :]))
    if _is_categorical(col):
        codes, categories = pd.factorize(col)
        k = len(categories)
        if k < 2:
            return np.zeros((n, 0))
        onehot = np.eye(k)[codes]
        if constant_z:
            # boosted trees on a constant feature predict the class priors
            proba = np.broadcast_to(onehot.mean(axis=0), (n, k))
        else:
            if classifier_factory is None:
                from sklearn.ensemble import HistGradientBoostingClassifier

                clf = HistGradientBoostingClassifier(
                    categorical_features=cat_idx or None, random_state=seed
                )
            else:
                clf = classifier_factory()
            clf.fit(Zmat, codes)
            proba = clf.predict_proba(Zmat)
            # classes_ are sorted codes 0..k-1 (all present after factorize),
            # so proba columns align with the one-hot columns
        return (onehot - proba)[:, :-1]
    y = col.to_numpy(dtype=np.float64)
    if constant_z:
        pred = np.full(n, y.mean())
    else:
        if regressor_factory is None:
            from sklearn.ensemble import HistGradientBoostingRegressor

            reg = HistGradientBoostingRegressor(
                categorical_features=cat_idx or None, random_state=seed
            )
        else:
            reg = regressor_factory()
        reg.fit(Zmat, y)
        pred = np.asarray(reg.predict(Zmat), dtype=np.float64)
    return (y - pred)[:, None]


def _canonical_corrs(res_x, res_y):
    """Canonical correlations of two residual blocks.

    The (p+q)^2 Gram cross-product and whiten-and-SVD run host-side in
    float64: the blocks are host arrays (they come out of the host
    regressions), the matrices are tiny, and f32 rounding would lose ~3
    digits of the test statistic (differential goldens v6 pin reference parity at
    1e-6 relative).  Equals the reference's per-component corrcoef of
    sklearn-CCA transforms (``CITests.py:730-737``) for full-rank blocks,
    and degrades gracefully (pinv tolerance) on rank-deficient ones.
    """
    A = res_x - res_x.mean(axis=0, keepdims=True)
    B = res_y - res_y.mean(axis=0, keepdims=True)
    p, q = A.shape[1], B.shape[1]
    if p == 0 or q == 0:
        return np.zeros(0)
    M = np.column_stack([A, B]).astype(np.float64, copy=False)
    G = M.T @ M
    Sxx, Sxy, Syy = G[:p, :p], G[:p, p:], G[p:, p:]

    def inv_sqrt(S):
        w, V = np.linalg.eigh(S)
        tol = max(w.max(), 0.0) * 1e-10 if w.size else 0.0
        w_is = np.where(w > tol, 1.0 / np.sqrt(np.where(w > tol, w, 1.0)), 0.0)
        return (V * w_is) @ V.T

    K = inv_sqrt(Sxx) @ Sxy @ inv_sqrt(Syy)
    s = np.linalg.svd(K, compute_uv=False)
    return np.clip(s, 0.0, 1.0)


def pillai_trace(X, Y, Z, data, boolean=True, significance_level=0.05, seed=None, **kwargs):
    """Mixed-data residualization CI test (Ankan & Textor, AAAI 2024).

    Pillai's trace of the canonical correlations between the boosted-tree
    Z-residuals of X and Y, with the Muller-Peterson (1984) F
    approximation for the p-value.  Works on any mix of categorical and
    continuous columns.  Parity: reference ``CITests.py:638-755``.
    """
    Z = list(Z)
    if not isinstance(data, pd.DataFrame):
        raise ValueError(
            f"Variable data. Expected type: pandas.DataFrame. Got type: {type(data)}"
        )
    factories = {
        "classifier_factory": kwargs.get("classifier_factory"),
        "regressor_factory": kwargs.get("regressor_factory"),
    }
    res_x = _boosted_residuals(X, Z, data, seed=seed, **factories)
    res_y = _boosted_residuals(Y, Z, data, seed=seed, **factories)
    p, q = res_x.shape[1], res_y.shape[1]
    if p == 0 or q == 0:
        # a single-state variable is independent of everything
        return True if boolean else (0.0, 1.0)
    cancor = _canonical_corrs(res_x, res_y)
    coef = float((cancor**2).sum())

    # Muller & Peterson (1984) F approximation (ref CITests.py:739-744)
    n = data.shape[0]
    s = min(p, q)
    df1 = p * q
    df2 = s * (n - 1 + s - p - q)
    denom = max(s - coef, 1e-12)
    f_stat = (coef / df1) * (df2 / denom)
    p_value = float(stats.f.sf(f_stat, df1, df2))
    if boolean:
        return p_value >= significance_level
    return coef, p_value


def gcm(X, Y, Z, data, boolean=True, significance_level=0.05, regressor=None, **kwargs):
    """Generalized covariance measure (Shah & Peters 2020) with linear (or
    user-provided sklearn-compatible) regressors."""
    Z = list(Z)
    if regressor is None:
        rx = _residualize(X, Z, data)
        ry = _residualize(Y, Z, data)
    else:
        import sklearn.base

        Zmat, _ = _feature_matrix(Z, data)
        if Zmat.size == 0:
            rx = _as_float_column(data[X])
            rx = rx - rx.mean()
            ry = _as_float_column(data[Y])
            ry = ry - ry.mean()
        else:
            x = _as_float_column(data[X])
            y = _as_float_column(data[Y])
            rx = x - sklearn.base.clone(regressor).fit(Zmat, x).predict(Zmat)
            ry = y - sklearn.base.clone(regressor).fit(Zmat, y).predict(Zmat)
    n = len(rx)
    prod = rx * ry
    test_stat = np.sqrt(n) * prod.mean() / max(prod.std(), 1e-12)
    p_value = float(2 * stats.norm.sf(abs(test_stat)))
    if boolean:
        return p_value >= significance_level
    return float(test_stat), p_value


def independence_match(X, Y, Z, independencies=None, **kwargs):
    """Oracle CI test against an Independencies object."""
    from pgmpy_tpu_torch.independencies import IndependenceAssertion

    if independencies is None:
        raise ValueError("independencies must be provided for independence_match")
    return IndependenceAssertion(X, Y, Z) in independencies
