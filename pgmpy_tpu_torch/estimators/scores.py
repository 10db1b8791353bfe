"""Decomposable structure scores (K2/BDeu/BDs/LL/BIC/AIC + Gaussian
variants).

Port of ``pgmpy_tpu/estimators/scores.py``.  Only the count tables come from
the device (``_CodedData.multi_counts_padded``: one ``table_counts`` launch
for a whole spec list, int32 counts, widened to float64 on the host without
rounding).  Every score reduction is host code in float64 with
``scipy.special.gammaln``, expression for expression as in the JAX package:
greedy searches decide near-symmetric orientations on score differences of
1e-14, so the order of summation is part of the contract.  The Gaussian and
conditional-Gaussian scores are host numpy/scipy regressions.

Examples
--------
>>> import numpy as np
>>> import pandas as pd
>>> from pgmpy_tpu_torch.estimators import BIC, K2
>>> from pgmpy_tpu_torch.models import DiscreteBayesianNetwork
>>> rng = np.random.default_rng(0)
>>> a = rng.integers(0, 2, 200)
>>> b = np.where(rng.random(200) < 0.9, a, 1 - a)
>>> df = pd.DataFrame({"a": a, "b": b})
>>> dependent = DiscreteBayesianNetwork([("a", "b")])
>>> indep = DiscreteBayesianNetwork()
>>> indep.add_nodes_from(["a", "b"])
>>> bic = BIC(df)
>>> bool(bic.score(dependent) > bic.score(indep))  # dependence wins
True
>>> round(float(K2(df).local_score("a", [])), 1)
-139.9
"""

import numpy as np
import pandas as pd
from scipy.special import gammaln

from pgmpy_tpu_torch.estimators.base import StructureEstimator


def get_scoring_method(scoring_method, data, use_cache=True):
    scores = {
        "k2": K2,
        "bdeu": BDeu,
        "bds": BDs,
        "bic-d": BIC,
        "bic": BIC,
        "aic-d": AIC,
        "aic": AIC,
        "ll-d": LogLikeliHood,
        "ll-g": LogLikelihoodGauss,
        "bic-g": BICGauss,
        "aic-g": AICGauss,
        "ll-cg": LogLikelihoodCondGauss,
        "bic-cg": BICCondGauss,
        "aic-cg": AICCondGauss,
        "loglikelihood": LogLikeliHood,
    }
    if scoring_method is None:
        # reference semantics (StructureScore.py:67-69): pick the first
        # score for the data's variable type — BIC / BICGauss / BICCondGauss
        from pgmpy_tpu_torch.utils.utils import get_dataset_type

        scoring_method = {
            "discrete": "bic-d",
            "continuous": "bic-g",
            "mixed": "bic-cg",
        }[get_dataset_type(data)]
    if isinstance(scoring_method, str):
        key = scoring_method.lower()
        if key not in scores:
            raise ValueError(
                f"Unknown scoring method: {scoring_method}. Options: {sorted(scores)}"
            )
        scorer = scores[key](data)
    elif isinstance(scoring_method, StructureScore):
        scorer = scoring_method
    else:
        raise ValueError(
            "scoring_method should either be a string or an instance of StructureScore"
        )
    if use_cache:
        return scorer, ScoreCache(scorer, data)
    return scorer, scorer


class StructureScore(StructureEstimator):
    def __init__(self, data=None, **kwargs):
        super().__init__(data, **kwargs)

    def score(self, model):
        """Sum of local scores + structure prior."""
        score = 0
        for node in model.nodes():
            score += self.local_score(node, list(model.predecessors(node)))
        score += self.structure_prior(model)
        return score

    def structure_prior(self, model):
        return 0

    def structure_prior_ratio(self, operation):
        return 0

    def local_score(self, variable, parents):
        raise NotImplementedError

    def local_scores_batch(self, specs):
        """Local scores for many ``(variable, parents)`` specs.  Count-table
        scores override this to fetch ALL tables in one table-count launch
        and one readback (``_CodedData.multi_counts_padded``), so a search
        iteration does not pay a launch and a device-to-host copy per
        candidate (the reference parallelizes with joblib instead)."""
        return [self.local_score(var, list(parents)) for var, parents in specs]

    def prime(self, specs):
        """Hook for ScoreCache: precompute specs in one batch.  No-op on a
        bare scorer (nowhere to store the results)."""
        return None


class _CountScore(StructureScore):
    """Discrete scores that are pure functions of the (child, parents)
    count table: the table comes off the count kernel as exact integers, the
    lgamma/log reduction runs host-side in float64 (reference-parity
    digits)."""

    def _score_from_counts(self, counts):
        raise NotImplementedError

    def local_score(self, variable, parents):
        counts = self._coded.counts(variable, list(parents), dtype=np.float64)
        return self._score_from_counts(counts)

    def local_scores_batch(self, specs):
        tables = self._coded.multi_counts_padded(
            [(var, tuple(parents)) for var, parents in specs], dtype=np.float64
        )
        return [self._score_from_counts(t) for t in tables]


class K2(_CountScore):
    def _score_from_counts(self, counts):
        var_card = counts.shape[0]
        counts_with_alpha = counts + 1.0
        col_sums = counts_with_alpha.sum(axis=0)
        # Parity quirk (ref StructureScore.py:346-380): the reference drops
        # all-zero parent configurations from the conditional term
        # (reindex=False, zero-column adjustment commented out there) but
        # still adds lgamma(r) for EVERY parent configuration — so an
        # unobserved configuration nets +lgamma(r) instead of 0.
        observed = counts.sum(axis=0) > 0
        score = float(
            np.sum(gammaln(counts_with_alpha))
            - np.sum(gammaln(col_sums[observed]))
        )
        score += counts.shape[1] * float(gammaln(var_card))
        return score


class BDeu(_CountScore):
    def __init__(self, data=None, equivalent_sample_size=10, **kwargs):
        self.equivalent_sample_size = equivalent_sample_size
        super().__init__(data, **kwargs)

    def _score_from_counts(self, counts):
        # Mirrors the reference's expression tree exactly
        # (StructureScore.py BDeu.local_score): greedy searches decide
        # near-symmetric orientations on ~1e-14 score differences, so the
        # summation must be restricted to OBSERVED parent configurations
        # with closed-form adjustments for the dropped zero columns —
        # otherwise HillClimb/MMHC trajectories diverge from the reference.
        from math import lgamma

        var_card, n_configs = counts.shape
        col_sums = np.sum(counts, axis=0, dtype=float)
        observed = counts[:, col_sums > 0]
        m = observed.shape[1]
        alpha = self.equivalent_sample_size / n_configs
        beta = self.equivalent_sample_size / counts.size
        log_gamma_counts = gammaln(observed + beta)
        log_gamma_conds = gammaln(np.sum(observed, axis=0, dtype=float) + alpha)
        gamma_counts_adj = (n_configs - m) * var_card * gammaln(beta)
        gamma_conds_adj = (n_configs - m) * gammaln(alpha)
        score = (
            (np.sum(log_gamma_counts) + gamma_counts_adj)
            - (np.sum(log_gamma_conds) + gamma_conds_adj)
            + n_configs * lgamma(alpha)
            - counts.size * lgamma(beta)
        )
        return float(score)


class BDs(BDeu):
    """BDeu with prior spread only over *observed* parent configurations."""

    def structure_prior_ratio(self, operation):
        # marginal uniform prior: each arc present with probability 1/4,
        # absent with 1/2 (reference BDs.structure_prior_ratio)
        if operation == "+":
            return -np.log(2.0)
        if operation == "-":
            return np.log(2.0)
        return 0

    def structure_prior(self, model):
        nedges = float(len(model.edges()))
        nnodes = float(len(model.nodes()))
        possible_edges = nnodes * (nnodes - 1) / 2.0
        return -(nedges + possible_edges) * np.log(2.0)

    def _score_from_counts(self, counts):
        # Reference expression tree (StructureScore.py BDs.local_score):
        # the sparse-Dirichlet alpha spreads ESS over OBSERVED parent
        # configurations, but beta and the prior-normalization terms still
        # use the FULL table size, and the dropped zero columns keep their
        # closed-form gammaln contributions.
        from math import lgamma

        var_card, n_configs = counts.shape
        col_sums = np.sum(counts, axis=0, dtype=float)
        observed = counts[:, col_sums > 0]
        m = observed.shape[1]
        if m == 0:
            m = 1
            observed = counts[:, :1]
        alpha = self.equivalent_sample_size / m
        beta = self.equivalent_sample_size / counts.size
        log_gamma_counts = gammaln(observed + beta)
        log_gamma_conds = gammaln(np.sum(observed, axis=0, dtype=float) + alpha)
        gamma_counts_adj = (n_configs - m) * var_card * gammaln(beta)
        gamma_conds_adj = (n_configs - m) * gammaln(alpha)
        score = (
            (np.sum(log_gamma_counts) + gamma_counts_adj)
            - (np.sum(log_gamma_conds) + gamma_conds_adj)
            + m * lgamma(alpha)
            - counts.size * lgamma(beta)
        )
        return float(score)


class LogLikeliHood(_CountScore):
    def _score_from_counts(self, counts):
        col_sums = counts.sum(axis=0, keepdims=True)
        with np.errstate(divide="ignore", invalid="ignore"):
            log_ratio = np.where(
                counts > 0, np.log(counts) - np.log(col_sums), 0.0
            )
        return float(np.sum(counts * log_ratio))


class BIC(LogLikeliHood):
    def _score_from_counts(self, counts):
        sample_size = counts.sum()
        var_card, n_configs = counts.shape
        ll = LogLikeliHood._score_from_counts(self, counts)
        num_params = n_configs * (var_card - 1)
        return ll - 0.5 * np.log(max(sample_size, 1)) * num_params


class AIC(LogLikeliHood):
    def _score_from_counts(self, counts):
        var_card, n_configs = counts.shape
        ll = LogLikeliHood._score_from_counts(self, counts)
        num_params = n_configs * (var_card - 1)
        return ll - num_params


# deprecated alias used by the reference
BicScore = BIC
AicScore = AIC
K2Score = K2
BDeuScore = BDeu
BDsScore = BDs


class _GaussBase(StructureScore):
    """Gaussian local scores from linear-regression residuals.

    Numerics match the reference's ``smf.glm(...).fit()`` Gaussian GLM
    (``StructureScore.py:960-1001``): the log-likelihood is evaluated at
    the dispersion estimate ``scale = RSS / df_resid`` (not the MLE
    ``RSS / n``), and ``df_model`` is the regressor count excluding the
    intercept.  The regressions are tiny and sit inside host-side search
    loops, so they run on host numpy: a launch per operation would
    dominate by orders of magnitude.
    """

    def _residual_ll(self, variable, parents):
        y = self.data[variable].to_numpy(dtype=np.float64)
        n = y.shape[0]
        X = np.column_stack(
            [np.ones(n)]
            + [self.data[p].to_numpy(dtype=np.float64) for p in parents]
        )
        beta, _, rank, _ = np.linalg.lstsq(X, y, rcond=None)
        resid = y - X @ beta
        ssr = float(resid @ resid)
        df_resid = n - rank
        if df_resid <= 0 or ssr <= 0:
            return np.inf, int(rank - 1), n
        scale = ssr / df_resid
        ll = -0.5 * (ssr / scale + n * np.log(2 * np.pi * scale))
        return ll, int(rank - 1), n


class LogLikelihoodGauss(_GaussBase):
    def local_score(self, variable, parents):
        ll, _, _ = self._residual_ll(variable, list(parents))
        return ll


class BICGauss(_GaussBase):
    def local_score(self, variable, parents):
        # df_model + 2: coefficients excl. intercept, plus intercept and
        # the variance parameter (reference StructureScore.py:1108-1113)
        ll, df_model, n = self._residual_ll(variable, list(parents))
        return ll - 0.5 * (df_model + 2) * np.log(max(n, 1))


class AICGauss(_GaussBase):
    def local_score(self, variable, parents):
        ll, df_model, _ = self._residual_ll(variable, list(parents))
        return ll - (df_model + 2)


def _infer_column_kinds(df):
    """Column kind map with the reference's ``preprocess_data`` semantics
    (``utils/utils.py:407-452``): numeric (incl. integer) columns are 'N',
    unordered categoricals/objects 'C', ordered categoricals 'O'."""
    kinds = {}
    for col in df.columns:
        s = df[col]
        if pd.api.types.is_numeric_dtype(s):
            kinds[col] = "N"
        elif isinstance(s.dtype, pd.CategoricalDtype):
            kinds[col] = "O" if s.dtype.ordered else "C"
        else:
            kinds[col] = "C"
    return kinds


class _CondGaussBase(StructureScore):
    """Conditional-Gaussian local scores for MIXED data — the CG score of
    Andrews, Ramsey & Cooper (2018), matching the reference numerics
    (``StructureScore.py:1192-1737``): density ratios of (possibly
    singular) multivariate normals fitted per discrete-parent
    configuration from pandas sample covariances, with the identity
    covariance substituted when a configuration has fewer rows than
    columns.  These are tiny host regressions inside search loops, so
    they run on host numpy/scipy.
    """

    @property
    def _kinds(self):
        if not hasattr(self, "_kinds_cache"):
            self._kinds_cache = _infer_column_kinds(self.data)
        return self._kinds_cache

    @staticmethod
    def _safe_cov(df):
        # identity when the configuration cannot support a covariance
        # estimate; tiny global jitter when near-singular (reference
        # `_adjusted_cov`, StructureScore.py:1243-1284)
        if df.shape[0] == 1 or df.shape[0] < df.shape[1]:
            return pd.DataFrame(
                np.eye(df.shape[1]), index=df.columns, columns=df.columns
            )
        cov = df.cov()
        if np.any(np.isclose(np.linalg.eig(cov)[0], 0)):
            cov = cov + 1e-6
        return cov

    @staticmethod
    def _mvn_pdf(x_rows, fit_rows):
        from scipy.stats import multivariate_normal

        return multivariate_normal.pdf(
            x=x_rows,
            mean=fit_rows.mean(axis=0),
            cov=_CondGaussBase._safe_cov(fit_rows),
            allow_singular=True,
        )

    def _ll_continuous(self, variable, parents):
        df = self.data.loc[:, [variable] + parents]
        cont = [p for p in parents if self._kinds[p] == "N"]
        disc = list(set(parents) - set(cont))
        if not disc:
            joint = self._mvn_pdf(df, df)
            if not cont:
                return float(np.sum(np.log(joint)))
            denom = np.maximum(1e-8, self._mvn_pdf(df.loc[:, cont], df.loc[:, cont]))
            return float(np.sum(np.log(joint / denom)))
        total = 0.0
        for _, grp in df.groupby(disc, observed=True):
            cols = [variable] + cont
            joint = self._mvn_pdf(grp.loc[:, cols], grp.loc[:, cols])
            if cont:
                denom = np.maximum(
                    1e-8, self._mvn_pdf(grp.loc[:, cont], grp.loc[:, cont])
                )
            else:
                denom = 1.0
            total += float(np.sum(np.log(joint / denom)))
        return total

    def _ll_discrete(self, variable, parents):
        df = self.data.loc[:, [variable] + parents]
        cont = [p for p in parents if self._kinds[p] == "N"]
        disc = list(set(parents) - set(cont))
        n = df.shape[0]
        total = 0.0
        for key, grp in df.groupby([variable] + disc, observed=True):
            # P(D1=d1, D2=d2): the group's empirical mass, one entry PER ROW
            # so the log-sum runs over rows even when there are no
            # continuous parents to supply a density vector
            p_joint = np.full(grp.shape[0], grp.shape[0] / n)
            num = self._mvn_pdf(grp.loc[:, cont], grp.loc[:, cont]) if cont else 1.0
            if not disc:
                denom_c = (
                    np.maximum(1e-8, self._mvn_pdf(grp.loc[:, cont], df.loc[:, cont]))
                    if cont
                    else 1.0
                )
                total += float(np.sum(np.log(num * p_joint / denom_c)))
            else:
                states = key[1:] if isinstance(key, tuple) else ()
                sub = df
                for var, st in zip(disc, states):
                    sub = sub.loc[sub[var] == st]
                denom_c = (
                    np.maximum(1e-8, self._mvn_pdf(grp.loc[:, cont], sub.loc[:, cont]))
                    if cont
                    else 1.0
                )
                p_d2 = sub.shape[0] / n
                total += float(np.sum(np.log(num * p_joint / (denom_c * p_d2))))
        return total

    def _cg_log_likelihood(self, variable, parents):
        parents = list(parents)
        if self._kinds[variable] == "N":
            return self._ll_continuous(variable, parents)
        return self._ll_discrete(variable, parents)

    def _num_parameters(self, variable, parents):
        # reference `_get_num_parameters` (StructureScore.py:1318-1365)
        kinds = self._kinds
        n_cont = sum(1 for p in parents if kinds[p] == "N")
        k_disc = 1
        for p in parents:
            if kinds[p] != "N":
                n_states = self.data[p].nunique()
                if n_states > 1:
                    k_disc *= n_states
        if kinds[variable] == "N":
            return k_disc * (n_cont + 2)
        card = self.data[variable].nunique()
        if n_cont == 0:
            return k_disc * (card - 1)
        return k_disc * (card - 1) * (n_cont + 2)


class LogLikelihoodCondGauss(_CondGaussBase):
    def local_score(self, variable, parents):
        return self._cg_log_likelihood(variable, list(parents))


class BICCondGauss(_CondGaussBase):
    def local_score(self, variable, parents):
        parents = list(parents)
        ll = self._cg_log_likelihood(variable, parents)
        k = self._num_parameters(variable, parents)
        return ll - 0.5 * k * np.log(self.data.shape[0])


class AICCondGauss(_CondGaussBase):
    def local_score(self, variable, parents):
        parents = list(parents)
        ll = self._cg_log_likelihood(variable, parents)
        return ll - self._num_parameters(variable, parents)


class ScoreCache(StructureScore):
    """LRU cache over (variable, parents) local scores
    (reference: ``estimators/ScoreCache.py:18-124``)."""

    def __init__(self, base_scorer, data, max_size=10000, **kwargs):
        if not isinstance(base_scorer, StructureScore):
            raise TypeError("base_scorer must be an instance of StructureScore")
        from pgmpy_tpu_torch.utils.cache import LRUDict

        self.base_scorer = base_scorer
        self.max_size = max_size
        self._cache = LRUDict(max_size=max_size)
        super().__init__(data, **kwargs)

    def local_score(self, variable, parents):
        key = (variable, tuple(sorted(parents, key=str)))
        if key in self._cache:
            # true LRU: a hit refreshes recency (ref ScoreCache.py:18-124)
            return self._cache[key]
        score = self.base_scorer.local_score(variable, list(parents))
        self._cache[key] = score
        return score

    def prime(self, specs):
        """Batch-compute all UNCACHED ``(variable, parents)`` specs in one
        table-count launch and warm the cache.  Every local score is
        invariant to parent order (the table reduction sums all cells), so
        deduplication on the sorted cache key is exact.  Search loops call
        this once per iteration so the subsequent per-candidate
        ``local_score`` calls are all cache hits."""
        needed, keys = [], []
        seen = set()
        for variable, parents in specs:
            key = (variable, tuple(sorted(parents, key=str)))
            if key in self._cache or key in seen:
                continue
            seen.add(key)
            keys.append(key)
            needed.append((variable, list(parents)))
        if needed:
            # a prime batch larger than the LRU capacity would evict its
            # own earliest entries before the per-candidate local_score
            # loop reads them — silently reverting to one count launch
            # per candidate (the exact pathology batching exists to
            # remove).  Grow the cache so every primed entry survives the
            # consuming iteration.
            if len(needed) + len(self._cache) > self.max_size:
                self.max_size = 2 * (len(needed) + len(self._cache))
                self._cache.max_size = self.max_size
            for key, score in zip(
                keys, self.base_scorer.local_scores_batch(needed)
            ):
                self._cache[key] = score

    def structure_prior(self, model):
        return self.base_scorer.structure_prior(model)

    def structure_prior_ratio(self, operation):
        return self.base_scorer.structure_prior_ratio(operation)
