"""Model-quality metrics.

Port of ``pgmpy_tpu/metrics/metrics.py``; host code.  ``log_likelihood_score``
runs ``BayesianModelProbability`` on ``config.DEVICE``, the CI-test and score
metrics run the port's count kernel; ``correlation_score`` imports
``sklearn`` when it is called, nothing else here needs it.

Examples
--------
>>> from pgmpy_tpu_torch.base import DAG
>>> from pgmpy_tpu_torch.metrics import SHD
>>> SHD(DAG([("a", "b"), ("b", "c")]), DAG([("a", "b"), ("c", "b")]))
1
>>> import numpy as np
>>> import pandas as pd
>>> from pgmpy_tpu_torch.metrics import structure_score
>>> from pgmpy_tpu_torch.models import DiscreteBayesianNetwork
>>> rng = np.random.default_rng(0)
>>> a = rng.integers(0, 2, 200)
>>> df = pd.DataFrame({"a": a,
...                    "b": np.where(rng.random(200) < 0.9, a, 1 - a)})
>>> empty = DiscreteBayesianNetwork()
>>> empty.add_nodes_from(["a", "b"])
>>> bool(structure_score(DiscreteBayesianNetwork([("a", "b")]), df,
...                      scoring_method="bic-d")
...      > structure_score(empty, df, scoring_method="bic-d"))
True
"""

import itertools

import numpy as np
import pandas as pd
from scipy import stats


def correlation_score(
    model,
    data,
    test="chi_square",
    significance_level=0.05,
    score=None,
    return_summary=False,
):
    """Agreement between model-implied d-separations and CI tests on data,
    summarized by a sklearn-style classification metric."""
    from sklearn.metrics import f1_score

    from pgmpy_tpu_torch.estimators.citests import get_callable_ci_test
    from pgmpy_tpu_torch.models.discrete_bn import DiscreteBayesianNetwork

    from pgmpy_tpu_torch.base.dag import DAG

    if score is None:
        score = f1_score
    test_fn = get_callable_ci_test(test)
    if not isinstance(model, DAG):
        raise ValueError(
            f"model must be a DAG or DiscreteBayesianNetwork. Got {type(model)}"
        )
    if set(model.nodes()) != set(data.columns):
        raise ValueError("Missing columns in data. Can't be used for testing.")

    # reference semantics (ref metrics.py:140-162): truth = the marginal CI
    # test's independence verdict, prediction = d-SEPARATION in the model;
    # absence of correlation/d-connection is the positive class
    results = []
    for i, j in itertools.combinations(model.nodes(), 2):
        test_result = test_fn(
            i, j, [], data, boolean=True, significance_level=significance_level
        )
        d_separated = not model.is_dconnected(i, j)
        results.append(
            {"var1": i, "var2": j, "stat_test": test_result,
             "d_connected": d_separated}
        )
    results = pd.DataFrame(results)
    metric = float(
        score(
            y_true=results["stat_test"].to_numpy(),
            y_pred=results["d_connected"].to_numpy(),
        )
    )
    if return_summary:
        return results
    return metric


def log_likelihood_score(model, data):
    """Total log-likelihood of ``data`` under the fitted model."""
    from pgmpy_tpu_torch.metrics.bn_inference import BayesianModelProbability

    model.check_model()
    return BayesianModelProbability(model).score(data)


def structure_score(model, data, scoring_method="bic-g", **kwargs):
    """Structure score (k2/bdeu/bds/bic-d/aic-d/ll-g/bic-g/...) of model
    given data.  Default scoring_method matches the reference's
    (``metrics.py:222``: "bic-g")."""
    from pgmpy_tpu_torch.estimators.scores import get_scoring_method

    scorer, _ = get_scoring_method(scoring_method, data, use_cache=False)
    return float(scorer.score(model))


def implied_cis(model, data, ci_test, show_progress=True):
    """One CI test per non-adjacent pair (u, v), conditioned on a minimal
    d-separator, as a DataFrame with columns [u, v, cond_vars, p-value]
    (ref metrics.py:310-375)."""
    from itertools import combinations

    from pgmpy_tpu_torch.estimators.citests import get_callable_ci_test

    test_fn = get_callable_ci_test(ci_test)
    rows = []
    for u, v in combinations(sorted(model.nodes(), key=str), 2):
        if model.has_edge(u, v) or model.has_edge(v, u):
            continue
        Z = model.minimal_dseparator(u, v)
        if Z is None:
            continue
        Z = sorted(Z, key=str)
        out = test_fn(u, v, Z, data, boolean=False)
        rows.append([u, v, Z, out[1]])
    return pd.DataFrame(rows, columns=["u", "v", "cond_vars", "p-value"])


def fisher_c(model, data, ci_test, compute_rmsea=False, show_progress=True):
    """Fisher's C global-fit p-value over the per-pair CIs conditioned on
    the union of the pair's parent sets (ref metrics.py:379-466).  Returns
    a float p-value, or (p_value, rmsea) when ``compute_rmsea``."""
    from itertools import combinations

    from pgmpy_tpu_torch.estimators.citests import get_callable_ci_test

    if model.latents:
        raise ValueError(
            "This test can not be performed on models with latent variables."
        )
    test_fn = get_callable_ci_test(ci_test)
    p_values = []
    for u, v in combinations(sorted(model.nodes(), key=str), 2):
        if model.has_edge(u, v) or model.has_edge(v, u):
            continue
        Z = set(model.predecessors(u)) | set(model.predecessors(v))
        out = test_fn(u, v, sorted(Z, key=str), data, boolean=False)
        p_values.append(out[1])
    p_values = np.clip(np.asarray(p_values, dtype=np.float64), 1e-6, None)
    # reference quirk (ref metrics.py:456-460): p-values of fully-degenerate
    # CI tests are NaN and pandas' .sum() silently skips them, while the
    # chi2 dof still counts every pair — mirror with nansum
    C = -2 * float(np.nansum(np.log(p_values)))
    p_value = float(1 - stats.chi2.cdf(C, df=2 * len(p_values)))
    if compute_rmsea:
        rmsea = np.nan
        if len(data) != 1 and len(p_values) != 0:
            rmsea = np.sqrt(
                max((C - 2 * len(p_values))
                    / (2 * len(p_values) * (len(data) - 1)), 0)
            )
        return (p_value, float(rmsea))
    return p_value


def SHD(true_model, est_model):
    """Structural Hamming distance between two DAGs: missing + extra +
    wrongly-oriented edges (orientation mistakes count once)."""
    true_edges = set(map(tuple, true_model.edges()))
    est_edges = set(map(tuple, est_model.edges()))
    if set(true_model.nodes()) != set(est_model.nodes()):
        raise ValueError("The graphs must have the same nodes.")
    true_skel = set(map(frozenset, true_edges))
    est_skel = set(map(frozenset, est_edges))
    missing = true_skel - est_skel
    extra = est_skel - true_skel
    common = true_skel & est_skel
    reversed_count = 0
    for e in common:
        u, v = tuple(e)
        if ((u, v) in true_edges) != ((u, v) in est_edges):
            reversed_count += 1
    return len(missing) + len(extra) + reversed_count


def get_metrics(metrics=None):
    available = {
        "correlation_score": correlation_score,
        "log_likelihood_score": log_likelihood_score,
        "structure_score": structure_score,
        "implied_cis": implied_cis,
        "fisher_c": fisher_c,
        "SHD": SHD,
    }
    if metrics is None:
        return available
    return {name: available[name] for name in metrics}
