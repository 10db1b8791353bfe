from pgmpy_tpu_torch.estimators.base import (
    BaseEstimator,
    ParameterEstimator,
    StructureEstimator,
    MarginalEstimator,
)
from pgmpy_tpu_torch.estimators.mle import MaximumLikelihoodEstimator
from pgmpy_tpu_torch.estimators.bayes import BayesianEstimator
from pgmpy_tpu_torch.estimators.em import ExpectationMaximization
from pgmpy_tpu_torch.estimators.scores import (
    StructureScore,
    K2,
    BDeu,
    BDs,
    BIC,
    AIC,
    LogLikeliHood,
    LogLikelihoodGauss,
    BICGauss,
    AICGauss,
    LogLikelihoodCondGauss,
    BICCondGauss,
    AICCondGauss,
    K2Score,
    BDeuScore,
    BDsScore,
    BicScore,
    AicScore,
    ScoreCache,
    get_scoring_method,
)
from pgmpy_tpu_torch.estimators.citests import (
    power_divergence,
    chi_square,
    g_sq,
    log_likelihood,
    modified_log_likelihood,
    pearsonr,
    pillai_trace,
    gcm,
    independence_match,
    get_callable_ci_test,
)
from pgmpy_tpu_torch.estimators.constraint import BaseConstraintEstimator
from pgmpy_tpu_torch.estimators.pc import PC
from pgmpy_tpu_torch.estimators.hill_climb import HillClimbSearch
from pgmpy_tpu_torch.estimators.ges import GES
from pgmpy_tpu_torch.estimators.exhaustive import ExhaustiveSearch
from pgmpy_tpu_torch.estimators.tree_search import TreeSearch
from pgmpy_tpu_torch.estimators.mmhc import MmhcEstimator
from pgmpy_tpu_torch.estimators.expert_knowledge import ExpertKnowledge

__all__ = [
    "BaseEstimator", "ParameterEstimator", "StructureEstimator", "MarginalEstimator",
    "MaximumLikelihoodEstimator", "BayesianEstimator", "ExpectationMaximization",
    "StructureScore", "K2", "BDeu", "BDs", "BIC", "AIC", "LogLikeliHood",
    "LogLikelihoodGauss", "BICGauss", "AICGauss",
    "LogLikelihoodCondGauss", "BICCondGauss", "AICCondGauss",
    "K2Score", "BDeuScore", "BDsScore", "BicScore", "AicScore",
    "ScoreCache", "get_scoring_method",
    "power_divergence", "chi_square", "g_sq", "log_likelihood", "modified_log_likelihood",
    "pearsonr", "pillai_trace", "gcm", "independence_match", "get_callable_ci_test",
    "BaseConstraintEstimator", "PC", "HillClimbSearch", "GES",
    "ExhaustiveSearch", "TreeSearch", "MmhcEstimator", "ExpertKnowledge",
]


def __getattr__(name):
    # the JAX package resolves these lazily; so does the port
    if name == "MirrorDescentEstimator":
        from pgmpy_tpu_torch.estimators.mirror_descent import MirrorDescentEstimator

        return MirrorDescentEstimator
    if name == "ExpertInLoop":
        from pgmpy_tpu_torch.estimators.expert import ExpertInLoop

        return ExpertInLoop
    raise AttributeError(name)
