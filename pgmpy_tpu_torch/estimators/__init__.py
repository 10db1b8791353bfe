from pgmpy_tpu_torch.estimators.base import (
    BaseEstimator,
    ParameterEstimator,
    StructureEstimator,
    MarginalEstimator,
)
from pgmpy_tpu_torch.estimators.mle import MaximumLikelihoodEstimator
from pgmpy_tpu_torch.estimators.bayes import BayesianEstimator
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
from pgmpy_tpu_torch.estimators.hill_climb import HillClimbSearch
from pgmpy_tpu_torch.estimators.exhaustive import ExhaustiveSearch
from pgmpy_tpu_torch.estimators.tree_search import TreeSearch
from pgmpy_tpu_torch.estimators.expert_knowledge import ExpertKnowledge

__all__ = [
    "BaseEstimator", "ParameterEstimator", "StructureEstimator", "MarginalEstimator",
    "MaximumLikelihoodEstimator", "BayesianEstimator",
    "StructureScore", "K2", "BDeu", "BDs", "BIC", "AIC", "LogLikeliHood",
    "LogLikelihoodGauss", "BICGauss", "AICGauss",
    "LogLikelihoodCondGauss", "BICCondGauss", "AICCondGauss",
    "K2Score", "BDeuScore", "BDsScore", "BicScore", "AicScore",
    "ScoreCache", "get_scoring_method",
    "HillClimbSearch", "ExhaustiveSearch", "TreeSearch", "ExpertKnowledge",
]
