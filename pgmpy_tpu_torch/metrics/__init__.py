from pgmpy_tpu_torch.metrics.metrics import (
    correlation_score,
    log_likelihood_score,
    structure_score,
    implied_cis,
    fisher_c,
    SHD,
    get_metrics,
)
from pgmpy_tpu_torch.metrics.bn_inference import BayesianModelProbability

__all__ = [
    "correlation_score",
    "log_likelihood_score",
    "structure_score",
    "implied_cis",
    "fisher_c",
    "SHD",
    "get_metrics",
    "BayesianModelProbability",
]
