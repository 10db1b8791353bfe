from pgmpy_tpu_torch.inference.base import Inference
from pgmpy_tpu_torch.inference.ve import (
    VariableElimination,
    WeightedMinFill,
    MinNeighbors,
    MinWeight,
    MinFill,
)
from pgmpy_tpu_torch.inference.bp import BeliefPropagation
from pgmpy_tpu_torch.inference.approx import ApproxInference
from pgmpy_tpu_torch.inference.dbn import DBNInference

__all__ = [
    "Inference", "VariableElimination", "WeightedMinFill", "MinNeighbors", "MinWeight",
    "MinFill", "BeliefPropagation", "ApproxInference", "DBNInference",
]


def __getattr__(name):
    # the JAX package resolves these lazily; so does the port
    if name == "BeliefPropagationWithMessagePassing":
        from pgmpy_tpu_torch.inference.fg_bp import BeliefPropagationWithMessagePassing

        return BeliefPropagationWithMessagePassing
    if name == "Mplp":
        from pgmpy_tpu_torch.inference.mplp import Mplp

        return Mplp
    if name == "CausalInference":
        from pgmpy_tpu_torch.inference.causal import CausalInference

        return CausalInference
    if name == "LinearEstimator":
        from pgmpy_tpu_torch.inference.linear_model import LinearEstimator

        return LinearEstimator
    raise AttributeError(name)
