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
