from pgmpy_tpu_torch.inference.base import Inference
from pgmpy_tpu_torch.inference.ve import VariableElimination
from pgmpy_tpu_torch.inference.bp import BeliefPropagation
from pgmpy_tpu_torch.inference.approx import ApproxInference

__all__ = ["Inference", "VariableElimination", "BeliefPropagation", "ApproxInference"]
