from pgmpy_tpu_torch.sampling.core import CompiledAncestralSampler
from pgmpy_tpu_torch.sampling.forward import BayesianModelSampling

# API-parity alias: the reference's BayesianModelInference base (CPT gather
# tables) corresponds to the compiled ancestral sampler here
BayesianModelInference = CompiledAncestralSampler

__all__ = [
    "CompiledAncestralSampler",
    "BayesianModelInference",
    "BayesianModelSampling",
]
