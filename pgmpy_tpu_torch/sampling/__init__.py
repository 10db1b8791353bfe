from pgmpy_tpu_torch.sampling.core import CompiledAncestralSampler
from pgmpy_tpu_torch.sampling.forward import BayesianModelSampling
from pgmpy_tpu_torch.sampling.gibbs import GibbsSampling
from pgmpy_tpu_torch.sampling.checkpoint import save_sampler_state, load_sampler_state
from pgmpy_tpu_torch.sampling.hmc import (
    BaseGradLogPDF,
    BaseSimulateHamiltonianDynamics,
    GradLogPDFGaussian,
    HamiltonianMC,
    HamiltonianMCDA,
    LeapFrog,
    ModifiedEuler,
    NoUTurnSampler,
    NoUTurnSamplerDA,
)
from pgmpy_tpu_torch.sampling.nuts import VectorizedNUTS

# API-parity alias: the reference's BayesianModelInference base (CPT gather
# tables) corresponds to the compiled ancestral sampler here
BayesianModelInference = CompiledAncestralSampler

__all__ = [
    "CompiledAncestralSampler",
    "BayesianModelInference",
    "BayesianModelSampling",
    "GibbsSampling",
    "save_sampler_state",
    "load_sampler_state",
    "VectorizedNUTS",
    "HamiltonianMC",
    "HamiltonianMCDA",
    "NoUTurnSampler",
    "NoUTurnSamplerDA",
    "LeapFrog",
    "ModifiedEuler",
    "BaseGradLogPDF",
    "GradLogPDFGaussian",
    "BaseSimulateHamiltonianDynamics",
]
