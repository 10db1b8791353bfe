from pgmpy_tpu_torch.factors.discrete import DiscreteFactor, State
from pgmpy_tpu_torch.factors.cpd import TabularCPD
from pgmpy_tpu_torch.factors.factor_ops import (
    factor_product,
    factor_sum_product,
    factor_divide,
)
from pgmpy_tpu_torch.factors.factor_dict import FactorDict
from pgmpy_tpu_torch.factors.factor_set import (
    FactorSet,
    factorset_product,
    factorset_divide,
)
from pgmpy_tpu_torch.factors.jpd import JointProbabilityDistribution
from pgmpy_tpu_torch.factors.continuous import LinearGaussianCPD
from pgmpy_tpu_torch.factors.noisy_or import NoisyORCPD
from pgmpy_tpu_torch.factors.hybrid import (
    FunctionalCPD,
    clear_param_store,
    get_param_store,
    param,
)

__all__ = [
    "DiscreteFactor",
    "State",
    "TabularCPD",
    "factor_product",
    "factor_sum_product",
    "factor_divide",
    "FactorDict",
    "FactorSet",
    "factorset_product",
    "factorset_divide",
    "JointProbabilityDistribution",
    "LinearGaussianCPD",
    "NoisyORCPD",
    "FunctionalCPD",
    "param",
    "get_param_store",
    "clear_param_store",
]
