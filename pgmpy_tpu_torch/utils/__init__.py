from pgmpy_tpu_torch.utils.state_name import StateNameMixin
from pgmpy_tpu_torch.utils.utils import (
    get_example_model,
    get_dataset_type,
    preprocess_data,
    discretize,
    llm_pairwise_orient,
    manual_pairwise_orient,
)
from pgmpy_tpu_torch.utils.mathext import (
    State,
    cartesian,
    sample_discrete,
    sample_discrete_maps,
    powerset,
)
from pgmpy_tpu_torch.utils._safe_import import _safe_import, _check_soft_dependencies

__all__ = [
    "StateNameMixin",
    "get_example_model",
    "get_dataset_type",
    "preprocess_data",
    "discretize",
    "llm_pairwise_orient",
    "manual_pairwise_orient",
    "State",
    "cartesian",
    "sample_discrete",
    "sample_discrete_maps",
    "powerset",
]
