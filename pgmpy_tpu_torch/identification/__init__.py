from pgmpy_tpu_torch.identification.base import BaseIdentification
from pgmpy_tpu_torch.identification.adjustment import Adjustment
from pgmpy_tpu_torch.identification.frontdoor import Frontdoor

__all__ = ["BaseIdentification", "Adjustment", "Frontdoor"]
