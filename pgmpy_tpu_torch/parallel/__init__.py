"""Multi-device execution: sharded samplers and batched queries
(:mod:`~pgmpy_tpu_torch.parallel.mesh`), model-parallel junction-tree
calibration (:mod:`~pgmpy_tpu_torch.parallel.jt_mesh`) and process groups
(:mod:`~pgmpy_tpu_torch.parallel.distributed`).  Port of
``pgmpy_tpu/parallel``."""

from pgmpy_tpu_torch.parallel import distributed
from pgmpy_tpu_torch.parallel.mesh import (
    get_mesh,
    sharded_sample_marginals,
    sharded_gibbs_marginals,
    sharded_nuts_moments,
    sharded_query_batch,
)

__all__ = [
    "distributed",
    "get_mesh",
    "sharded_sample_marginals",
    "sharded_gibbs_marginals",
    "sharded_nuts_moments",
    "sharded_query_batch",
]
