from pgmpy_tpu_torch.ops.einsum import make_axis_map, sum_product, sum_product_planned
from pgmpy_tpu_torch.ops.bincount import (
    column_major_codes,
    table_counts,
    table_counts_reference,
    table_specs,
    weighted_bincount,
    weighted_bincount_reference,
)

__all__ = [
    "make_axis_map",
    "sum_product",
    "sum_product_planned",
    "column_major_codes",
    "table_counts",
    "table_counts_reference",
    "table_specs",
    "weighted_bincount",
    "weighted_bincount_reference",
]
