"""Interleaved-format einsum helpers: the device-side contraction core.

Port of ``pgmpy_tpu/ops/einsum.py``.  A host-side planner maps variable
names to integer axis labels; a contraction is given as operands aligned
with tuples of labels plus the output labels, and its ``opt_einsum`` path is
computed once per static (axes, shapes) signature and cached.

``torch.einsum`` differs from ``jnp.einsum`` in two ways that shape this
module: its sublist form rejects labels outside ``[0, 52)`` (a MUNIN covering
subtree has more variables than that), and it takes no contraction path.  So
the cached plan is executed one step at a time: each step is a two-operand
(or one-operand) ``torch.einsum`` whose labels are renumbered into
``[0, 52)``.  Float32 products run in full f32 (``config`` disables TF32).
"""

from functools import lru_cache

import numpy as np
import torch


def _relabel_einsum(pairs, out_axes):
    """``torch.einsum`` in sublist form over ``pairs`` of (tensor, labels),
    with the labels renumbered densely from 0."""
    dense = {}
    args = []
    for arr, axes in pairs:
        args.append(arr)
        args.append([dense.setdefault(a, len(dense)) for a in axes])
    args.append([dense[a] for a in out_axes])
    return torch.einsum(*args)


def _run_plan(operand_axes, out_axes, arrays, plan):
    """Execute a contraction plan (see :func:`contraction_plan`) one step at
    a time."""
    ops = [(arr, tuple(axes)) for arr, axes in zip(arrays, operand_axes)]
    for step, keep in plan:
        picked = [ops[i] for i in step]
        for i in sorted(step, reverse=True):
            del ops[i]
        ops.append((_relabel_einsum(picked, keep), keep))
    if len(ops) != 1:
        raise ValueError("contraction path did not reduce to one operand")
    return _relabel_einsum(ops, tuple(out_axes))


@lru_cache(maxsize=4096)
def contraction_plan(operand_axes, out_axes, shapes, optimize="greedy"):
    """The contraction plan of a static signature: opt_einsum's path (a list
    of operand-position tuples) with, for each step, the labels its result
    keeps.  A label is kept if the output or any operand not yet contracted
    still needs it.  Cached, so planning is paid once per signature."""
    import opt_einsum

    interleaved = []
    for axes, shape in zip(operand_axes, shapes):
        interleaved.append(np.empty(shape))
        interleaved.append(list(axes))
    interleaved.append(list(out_axes))
    path, _ = opt_einsum.contract_path(*interleaved, optimize=optimize)

    ops = [tuple(axes) for axes in operand_axes]
    # how many live operands still carry each label
    uses = {}
    for axes in ops:
        for a in set(axes):
            uses[a] = uses.get(a, 0) + 1
    out_set = set(out_axes)
    plan = []
    for step in path:
        picked = [ops[i] for i in step]
        for i in sorted(step, reverse=True):
            del ops[i]
        for axes in picked:
            for a in set(axes):
                uses[a] -= 1
        keep = []
        for axes in picked:
            for a in axes:
                if (a in out_set or uses[a] > 0) and a not in keep:
                    keep.append(a)
        keep = tuple(keep)
        for a in keep:
            uses[a] += 1
        ops.append(keep)
        plan.append((tuple(step), keep))
    return tuple(plan)


def largest_intermediate(operand_axes, out_axes, shapes, optimize="greedy"):
    """Elements of the largest tensor the planned contraction of this
    signature builds (its intermediates and its output).  Decided from the
    plan alone, before anything runs."""
    operand_axes = tuple(tuple(ax) for ax in operand_axes)
    shapes = tuple(tuple(int(d) for d in shape) for shape in shapes)
    size = {}
    for axes, shape in zip(operand_axes, shapes):
        size.update(zip(axes, shape))
    plan = contraction_plan(operand_axes, tuple(out_axes), shapes, optimize)
    results = [keep for _, keep in plan] + [tuple(out_axes)]
    return max(int(np.prod([size[a] for a in axes], dtype=np.float64)) for axes in results)


def sum_product_planned(operand_axes, out_axes, arrays, optimize="greedy"):
    """Contract ``arrays`` (aligned with ``operand_axes``, each a tuple of
    integer axis labels) down to ``out_axes`` along a contraction plan cached
    on (axes, shapes), so host-side planning is paid once per signature."""
    shapes = tuple(tuple(a.shape) for a in arrays)
    operand_axes = tuple(tuple(ax) for ax in operand_axes)
    plan = contraction_plan(operand_axes, tuple(out_axes), shapes, optimize)
    return _run_plan(operand_axes, tuple(out_axes), arrays, plan)


def sum_product(operand_axes, out_axes, *arrays, optimize="greedy"):
    """Contract ``arrays`` (aligned with ``operand_axes``) down to
    ``out_axes``."""
    return sum_product_planned(operand_axes, out_axes, arrays, optimize=optimize)


def make_axis_map(factor_scopes):
    """Map every variable appearing in ``factor_scopes`` to a unique integer
    axis label.  Returns (var_to_int dict, operand_axes list)."""
    var_to_int = {}
    operand_axes = []
    for scope in factor_scopes:
        axes = []
        for var in scope:
            if var not in var_to_int:
                var_to_int[var] = len(var_to_int)
            axes.append(var_to_int[var])
        operand_axes.append(tuple(axes))
    return var_to_int, operand_axes
