"""A numpy walk of the step tables that ``csrc/einsum_plan.cu`` reads (K3's
``plan_block`` / ``plan_step``, K10's ``filter_scan``): the only CPU check of
what the CUDA threads compute.

Each step row is read word by word as the kernel reads it: its inputs' slots
(an operand pointer, or an arena offset), the output slot, the merged output
and reduced extents (innermost first), each input's strides per label, and
the lanes and chunk each output entry is split into.  Every (output, lane)
sums its chunk of reduced entries, then the lanes are added.  The walk also
asserts what the kernels take for granted: lanes a power of two that divides
the block, the chunks covering every reduced entry, a step's output never
overlapping a live intermediate, and every intermediate read once after it
is written.  ``random_signature`` makes the seeded contractions both the
CPU and the card's tests run."""

import math

import numpy as np

from pgmpy_tpu_torch.ops import einsum as E


def flat(tensor):
    """The storage a tensor's data pointer and strides address, as float64."""
    if tensor.numel() == 0:
        return np.zeros(0)
    n = sum((s - 1) * st for s, st in zip(tensor.shape, tensor.stride())) + 1
    return tensor.as_strided((n,), (1,), tensor.storage_offset()).double().numpy()


def _digits(ext, count):
    if not len(ext):
        return np.zeros((count, 0), dtype=np.int64)
    radix = np.cumprod([1] + [int(e) for e in ext[:-1]])
    return np.arange(count)[:, None] // radix[None, :] % np.asarray(ext, dtype=np.int64)[None, :]


def walk_steps(rows, operands, arena, out, threads, base=0, live=None):
    """Run table ``rows`` over ``operands`` (flat arrays by pointer index),
    the float64 ``arena`` (intermediates from offset ``base`` up) and the flat
    ``out``; ``live`` tracks the intermediates written and not yet read."""
    h, L = len(E.HEADER), E.MAX_LABELS
    live = {} if live is None else live
    for row in rows:
        n_in, in0, in1, oslot, n_out, n_red, oc, rc, lanes, chunk = (int(x) for x in row[:h])
        assert lanes & (lanes - 1) == 0 and lanes <= threads and threads % lanes == 0
        assert lanes * chunk >= rc
        assert n_out <= L and n_red <= L and n_in in (1, 2)
        ext_o, ext_r = row[h:h + n_out], row[h + L:h + L + n_red]
        assert oc == math.prod(int(e) for e in ext_o) and rc == math.prod(int(e) for e in ext_r)
        do, dr = _digits(ext_o, oc), _digits(ext_r, rc)
        prod = np.ones((oc, rc))
        for k, slot in enumerate((in0, in1)[:n_in]):
            s_o = row[h + (2 + 2 * k) * L:h + (2 + 2 * k) * L + n_out]
            s_r = row[h + (3 + 2 * k) * L:h + (3 + 2 * k) * L + n_red]
            offsets = (do @ s_o)[:, None] + (dr @ s_r)[None, :]
            if slot >= 0:
                source = operands[slot]
            else:
                offset = -1 - slot
                if offset >= base:  # an intermediate: read once, then dead
                    assert offset in live, f"step reads arena {offset}, never written or read"
                    del live[offset]
                source = arena[offset:]
            if offsets.size:
                prod = prod * source[offsets]
        padded = np.zeros((oc, lanes * chunk))
        padded[:, :rc] = prod
        result = padded.reshape(oc, lanes, chunk).sum(axis=2).sum(axis=1)
        if oslot < 0:
            out[:oc] = result
        else:
            if oslot >= base:
                for start, size in live.items():
                    assert oslot + max(oc, 1) <= start or start + size <= oslot, \
                        "a step's output overlaps a live intermediate"
                live[oslot] = max(oc, 1)
            arena[oslot:oslot + oc] = result
    return live


def walk_plan(table, arrays, out_shape):
    """A :class:`PlanTable` over torch ``arrays`` -> the contraction (float64)."""
    threads = E.BLOCK_THREADS if table.schedule == "plan_block" else E.STEP_THREADS
    arena = np.full(max(table.arena, 1), np.nan)
    out = np.full(math.prod(out_shape), np.nan)
    live = walk_steps(table.steps, [flat(a) for a in arrays], arena, out, threads)
    assert not live, "an intermediate was never read"
    if table.schedule == "plan_step":
        tasks = table.steps[:, 6] * table.steps[:, 8]
        assert (table.blocks >= 1).all() and (table.blocks <= E.MAX_STEP_BLOCKS).all()
        covered = table.blocks * E.STEP_THREADS >= tasks
        assert (covered | (table.blocks == E.MAX_STEP_BLOCKS)).all()
    return out.reshape(out_shape)


def walk_scan(program, alpha, trans, codes):
    """A :class:`ScanProgram` over ``alpha``, the transition tensors and the
    (slices, variables) codes -> the (slices, width) normalised marginals,
    as ``filter_scan`` computes them slice by slice."""
    arena = np.full(program.arena, np.nan)
    arena[:program.alpha_size] = alpha.contiguous().reshape(-1).double().numpy()
    operands = [flat(t) for t in trans]
    base = program.base
    out = np.full((codes.shape[0], program.width), np.nan)
    for t, row in enumerate(np.asarray(codes)):
        for offset, var, state in program.deltas:
            code = row[var]
            arena[offset] = 1.0 if code < 0 or code == state else 0.0
        live = walk_steps(program.steps, operands, arena, None, E.BLOCK_THREADS, base=base)
        assert not live
        for offset, entries, column, _ in program.results:
            m = arena[offset:offset + entries].copy()
            with np.errstate(invalid="ignore", divide="ignore"):
                m = m / m.sum()
            if column < 0:
                arena[:entries] = m
            else:
                out[t, column:column + entries] = m
    return out


def random_signature(seed, batch=False):
    """(operand labels, output labels, float64 arrays) of a random
    contraction: 1-12 operands over up to 8 labels of extent 1-4 (scalars
    among them), the labels spread out (not 0..n-1), the output a random
    ordered subset; with ``batch`` a label of extent 7 on some operands and
    first in the output."""
    rng = np.random.default_rng(seed)
    n_ops = int(rng.integers(1, 13))
    n_labels = int(rng.integers(1, 9))
    labels = [int(a) for a in rng.choice(50, n_labels, replace=False)]
    ext = {a: int(rng.integers(1, 5)) for a in labels}
    axes = []
    for _ in range(n_ops):
        k = min(int(rng.integers(0, 4)), n_labels)
        axes.append(tuple(int(a) for a in rng.choice(labels, k, replace=False)))
    present = list(dict.fromkeys(a for ax in axes for a in ax))
    out = tuple(int(a) for a in rng.permutation(present)[: int(rng.integers(0, len(present) + 1))])
    if batch:
        b = 51
        ext[b] = 7
        axes = [(b,) + ax if rng.random() < 0.5 or i == 0 else ax for i, ax in enumerate(axes)]
        out = (b,) + out
    arrays = [rng.random([ext[a] for a in ax]) + 0.1 for ax in axes]
    return axes, out, arrays
