"""The Gibbs sweep (K6): every chain through one systematic-scan sweep of a
discrete Bayesian or Markov network.

Variable after variable in the scan order, each chain's local conditional
``log P(v | blanket)`` is the sum, over the variable's blanket factors in
order, of the factor's log-table row at the chain's current states (the
table stored with ``v``'s axis last, ``(rows, card)``), and the variable is
redrawn from it by the exponential race (``argmax_s(logit_s - log E_s)``,
``E ~ Exp(1)`` clamped at ``1e-20``).  A variable in no factor is drawn
uniform.

* On a CUDA tensor, the hand-written kernel of ``csrc/gibbs.cu`` (built with
  ``nvcc`` at first use): ONE launch per sweep, a block's chains in shared
  memory, up to ``GROUPS`` threads per chain (``ops.ancestral.sweep_groups``)
  drawing the variables of one level at a time (a level holds no two
  variables of one factor, so the sweep's draws are the sequential scan's),
  random bits from Philox keyed on one 64-bit draw per sweep from the call's
  generator.  A build or launch failure
  raises.
* On a CPU tensor, the plain version :func:`sweep_reference`: a few torch
  ops per (variable, blanket factor), its race noise drawn from the
  generator variable by variable (``utils/mathext.py:race_noise``).

Both take an explicit ``noise`` tensor in place of the generator: ``log E``
for every (state, chain), ``(sum of cards, n)``, variable ``i``'s states from
row ``noise_offsets[i]``.  On the same noise the kernel and the plain version
give the same codes, to the bit.

It replaces ``pgmpy_tpu/sampling/gibbs.py:120`` ``_conditional_logits``,
``:148`` ``_sweep`` and ``:160`` ``_run_chains``.  ``LAUNCHES`` counts the
kernel's launches; :func:`reset_launches` zeroes it.
"""

import ctypes

import numpy as np
import torch

from pgmpy_tpu_torch.config import config
from pgmpy_tpu_torch.ops._build import load_library
from pgmpy_tpu_torch.ops.ancestral import level_schedule, noise_offsets, sweep_groups
from pgmpy_tpu_torch.utils.mathext import race_noise

GROUPS = 32  # threads per chain at most: each draws its share of a level's variables
MAX_TILE_ROWS = 128  # chains a block at most (times the groups: at most 1024 threads)
SHARED_BUDGET = 48 * 1024  # a block's tile of codes stays within the default shared memory

LAUNCHES = 0


def reset_launches():
    global LAUNCHES
    LAUNCHES = 0


def conditional_logits(var_specs, cards, states, i):
    """log P(variable ``i`` = k | the rest) up to a constant, for EVERY chain:
    ``states`` (d, n) int64 -> (n, card), summed in the tables' type in the
    order of ``var_specs[i]`` (per blanket factor: table ``(rows, card)``,
    other variables' positions, their row strides)."""
    n = states.shape[1]
    total = None
    for table, other_idx, rstrides in var_specs[i]:
        if not other_idx:
            rows = table[0].expand(n, -1)
        else:
            row = None
            for j, s in zip(other_idx, rstrides):
                term = states[j] if s == 1 else states[j] * s
                row = term if row is None else row + term
            rows = table.index_select(0, row)
        total = rows if total is None else total + rows
    if total is None:  # a variable in no factor: uniform
        total = torch.zeros((n, cards[i]), dtype=config.DTYPE, device=states.device)
    return total


def blanket_levels(var_specs):
    """Each variable's level: one more than the highest level of its blanket
    neighbours earlier in the scan order (0 without one), and those earlier
    neighbours."""
    earlier = [sorted({j for _, others, _ in specs for j in others if j < i})
               for i, specs in enumerate(var_specs)]
    level = np.zeros(len(var_specs), dtype=np.int64)
    for i, nb in enumerate(earlier):
        level[i] = 1 + max((level[j] for j in nb), default=-1)
    return level, earlier


def plan_tile(d, code_bytes, groups):
    """(chains a block, codes a tile row, shared bytes) of a sweep over ``d``
    variables with ``groups`` threads per chain: each tile row padded to an
    odd number of 4-byte words (the lanes of a warp reading one column hit
    distinct banks), as many chains as ``SHARED_BUDGET`` allows, at most
    ``MAX_TILE_ROWS`` and ``1024 // groups``, in whole warps where it holds at
    least one."""
    row_bytes = -(-max(int(d), 1) * code_bytes // 4) * 4
    if (row_bytes // 4) % 2 == 0:
        row_bytes += 4
    rows = min(MAX_TILE_ROWS, 1024 // groups, SHARED_BUDGET // row_bytes)
    if rows < 1:
        raise ValueError(f"gibbs sweep: a chain of {d} codes of {code_bytes} bytes does not fit "
                         f"a block's {SHARED_BUDGET} bytes of shared memory")
    if rows >= 32:
        rows -= rows % 32
    return rows, row_bytes // code_bytes, rows * row_bytes


class GibbsTables:
    """The host side of a Gibbs sweep, CSR: per variable (card, noise offset,
    first blanket factor, factor count), per (variable, factor) (table
    offset, other count, first other), per other (column, row stride); the
    level schedule (:func:`blanket_levels`, dealt to ``groups`` groups,
    ``ops.ancestral.sweep_groups``, by each variable's states times its
    factors plus one) and, per card, the log
    tables concatenated into one flat tensor beside one uploaded int32 buffer
    of the rest.

    ``var_specs``: per variable in scan order, its blanket factors (table
    ``(rows, card)`` with the variable's axis last, other variables'
    positions, their row strides)."""

    def __init__(self, var_specs, cards, out_dtype):
        self.var_specs = var_specs
        self.cards = [int(c) for c in cards]
        self.out_dtype = out_dtype
        d = len(var_specs)
        specs = [s for per_var in var_specs for s in per_var]
        sizes = [int(t.numel()) for t, _, _ in specs]
        self.total = int(sum(sizes))
        self.noise_offsets = noise_offsets(self.cards) if d else np.zeros(0, dtype=np.int64)
        counts = [len(per_var) for per_var in var_specs]
        self.vars = np.zeros((d, 4), dtype=np.int64)
        self.vars[:, 0] = self.cards
        self.vars[:, 1] = self.noise_offsets
        self.vars[:, 2] = np.concatenate([[0], np.cumsum(counts)[:-1]]) if d else []
        self.vars[:, 3] = counts
        n_others = [len(others) for _, others, _ in specs]
        self.specs = np.zeros((len(specs), 3), dtype=np.int64)
        self.specs[:, 0] = np.concatenate([[0], np.cumsum(sizes)[:-1]]) if specs else []
        self.specs[:, 1] = n_others
        self.specs[:, 2] = np.concatenate([[0], np.cumsum(n_others)[:-1]]) if specs else []
        self.others = np.array([(j, s) for _, others, strides in specs
                                for j, s in zip(others, strides)], dtype=np.int64).reshape(-1, 2)
        self.vars, self.specs, self.others = (a.astype(np.int32) for a in
                                              (self.vars, self.specs, self.others))
        self.levels, earlier = blanket_levels(var_specs)
        self.groups = sweep_groups(d, int(self.levels.max()) + 1 if d else 1, GROUPS)
        loads = [c * (1 + k) for c, k in zip(self.cards, counts)]
        self.schedule, self.starts, self.n_levels = level_schedule(earlier, loads, self.groups)
        self.device = specs[0][0].device if specs else config.DEVICE
        self._device = {}

    def on(self, device):
        """(flat log tables, one int32 buffer of the variables, factors,
        others, schedule and its starts) on ``device``, made once per
        device."""
        entry = self._device.get(device)
        if entry is not None:
            torch.cuda.current_stream(device).wait_event(entry[2])
            return entry[:2]
        if self.total:
            tables = torch.cat([t.reshape(-1) for per_var in self.var_specs
                                for t, _, _ in per_var]).to(device)
        else:
            tables = torch.zeros(1, dtype=config.DTYPE, device=device)
        host = np.concatenate([self.vars.ravel(), self.specs.ravel(), self.others.ravel(),
                               self.schedule, self.starts]).astype(np.int32)
        plan = torch.from_numpy(host).pin_memory().to(device, non_blocking=True)
        uploaded = torch.cuda.Event()
        uploaded.record(torch.cuda.current_stream(device))
        self._device[device] = (tables, plan, uploaded)
        return tables, plan


def _library():
    lib = load_library("gibbs", ["gibbs.cu"])
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.pgmpy_gibbs_sweep.argtypes = [
        i64, i32, vp, vp, vp, vp, vp, i32, i32, vp, i32, vp, vp, vp, vp, i32, i32, i32, i64, i64,
        vp]
    lib.pgmpy_gibbs_sweep.restype = ctypes.c_int
    return lib


def _check(tables, codes, noise, out, dtype, device):
    d = len(tables.cards)
    if codes.dim() != 2 or codes.shape[1] != d or codes.device != device:
        raise ValueError(f"gibbs sweep: codes must be (n, {d}) on {device}, got "
                         f"{tuple(codes.shape)} on {codes.device}")
    n = codes.shape[0]
    if noise is not None:
        if noise.device != device or noise.dtype != dtype:
            raise TypeError(f"gibbs sweep: noise must be {dtype} on {device}, got "
                            f"{noise.dtype} on {noise.device}")
        if tuple(noise.shape) != (sum(tables.cards), n):
            raise ValueError(f"gibbs sweep: noise must be (sum of cards, n) = "
                             f"{(sum(tables.cards), n)}, got {tuple(noise.shape)}")
    if out is not None and (tuple(out.shape) != (n, d) or out.dtype != tables.out_dtype
                            or not out.is_contiguous() or out.device != device):
        raise ValueError(f"gibbs sweep: out must be a contiguous {tables.out_dtype} (n, d) = "
                         f"{(n, d)} on {device}")


def sweep_reference(tables, codes, gen, noise=None, out=None):
    """Plain version: one sweep of every chain on the tables' device, the
    variables in scan order; ``codes`` (n, d) integers -> (n, d) in
    ``tables.out_dtype`` (written into ``out`` when given, which may be
    ``codes``).  noise: ``log E`` per (state, chain) in place of draws from
    ``gen``."""
    dtype = tables.var_specs[0][0][0].dtype if tables.total else config.DTYPE
    _check(tables, codes, noise, out, dtype, tables.device)
    states = codes.to(torch.int64).T.contiguous()
    for i in range(len(tables.cards)):
        logits = conditional_logits(tables.var_specs, tables.cards, states, i)
        if noise is None:
            race = race_noise(logits.shape, gen, logits.dtype)
        else:
            first = int(tables.noise_offsets[i])
            race = noise[first: first + tables.cards[i]].t()
        states[i] = torch.argmax(logits - race, dim=-1)
    result = states.T.to(tables.out_dtype)
    if out is None:
        return result.contiguous()
    return out.copy_(result)


def sweep_cuda(tables, codes, gen, noise=None, out=None):
    """ONE launch of the sweep kernel on the current stream of the sampler's
    card; the arguments and result are those of :func:`sweep_reference`.
    Without ``noise`` the kernel's Philox key is one 64-bit draw from
    ``gen``."""
    global LAUNCHES
    if tables.total >= 2**31:
        raise ValueError(f"gibbs sweep: the log tables hold {tables.total} entries, beyond the "
                         "kernel's int32 index")
    device = tables.device
    if device.type != "cuda":
        raise ValueError("gibbs sweep_cuda: the sampler's log tables must be on a CUDA device")
    n, d = codes.shape[0], len(tables.cards)
    code_bytes = torch.empty((), dtype=tables.out_dtype).element_size()
    rows, stride, shared = plan_tile(d, code_bytes, tables.groups)
    with torch.cuda.device(device):
        flat, plan = tables.on(device)
        _check(tables, codes, noise, out, flat.dtype, device)
        codes = codes.to(tables.out_dtype).contiguous()
        if noise is not None:
            noise = noise.contiguous()
            key = None
        else:
            key = torch.randint(-2**63, 2**63 - 1, (1,), generator=gen, dtype=torch.int64,
                                device=device)
        if out is None:
            out = torch.empty((n, d), dtype=tables.out_dtype, device=device)
        if n == 0 or d == 0:
            return out
        ptr = plan.data_ptr()
        specs = ptr + 4 * tables.vars.size
        others = specs + 4 * tables.specs.size
        schedule = others + 4 * tables.others.size
        err = _library().pgmpy_gibbs_sweep(
            n, d, ptr, specs, others, schedule, schedule + 4 * tables.schedule.size,
            tables.n_levels, tables.groups, flat.data_ptr(), flat.element_size(),
            codes.data_ptr(), 0 if noise is None else noise.data_ptr(),
            0 if key is None else key.data_ptr(), out.data_ptr(), code_bytes, stride,
            rows * tables.groups, -(-n // rows), shared,
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gibbs sweep launch failed: cudaError_t {err}")
    LAUNCHES += 1
    return out


def sweep(tables, codes, gen, noise=None, out=None):
    """Dispatch on the sampler's log tables: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    device = tables.device
    if device.type == "cuda":
        return sweep_cuda(tables, codes, gen, noise, out)
    if device.type == "cpu":
        return sweep_reference(tables, codes, gen, noise, out)
    raise ValueError(f"gibbs sweep: unsupported device {device}")
