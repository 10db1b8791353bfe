"""The learning lane's count kernels: ``table_counts`` and ``weighted_bincount``.

Both are entry points of one hand-written CUDA source, ``csrc/bincount.cu``
(built with ``nvcc`` at first use):

* :func:`table_counts` builds every count table of a list of
  (variable, parents) specs in ONE launch, straight from the code matrix:
  ``out[offset_s + sum_j codes[col_sj, i] * stride_sj] += w_i`` for every row
  ``i`` of every spec ``s`` whose codes are all ``>= 0`` (-1 = missing).  The
  spec list is data (:class:`TableSpecs`, uploaded as one small descriptor
  tensor), so no flat-index or repeated-weight vector is ever materialised.
  It replaces ``pgmpy_tpu/estimators/base.py:_multi_counts_kernel`` and
  ``_padded_counts_kernel``.  Without weights the counts are ``int32``: exact
  and the same from run to run.
* :func:`weighted_bincount` is the TPU kernel's own contract
  (``pgmpy_tpu/ops/pallas_kernels.py:weighted_bincount``, the Pallas kernel
  ``_bincount_kernel``): ``out[b] = sum_i w_i * [idx_i == b]`` on a caller's
  own index vector, rows with ``idx < 0`` or ``idx >= length`` skipped.  There
  is no length cap: the TPU kernel's 1024 bins came from VMEM.

Each has a plain PyTorch version (``*_reference``: masking and
``index_add_``) and a dispatcher.  A CUDA tensor always goes to the kernel,
and a build or launch failure raises; a CPU tensor goes to the plain version.

``LAUNCHES`` counts the launches of ``weighted_bincount``'s kernel,
``TABLE_LAUNCHES`` those of ``table_counts``'s; :func:`reset_launches` zeroes
both.
"""

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from pgmpy_tpu_torch.ops._build import load_library

# Dynamic shared memory a block may use for its private histogram: the 48 KB a
# launch gets without opting in to more, less the kernel's 384 bytes of static
# arrays.  Longer histograms add straight into global memory.  Both entry
# points share it (PERF.md section 6 has the measurements).
SHARED_BUDGET_BYTES = 48 * 1024 - 512
_BLOCK = 256
# blocks wanted per launch, per multiprocessor
_BLOCKS_PER_SM = 4
# a thread reads 16 bytes of one code column per pass over its tile
_LOAD_BYTES = 16
# small tables are replicated up to this many shared-memory entries
_REPLICATED_ENTRIES = 4096
_MAX_REPLICATION_LOG2 = 5
_MAX_COLS = 32  # kMaxCols in bincount.cu
_HEADER = 6  # kHeader in bincount.cu
_ROW_ALIGN = 16  # rows per 16-byte load of int8 codes
_CODE_DTYPES = (torch.int8, torch.int16, torch.int32)

LAUNCHES = 0
TABLE_LAUNCHES = 0


def reset_launches():
    global LAUNCHES, TABLE_LAUNCHES
    LAUNCHES = 0
    TABLE_LAUNCHES = 0


# --------------------------------------------------------------------------- #
# the spec list as data
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class TableSpecs:
    """Count-table specs as host arrays: for spec ``s`` its ``n_cols[s]``
    column numbers ``cols[s, :k]`` into the code matrix, the row-major stride
    of each column, its table size and its offset into the output."""

    n_cols: np.ndarray  # (S,) int64
    cols: np.ndarray  # (S, K) int64, 0 beyond n_cols
    strides: np.ndarray  # (S, K) int64, 0 beyond n_cols
    sizes: np.ndarray  # (S,) int64
    offsets: np.ndarray  # (S,) int64
    total: int

    def __len__(self):
        return len(self.sizes)


def table_specs(col_lists, card_lists):
    """:class:`TableSpecs` for tables whose axes are the columns ``col_lists[s]``
    with cardinalities ``card_lists[s]`` (first axis slowest)."""
    n_specs = len(col_lists)
    width = max((len(c) for c in col_lists), default=1)
    if width > _MAX_COLS:
        raise ValueError(f"table_specs: a spec has {width} columns, at most {_MAX_COLS} are supported")
    n_cols = np.zeros(n_specs, dtype=np.int64)
    cols = np.zeros((n_specs, width), dtype=np.int64)
    strides = np.zeros((n_specs, width), dtype=np.int64)
    sizes = np.zeros(n_specs, dtype=np.int64)
    for s, (spec_cols, cards) in enumerate(zip(col_lists, card_lists)):
        k = len(spec_cols)
        n_cols[s] = k
        cols[s, :k] = spec_cols
        stride = 1
        for j in range(k - 1, -1, -1):
            strides[s, j] = stride
            stride *= int(cards[j])
        if stride >= 2**31:
            raise ValueError(f"table_specs: a table of {stride} entries is too large")
        sizes[s] = stride
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    return TableSpecs(n_cols, cols, strides, sizes, offsets, int(sizes.sum()))


def column_major_codes(codes, max_card):
    """The column-major copy of a row-major ``(n_rows, n_vars)`` code matrix
    that :func:`table_counts` reads: ``(n_vars, ld)`` with ``ld`` the row count
    rounded up to a multiple of 16 (padding is -1), stored as int8 or int16
    when ``max_card`` allows.  One column is then a contiguous, 16-byte aligned
    run instead of one 32-byte sector per code."""
    if max_card <= 127:
        dtype = torch.int8
    elif max_card <= 32767:
        dtype = torch.int16
    else:
        dtype = torch.int32
    n_rows, n_vars = codes.shape
    ld = -(-n_rows // _ROW_ALIGN) * _ROW_ALIGN
    out = torch.full((n_vars, ld), -1, dtype=dtype, device=codes.device)
    out[:, :n_rows] = codes.t()
    return out


def _check_table_inputs(codes_cm, n_rows, specs, weights):
    if codes_cm.dim() != 2 or codes_cm.dtype not in _CODE_DTYPES:
        raise TypeError("table_counts: codes must be a 2-D int8, int16 or int32 tensor")
    if not codes_cm.is_contiguous() or codes_cm.shape[1] % _ROW_ALIGN or codes_cm.shape[1] < n_rows:
        raise ValueError(
            "table_counts: codes must be column-major (n_vars, ld), contiguous, with ld a "
            f"multiple of {_ROW_ALIGN} and at least n_rows (see column_major_codes)"
        )
    if len(specs) and (specs.cols.min() < 0 or specs.cols.max() >= max(codes_cm.shape[0], 1)):
        raise ValueError("table_counts: a spec names a column outside the code matrix")
    if weights is not None:
        if weights.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"table_counts: weights must be float32 or float64, got {weights.dtype}")
        if weights.shape != (n_rows,) or weights.device != codes_cm.device:
            raise ValueError("table_counts: weights must be (n_rows,) on the codes' device")


def table_counts_reference(codes_cm, n_rows, specs, weights=None):
    """Plain version: one masked ``index_add_`` per spec.  Returns the
    concatenated tables, ``int32`` without weights, else in the weights' type."""
    _check_table_inputs(codes_cm, n_rows, specs, weights)
    dtype = torch.int32 if weights is None else weights.dtype
    out = torch.zeros(specs.total, dtype=dtype, device=codes_cm.device)
    for s in range(len(specs)):
        k = int(specs.n_cols[s])
        sub = codes_cm[specs.cols[s, :k].tolist(), :n_rows].long()
        valid = torch.all(sub >= 0, dim=0)
        strides = torch.as_tensor(specs.strides[s, :k], device=sub.device)
        flat = (sub * strides[:, None]).sum(dim=0) + int(specs.offsets[s])
        keep = valid & (flat < int(specs.offsets[s] + specs.sizes[s]))
        values = torch.ones((), dtype=dtype, device=out.device).expand(n_rows) if weights is None else weights
        out.index_add_(0, flat[keep], values[keep])
    return out


def _plan_tiles(sizes, n_rows, n_specs, code_bytes, elem_bytes, sms):
    """Per spec: row tiles, rows per tile and log2 of the shared-memory
    replication (-1: direct global atomics).

    ``want`` tiles per spec fill the card once, and never leave a thread less
    than one 16-byte load of codes.  A spec builds its table in shared memory
    when the table fits ``SHARED_BUDGET_BYTES`` and has no more bins than its
    tile has rows (fewer, longer tiles if need be); otherwise it adds straight
    into global memory from ``want`` tiles."""
    sizes = np.asarray(sizes, dtype=np.int64)
    rows_per_pass = _BLOCK * (_LOAD_BYTES // code_bytes)
    want = int(np.clip(-(-_BLOCKS_PER_SM * sms // max(n_specs, 1)), 1,
                       max(1, -(-n_rows // rows_per_pass))))
    amortised = np.clip(n_rows // np.maximum(sizes, 1), 1, want)
    rows = -(-n_rows // amortised)
    shared = (sizes * elem_bytes <= SHARED_BUDGET_BYTES) & (sizes <= rows)
    tiles = np.where(shared, amortised, want)
    rows = -(-(-(-n_rows // tiles)) // _ROW_ALIGN) * _ROW_ALIGN
    tiles = np.maximum(1, -(-n_rows // rows))
    # replicate while the copies stay small and no longer than the tile
    room = np.minimum(min(_REPLICATED_ENTRIES, SHARED_BUDGET_BYTES // elem_bytes), rows)
    room = room // np.maximum(sizes, 1)
    repl = np.clip(np.floor(np.log2(np.maximum(room, 1))).astype(np.int64), 0, _MAX_REPLICATION_LOG2)
    return tiles, rows, np.where(shared, repl, -1)


def _library():
    lib = load_library("bincount", ["bincount.cu"])
    table = lib.pgmpy_table_count
    table.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p,
    ]
    table.restype = ctypes.c_int
    bincount = lib.pgmpy_weighted_bincount
    bincount.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
    ]
    bincount.restype = ctypes.c_int
    return lib


def _shared_bytes(sizes, repl, elem_bytes):
    """Dynamic shared memory of a launch: its largest private histogram."""
    in_shared = repl >= 0
    if not in_shared.any():
        return 0
    return int(((sizes[in_shared] << repl[in_shared]) * elem_bytes).max())


def _aligned(tensor):
    """``tensor``, contiguous and on a 16-byte boundary (the kernel's loads)."""
    tensor = tensor.contiguous()
    return tensor if tensor.data_ptr() % 16 == 0 else tensor.clone()


def table_counts_cuda(codes_cm, n_rows, specs, weights=None):
    """Launch the table-count kernel on the current stream: one launch for
    all of ``specs``.  Returns the concatenated tables, ``int32`` without
    weights, else in the weights' type."""
    global TABLE_LAUNCHES
    if codes_cm.device.type != "cuda":
        raise ValueError("table_counts_cuda: codes must be on a CUDA device")
    _check_table_inputs(codes_cm, n_rows, specs, weights)
    device = codes_cm.device
    dtype = torch.int32 if weights is None else weights.dtype
    out = torch.empty(specs.total, dtype=dtype, device=device)
    if len(specs) == 0 or specs.total == 0 or n_rows == 0:
        return out.zero_()
    w = None if weights is None else _aligned(weights)
    elem = out.element_size()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles, rows, repl = _plan_tiles(specs.sizes, n_rows, len(specs), codes_cm.element_size(),
                                    elem, sms)
    width = specs.cols.shape[1]
    desc = np.concatenate(
        [np.stack([specs.n_cols, specs.offsets, specs.sizes, tiles, rows, repl], axis=1),
         specs.cols, specs.strides], axis=1).astype(np.int64)
    assert desc.shape[1] == _HEADER + 2 * width
    with torch.cuda.device(device):
        # pinned and asynchronous: the launch queues behind the copy without
        # the host waiting for the stream
        desc_dev = torch.from_numpy(np.ascontiguousarray(desc)).pin_memory().to(
            device, non_blocking=True)
        err = _library().pgmpy_table_count(
            codes_cm.data_ptr(), codes_cm.element_size(), codes_cm.shape[1], n_rows,
            0 if w is None else w.data_ptr(), 0 if w is None else w.element_size(),
            out.data_ptr(), out.numel() * elem, desc_dev.data_ptr(), len(specs), width,
            int(tiles.max()), _BLOCK, _shared_bytes(specs.sizes, repl, elem),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"table_counts kernel launch failed: cudaError_t {err}")
    TABLE_LAUNCHES += 1
    # the stream orders the launch before any reuse of desc_dev's memory
    return out


def table_counts(codes_cm, n_rows, specs, weights=None):
    """Dispatch: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if codes_cm.device.type == "cuda":
        return table_counts_cuda(codes_cm, n_rows, specs, weights)
    if codes_cm.device.type == "cpu":
        return table_counts_reference(codes_cm, n_rows, specs, weights)
    raise ValueError(f"table_counts: unsupported device {codes_cm.device}")


# --------------------------------------------------------------------------- #
# one histogram of a caller's index vector
# --------------------------------------------------------------------------- #
def weighted_bincount_reference(flat_idx, weights, length):
    """Plain version: rows whose index lies outside ``[0, length)`` are dropped."""
    keep = (flat_idx >= 0) & (flat_idx < length)
    out = torch.zeros(length, dtype=weights.dtype, device=weights.device)
    return out.index_add_(0, flat_idx[keep].long(), weights[keep])


def weighted_bincount_cuda(flat_idx, weights, length):
    """Launch the CUDA kernel on the current stream.  The histogram is built
    in shared memory when it fits ``SHARED_BUDGET_BYTES`` and the
    rows amortise its flush, else with direct global atomics (see
    ``_plan_tiles``)."""
    global LAUNCHES
    if flat_idx.device.type != "cuda" or weights.device != flat_idx.device:
        raise ValueError("weighted_bincount_cuda: idx and weights must be on one CUDA device")
    if flat_idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"weighted_bincount_cuda: idx must be int32 or int64, got {flat_idx.dtype}")
    if weights.dtype not in (torch.float32, torch.float64):
        raise TypeError(
            f"weighted_bincount_cuda: weights must be float32 or float64, got {weights.dtype}"
        )
    if flat_idx.dim() != 1 or flat_idx.shape != weights.shape:
        raise ValueError("weighted_bincount_cuda: idx and weights must be 1-D of equal length")
    length = int(length)
    idx = _aligned(flat_idx)
    w = _aligned(weights)
    out = torch.empty(length, dtype=w.dtype, device=w.device)
    n = idx.numel()
    if length == 0 or n == 0:
        return out.zero_()
    elem = w.element_size()
    with torch.cuda.device(w.device):
        sms = torch.cuda.get_device_properties(w.device).multi_processor_count
        sizes = np.array([length], dtype=np.int64)
        tiles, rows, repl = _plan_tiles(sizes, n, 1, idx.element_size(), elem, sms)
        err = _library().pgmpy_weighted_bincount(
            idx.data_ptr(), w.data_ptr(), out.data_ptr(), n, length, elem, idx.element_size(),
            int(rows[0]), int(tiles[0]), int(repl[0]), _BLOCK, _shared_bytes(sizes, repl, elem),
            torch.cuda.current_stream(w.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"weighted_bincount kernel launch failed: cudaError_t {err}")
    LAUNCHES += 1
    return out


def weighted_bincount(flat_idx, weights, length):
    """Dispatch: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if flat_idx.device.type == "cuda":
        return weighted_bincount_cuda(flat_idx, weights, length)
    if flat_idx.device.type == "cpu":
        return weighted_bincount_reference(flat_idx, weights, length)
    raise ValueError(f"weighted_bincount: unsupported device {flat_idx.device}")
