"""Per-row sums of one table entry per node: the gather that K11 and K13 share.

Each node owns a table inside one flat tensor.  A row's entry in node ``i``'s
table is ``offsets[i] + sum_j codes[cols[i][j], row] * strides[i][j]``: the
node's own code and its parents' codes, each times its stride.
``BayesianModelProbability`` (K13) sums the log-CPD entries of every node for
``log P(row)``; ``ExpectationMaximization``'s E-step (K11) sums them over the
rows expanded by the latent states, leaving out a node whose code or a
parent's code is missing (-1), then takes the softmax over each row's K
expanded rows.

Both are entry points of one hand-written CUDA source,
``csrc/table_gather.cu`` (built with ``nvcc`` at first use): one thread per
row walks the node table in node order and sums in float64 registers;
:meth:`TableGather.e_step` does the softmax in the same launch.  A CUDA
tensor always goes to the kernel, and a build or launch failure raises; a CPU
tensor goes to the plain version (``*_reference``): per group of nodes of one
width, one ``index_select`` of every column the group needs from the
column-major ``(n_vars, n_rows)`` code matrix, the index arithmetic, one
gather from the flat table and a sum over the group's nodes.

``LAUNCHES`` counts each entry point's launches; :func:`reset_launches`
zeroes them.
"""

import ctypes

import numpy as np
import torch

from pgmpy_tpu_torch.ops._build import load_library

ROW_BLOCK = 128  # threads (rows) per block of row_sums
E_STEP_BLOCK = 128  # threads per block of e_step: 128 // K whole rows, or one
MAX_SHARED = 232_448  # the most dynamic shared memory a block may opt in to (227 KB)
CHUNK_INTS = 2048  # int32 entries of node rows a block stages in shared memory at a time
WIDTHS = (4, 8, 32)  # the node-row widths (columns) table_gather.cu is compiled for
_NODE_HEADER = 2  # kHeader in table_gather.cu: table offset, column count
_CODE_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64)
_TABLE_DTYPES = (torch.float32, torch.float64)

LAUNCHES = {"row_sums": 0, "e_step": 0}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def node_table(cols, strides, offsets):
    """The kernel's node table: one int32 row per node, ``(table offset,
    column count, columns..., strides...)``, columns and strides padded with
    0 to the first of ``WIDTHS`` that holds the widest node (a node of more
    than 32 columns raises)."""
    widest = max([len(c) for c in cols] + [1])
    if widest > WIDTHS[-1]:
        raise ValueError(f"TableGather: a node indexes {widest} columns, the kernel takes at "
                         f"most {WIDTHS[-1]}")
    width = next(w for w in WIDTHS if w >= widest)
    out = np.zeros((len(cols), _NODE_HEADER + 2 * width), dtype=np.int64)
    out[:, 0] = np.asarray(offsets, dtype=np.int64)[: len(cols)]
    for i, (c, s) in enumerate(zip(cols, strides)):
        out[i, 1] = len(c)
        out[i, _NODE_HEADER: _NODE_HEADER + len(c)] = c
        out[i, _NODE_HEADER + width: _NODE_HEADER + width + len(c)] = s
    return out.astype(np.int32)


def chunk_nodes(width):
    """Node rows of ``width`` columns a block stages at a time."""
    return CHUNK_INTS // (_NODE_HEADER + 2 * width)


def plan_rows(n_rows, width):
    """(threads a block, blocks, dynamic shared bytes) of a row_sums launch:
    one thread per row, a chunk of node rows in shared memory."""
    chunk = chunk_nodes(width)
    return (ROW_BLOCK, max(1, -(-int(n_rows) // ROW_BLOCK)),
            chunk * (_NODE_HEADER + 2 * width) * 4)


def plan_e_step(n_groups, K, width):
    """(original rows a block, threads a block, blocks, dynamic shared bytes)
    of an e_step launch: ``E_STEP_BLOCK // K`` whole rows a block (one when
    K is larger), their K float64 sums and a max and a sum each, then a chunk
    of node rows, in shared memory.  A K whose one row's sums exceed
    ``MAX_SHARED`` raises."""
    per_block = max(1, E_STEP_BLOCK // int(K))
    shared = (per_block * int(K) + 2 * per_block) * 8 \
        + chunk_nodes(width) * (_NODE_HEADER + 2 * width) * 4
    if shared > MAX_SHARED:
        raise ValueError(f"TableGather.e_step: {K} latent configurations need {shared} bytes of "
                         f"shared memory, more than the {MAX_SHARED} a block may have")
    return per_block, E_STEP_BLOCK, max(1, -(-int(n_groups) // per_block)), shared


def _library():
    lib = load_library("table_gather", ["table_gather.cu"])
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.pgmpy_table_gather_row_sums.argtypes = [
        vp, i32, i64, i64, vp, i32, vp, i32, i32, i32, i32, vp, i32, i64, i64, vp]
    lib.pgmpy_table_gather_e_step.argtypes = [
        vp, i32, i64, i64, i32, vp, i32, vp, i32, i32, i32, vp, i32, i32, i32, i64, i64, vp]
    for fn in (lib.pgmpy_table_gather_row_sums, lib.pgmpy_table_gather_e_step):
        fn.restype = ctypes.c_int
    return lib


class TableGather:
    """``cols[i]`` / ``strides[i]``: the code-matrix rows that index node
    ``i``'s table and their strides; ``offsets[i]``: the table's start in the
    flat tensor of ``total`` entries."""

    def __init__(self, cols, strides, offsets, total, device):
        self.index_dtype = torch.int32 if total < 2**31 else torch.int64
        self.total = int(total)
        self.n_cols_max = max([int(np.max(c)) + 1 for c in cols if len(c)] + [0])
        by_width = {}
        for i, c in enumerate(cols):
            by_width.setdefault(len(c), []).append(i)
        self.groups = []
        for width, nodes in sorted(by_width.items()):
            g_cols = np.array([cols[i] for i in nodes], dtype=np.int64).reshape(len(nodes), width)
            g_strides = np.array([strides[i] for i in nodes], dtype=np.int64).reshape(len(nodes), width)
            self.groups.append((
                torch.as_tensor(g_cols.T.reshape(-1), device=device),
                torch.as_tensor(g_strides.T[:, :, None], dtype=self.index_dtype, device=device),
                torch.as_tensor(np.asarray(offsets, dtype=np.int64)[nodes][:, None],
                                dtype=self.index_dtype, device=device),
            ))
        # the kernel's node table (host), uploaded at a card's first launch;
        # None where the kernel cannot take the nodes (its _check says why)
        self.nodes = (node_table(cols, strides, offsets)
                      if self.total < 2**31 and max([len(c) for c in cols] + [0]) <= WIDTHS[-1]
                      else None)
        self._device_nodes = {}

    # ------------------------------------------------------------------ #
    # plain versions
    # ------------------------------------------------------------------ #
    def row_sums_reference(self, table, codes, missing=False):
        """Plain version of :meth:`row_sums`."""
        n = codes.shape[1]
        out = torch.zeros(n, dtype=table.dtype, device=table.device)
        for cols, strides, offsets in self.groups:
            width, m = strides.shape[0], offsets.shape[0]
            g = codes.index_select(0, cols).view(width, m, n)
            if missing:
                valid = (g >= 0).all(dim=0)
                g = g.clamp_min(0)
            flat = (g.to(self.index_dtype) * strides).sum(dim=0, dtype=self.index_dtype) + offsets
            values = table.index_select(0, flat.view(-1)).view(m, n)
            if missing:
                values = torch.where(valid, values, torch.zeros((), dtype=values.dtype,
                                                                device=values.device))
            out += values.sum(dim=0)
        return out

    def e_step_reference(self, table, codes, K, dtype):
        """Plain version of :meth:`e_step`."""
        lp = self.row_sums_reference(table, codes, missing=True)
        return torch.softmax(lp.view(-1, K).to(torch.float64), dim=1).view(-1).to(dtype)

    # ------------------------------------------------------------------ #
    # the CUDA kernels
    # ------------------------------------------------------------------ #
    def _check(self, name, table, codes):
        if table.device.type != "cuda" or codes.device != table.device:
            raise ValueError(f"{name}: the table and the codes must be on one CUDA device")
        if self.nodes is None:
            raise ValueError(f"{name}: a flat table of {self.total} entries is beyond the "
                             f"kernel's int32 index, or a node indexes more than {WIDTHS[-1]} "
                             "columns")
        if table.dtype not in _TABLE_DTYPES or table.dim() != 1 or not table.is_contiguous():
            raise TypeError(f"{name}: the table must be a contiguous 1-D float32 or float64 "
                            f"tensor, got {table.dtype} {tuple(table.shape)}")
        if table.numel() < self.total:
            raise ValueError(f"{name}: the table has {table.numel()} entries, the nodes "
                             f"index {self.total}")
        if codes.dim() != 2 or codes.dtype not in _CODE_DTYPES:
            raise TypeError(f"{name}: codes must be a 2-D integer tensor, got {codes.dtype}")
        if codes.shape[1] > 1 and codes.stride(1) != 1:
            raise ValueError(f"{name}: a column of codes must be contiguous over the rows")
        if codes.shape[0] < self.n_cols_max:
            raise ValueError(f"{name}: the nodes read {self.n_cols_max} code columns, the codes "
                             f"have {codes.shape[0]}")

    def _nodes_on(self, device):
        """The node table on ``device``: uploaded once, pinned and without
        the host waiting; a later launch on another stream waits for it."""
        entry = self._device_nodes.get(device)
        if entry is not None:
            torch.cuda.current_stream(device).wait_event(entry[1])
            return entry[0]
        nodes = torch.from_numpy(self.nodes).pin_memory().to(device, non_blocking=True)
        uploaded = torch.cuda.Event()
        uploaded.record(torch.cuda.current_stream(device))
        self._device_nodes[device] = (nodes, uploaded)
        return nodes

    def row_sums_cuda(self, table, codes, missing=False):
        """One ``row_sums`` launch on the current stream."""
        self._check("row_sums", table, codes)
        n = codes.shape[1]
        out = torch.empty(n, dtype=table.dtype, device=table.device)
        if n == 0:
            return out
        width = self._width()
        block, blocks, shared = plan_rows(n, width)
        with torch.cuda.device(table.device):
            nodes = self._nodes_on(table.device)
            err = _library().pgmpy_table_gather_row_sums(
                codes.data_ptr(), codes.element_size(), codes.stride(0), n, table.data_ptr(),
                table.element_size(), nodes.data_ptr(), nodes.shape[0], width,
                chunk_nodes(width), int(bool(missing)), out.data_ptr(), block, blocks, shared,
                torch.cuda.current_stream(table.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"table_gather row_sums launch failed: cudaError_t {err}")
        LAUNCHES["row_sums"] += 1
        return out

    def e_step_cuda(self, table, codes, K, dtype):
        """One ``e_step`` launch on the current stream, whatever the rows."""
        self._check("e_step", table, codes)
        if dtype not in _TABLE_DTYPES:
            raise TypeError(f"e_step: float32 or float64 weights, got {dtype}")
        n_rows = codes.shape[1]
        if n_rows % K:
            raise ValueError(f"e_step: {n_rows} expanded rows are not whole rows of {K}")
        out = torch.empty(n_rows, dtype=dtype, device=table.device)
        if n_rows == 0:
            return out
        width = self._width()
        per_block, block, blocks, shared = plan_e_step(n_rows // K, K, width)
        with torch.cuda.device(table.device):
            nodes = self._nodes_on(table.device)
            err = _library().pgmpy_table_gather_e_step(
                codes.data_ptr(), codes.element_size(), codes.stride(0), n_rows // K, K,
                table.data_ptr(), table.element_size(), nodes.data_ptr(), nodes.shape[0],
                width, chunk_nodes(width), out.data_ptr(), out.element_size(), per_block, block,
                blocks, shared, torch.cuda.current_stream(table.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"table_gather e_step launch failed: cudaError_t {err}")
        LAUNCHES["e_step"] += 1
        return out

    def _width(self):
        return (self.nodes.shape[1] - _NODE_HEADER) // 2

    # ------------------------------------------------------------------ #
    # dispatch
    # ------------------------------------------------------------------ #
    def row_sums(self, table, codes, missing=False):
        """``(n_rows,)`` sums over the nodes of ``table[entry of the row]`` in
        ``table``'s type, from ``codes`` ``(n_vars, n_rows)`` (any integer
        type; rows of a column-major code matrix).  With ``missing`` a node's
        term is 0 in a row where any of its codes is negative.  The kernel for
        a CUDA table, the plain version for a CPU one."""
        if table.device.type == "cuda":
            return self.row_sums_cuda(table, codes, missing)
        if table.device.type == "cpu":
            return self.row_sums_reference(table, codes, missing)
        raise ValueError(f"row_sums: unsupported device {table.device}")

    def e_step(self, table, codes, K, dtype):
        """EM's E-step weights, ``(n_rows,)`` in ``dtype``: per run of K
        consecutive rows (one row expanded over the latent configurations),
        the softmax in float64 of their masked row sums (``missing``)."""
        if table.device.type == "cuda":
            return self.e_step_cuda(table, codes, K, dtype)
        if table.device.type == "cpu":
            return self.e_step_reference(table, codes, K, dtype)
        raise ValueError(f"e_step: unsupported device {table.device}")
