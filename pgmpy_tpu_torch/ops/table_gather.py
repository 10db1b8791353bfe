"""Per-row sums of one table entry per node: the gather that K11 and K13 share.

Each node owns a table inside one flat tensor.  A row's entry in node ``i``'s
table is ``offsets[i] + sum_j codes[cols[i][j], row] * strides[i][j]``: the
node's own code and its parents' codes, each times its stride.
``BayesianModelProbability`` (K13, :class:`TableGather`) sums the log-CPD
entries of every node for ``log P(row)``.  ``ExpectationMaximization``'s
E-step (K11, :class:`LatentGather`) sums them for each row and each of the K
joint configurations of the latent variables, leaving out a node whose code
or a parent's code is missing (-1), then takes the softmax over the K sums of
each row; a node with no latent in scope gives the same term for every k and
is summed once per row.

Both are entry points of one hand-written CUDA source,
``csrc/table_gather.cu`` (built with ``nvcc`` at first use), and share its
row tiles: a block takes ``ROW_TILE`` rows and cuts the nodes into slices
over its warps, each thread summing its slice for its row in float64, the
slices combined per row in a fixed order.  ``row_sums`` stores each row's
sum; ``e_step`` cuts only the shared nodes so, runs the latent ones as
(slice, configuration, row) tasks, and takes the softmax in the same launch.
A CUDA tensor always goes to the kernel, and a build or launch failure
raises; a CPU tensor goes to the plain version (``*_reference``): per group
of nodes of one width, one ``index_select`` of every column the group needs
from the column-major ``(n_vars, n_rows)`` code matrix, the index
arithmetic, one gather from the flat table and a sum over the group's nodes
(a latent group's gather is ``(nodes, rows, K)``).

``LAUNCHES`` counts each entry point's launches; :func:`reset_launches`
zeroes them.
"""

import ctypes

import numpy as np
import torch

from pgmpy_tpu_torch.ops._build import load_library

ROW_BLOCK = 256  # threads a block of row_sums (at most kTileThreads, 256)
ROW_TILE = 32  # rows a tile of row_sums, one a lane: the block's warps are its slices of nodes
E_STEP_BLOCK = 256  # threads per block of e_step (at most kTileThreads, 256)
E_STEP_ROWS = 32  # original rows a tile of e_step, at most (one a lane)
E_STEP_KBLOCK = 8  # latent configurations a thread of e_step sums at once (kLatentBlock)
LP_BYTES = 32 * 1024  # a tile's K x rows float64 sums at most: fewer rows for a larger K
MAX_SHARED = 232_448  # the most dynamic shared memory a block may opt in to (227 KB)
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


def plan_rows(n_rows):
    """(rows a tile R, node slices, threads a block, dynamic shared bytes,
    tiles) of a row_sums launch: tiles of ``ROW_TILE`` rows, each thread
    summing its slice of the nodes for its row (``ROW_BLOCK / ROW_TILE``
    slices), a float64 partial sum a thread in shared memory.  The grid is
    the blocks the card holds at once, striding over the tiles."""
    return (ROW_TILE, ROW_BLOCK // ROW_TILE, ROW_BLOCK, ROW_BLOCK * 8,
            -(-int(n_rows) // ROW_TILE))


def plan_e_step(K, width, n_shared, n_latent, L):
    """(rows a tile R, latent slices P, threads a block, dynamic shared
    bytes) of an e_step launch.  A tile is R original rows (32, fewer
    where its K x R float64 sums would pass ``LP_BYTES``); each thread sums a
    slice of the shared nodes for one row, and the latent nodes are cut into
    P slices so that the (slice, block of ``E_STEP_KBLOCK`` configurations,
    row) tasks fill the block where they can.  Shared memory: a partial sum a
    thread, the P x K x R latent partial sums, a max and a sum a row, and the
    K x L latent codes.  The grid is the blocks the card holds at once,
    striding over the tiles.  A K whose one row's sums exceed ``MAX_SHARED``
    raises."""
    K = int(K)
    rows = E_STEP_ROWS
    while rows > 1 and rows * K * 8 > LP_BYTES:
        rows //= 2
    blocks = -(-K // E_STEP_KBLOCK)
    slices = max(1, min(E_STEP_BLOCK // (blocks * rows), n_latent))
    shared = (E_STEP_BLOCK + slices * K * rows + 2 * rows) * 8 + K * L * 4
    if shared > MAX_SHARED:
        raise ValueError(f"TableGather.e_step: {K} latent configurations need {shared} bytes of "
                         f"shared memory, more than the {MAX_SHARED} a block may have")
    return rows, slices, E_STEP_BLOCK, shared


def _upload(cache, host, device):
    """``host`` (an int32 array) on ``device``: uploaded once, pinned and
    without the host waiting; a later launch on another stream waits for it."""
    entry = cache.get(device)
    if entry is not None:
        torch.cuda.current_stream(device).wait_event(entry[1])
        return entry[0]
    buf = torch.from_numpy(np.ascontiguousarray(host)).pin_memory().to(device, non_blocking=True)
    uploaded = torch.cuda.Event()
    uploaded.record(torch.cuda.current_stream(device))
    cache[device] = (buf, uploaded)
    return buf


def _check_inputs(name, table, codes, fits, total, n_cols):
    if table.device.type != "cuda" or codes.device != table.device:
        raise ValueError(f"{name}: the table and the codes must be on one CUDA device")
    if not fits:
        raise ValueError(f"{name}: a flat table of {total} entries is beyond the kernel's int32 "
                         f"index, or a node indexes more than {WIDTHS[-1]} columns")
    if table.dtype not in _TABLE_DTYPES or table.dim() != 1 or not table.is_contiguous():
        raise TypeError(f"{name}: the table must be a contiguous 1-D float32 or float64 "
                        f"tensor, got {table.dtype} {tuple(table.shape)}")
    if table.numel() < total:
        raise ValueError(f"{name}: the table has {table.numel()} entries, the nodes index {total}")
    if codes.dim() != 2 or codes.dtype not in _CODE_DTYPES:
        raise TypeError(f"{name}: codes must be a 2-D integer tensor, got {codes.dtype}")
    if codes.shape[1] > 1 and codes.stride(1) != 1:
        raise ValueError(f"{name}: a column of codes must be contiguous over the rows")
    if codes.shape[0] < n_cols:
        raise ValueError(f"{name}: the nodes read {n_cols} code columns, the codes have "
                         f"{codes.shape[0]}")


def _library():
    lib = load_library("table_gather", ["table_gather.cu"])
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.pgmpy_table_gather_row_sums.argtypes = [
        vp, i32, i64, i64, vp, i32, vp, i32, i32, i32, i32, vp, i32, i64, vp]
    lib.pgmpy_table_gather_e_step.argtypes = [
        vp, i32, i64, i64, vp, i32, vp, i32, i32, i32, i32, i32, i32, i32, vp, i32, i32, i64,
        vp]
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

    # ------------------------------------------------------------------ #
    # the CUDA kernels
    # ------------------------------------------------------------------ #
    def _check(self, name, table, codes):
        _check_inputs(name, table, codes, self.nodes is not None, self.total, self.n_cols_max)

    def _nodes_on(self, device):
        return _upload(self._device_nodes, self.nodes, device)

    def row_sums_cuda(self, table, codes, missing=False):
        """One ``row_sums`` launch on the current stream."""
        self._check("row_sums", table, codes)
        n = codes.shape[1]
        out = torch.empty(n, dtype=table.dtype, device=table.device)
        if n == 0:
            return out
        rows, _, block, shared, _ = plan_rows(n)
        with torch.cuda.device(table.device):
            nodes = self._nodes_on(table.device)
            err = _library().pgmpy_table_gather_row_sums(
                codes.data_ptr(), codes.element_size(), codes.stride(0), n, table.data_ptr(),
                table.element_size(), nodes.data_ptr(), nodes.shape[0], self._width(), rows,
                int(bool(missing)), out.data_ptr(), block, shared,
                torch.cuda.current_stream(table.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"table_gather row_sums launch failed: cudaError_t {err}")
        LAUNCHES["row_sums"] += 1
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


class LatentGather:
    """EM's E-step over the original rows (K11).

    ``cols[i]`` / ``strides[i]``: the columns that index node ``i``'s table
    and their strides, a column being a data column (``>= 0``) of the
    observed code matrix or ``-1 - l`` for latent variable ``l``;
    ``offsets[i]``: the table's start in the flat tensor of ``total``
    entries; ``grid``: ``(K, L)`` codes of the L latent variables in each of
    the K joint configurations.  A row's log-probability in configuration k
    is the sum over the nodes of its masked entry: the nodes with no latent in
    scope (*shared*) give one term per row whatever k; the others (*latent*)
    read their latent codes from ``grid[k]``.  The shared nodes are summed
    once per row and the latent ones K times: the E-step never builds or
    reads the rows expanded over the configurations.

    The kernel's table (``nodes``, int32): the shared node rows, the latent
    node rows (a latent column is ``-1 - l``), then the grid."""

    def __init__(self, cols, strides, offsets, total, grid, device):
        grid = np.asarray(grid, dtype=np.int64)
        self.K, self.L = grid.shape
        self.grid = grid
        self.total = int(total)
        offsets = np.asarray(offsets, dtype=np.int64)
        self.latent_nodes = [i for i, c in enumerate(cols) if any(int(x) < 0 for x in c)]
        self.shared_nodes = [i for i, c in enumerate(cols) if all(int(x) >= 0 for x in c)]
        shared = self.shared_nodes
        self.shared = TableGather([cols[i] for i in shared], [strides[i] for i in shared],
                                  offsets[shared], total, device)
        self.n_cols_max = max([int(x) + 1 for c in cols for x in c] + [0])
        # the plain version's latent groups, by width: the data columns (a
        # latent one read as column 0), each column's stride where it is a
        # data column, and per configuration the table offset plus the
        # latent columns' part of the index, (nodes, K)
        by_width = {}
        for i in self.latent_nodes:
            by_width.setdefault(len(cols[i]), []).append(i)
        self.latent_groups = []
        index_dtype = torch.int32 if total < 2**31 else torch.int64
        for width, members in sorted(by_width.items()):
            c = np.array([cols[i] for i in members], dtype=np.int64).reshape(len(members), width)
            st = np.array([strides[i] for i in members], dtype=np.int64).reshape(len(members),
                                                                                 width)
            data = c >= 0
            base = offsets[members][:, None] + sum(
                np.where(data[:, j, None], 0, grid[:, np.maximum(-1 - c[:, j], 0)].T
                         if self.L else 0) * st[:, j, None] for j in range(width))
            self.latent_groups.append((
                torch.as_tensor(np.where(data, c, 0).T.reshape(-1), device=device),
                torch.as_tensor(data.T[:, :, None], device=device),
                torch.as_tensor(np.where(data, st, 0).T[:, :, None], dtype=index_dtype,
                                device=device),
                torch.as_tensor(base[:, None, :], dtype=index_dtype, device=device),
            ))
        order = shared + self.latent_nodes
        widest = max([len(c) for c in cols] + [0])
        self.nodes = None
        if self.total < 2**31 and widest <= WIDTHS[-1]:
            table = node_table([cols[i] for i in order], [strides[i] for i in order],
                               offsets[order])
            self.nodes = np.concatenate([table.ravel(), grid.astype(np.int32).ravel()])
            self.width = (table.shape[1] - _NODE_HEADER) // 2
        self._device_nodes = {}

    def e_step_reference(self, table, codes, dtype):
        """Plain version of :meth:`e_step`: the shared nodes' masked sums
        (``TableGather.row_sums_reference``), then per latent group one gather
        of ``(nodes, rows, K)`` entries, their masked sum, and the softmax in
        float64."""
        n = codes.shape[1]
        shared = self.shared.row_sums_reference(table, codes, missing=True).to(torch.float64)
        latent = torch.zeros((n, self.K), dtype=torch.float64, device=table.device)
        for cols, data, strides, base in self.latent_groups:
            width, m = data.shape[0], data.shape[1]
            g = codes.index_select(0, cols).view(width, m, n)
            valid = ((g >= 0) | ~data).all(dim=0)
            flat = (g.clamp_min(0).to(strides.dtype) * strides).sum(dim=0, dtype=strides.dtype)
            flat = flat[:, :, None] + base
            values = table.index_select(0, flat.view(-1)).view(m, n, self.K)
            values = torch.where(valid[:, :, None], values,
                                 torch.zeros((), dtype=values.dtype, device=values.device))
            latent += values.sum(dim=0, dtype=torch.float64)
        lp = shared[:, None] + latent
        return torch.softmax(lp, dim=1).view(-1).to(dtype)

    def e_step_cuda(self, table, codes, dtype):
        """One ``e_step`` launch on the current stream, whatever the rows."""
        _check_inputs("e_step", table, codes, self.nodes is not None, self.total,
                      self.n_cols_max)
        if dtype not in _TABLE_DTYPES:
            raise TypeError(f"e_step: float32 or float64 weights, got {dtype}")
        n = codes.shape[1]
        out = torch.empty(n * self.K, dtype=dtype, device=table.device)
        if n == 0:
            return out
        n_shared, n_latent = len(self.shared_nodes), len(self.latent_nodes)
        rows, slices, block, shared = plan_e_step(self.K, self.width, n_shared, n_latent,
                                                  self.L)
        with torch.cuda.device(table.device):
            nodes = _upload(self._device_nodes, self.nodes, table.device)
            err = _library().pgmpy_table_gather_e_step(
                codes.data_ptr(), codes.element_size(), codes.stride(0), n, table.data_ptr(),
                table.element_size(), nodes.data_ptr(), n_shared, n_latent, self.width, self.K,
                self.L, rows, slices, out.data_ptr(), out.element_size(), block, shared,
                torch.cuda.current_stream(table.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"table_gather e_step launch failed: cudaError_t {err}")
        LAUNCHES["e_step"] += 1
        return out

    def e_step(self, table, codes, dtype):
        """EM's E-step weights, ``(n_rows * K,)`` in ``dtype`` (row-major:
        the K configurations of a row together), from the log tables
        ``table`` and the observed ``codes`` ``(n_vars, n_rows)`` (rows of a
        column-major code matrix, -1 missing): per row the softmax in float64
        over k of the sum of the node terms, a term left out where one of its
        data codes is missing.  The kernel for a CUDA table, the plain version
        for a CPU one."""
        if table.device.type == "cuda":
            return self.e_step_cuda(table, codes, dtype)
        if table.device.type == "cpu":
            return self.e_step_reference(table, codes, dtype)
        raise ValueError(f"e_step: unsupported device {table.device}")
