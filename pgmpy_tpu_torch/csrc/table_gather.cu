// Table-gather kernels for Hopper (sm_90a): per-row sums of one table entry
// per node, and EM's E-step on top of them.
//
//   row sums   out[r] = sum_i table[offset_i + sum_j codes[col_ij][r] * stride_ij]
//              (with `missing`, node i's term is dropped where any of its
//              codes is negative)
//   E-step     for each original row r and latent configuration k:
//              lp[k] = the masked sum over the nodes, a latent column's code
//              being grid[k][l]; then w[rK + k] = exp(lp[k] - max lp) /
//              sum_k' exp(lp[k'] - max lp)
//
// Replaces, from the JAX package:
//   * pgmpy_tpu/metrics/bn_inference.py:24-32 (`logp`, K13): a jitted loop of
//     per-node flat indices and gathers from the sampler's log tables;
//   * pgmpy_tpu/estimators/em.py:169-191 (`log_prob` and `e_step_chunk`, K11):
//     the same gather-sum with missing codes masked over the rows expanded by
//     the latent configurations, then a softmax over the K configurations of
//     each row, one jitted program per chunk.
// The port's plain version (ops/table_gather.py) groups the nodes by width and
// makes a few torch kernels per group, each with an (m, n) temporary
// ((m, n, K) for the E-step's latent nodes).
//
// Bound: bytes.  A row reads its own code and its parents' codes once per
// node that names them and writes one value; the table (MUNIN: 98,423 entries,
// 0.4-0.8 MB) stays in L2 and L1.  K13 reads MUNIN's 50,000 x 1041 int8
// codes, 52 MB (0.016 ms at 3.35 TB/s); the E-step the same 50,000 x 1040
// observed codes once and writes 250,000 weights (DIFFN_PATHO latent at 5
// states).  The arithmetic is an integer multiply-add per (row, column) and
// one double add per (row, node): far below the card's rate.  What limits
// both is the chain of dependent loads per node (node row, codes, table
// entry), a thousand nodes a row.
//
// What the design does about it:
//   1. The codes are column-major (n_vars, ld), a warp's lanes on consecutive
//      rows: every code load is coalesced, and a block's columns stay in L1
//      for the nodes that read them again as parents.
//   2. The node table is data: one int32 row per node (table offset, column
//      count, columns, strides), uploaded once and padded to a width of 4, 8
//      or 32 columns, the kernels' template argument, so the column loop is
//      unrolled.  Every lane of a warp reads the same node row.
//   3. A thread issues the code and table loads of four nodes before it
//      adds their terms, in node order, in both kernels.  Eight made
//      row_sums on MUNIN 0.233 ms where four take 0.241, on an H100, but
//      the E-step that shares the code 0.303 where the earlier E-step took
//      0.299 in the same run, its registers spilling more at the cap.
//   4. The E-step reads the ORIGINAL rows, not the rows expanded over the K
//      latent configurations.  The host splits the nodes: a shared node (no
//      latent in scope; MUNIN: 971 of 1041) has the same term for every k
//      and is summed once per row; a latent node (70) reads its latent codes
//      from the K x L grid in shared memory and is summed once per (row, k).
//      MUNIN at K = 5: 1,321 table gathers a row where the expanded rows took
//      5,205, and 52 MB of codes where they took 260 MB.
//   5. Row tiles, nodes in slices (`node_slice`, `combine_slices`, shared by
//      both kernels): a block takes a tile of R rows (32; fewer for the
//      E-step's large K) and cuts the nodes (row_sums: all of them; the
//      E-step: the shared ones) into threads / R slices, a thread summing its
//      slice for its row, so that a row's chain of gathers is spread over 8
//      warps and tens of warps a multiprocessor are in flight (row_sums ran
//      one thread a row until then, 12 warps an SM on MUNIN's 50,000 rows:
//      0.50 ms, 32x the byte bound).  The E-step's latent nodes run as
//      (slice, block of 8 k, row) tasks, each reading a node's data codes
//      once and gathering its 8 entries together.  The grid is the blocks
//      the card holds at once (the occupancy API), each looping over tiles.
//      The node rows are read through L1 (every lane of a warp reads the
//      same row): staging MUNIN's 41 KB in shared memory leaves L1 less room
//      for the table's entries (the E-step: 0.332 ms staged, 0.320 not, on
//      an H100).  Registers are capped at 64 a thread, so that 4 blocks (32
//      warps) fit an SM: uncapped, the latent blocks' registers (96-108 in a
//      stamped build) left 2 and the E-step took 0.426 ms.
//   6. Sums in float64 in a fixed order, stored once in the output's type:
//      the same result from run to run.  Each slice adds in node order; per
//      row the slices meet in a fixed order (lane j of a warp adds slices j,
//      j + 32, ..., then a fixed shuffle tree); row_sums stores that; the
//      E-step takes it as the shared sum, then lp[k] = shared + the latent
//      slices in order, and the softmax (a warp a row, fixed shuffle trees).
//
// The wrapper (pgmpy_tpu_torch/ops/table_gather.py) builds and uploads the
// node table, plans the launch and calls the extern "C" launchers through
// ctypes on PyTorch's current stream; each returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

// Node row (int32): table offset, column count k, then W columns, then W
// strides (0 beyond k).
constexpr int kHeader = 2;
constexpr int kWarp = 32;
constexpr int kUnroll = 4;  // nodes whose loads a thread issues before adding their terms
constexpr int kLatentBlock = 8;  // latent configurations a thread sums at once (ops: E_STEP_KBLOCK)
// a tile kernel's block at most (ops: ROW_BLOCK, E_STEP_BLOCK) and the blocks
// a multiprocessor should hold: registers are capped at 64 a thread
constexpr int kTileThreads = 256, kTileBlocks = 4;

struct Args {
  const void* codes;
  long long ld;
  long long n;  // rows (row_sums) or original rows (e_step)
  const void* table;
  const void* nodes;
  int n_nodes;  // row_sums: every node; e_step: the shared ones
  int missing;
  void* out;
  int block;
  int R;  // rows a tile
  long long smem;
  cudaStream_t stream;
  // e_step only
  int K, P, n_latent, L;
};

// Node d's entry for the row at `base` (its code of column c: base[c * ld]);
// false where `missing` drops the term.  Codes below 0 index as 0.
template <int W, typename C, typename T>
__device__ __forceinline__ bool term(const C* __restrict__ base, long long ld,
                                     const T* __restrict__ table, const int* d, bool missing,
                                     T& value) {
  int flat = d[0];
  const int k = d[1];
  bool valid = true;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    if (j < k) {
      const int code = (int)base[(long long)d[kHeader + j] * ld];
      valid &= code >= 0;
      flat += max(code, 0) * d[kHeader + W + j];
    }
  }
  value = table[flat];
  return valid || !missing;
}

// acc plus the terms of `count` node rows, added in node order, the loads of
// kUnroll nodes issued before their adds.
template <int W, typename C, typename T>
__device__ __forceinline__ double chunk_sum(double acc, const C* __restrict__ base, long long ld,
                                            const T* __restrict__ table, const int* rows,
                                            int count, bool missing) {
  constexpr int kRow = kHeader + 2 * W;
  int i = 0;
  for (; i + kUnroll <= count; i += kUnroll) {
    T v[kUnroll];
    bool use[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      use[u] = term<W>(base, ld, table, rows + (i + u) * kRow, missing, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (use[u]) acc += (double)v[u];
    }
  }
  for (; i < count; ++i) {
    T v;
    if (term<W>(base, ld, table, rows + i * kRow, missing, v)) acc += (double)v;
  }
  return acc;
}

// A thread's part of a tile: its row (one of R, the lanes of a warp on
// consecutive rows) and its slice of n_nodes node rows (one of threads / R,
// cut as evenly as the nodes allow).
struct Slice {
  int row, first, count;
};

__device__ __forceinline__ Slice node_slice(int n_nodes, int R) {
  const int slices = blockDim.x / R, slice = threadIdx.x / R;
  const int first = (int)((long long)n_nodes * slice / slices);
  return {(int)threadIdx.x % R, first, (int)((long long)n_nodes * (slice + 1) / slices) - first};
}

// Row r's sum of the tile's slice sums (s_part: one a thread, thread
// slice * R + r), in a fixed order: lane j of the warp adds slices j, j + 32,
// ..., then a shuffle tree.  Every lane of the warp calls it and gets the
// same sum.
__device__ __forceinline__ double combine_slices(const double* s_part, int slices, int R, int r,
                                                 int lane) {
  double v = 0.0;
  for (int j = lane; j < slices; j += kWarp) v += s_part[j * R + r];
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// K13: the rows a tile of R at a time (the grid strides over the tiles):
// each thread sums its slice of the nodes for its row, then a warp a row
// combines the slices and stores the sum once.
template <int W, typename C, typename T>
__global__ void __launch_bounds__(kTileThreads, kTileBlocks)
    row_sums_kernel(const C* __restrict__ codes, long long ld, long long n_rows, int R,
                    const T* __restrict__ table, const int* __restrict__ nodes, int n_nodes,
                    int missing, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kRow = kHeader + 2 * W;
  double* s_part = reinterpret_cast<double*>(smem_raw);  // a slice sum a thread
  const Slice mine = node_slice(n_nodes, R);
  const int slices = blockDim.x / R;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp, warps = blockDim.x / kWarp;
  const long long n_tiles = (n_rows + R - 1) / R;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long r0 = tile * R;
    const int here = (int)min((long long)R, n_rows - r0);
    s_part[threadIdx.x] = chunk_sum<W>(0.0, codes + r0 + min(mine.row, here - 1), ld, table,
                                       nodes + mine.first * kRow, mine.count, missing != 0);
    __syncthreads();
    for (int r = warp; r < here; r += warps) {
      const double v = combine_slices(s_part, slices, R, r, lane);
      if (lane == 0) out[r0 + r] = (T)v;
    }
    __syncthreads();  // the slice sums are read before the next tile's are written
  }
}

// acc[k] (k < kc) plus the terms of `count` latent node rows for the row at
// `base` and the latent configurations k0 .. k0 + kc - 1 (grid: K x L codes;
// column j of a node row is a data column (>= 0) or latent l (-1 - l)), added
// in node order.  A node's data codes are read once; its kc table entries are
// gathered together.  A term is dropped where a data code is missing (latent
// codes never are).
template <int W, typename C, typename T>
__device__ __forceinline__ void latent_block(double* acc, const C* __restrict__ base, long long ld,
                                             const T* __restrict__ table, const int* rows,
                                             int count, const int* grid, int L, int k0, int kc) {
  constexpr int kRow = kHeader + 2 * W;
  for (int i = 0; i < count; ++i) {
    const int* d = rows + i * kRow;
    int flat = d[0];
    const int n = d[1];
    bool valid = true;
    int lat[W], stride[W];
#pragma unroll
    for (int j = 0; j < W; ++j) {
      lat[j] = -1;
      stride[j] = 0;
      if (j < n) {
        const int col = d[kHeader + j], st = d[kHeader + W + j];
        if (col >= 0) {
          const int code = (int)base[(long long)col * ld];
          valid &= code >= 0;
          flat += max(code, 0) * st;
        } else {
          lat[j] = -1 - col;
          stride[j] = st;
        }
      }
    }
    T v[kLatentBlock];
#pragma unroll
    for (int k = 0; k < kLatentBlock; ++k) {
      if (k < kc) {
        const int* g = grid + (k0 + k) * L;
        int f = flat;
#pragma unroll
        for (int j = 0; j < W; ++j) {
          if (lat[j] >= 0) f += g[lat[j]] * stride[j];
        }
        v[k] = table[f];
      }
    }
#pragma unroll
    for (int k = 0; k < kLatentBlock; ++k) {
      if (k < kc && valid) acc[k] += (double)v[k];
    }
  }
}

// The E-step over the original rows, a tile of R rows at a time (the grid
// strides over the tiles).  Node rows: the n_shared shared nodes (no latent
// in scope), then the n_latent latent nodes; grid: K x L latent codes.
//   1. thread (slice, row) sums slice `slice` of the shared nodes for its row
//      (threads / R slices, the lanes of a warp on consecutive rows);
//   2. task (p, b, row) sums slice p of the latent nodes for its row at the
//      configurations of block b (kLatentBlock of them, in registers; P
//      slices, chosen so that the tasks fill the block where they can);
//   3. a warp per row: its shared sum over the slices in order, then each
//      lp[k] = shared + the latent slices in order, their max and the sum of
//      exponentials (fixed shuffle trees);
//   4. the weights, K consecutive outputs a row.
template <int W, typename C, typename T, typename O>
__global__ void __launch_bounds__(kTileThreads, kTileBlocks)
    e_step_kernel(const C* __restrict__ codes, long long ld, long long n_rows, int K,
                  int R, int P, const int* __restrict__ nodes, int n_shared, int n_latent,
                  int L, const T* __restrict__ table, O* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kRow = kHeader + 2 * W;
  const int threads = blockDim.x, KR = K * R;
  double* s_part = reinterpret_cast<double*>(smem_raw);  // threads shared-node partial sums
  double* s_lp = s_part + threads;                       // P * K * R latent partials, then lp
  double* s_max = s_lp + (long long)P * KR;              // R
  double* s_sum = s_max + R;                             // R
  int* s_grid = reinterpret_cast<int*>(s_sum + R);       // K * L
  const int* grid = nodes + (long long)(n_shared + n_latent) * kRow;
  for (int i = threadIdx.x; i < K * L; i += threads) s_grid[i] = grid[i];
  const int* rows = nodes;  // read through L1: every lane of a warp reads the same row
  __syncthreads();
  const int slices = threads / R;
  const Slice mine = node_slice(n_shared, R);
  const int blocks = (K + kLatentBlock - 1) / kLatentBlock, tasks = P * blocks * R;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp, warps = threads / kWarp;
  const long long n_tiles = (n_rows + R - 1) / R;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long r0 = tile * R;
    const int here = (int)min((long long)R, n_rows - r0);
    s_part[threadIdx.x] = chunk_sum<W>(0.0, codes + r0 + min(mine.row, here - 1), ld, table,
                                       rows + mine.first * kRow, mine.count, true);
    for (int q = threadIdx.x; q < tasks; q += threads) {
      const int p = q / (blocks * R), b = q / R % blocks, r = q % R;
      const int lo = n_shared + (int)((long long)n_latent * p / P);
      const int hi = n_shared + (int)((long long)n_latent * (p + 1) / P);
      const int k0 = b * kLatentBlock, kc = min(kLatentBlock, K - k0);
      double acc[kLatentBlock];
#pragma unroll
      for (int k = 0; k < kLatentBlock; ++k) acc[k] = 0.0;
      latent_block<W>(acc, codes + r0 + min(r, here - 1), ld, table, rows + lo * kRow, hi - lo,
                      s_grid, L, k0, kc);
#pragma unroll
      for (int k = 0; k < kLatentBlock; ++k) {
        if (k < kc) s_lp[(long long)p * KR + (k0 + k) * R + r] = acc[k];
      }
    }
    __syncthreads();
    for (int r = warp; r < here; r += warps) {
      const double shared = combine_slices(s_part, slices, R, r, lane);
      double m = -CUDART_INF;
      for (int k = lane; k < K; k += kWarp) {
        double lp = shared;
        for (int p = 0; p < P; ++p) lp += s_lp[(long long)p * KR + k * R + r];
        s_lp[k * R + r] = lp;
        m = fmax(m, lp);
      }
      for (int o = kWarp / 2; o > 0; o >>= 1) m = fmax(m, __shfl_xor_sync(0xffffffffu, m, o));
      double s = 0.0;
      for (int k = lane; k < K; k += kWarp) s += exp(s_lp[k * R + r] - m);
      for (int o = kWarp / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) {
        s_max[r] = m;
        s_sum[r] = s;
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < here * K; e += threads) {
      const int r = e / K, k = e % K;
      out[r0 * K + e] = (O)(exp(s_lp[k * R + r] - s_max[r]) / s_sum[r]);
    }
    __syncthreads();  // the tile's sums are read before the next tile writes them
  }
}

template <typename F>
cudaError_t allow_smem(F* kernel, long long smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Blocks of a tile kernel: as many as the card holds at once at this shared
// memory (the occupancy API), at most one a tile.
template <typename F>
cudaError_t resident_grid(F* kernel, const Args& a, long long* blocks) {
  cudaError_t err = allow_smem(kernel, a.smem);
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, a.block, (size_t)a.smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = (a.n + a.R - 1) / a.R;
  *blocks = tiles < (long long)per_sm * sms ? tiles : (long long)per_sm * sms;
  return cudaSuccess;
}

template <int W, typename C, typename T>
cudaError_t launch_row_sums(const Args& a) {
  auto kernel = row_sums_kernel<W, C, T>;
  long long blocks = 0;
  cudaError_t err = resident_grid(kernel, a, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, a.block, (size_t)a.smem, a.stream>>>(
      static_cast<const C*>(a.codes), a.ld, a.n, a.R, static_cast<const T*>(a.table),
      static_cast<const int*>(a.nodes), a.n_nodes, a.missing, static_cast<T*>(a.out));
  return cudaGetLastError();
}

template <int W, typename C, typename T, typename O>
cudaError_t launch_e_step(const Args& a) {
  auto kernel = e_step_kernel<W, C, T, O>;
  long long blocks = 0;
  cudaError_t err = resident_grid(kernel, a, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, a.block, (size_t)a.smem, a.stream>>>(
      static_cast<const C*>(a.codes), a.ld, a.n, a.K, a.R, a.P,
      static_cast<const int*>(a.nodes), a.n_nodes, a.n_latent, a.L,
      static_cast<const T*>(a.table), static_cast<O*>(a.out));
  return cudaGetLastError();
}

// out_bytes 0: row_sums (the table's type); 4 or 8: the E-step's weights
template <int W, typename C>
cudaError_t by_types(int table_bytes, int out_bytes, const Args& a) {
  if (out_bytes == 0 && table_bytes == 4) return launch_row_sums<W, C, float>(a);
  if (out_bytes == 0 && table_bytes == 8) return launch_row_sums<W, C, double>(a);
  if (table_bytes == 8 && out_bytes == 4) return launch_e_step<W, C, double, float>(a);
  if (table_bytes == 8 && out_bytes == 8) return launch_e_step<W, C, double, double>(a);
  if (table_bytes == 4 && out_bytes == 4) return launch_e_step<W, C, float, float>(a);
  if (table_bytes == 4 && out_bytes == 8) return launch_e_step<W, C, float, double>(a);
  return cudaErrorInvalidValue;
}

template <int W>
cudaError_t by_codes(int code_bytes, int table_bytes, int out_bytes, const Args& a) {
  if (code_bytes == 1) return by_types<W, int8_t>(table_bytes, out_bytes, a);
  if (code_bytes == 2) return by_types<W, int16_t>(table_bytes, out_bytes, a);
  if (code_bytes == 4) return by_types<W, int32_t>(table_bytes, out_bytes, a);
  if (code_bytes == 8) return by_types<W, int64_t>(table_bytes, out_bytes, a);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch(int width, int code_bytes, int table_bytes, int out_bytes, const Args& a) {
  if (a.block % kWarp != 0 || a.block > kTileThreads || a.R < 1 || a.block % a.R != 0)
    return cudaErrorInvalidValue;
  if (width == 4) return by_codes<4>(code_bytes, table_bytes, out_bytes, a);
  if (width == 8) return by_codes<8>(code_bytes, table_bytes, out_bytes, a);
  if (width == 32) return by_codes<32>(code_bytes, table_bytes, out_bytes, a);
  return cudaErrorInvalidValue;
}

}  // namespace

// out[r] (n_rows values of the table's type) = the sum over the n_nodes node
// rows of `nodes` (int32, 2 + 2 * width entries each; width 4, 8 or 32) of
// the row's table entry.  code_bytes: 1, 2, 4 or 8 (int8 .. int64 codes,
// column-major with leading dimension ld, `codes` pointing at the first row);
// table_bytes: 4 (float) or 8 (double).  Tiles of R rows, `block` threads (a
// multiple of 32 and of R, at most kTileThreads), smem = block * 8 bytes.
extern "C" int pgmpy_table_gather_row_sums(const void* codes, int code_bytes, long long ld,
                                           long long n_rows, const void* table, int table_bytes,
                                           const void* nodes, int n_nodes, int width, int R,
                                           int missing, void* out, int block, long long smem,
                                           void* stream) {
  const Args a{codes, ld, n_rows, table, nodes, n_nodes, missing, out, block, R, smem,
               static_cast<cudaStream_t>(stream), 1, 1, 0, 0};
  return (int)dispatch(width, code_bytes, table_bytes, 0, a);
}

// The E-step's weights, n_rows * K values of out_bytes (4: float, 8: double):
// per original row (codes column-major, `ld` apart, as row_sums reads them)
// and latent configuration k, the masked sum of every node's entry, then the
// softmax over k in float64.  nodes: the n_shared shared node rows, then the
// n_latent latent node rows (width columns each, a latent column -1 - l),
// then the K x L latent codes, all int32.  Tiles of R rows, P latent slices,
// `block` threads (a multiple of 32 and of R, at most kTileThreads); smem =
// (block + P * K * R + 2 * R) * 8 + K * L * 4 bytes.
extern "C" int pgmpy_table_gather_e_step(const void* codes, int code_bytes, long long ld,
                                         long long n_rows, const void* table, int table_bytes,
                                         const void* nodes, int n_shared, int n_latent,
                                         int width, int K, int L, int R, int P, void* out,
                                         int out_bytes, int block, long long smem,
                                         void* stream) {
  if (K < 1 || P < 1 || L < 0 || (out_bytes != 4 && out_bytes != 8))
    return (int)cudaErrorInvalidValue;
  const Args a{codes, ld, n_rows, table, nodes, n_shared, 1, out, block, R, smem,
               static_cast<cudaStream_t>(stream), K, P, n_latent, L};
  return (int)dispatch(width, code_bytes, table_bytes, out_bytes, a);
}
