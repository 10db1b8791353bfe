// Table-gather kernels for Hopper (sm_90a): per-row sums of one table entry
// per node, and EM's E-step on top of them.
//
//   row sums   out[r] = sum_i table[offset_i + sum_j codes[col_ij][r] * stride_ij]
//              (with `missing`, node i's term is dropped where any of its
//              codes is negative)
//   E-step     for each original row g, its K consecutive expanded rows
//              gK .. gK + K - 1: lp[k] = the masked row sum, then
//              w[gK + k] = exp(lp[k] - max lp) / sum_k' exp(lp[k'] - max lp)
//
// Replaces, from the JAX package:
//   * pgmpy_tpu/metrics/bn_inference.py:24-32 (`logp`, K13): a jitted loop of
//     per-node flat indices and gathers from the sampler's log tables;
//   * pgmpy_tpu/estimators/em.py:169-191 (`log_prob` and `e_step_chunk`, K11):
//     the same gather-sum with missing codes masked, then a softmax over the
//     K latent configurations of each row, one jitted program per chunk.
// The port's plain version (ops/table_gather.py) groups the nodes by width and
// makes a few torch kernels per group, each with an (m, n) temporary.
//
// Bound: bytes.  A row reads its own code and its parents' codes once per
// node that names them and writes one value; the table (MUNIN: 98,423 entries,
// 0.4-0.8 MB) stays in L2 and L1.  MUNIN's E-step reads its 250,000 x 1041
// int8 expanded codes, 260 MB (0.078 ms at 3.35 TB/s); K13 its 50,000 x 1041
// int8 codes, 52 MB (0.016 ms).  The arithmetic is an integer multiply-add per
// (row, column) and one double add per (row, node): far below the card's rate.
//
// What the design does about it:
//   1. One thread per (expanded) row.  The codes are column-major (n_vars, ld),
//      so a warp's 32 rows of one column are 32 consecutive codes: every code
//      load is coalesced, and a block's columns stay in L1 for the nodes that
//      read them again as parents.  No temporary leaves the registers.
//   2. The node table is data: one int32 row per node (table offset, column
//      count, columns, strides), uploaded once per TableGather and padded to
//      a width of 4, 8 or 32 columns, the kernel's template argument, so the
//      column loop is unrolled.  A block stages it in shared memory a chunk
//      of nodes at a time (8 KB), and every lane of a warp reads the same row.
//   3. A row is a chain (node row, codes, table entry) a thousand nodes long,
//      and MUNIN's 50,000 rows are only 12 warps per multiprocessor.  A thread
//      issues the code and table loads of four nodes before it adds their
//      terms.  With 2, that took K13 on MUNIN from 1.0 ms (one node at a time,
//      node rows read through L1) to 0.5 ms, 32x the byte bound; eight nodes
//      deep gained nothing, and staging the tables in shared memory too cost
//      more than it saved.  What limits it now is not measured.
//   4. Each row accumulates in float64 in node order and stores once in the
//      output's type: the same sum from run to run, and at MUNIN's 1041 terms
//      no less exact than the plain version's float32 sum.
//   5. The E-step keeps a block's whole rows in shared memory: G = 128 / K
//      original rows (one for K >= 128, the block then loops over the K
//      expanded rows), their K float64 running sums, then one warp per row
//      takes the max and the sum of exponentials by a fixed shuffle tree, and
//      every thread writes its weight.  One launch per EM iteration, any K.
//
// The wrapper (pgmpy_tpu_torch/ops/table_gather.py) builds and uploads the
// node table, plans the grid and calls the extern "C" launchers through
// ctypes on PyTorch's current stream; each returns the launch's cudaError_t.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// Node row (int32): table offset, column count k, then W columns, then W
// strides (0 beyond k).
constexpr int kHeader = 2;
constexpr int kWarp = 32;
constexpr int kUnroll = 4;  // nodes whose loads a thread issues before adding their terms

struct Args {
  const void* codes;
  long long ld;
  long long n;  // rows (row_sums) or original rows (e_step)
  int K;
  int per_block;
  const void* table;
  const void* nodes;
  int n_nodes;
  int chunk;  // nodes staged in shared memory at a time
  int missing;
  void* out;
  int block;
  long long blocks;
  long long smem;
  cudaStream_t stream;
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

// acc plus the terms of `count` staged nodes, added in node order.
template <int W, typename C, typename T>
__device__ __forceinline__ double chunk_sum(double acc, const C* __restrict__ base, long long ld,
                                            const T* __restrict__ table, const int* s_nodes,
                                            int count, bool missing) {
  constexpr int kRow = kHeader + 2 * W;
  int i = 0;
  for (; i + kUnroll <= count; i += kUnroll) {
    T v[kUnroll];
    bool use[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      use[u] = term<W>(base, ld, table, s_nodes + (i + u) * kRow, missing, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (use[u]) acc += (double)v[u];
    }
  }
  for (; i < count; ++i) {
    T v;
    if (term<W>(base, ld, table, s_nodes + i * kRow, missing, v)) acc += (double)v;
  }
  return acc;
}

// Nodes first .. first + count - 1 of the node table into shared memory.
template <int W>
__device__ __forceinline__ void stage(int* s_nodes, const int* __restrict__ nodes, int first,
                                      int count) {
  constexpr int kRow = kHeader + 2 * W;
  const int* src = nodes + (long long)first * kRow;
  for (int x = threadIdx.x; x < count * kRow; x += blockDim.x) s_nodes[x] = src[x];
}

template <int W, typename C, typename T>
__global__ void row_sums_kernel(const C* __restrict__ codes, long long ld, long long n_rows,
                                const T* __restrict__ table, const int* __restrict__ nodes,
                                int n_nodes, int chunk, int missing, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* s_nodes = reinterpret_cast<int*>(smem_raw);
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = row < n_rows;
  const C* base = codes + (active ? row : 0);
  double acc = 0.0;
  for (int first = 0; first < n_nodes; first += chunk) {
    const int count = min(chunk, n_nodes - first);
    __syncthreads();  // the previous chunk is read
    stage<W>(s_nodes, nodes, first, count);
    __syncthreads();
    if (active) acc = chunk_sum<W>(acc, base, ld, table, s_nodes, count, missing != 0);
  }
  if (active) out[row] = (T)acc;
}

// One block: `per_block` original rows of K expanded rows each.
template <int W, typename C, typename T, typename O>
__global__ void e_step_kernel(const C* __restrict__ codes, long long ld, long long n_groups,
                              int K, int per_block, const T* __restrict__ table,
                              const int* __restrict__ nodes, int n_nodes, int chunk,
                              O* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* s_lp = reinterpret_cast<double*>(smem_raw);  // per_block * K running sums
  double* s_max = s_lp + (long long)per_block * K;
  double* s_sum = s_max + per_block;
  int* s_nodes = reinterpret_cast<int*>(s_sum + per_block);
  const long long g0 = (long long)blockIdx.x * per_block;
  const int groups = (int)min((long long)per_block, n_groups - g0);
  const long long e0 = g0 * K;
  const int count = groups * K;
  for (int e = threadIdx.x; e < count; e += blockDim.x) s_lp[e] = 0.0;
  for (int first = 0; first < n_nodes; first += chunk) {
    const int staged = min(chunk, n_nodes - first);
    __syncthreads();
    stage<W>(s_nodes, nodes, first, staged);
    __syncthreads();
    for (int e = threadIdx.x; e < count; e += blockDim.x) {
      s_lp[e] = chunk_sum<W>(s_lp[e], codes + e0 + e, ld, table, s_nodes, staged, true);
    }
  }
  __syncthreads();
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  for (int g = warp; g < groups; g += blockDim.x / kWarp) {
    const double* lp = s_lp + (long long)g * K;
    double m = lp[lane < K ? lane : 0];
    for (int k = lane + kWarp; k < K; k += kWarp) m = fmax(m, lp[k]);
    for (int o = kWarp / 2; o > 0; o >>= 1) m = fmax(m, __shfl_xor_sync(0xffffffffu, m, o));
    double s = 0.0;
    for (int k = lane; k < K; k += kWarp) s += exp(lp[k] - m);
    for (int o = kWarp / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) {
      s_max[g] = m;
      s_sum[g] = s;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const int g = e / K;
    out[e0 + e] = (O)(exp(s_lp[e] - s_max[g]) / s_sum[g]);
  }
}

template <typename F>
cudaError_t allow_smem(F* kernel, long long smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int W, typename C, typename T>
cudaError_t launch_row_sums(const Args& a) {
  auto kernel = row_sums_kernel<W, C, T>;
  cudaError_t err = allow_smem(kernel, a.smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)a.blocks, a.block, (size_t)a.smem, a.stream>>>(
      static_cast<const C*>(a.codes), a.ld, a.n, static_cast<const T*>(a.table),
      static_cast<const int*>(a.nodes), a.n_nodes, a.chunk, a.missing, static_cast<T*>(a.out));
  return cudaGetLastError();
}

template <int W, typename C, typename T, typename O>
cudaError_t launch_e_step(const Args& a) {
  auto kernel = e_step_kernel<W, C, T, O>;
  cudaError_t err = allow_smem(kernel, a.smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)a.blocks, a.block, (size_t)a.smem, a.stream>>>(
      static_cast<const C*>(a.codes), a.ld, a.n, a.K, a.per_block,
      static_cast<const T*>(a.table), static_cast<const int*>(a.nodes), a.n_nodes, a.chunk,
      static_cast<O*>(a.out));
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
  if (a.block % kWarp != 0 || a.chunk < 1) return cudaErrorInvalidValue;
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
// table_bytes: 4 (float) or 8 (double).  One thread per row, `block` threads
// a block (a multiple of 32), `chunk` node rows staged in smem bytes.
extern "C" int pgmpy_table_gather_row_sums(const void* codes, int code_bytes, long long ld,
                                           long long n_rows, const void* table, int table_bytes,
                                           const void* nodes, int n_nodes, int width, int chunk,
                                           int missing, void* out, int block, long long blocks,
                                           long long smem, void* stream) {
  const Args a{codes, ld, n_rows, 1, 1, table, nodes, n_nodes, chunk, missing, out, block,
               blocks, smem, static_cast<cudaStream_t>(stream)};
  return (int)dispatch(width, code_bytes, table_bytes, 0, a);
}

// The E-step's weights, n_groups * K values of out_bytes (4: float, 8:
// double): per original row the masked row sums of its K expanded rows, then
// their softmax in float64.  per_block original rows a block, `block` threads
// (a multiple of 32); smem = (per_block * K + 2 * per_block) * 8 bytes, then
// the staged chunk of node rows.
extern "C" int pgmpy_table_gather_e_step(const void* codes, int code_bytes, long long ld,
                                         long long n_groups, int K, const void* table,
                                         int table_bytes, const void* nodes, int n_nodes,
                                         int width, int chunk, void* out, int out_bytes,
                                         int per_block, int block, long long blocks,
                                         long long smem, void* stream) {
  if (K < 1 || per_block < 1 || (out_bytes != 4 && out_bytes != 8))
    return (int)cudaErrorInvalidValue;
  const Args a{codes, ld, n_groups, K, per_block, table, nodes, n_nodes, chunk, 1, out, block,
               blocks, smem, static_cast<cudaStream_t>(stream)};
  return (int)dispatch(width, code_bytes, table_bytes, out_bytes, a);
}
