// The ancestral sweep for Hopper (sm_90a): one launch draws every row of a
// discrete Bayesian network, node after node in topological order.  The same
// kernel draws one slice of the particle filter, whose nodes may also have
// parents in the previous slice.
//
//   for each row r, for each node i in order, into column c_i of the row:
//     clamp      code[r][c_i] = s                                (mode s >= 0)
//     evidence   code[r][c_i] = s; logw[r] += table_i[flat][s]   (mode -2 - s)
//     draw       code[r][c_i] = argmax_s (table_i[flat][s] - log E[r][i][s])
//                (then replaced by partial[r][i] where that is >= 0)
//   flat = sum_j v_ij * stride_ij, where v_ij is code[r][p_ij] for a parent
//   index p_ij < d and prev[r][p_ij - d] (the previous slice) otherwise;
//   table_i its (rows, card) log CPD; E ~ Exp(1) clamped at 1e-20: the
//   exponential race (race.cuh), a categorical draw that never picks a state
//   of zero probability against one of real mass.
//
// Replaces, from the JAX package: pgmpy_tpu/sampling/core.py:173 `_forward`,
// :189 `_forward_partial` and :208 `_likelihood_weighted`, jitted loops over
// the nodes whose table rows come from `onehot_table_rows` (:34), a one-hot
// matrix product that suits the TPU's matrix unit and not this card; and
// pgmpy_tpu/sampling/smc.py:101 `_sweep`, the particle filter's slice inside
// the `scan` of `_filter_program` (:174, step :184).  The port's plain version
// (ops/ancestral.py) makes a handful of torch kernels per node: 7,227 per
// sweep of MUNIN, about 270 per slice of ALARM as a 2-TBN.
//
// Bound: bytes, in principle.  The sweep writes n x d codes (MUNIN's 52,048 x
// 1041 int8: 54 MB, 0.016 ms at 3.35 TB/s) and reads the log tables (0.4 MB,
// in L2).  The work per row is a chain: a node's parents are the row's own
// earlier draws, and a draw costs one Philox block per four states and two
// logarithms per state (MUNIN: 5,651 states a row).
//
// What the design does about it:
//   1. A block's rows live in shared memory.  Each row's codes sit in a shared
//      tile (rows x d, each row padded to an odd number of 4-byte words so
//      that the 32 lanes of a warp reading one column hit 32 banks); a node
//      reads its parents from there, and at the end the block writes its tile
//      out whole: row-major (n, d) row after row, consecutive threads on
//      consecutive codes, or column-major (d, ld) column after column,
//      consecutive threads on consecutive rows (the layout the count kernel
//      reads, which the particle filter hands on to it).  A thread storing its
//      own row straight to device memory would store at a stride of d bytes.
//      MUNIN's tile is 32 rows x 1044 bytes, 33 KB.  The previous slice's
//      codes are read column-major: the lanes of a warp read 32 consecutive
//      codes of one column.
//   2. The tile bounds the rows a multiprocessor holds (MUNIN: 6 tiles, 192
//      rows), and a row's nodes are a long chain: one thread per row (the
//      first kernel) left 6 warps a multiprocessor and ran 31x the bound.  So
//      up to 8 warps share a tile, as many as an average level's nodes
//      (ALARM's slice: 4): the nodes are cut into levels (a node's parents
//      all lie in earlier levels; MUNIN has 15), each level's nodes are dealt
//      out to the groups by their states, and the block synchronises after
//      each level.  Thread (row r, group g) draws group
//      g's nodes of each level for row r; the lanes of a warp are 32 rows of
//      one group, so they walk the same nodes.  Eight groups took MUNIN's
//      52,048-row sweep from 4.38 ms to 1.41 ms (two: 2.72, four: 1.59).
//   3. The node table is data: one int32 row per node (card, table offset,
//      noise offset, parent count, parents, strides), each node's column, and
//      the level schedule, uploaded once per sampler, and a per-call int32
//      mode per node (draw, clamp, evidence) with the evidence nodes in order;
//      all lanes read the same entries (a broadcast).
//   4. Randomness from a counter: Philox-4x32-10 keyed on one 64-bit draw from
//      the call's torch.Generator (read from device memory, so the host never
//      waits), counter (row, node, state / 4).  No state is carried between
//      threads or launches, the draws do not depend on the schedule, the same
//      seed gives the same codes, and the global generator is left alone.  An
//      explicit noise tensor (log E, states x rows) may replace the
//      generator: then the kernel's draws are the plain version's on the same
//      noise, to the bit.
//   5. The row's log weight is added in the tables' type in node order after
//      the last level, by the row's first group, as the plain version adds it.
//
// The wrapper (pgmpy_tpu_torch/ops/ancestral.py) builds the node table, plans
// the tile and calls the extern "C" launcher through ctypes on PyTorch's
// current stream; it returns the launch's cudaError_t.

#include <cuda_runtime.h>

#include <cstdint>

#include "race.cuh"

namespace {

using pgmpy_race::counter;
using pgmpy_race::philox;
using pgmpy_race::race;

// Node row (int32): card, table offset, noise offset, parent count, then
// `width` parents, then `width` strides.
constexpr int kHeader = 4;

// The flat row of node `nd`'s table: its parents' codes from the row's tile
// (parent index < d) or the previous slice (index d + column).
template <typename C>
__device__ __forceinline__ int flat_row(const int* __restrict__ nd, int width, const C* mine,
                                        int d, const C* __restrict__ prev, long long prev_ld,
                                        long long row) {
  int flat = 0;
  const int n_parents = __ldg(nd + 3);
  for (int j = 0; j < n_parents; ++j) {
    const int p = __ldg(nd + kHeader + j);
    const int v = p < d ? (int)mine[p] : (int)prev[(long long)(p - d) * prev_ld + row];
    flat += v * __ldg(nd + kHeader + width + j);
  }
  return flat;
}

// One node of one row: its code into the row's tile, at column `col`.
template <typename T, typename C>
__device__ __forceinline__ void draw_node(int i, int col, int m, const int* __restrict__ nd,
                                          int width, C* mine, long long row, long long n, int d,
                                          const T* __restrict__ tables,
                                          const long long* __restrict__ partial,
                                          const T* __restrict__ noise,
                                          const C* __restrict__ prev, long long prev_ld,
                                          uint2 key) {
  if (m >= 0) {  // clamped for every row
    mine[col] = (C)m;
    return;
  }
  if (m <= -2) {  // evidence: fixed (its weight is added after the last level)
    mine[col] = (C)(-2 - m);
    return;
  }
  const int card = __ldg(nd);
  const int flat = flat_row<C>(nd, width, mine, d, prev, prev_ld, row);
  const T* logits = tables + __ldg(nd + 1) + (long long)flat * card;
  int best = 0;
  T best_v = T(0);
  if (noise != nullptr) {
    const T* e = noise + (long long)__ldg(nd + 2) * n + row;
    best_v = logits[0] - e[0];
    for (int s = 1; s < card; ++s) {
      const T v = logits[s] - e[(long long)s * n];
      if (v > best_v) {
        best_v = v;
        best = s;
      }
    }
  } else {
    for (int s0 = 0; s0 < card; s0 += 4) {
      const uint4 r = philox(counter(row, i, s0), key);
      const unsigned bits[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int s = s0 + q;
        if (s < card) {
          const T v = race(logits[s], bits[q]);
          if (s == 0 || v > best_v) {
            best_v = v;
            best = s;
          }
        }
      }
    }
  }
  if (partial != nullptr) {
    const long long p = partial[row * d + i];
    if (p >= 0) best = (int)p;
  }
  mine[col] = (C)best;
}

// blockDim.x = rows * groups; thread t is row t % rows of group t / rows.
// out_ld == 0: out is row-major (n, d); else column-major (d, out_ld).
template <typename T, typename C>
__global__ void sweep_kernel(long long n, int d, int width, const int* __restrict__ nodes,
                             const int* __restrict__ columns, const int* __restrict__ schedule,
                             const int* __restrict__ starts, int n_levels, int groups,
                             const int* __restrict__ mode, const int* __restrict__ evidence,
                             int n_evidence, const T* __restrict__ tables,
                             const long long* __restrict__ partial, const T* __restrict__ noise,
                             const C* __restrict__ prev, long long prev_ld,
                             const unsigned long long* __restrict__ key, int stride,
                             C* __restrict__ out, long long out_ld, T* __restrict__ logw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* tile = reinterpret_cast<C*>(smem_raw);
  const int rows = blockDim.x / groups;
  const int r = threadIdx.x % rows, g = threadIdx.x / rows;
  const long long row0 = (long long)blockIdx.x * rows;
  const long long row = row0 + r;
  const bool active = row < n;
  const int row_len = kHeader + 2 * width;
  C* mine = tile + (long long)r * stride;
  const uint2 k = noise == nullptr ? pgmpy_race::launch_key(key) : make_uint2(0u, 0u);
  for (int level = 0; level < n_levels; ++level) {
    if (active) {
      const int hi = __ldg(starts + level * groups + g + 1);
      for (int x = __ldg(starts + level * groups + g); x < hi; ++x) {
        const int i = __ldg(schedule + x);
        draw_node<T, C>(i, __ldg(columns + i), __ldg(mode + i), nodes + (long long)i * row_len,
                        width, mine, row, n, d, tables, partial, noise, prev, prev_ld, k);
      }
    }
    __syncthreads();  // the level's codes are in the tile
  }
  if (active && g == 0 && logw != nullptr) {
    T lw = T(0);
    for (int e = 0; e < n_evidence; ++e) {
      const int i = __ldg(evidence + e);
      const int* nd = nodes + (long long)i * row_len;
      const int flat = flat_row<C>(nd, width, mine, d, prev, prev_ld, row);
      lw = lw + tables[__ldg(nd + 1) + (long long)flat * __ldg(nd) + (-2 - __ldg(mode + i))];
    }
    logw[row] = lw;
  }
  // the tile written out whole
  const int count = (int)min((long long)rows, n - row0);
  if (out_ld == 0) {  // row after row: consecutive threads on consecutive codes
    for (int rr = 0; rr < count; ++rr) {
      C* dst = out + (row0 + rr) * d;
      const C* src = tile + (long long)rr * stride;
      for (int c = threadIdx.x; c < d; c += blockDim.x) dst[c] = src[c];
    }
  } else {  // column after column: consecutive threads on consecutive rows
    for (int t = threadIdx.x; t < count * d; t += blockDim.x) {
      const int c = t / count, rr = t - c * count;
      out[(long long)c * out_ld + row0 + rr] = tile[(long long)rr * stride + c];
    }
  }
}

template <typename T, typename C>
cudaError_t launch_sweep(long long n, int d, int width, const void* nodes, const void* columns,
                         const void* schedule, const void* starts, int n_levels, int groups,
                         const void* mode, const void* evidence, int n_evidence,
                         const void* tables, const void* partial, const void* noise,
                         const void* prev, long long prev_ld, const void* key, int stride,
                         void* out, long long out_ld, void* logw, int threads, long long blocks,
                         long long smem, cudaStream_t stream) {
  sweep_kernel<T, C><<<(unsigned)blocks, threads, (size_t)smem, stream>>>(
      n, d, width, static_cast<const int*>(nodes), static_cast<const int*>(columns),
      static_cast<const int*>(schedule), static_cast<const int*>(starts), n_levels, groups,
      static_cast<const int*>(mode), static_cast<const int*>(evidence), n_evidence,
      static_cast<const T*>(tables), static_cast<const long long*>(partial),
      static_cast<const T*>(noise), static_cast<const C*>(prev), prev_ld,
      static_cast<const unsigned long long*>(key), stride, static_cast<C*>(out), out_ld,
      static_cast<T*>(logw));
  return cudaGetLastError();
}

}  // namespace

// One sweep of n rows over d nodes.  table_bytes: 4 (float) or 8 (double)
// log tables, noise and log weights; code_bytes: 1 (int8) or 4 (int32)
// codes.  out: row-major (n, d) when out_ld is 0, else column-major
// (d, out_ld), out_ld >= n.  nodes: d int32 rows of 4 + 2 * width entries
// (a parent index >= d is column index - d of prev); columns: the output
// column of each node (a permutation of 0 .. d - 1); schedule / starts: the
// nodes level by level, group by group (starts has n_levels * groups + 1
// offsets into schedule); mode: d int32 (-1 draw, s >= 0 clamp, -2 - s
// evidence); evidence: the n_evidence evidence nodes in order.  partial
// (int64 (n, d), -1 = draw), noise ((sum of cards, n)), prev (column-major
// codes (columns, prev_ld) of the previous slice) and logw (n) may be null;
// key (one uint64 on the card) is read when noise is null.  `threads` = rows
// * groups a block, each row `stride` codes of the shared tile (smem bytes).
extern "C" int pgmpy_ancestral_sweep(long long n, int d, int width, const void* nodes,
                                     const void* columns, const void* schedule,
                                     const void* starts, int n_levels, int groups,
                                     const void* mode, const void* evidence, int n_evidence,
                                     const void* tables, int table_bytes, const void* partial,
                                     const void* noise, const void* prev, long long prev_ld,
                                     const void* key, void* out, long long out_ld,
                                     int code_bytes, void* logw, int stride, int threads,
                                     long long blocks, long long smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width < 1 || groups < 1 || threads < groups || threads % groups != 0 ||
      (noise == nullptr && key == nullptr) || (out_ld != 0 && out_ld < n))
    return (int)cudaErrorInvalidValue;
#define PGMPY_SWEEP(T, C)                                                                      \
  return (int)launch_sweep<T, C>(n, d, width, nodes, columns, schedule, starts, n_levels,      \
                                 groups, mode, evidence, n_evidence, tables, partial, noise,   \
                                 prev, prev_ld, key, stride, out, out_ld, logw, threads,       \
                                 blocks, smem, s)
  if (table_bytes == 4 && code_bytes == 1) PGMPY_SWEEP(float, int8_t);
  if (table_bytes == 4 && code_bytes == 4) PGMPY_SWEEP(float, int32_t);
  if (table_bytes == 8 && code_bytes == 1) PGMPY_SWEEP(double, int8_t);
  if (table_bytes == 8 && code_bytes == 4) PGMPY_SWEEP(double, int32_t);
#undef PGMPY_SWEEP
  return (int)cudaErrorInvalidValue;
}
