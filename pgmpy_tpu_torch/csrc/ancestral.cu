// The ancestral sweep for Hopper (sm_90a): one launch draws every row of a
// discrete Bayesian network, node after node in topological order.  The same
// kernel draws one slice of the particle filter, whose nodes may also have
// parents in the previous slice.
//
//   for each row r, for each node i in order, into column c_i of the row:
//     clamp      code[r][c_i] = s                                (mode s >= 0)
//     evidence   code[r][c_i] = s; logw[r] += table_i[flat][s]   (mode -2 - s)
//     draw       code[r][c_i] = #{s : cdf_i[flat][s] <= u[r][i]}
//                (then replaced by partial[r][i] where that is >= 0)
//   flat = sum_j v_ij * stride_ij, where v_ij is code[r][p_ij] for a parent
//   index p_ij < d and prev[r][p_ij - d] (the previous slice) otherwise;
//   table_i its (rows, card) log CPD; cdf_i its (rows, card) cumulative
//   probabilities in double (ops/ancestral.py: cdf_rows); u a uniform in
//   [0, 1) per row and node: the inverse-CDF draw.  A state of zero
//   probability has the cumulative value of the state before it (0 for the
//   first), so no u picks it over a state of mass; the last state with mass
//   sits at exactly 1, above every u.
//
// Replaces, from the JAX package: pgmpy_tpu/sampling/core.py:173 `_forward`,
// :189 `_forward_partial` and :208 `_likelihood_weighted`, jitted loops over
// the nodes whose table rows come from `onehot_table_rows` (:34), a one-hot
// matrix product that suits the TPU's matrix unit and not this card; and
// pgmpy_tpu/sampling/smc.py:101 `_sweep`, the particle filter's slice inside
// the `scan` of `_filter_program` (:174, step :184).  The port's plain version
// (ops/ancestral.py) makes a handful of torch kernels per node: about 7,000
// per sweep of MUNIN, about 270 per slice of ALARM as a 2-TBN.
//
// Bound: bytes, in principle.  The sweep writes n x d codes (MUNIN's 52,048 x
// 1041 int8: 54 MB, 0.016 ms at 3.35 TB/s) and reads the tables (1.2 MB, in
// L2).  The work per row is a chain: a node's parents are the row's own
// earlier draws.  A draw costs a quarter of a Philox block (the uniform), the
// flat row, and (card + 1) / 2 16-byte reads and their compares; an
// exponential race would cost one Philox block per four states and two
// accurate logarithms per state (MUNIN: 5,651 states a row, 1041 nodes), and
// did cost 78% of a draw's cycles.
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
//      The previous slice's codes are read column-major: the lanes of a warp
//      read 32 consecutive codes of one column.  The rows a block holds are
//      chosen on the host for the most rows a multiprocessor holds at once
//      and the fewest rounds of blocks (ops/ancestral.py: plan_tile; past
//      48 KB a block opts in to more shared memory).
//   2. A row's nodes are a long chain, so up to 8 warps share a tile, as many
//      as an average level's nodes (ALARM's slice: 4): the nodes are cut into
//      levels (a node's parents all lie in earlier levels; MUNIN has 15),
//      each level's nodes are dealt out to the groups by their cost (a
//      Philox block, and a read per two states), and the block synchronises
//      after each level.  Thread (row r, group g) draws group g's nodes of
//      each level for row r; the lanes of a warp are 32 rows of one group, so
//      they walk the same nodes.
//   3. The draw is the inverse CDF: one 32-bit uniform per node, four
//      nodes' from one Philox block, the row of cumulative probabilities
//      read as double2 (each row padded on the host to an even count from a
//      16-byte boundary, the padding 2.0, above every u; up to four reads in
//      flight at once), and a branch-free count of the entries at or below
//      u.  No logarithm is taken.
//   4. The node table is data: one int32 row per node in schedule order
//      (card, log table offset, CDF offset, parent count, column, node index,
//      parents, strides; rows of a multiple of 16 bytes) and the level
//      schedule, uploaded once per sampler, and a per-call int32 mode per
//      node (draw, clamp, evidence) in the same order with the evidence
//      nodes' entries.  The block stages each level's rows and modes in
//      shared memory (16-byte copies into one of two buffers, done by the
//      threads that have drawn their share of the level before while the
//      others still draw), so a draw reads its node's row, and its parents,
//      from shared memory: read from L2, a row cost ~900 cycles a draw.
//      A level holds at most the nodes a stage buffer does (longer levels
//      are split); all lanes read the same entries (a broadcast).
//   5. Randomness from a counter: Philox-4x32-10 keyed on one 64-bit draw from
//      the call's torch.Generator (read from device memory, so the host never
//      waits), counter (row, x / 4, 0) for the node at schedule entry x, its
//      word x % 4 making u.  No state is carried between threads or
//      launches, the same seed gives the same codes, and the global
//      generator is left alone.  An explicit noise tensor (u, nodes x
//      rows, double) may replace the generator: then the kernel's draws are
//      the plain version's on the same noise, to the bit.
//   6. The row's log weight is added in the tables' type in node order after
//      the last level, by the row's first group, as the plain version adds it.
//
// The wrapper (pgmpy_tpu_torch/ops/ancestral.py) builds the node table and
// the CDF rows, plans the tile and calls the extern "C" launcher through
// ctypes on PyTorch's current stream; it returns the launch's cudaError_t.

#include <cuda_runtime.h>

#include <cstdint>

#include "race.cuh"

namespace {

using pgmpy_race::counter;
using pgmpy_race::philox;

// Node row (int32), in schedule order: card, log table offset, CDF offset (in
// doubles, even), parent count, output column, node index, then `width`
// parents, then `width` strides, padded to `row_ints`, a multiple of 4.
constexpr int kCard = 0, kLogOffset = 1, kCdfOffset = 2, kParents = 3, kColumn = 4, kNode = 5;
constexpr int kHeader = 6;

// The uniforms of one row: one Philox block gives the four schedule entries
// x = 4 b .. 4 b + 3 theirs, a 32-bit word each, (w + 1/2) 2^-32 in (0, 1),
// exact in double.  A thread draws its nodes of a level at consecutive
// entries, so one block serves up to four of its draws.
struct RowUniforms {
  uint4 bits;
  int block = -1;

  __device__ __forceinline__ double at(long long row, int x, uint2 key) {
    if ((x >> 2) != block) {
      block = x >> 2;
      bits = philox(counter(row, block, 0), key);
    }
    const int w = x & 3;
    const unsigned word = w == 0 ? bits.x : w == 1 ? bits.y : w == 2 ? bits.z : bits.w;
    return ((double)word + 0.5) * 2.3283064365386962890625e-10;  // 2^-32
  }
};

// The flat row of node `nd`'s table: its parents' codes from the row's tile
// (parent index < d) or the previous slice (index d + column).
template <typename C>
__device__ __forceinline__ int flat_row(const int* nd, int width, const C* mine, int d,
                                        const C* __restrict__ prev, long long prev_ld,
                                        long long row) {
  int flat = 0;
  const int n_parents = nd[kParents];
  for (int j = 0; j < n_parents; ++j) {
    const int p = nd[kHeader + j];
    const int v = p < d ? (int)mine[p] : (int)prev[(long long)(p - d) * prev_ld + row];
    flat += v * nd[kHeader + width + j];
  }
  return flat;
}

// Four pairs of a CDF row from pair h on (2.0, above every u, past the row),
// all in flight at once, counted against u.
__device__ __forceinline__ int count_pairs(const double2* __restrict__ c, int h, int pairs,
                                           double u) {
  double2 v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = h + q < pairs ? __ldg(c + h + q) : make_double2(2.0, 2.0);
  int below = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) below += (v[q].x <= u) + (v[q].y <= u);
  return below;
}

// One node of one row (its staged row `nd`, its mode m, its schedule entry
// x): its code into the row's tile.
template <typename C>
__device__ __forceinline__ void draw_node(int m, const int* nd, int x, int width, C* mine,
                                          long long row, long long n, int d,
                                          const double* __restrict__ cdf,
                                          const long long* __restrict__ partial,
                                          const double* __restrict__ noise,
                                          const C* __restrict__ prev, long long prev_ld,
                                          uint2 key, RowUniforms& uniforms) {
  const int col = nd[kColumn];
  if (m >= 0) {  // clamped for every row
    mine[col] = (C)m;
    return;
  }
  if (m <= -2) {  // evidence: fixed (its weight is added after the last level)
    mine[col] = (C)(-2 - m);
    return;
  }
  const int i = nd[kNode];
  const int pairs = (nd[kCard] + 1) >> 1;
  const int flat = flat_row<C>(nd, width, mine, d, prev, prev_ld, row);
  const double2* c = reinterpret_cast<const double2*>(cdf + nd[kCdfOffset]) +
                     (long long)flat * pairs;
  const double u = noise != nullptr ? noise[(long long)i * n + row] : uniforms.at(row, x, key);
  int best;
  if (pairs <= 2) {  // most nodes: up to four states, one or two reads
    const double2 v0 = __ldg(c);
    const double2 v1 = pairs == 2 ? __ldg(c + 1) : make_double2(2.0, 2.0);
    best = (v0.x <= u) + (v0.y <= u) + (v1.x <= u) + (v1.y <= u);
  } else {
    best = 0;
    for (int h = 0; h < pairs; h += 4) best += count_pairs(c, h, pairs, u);
  }
  if (partial != nullptr) {
    const long long p = partial[row * d + i];
    if (p >= 0) best = (int)p;
  }
  mine[col] = (C)best;
}

// The node rows and modes of schedule entries [first, last) into a stage
// buffer, by the whole block (16-byte copies: row_ints is a multiple of 4).
__device__ __forceinline__ void stage_level(const int* __restrict__ nodes,
                                            const int* __restrict__ mode, int first, int last,
                                            int row_ints, int* rows, int* modes) {
  const int4* src = reinterpret_cast<const int4*>(nodes + (long long)first * row_ints);
  int4* dst = reinterpret_cast<int4*>(rows);
  const int quads = (last - first) * (row_ints >> 2);
  for (int q = threadIdx.x; q < quads; q += blockDim.x) dst[q] = __ldg(src + q);
  for (int k = threadIdx.x; k < last - first; k += blockDim.x) modes[k] = __ldg(mode + first + k);
}

// blockDim.x = rows * groups; thread t is row t % rows of group t / rows.
// Shared memory: the tile (rows x stride codes, to a 16-byte boundary), then
// two stage buffers of stage_nodes node rows, then their two mode arrays.
// out_ld == 0: out is row-major (n, d); else column-major (d, out_ld).
template <typename T, typename C>
__global__ void sweep_kernel(long long n, int d, int width, int row_ints,
                             const int* __restrict__ nodes, const int* __restrict__ starts,
                             int n_levels, int groups, int stage_nodes,
                             const int* __restrict__ mode, const int* __restrict__ evidence,
                             int n_evidence, const T* __restrict__ tables,
                             const double* __restrict__ cdf,
                             const long long* __restrict__ partial,
                             const double* __restrict__ noise,
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
  C* mine = tile + (long long)r * stride;
  int* stage_rows = reinterpret_cast<int*>(
      smem_raw + (((long long)rows * stride * sizeof(C) + 15) & ~15LL));
  int* stage_modes = stage_rows + 2 * stage_nodes * row_ints;
  const uint2 k = noise == nullptr ? pgmpy_race::launch_key(key) : make_uint2(0u, 0u);
  if (n_levels > 0)
    stage_level(nodes, mode, __ldg(starts), __ldg(starts + groups), row_ints, stage_rows,
                stage_modes);
  __syncthreads();
  for (int level = 0; level < n_levels; ++level) {
    const int buf = level & 1;
    const int* level_rows = stage_rows + buf * stage_nodes * row_ints;
    const int* level_modes = stage_modes + buf * stage_nodes;
    const int first = __ldg(starts + level * groups);
    if (active) {
      const int hi = __ldg(starts + level * groups + g + 1);
      RowUniforms uniforms;
      for (int x = __ldg(starts + level * groups + g); x < hi; ++x)
        draw_node<C>(level_modes[x - first], level_rows + (x - first) * row_ints, x, width,
                     mine, row, n, d, cdf, partial, noise, prev, prev_ld, k, uniforms);
    }
    if (level + 1 < n_levels)  // the next level's rows, while slower groups draw
      stage_level(nodes, mode, __ldg(starts + (level + 1) * groups),
                  __ldg(starts + (level + 2) * groups), row_ints,
                  stage_rows + (buf ^ 1) * stage_nodes * row_ints,
                  stage_modes + (buf ^ 1) * stage_nodes);
    __syncthreads();  // the level's codes are in the tile, the next level staged
  }
  if (active && g == 0 && logw != nullptr) {
    T lw = T(0);
    for (int e = 0; e < n_evidence; ++e) {  // node order; evidence holds schedule entries
      const int x = __ldg(evidence + e);
      const int* nd = nodes + (long long)x * row_ints;
      const int flat = flat_row<C>(nd, width, mine, d, prev, prev_ld, row);
      lw = lw + tables[__ldg(nd + kLogOffset) + (long long)flat * __ldg(nd + kCard) +
                       (-2 - __ldg(mode + x))];
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
cudaError_t launch_sweep(long long n, int d, int width, int row_ints, const void* nodes,
                         const void* starts, int n_levels, int groups, int stage_nodes,
                         const void* mode, const void* evidence, int n_evidence,
                         const void* tables, const void* cdf, const void* partial,
                         const void* noise, const void* prev, long long prev_ld,
                         const void* key, int stride, void* out, long long out_ld, void* logw,
                         int threads, long long blocks, long long smem, cudaStream_t stream) {
  if (smem > 46 * 1024) {  // past the default 48 KB: the block opts in
    const cudaError_t err = cudaFuncSetAttribute(
        sweep_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  sweep_kernel<T, C><<<(unsigned)blocks, threads, (size_t)smem, stream>>>(
      n, d, width, row_ints, static_cast<const int*>(nodes), static_cast<const int*>(starts),
      n_levels, groups, stage_nodes, static_cast<const int*>(mode),
      static_cast<const int*>(evidence), n_evidence, static_cast<const T*>(tables),
      static_cast<const double*>(cdf), static_cast<const long long*>(partial),
      static_cast<const double*>(noise), static_cast<const C*>(prev), prev_ld,
      static_cast<const unsigned long long*>(key), stride, static_cast<C*>(out), out_ld,
      static_cast<T*>(logw));
  return cudaGetLastError();
}

}  // namespace

// One sweep of n rows over d nodes.  table_bytes: 4 (float) or 8 (double)
// log tables and log weights; cdf: the double CDF rows (each node's rows of
// (card + 1) / 2 double2 from an even offset); code_bytes: 1 (int8) or 4
// (int32) codes.  out: row-major (n, d) when out_ld is 0, else column-major
// (d, out_ld), out_ld >= n.  nodes: d int32 rows of row_ints entries in
// schedule order (a parent index >= d is column index - d of prev), 16-byte
// aligned; starts: n_levels * groups + 1 offsets into them, level by level,
// group by group, no level more than stage_nodes rows; mode: d int32 in
// schedule order (-1 draw, s >= 0 clamp, -2 - s evidence); evidence: the
// schedule entries of the n_evidence evidence nodes, in node order.  partial
// (int64 (n, d), -1 = draw), noise (double uniforms (d, n)), prev
// (column-major codes (columns, prev_ld) of the previous slice) and logw (n)
// may be null; key (one uint64 on the card) is read when noise is null.
// `threads` = rows * groups a block, each row `stride` codes of the shared
// tile; smem bytes hold the tile and the two stage buffers.
extern "C" int pgmpy_ancestral_sweep(long long n, int d, int width, int row_ints,
                                     const void* nodes, const void* starts, int n_levels,
                                     int groups, int stage_nodes, const void* mode,
                                     const void* evidence, int n_evidence, const void* tables,
                                     int table_bytes, const void* cdf, const void* partial,
                                     const void* noise, const void* prev, long long prev_ld,
                                     const void* key, void* out, long long out_ld,
                                     int code_bytes, void* logw, int stride, int threads,
                                     long long blocks, long long smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width < 1 || row_ints < kHeader + 2 * width || row_ints % 4 != 0 || groups < 1 ||
      threads < groups || threads % groups != 0 || stage_nodes < 1 || cdf == nullptr ||
      (noise == nullptr && key == nullptr) || (out_ld != 0 && out_ld < n))
    return (int)cudaErrorInvalidValue;
#define PGMPY_SWEEP(T, C)                                                                     \
  return (int)launch_sweep<T, C>(n, d, width, row_ints, nodes, starts, n_levels, groups,      \
                                 stage_nodes, mode, evidence, n_evidence, tables, cdf,        \
                                 partial, noise, prev, prev_ld, key, stride, out, out_ld,     \
                                 logw, threads, blocks, smem, s)
  if (table_bytes == 4 && code_bytes == 1) PGMPY_SWEEP(float, int8_t);
  if (table_bytes == 4 && code_bytes == 4) PGMPY_SWEEP(float, int32_t);
  if (table_bytes == 8 && code_bytes == 1) PGMPY_SWEEP(double, int8_t);
  if (table_bytes == 8 && code_bytes == 4) PGMPY_SWEEP(double, int32_t);
#undef PGMPY_SWEEP
  return (int)cudaErrorInvalidValue;
}

// The blocks of `threads` threads and `smem` bytes of shared memory a
// multiprocessor holds of the sweep for these types (the wrapper plans its
// tile from it).
extern "C" int pgmpy_ancestral_occupancy(int table_bytes, int code_bytes, int threads,
                                         long long smem, int* blocks) {
#define PGMPY_OCCUPANCY(T, C)                                                               \
  {                                                                                         \
    if (smem > 46 * 1024) {                                                                 \
      const cudaError_t err = cudaFuncSetAttribute(                                         \
          sweep_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);      \
      if (err != cudaSuccess) return (int)err;                                              \
    }                                                                                       \
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, sweep_kernel<T, C>,   \
                                                              threads, (size_t)smem);       \
  }
  if (table_bytes == 4 && code_bytes == 1) PGMPY_OCCUPANCY(float, int8_t);
  if (table_bytes == 4 && code_bytes == 4) PGMPY_OCCUPANCY(float, int32_t);
  if (table_bytes == 8 && code_bytes == 1) PGMPY_OCCUPANCY(double, int8_t);
  if (table_bytes == 8 && code_bytes == 4) PGMPY_OCCUPANCY(double, int32_t);
#undef PGMPY_OCCUPANCY
  return (int)cudaErrorInvalidValue;
}
