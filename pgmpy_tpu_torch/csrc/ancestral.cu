// The ancestral sweep for Hopper (sm_90a): one launch draws every row of a
// discrete Bayesian network, node after node in topological order.
//
//   for each row r, for each node i in order:
//     clamp      code[r][i] = s                                (mode s >= 0)
//     evidence   code[r][i] = s; logw[r] += table_i[flat][s]   (mode -2 - s)
//     draw       code[r][i] = argmax_s (table_i[flat][s] - log E[r][i][s])
//                (then replaced by partial[r][i] where that is >= 0)
//   flat = sum_j code[r][parent_ij] * stride_ij, table_i its (rows, card)
//   log CPD; E ~ Exp(1) clamped at 1e-20: the exponential race, a
//   categorical draw that never picks a state of zero probability against
//   one of real mass.
//
// Replaces, from the JAX package: pgmpy_tpu/sampling/core.py:173 `_forward`,
// :189 `_forward_partial` and :208 `_likelihood_weighted`, jitted loops over
// the nodes whose table rows come from `onehot_table_rows` (:34), a one-hot
// matrix product that suits the TPU's matrix unit and not this card.  The
// port's plain version (ops/ancestral.py) makes a handful of torch kernels
// per node: 7,227 per sweep of MUNIN.
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
//      out whole: row after row, consecutive threads on consecutive codes.  A
//      thread storing its own row straight to device memory would store at a
//      stride of d bytes.  MUNIN's tile is 32 rows x 1044 bytes, 33 KB.
//   2. The tile bounds the rows a multiprocessor holds (MUNIN: 6 tiles, 192
//      rows), and a row's nodes are a long chain: one thread per row (the
//      first kernel) left 6 warps a multiprocessor and ran 31x the bound.  So
//      GROUPS warps share a tile: the nodes are cut into levels (a node's
//      parents all lie in earlier levels; MUNIN has 15), each level's nodes
//      are dealt out to the groups by their states, and the block
//      synchronises after each level.  Thread (row r, group g) draws group
//      g's nodes of each level for row r; the lanes of a warp are 32 rows of
//      one group, so they walk the same nodes.  Eight groups took MUNIN's
//      52,048-row sweep from 4.38 ms to 1.41 ms (two: 2.72, four: 1.59).
//   3. The node table is data: one int32 row per node (card, table offset,
//      noise offset, parent count, parents, strides) and the level schedule,
//      uploaded once per sampler, and a per-call int32 mode per node (draw,
//      clamp, evidence) with the evidence nodes in order; all lanes read the
//      same entries (a broadcast).
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

namespace {

// Node row (int32): card, table offset, noise offset, parent count, then
// `width` parents, then `width` strides.
constexpr int kHeader = 4;

__device__ __forceinline__ uint4 philox(uint4 c, uint2 k) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    if (round) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const unsigned lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const unsigned lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// logit - log(max(E, 1e-20)), E = -log(U), U uniform in (0, 1) from 32 bits
__device__ __forceinline__ float race(float logit, unsigned x) {
  const float u = ((float)(x >> 9) + 0.5f) * 1.1920928955078125e-07f;  // 2^-23
  return logit - logf(fmaxf(-logf(u), 1e-20f));
}

__device__ __forceinline__ double race(double logit, unsigned x) {
  const double u = ((double)x + 0.5) * 2.3283064365386962890625e-10;  // 2^-32
  return logit - log(fmax(-log(u), 1e-20));
}

// One node of one row: its code into the row's tile.
template <typename T, typename C>
__device__ __forceinline__ void draw_node(int i, int m, const int* __restrict__ nd, int width,
                                          C* mine, long long row, long long n, int d,
                                          const T* __restrict__ tables,
                                          const long long* __restrict__ partial,
                                          const T* __restrict__ noise, uint2 key) {
  if (m >= 0) {  // clamped for every row
    mine[i] = (C)m;
    return;
  }
  if (m <= -2) {  // evidence: fixed (its weight is added after the last level)
    mine[i] = (C)(-2 - m);
    return;
  }
  const int card = __ldg(nd);
  const int n_parents = __ldg(nd + 3);
  int flat = 0;
  for (int j = 0; j < n_parents; ++j) {
    flat += (int)mine[__ldg(nd + kHeader + j)] * __ldg(nd + kHeader + width + j);
  }
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
      const uint4 r = philox(
          make_uint4((unsigned)row, (unsigned)(row >> 32), (unsigned)i, (unsigned)(s0 >> 2)), key);
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
  mine[i] = (C)best;
}

// blockDim.x = rows * groups; thread t is row t % rows of group t / rows.
template <typename T, typename C>
__global__ void sweep_kernel(long long n, int d, int width, const int* __restrict__ nodes,
                             const int* __restrict__ schedule, const int* __restrict__ starts,
                             int n_levels, int groups, const int* __restrict__ mode,
                             const int* __restrict__ evidence, int n_evidence,
                             const T* __restrict__ tables, const long long* __restrict__ partial,
                             const T* __restrict__ noise, const unsigned long long* __restrict__ key,
                             int stride, C* __restrict__ out, T* __restrict__ logw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* tile = reinterpret_cast<C*>(smem_raw);
  const int rows = blockDim.x / groups;
  const int r = threadIdx.x % rows, g = threadIdx.x / rows;
  const long long row0 = (long long)blockIdx.x * rows;
  const long long row = row0 + r;
  const bool active = row < n;
  const int row_len = kHeader + 2 * width;
  C* mine = tile + (long long)r * stride;
  uint2 k = make_uint2(0u, 0u);
  if (noise == nullptr) {
    const unsigned long long seed = *key;
    k = make_uint2((unsigned)seed, (unsigned)(seed >> 32));
  }
  for (int level = 0; level < n_levels; ++level) {
    if (active) {
      const int hi = __ldg(starts + level * groups + g + 1);
      for (int x = __ldg(starts + level * groups + g); x < hi; ++x) {
        const int i = __ldg(schedule + x);
        draw_node<T, C>(i, __ldg(mode + i), nodes + (long long)i * row_len, width, mine, row,
                        n, d, tables, partial, noise, k);
      }
    }
    __syncthreads();  // the level's codes are in the tile
  }
  if (active && g == 0 && logw != nullptr) {
    T lw = T(0);
    for (int e = 0; e < n_evidence; ++e) {
      const int i = __ldg(evidence + e);
      const int* nd = nodes + (long long)i * row_len;
      int flat = 0;
      for (int j = 0; j < __ldg(nd + 3); ++j) {
        flat += (int)mine[__ldg(nd + kHeader + j)] * __ldg(nd + kHeader + width + j);
      }
      lw = lw + tables[__ldg(nd + 1) + (long long)flat * __ldg(nd) + (-2 - __ldg(mode + i))];
    }
    logw[row] = lw;
  }
  // the tile's rows, written out whole: consecutive threads on consecutive codes
  const int count = (int)min((long long)rows, n - row0);
  for (int rr = 0; rr < count; ++rr) {
    C* dst = out + (row0 + rr) * d;
    const C* src = tile + (long long)rr * stride;
    for (int c = threadIdx.x; c < d; c += blockDim.x) dst[c] = src[c];
  }
}

template <typename T, typename C>
cudaError_t launch_sweep(long long n, int d, int width, const void* nodes, const void* schedule,
                         const void* starts, int n_levels, int groups, const void* mode,
                         const void* evidence, int n_evidence, const void* tables,
                         const void* partial, const void* noise, const void* key, int stride,
                         void* out, void* logw, int threads, long long blocks, long long smem,
                         cudaStream_t stream) {
  sweep_kernel<T, C><<<(unsigned)blocks, threads, (size_t)smem, stream>>>(
      n, d, width, static_cast<const int*>(nodes), static_cast<const int*>(schedule),
      static_cast<const int*>(starts), n_levels, groups, static_cast<const int*>(mode),
      static_cast<const int*>(evidence), n_evidence, static_cast<const T*>(tables),
      static_cast<const long long*>(partial), static_cast<const T*>(noise),
      static_cast<const unsigned long long*>(key), stride, static_cast<C*>(out),
      static_cast<T*>(logw));
  return cudaGetLastError();
}

}  // namespace

// One sweep of n rows over d nodes.  table_bytes: 4 (float) or 8 (double)
// log tables, noise and log weights; code_bytes: 1 (int8) or 4 (int32) codes,
// out row-major (n, d).  nodes: d int32 rows of 4 + 2 * width entries;
// schedule / starts: the nodes level by level, group by group (starts has
// n_levels * groups + 1 offsets into schedule); mode: d int32 (-1 draw, s >= 0
// clamp, -2 - s evidence); evidence: the n_evidence evidence nodes in order.
// partial (int64 (n, d), -1 = draw), noise ((sum of cards, n)) and logw (n)
// may be null; key (one uint64 on the card) is read when noise is null.
// `threads` = rows * groups a block, each row `stride` codes of the shared
// tile (smem bytes).
extern "C" int pgmpy_ancestral_sweep(long long n, int d, int width, const void* nodes,
                                     const void* schedule, const void* starts, int n_levels,
                                     int groups, const void* mode, const void* evidence,
                                     int n_evidence, const void* tables, int table_bytes,
                                     const void* partial, const void* noise, const void* key,
                                     void* out, int code_bytes, void* logw, int stride,
                                     int threads, long long blocks, long long smem,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width < 1 || groups < 1 || threads < groups || threads % groups != 0 ||
      (noise == nullptr && key == nullptr))
    return (int)cudaErrorInvalidValue;
#define PGMPY_SWEEP(T, C)                                                                     \
  return (int)launch_sweep<T, C>(n, d, width, nodes, schedule, starts, n_levels, groups, mode, \
                                 evidence, n_evidence, tables, partial, noise, key, stride,    \
                                 out, logw, threads, blocks, smem, s)
  if (table_bytes == 4 && code_bytes == 1) PGMPY_SWEEP(float, int8_t);
  if (table_bytes == 4 && code_bytes == 4) PGMPY_SWEEP(float, int32_t);
  if (table_bytes == 8 && code_bytes == 1) PGMPY_SWEEP(double, int8_t);
  if (table_bytes == 8 && code_bytes == 4) PGMPY_SWEEP(double, int32_t);
#undef PGMPY_SWEEP
  return (int)cudaErrorInvalidValue;
}
