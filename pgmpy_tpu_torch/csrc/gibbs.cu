// The Gibbs sweep for Hopper (sm_90a): one launch takes every chain through
// one systematic-scan sweep of a discrete Bayesian or Markov network.
//
//   for each chain r, for each variable i in the scan order:
//     logit[s] = sum over i's blanket factors k, in order, of
//                table_k[row_k][s],  row_k = sum_j code[r][o_kj] * stride_kj
//     code[r][i] = argmax_s (logit[s] - log E[r][i][s])
//   table_k: factor k's log table with i's axis moved last, (rows, card_i);
//   o_kj: the factor's other variables; E ~ Exp(1) clamped at 1e-20 (the
//   exponential race, race.cuh).  A variable in no factor is drawn uniform.
//
// Replaces, from the JAX package: pgmpy_tpu/sampling/gibbs.py:120
// `_conditional_logits`, :148 `_sweep` and :160 `_run_chains` (one sweep per
// step of the `scan` at :172).  The port's plain version (ops/gibbs.py) makes
// a few torch kernels per (variable, blanket factor) and per draw: 13,714
// per sweep of MUNIN.
//
// Bound: operations.  A sweep reads and writes n x d codes (MUNIN's 4,096 x
// 1041 int8: 8.5 MB, 0.003 ms at 3.35 TB/s); the log tables (MUNIN: 2,438
// (variable, factor) copies) stay in L2.  A draw costs, per state, one Philox
// block per four states, two logarithms and one add per blanket factor, and
// per factor one multiply-add per other variable (MUNIN: 5,651 states a
// chain).
//
// What the design does about it:
//   1. The order is the contract, and it allows parallelism.  Variable i is
//      drawn from the newest states of its blanket.  Its level is one more
//      than the highest level of its blanket neighbours earlier in the scan
//      (ops/ancestral.py:level_schedule on the moral graph oriented by the
//      scan order), so every earlier neighbour lies in an earlier level and
//      every later one in a later level: two variables of one level share no
//      factor, and drawing a level at once gives the sequential sweep's draws
//      exactly (MUNIN: 16 levels, HEPAR2 13, ALARM 11).
//   2. As in the ancestral sweep, a block's chains live in a shared tile (rows
//      x d codes, each row padded to an odd number of 4-byte words), read in
//      and written out whole and coalesced; `groups` warps share the tile,
//      thread (chain r, group g) drawing group g's variables of each level for
//      chain r, the block synchronised per level.  MUNIN's 4,096 chains fill
//      only 128 tiles of 32 chains, fewer than the card's 132 multiprocessors,
//      so the groups, not the tiles, fill each one: as many as an average
//      level's variables, at most 32 (ops/gibbs.py: GROUPS; MUNIN's sweep
//      took 0.451 ms with 8, 0.293 with 16, 0.247 with 32 on an H100).
//   3. A variable's blanket has no fixed width (MUNIN: 1 to 70 factors), so
//      the tables are CSR: per variable (card, noise offset, first factor,
//      factor count), per (variable, factor) (table offset, other count,
//      first other), per other (column, row stride).  A chunk of four states
//      is summed in registers over the factors, each factor's row formed
//      again per chunk (MUNIN averages 5.4 states a variable).
//   4. Randomness from a counter: Philox keyed on one 64-bit draw per sweep
//      from the call's generator, counter (chain, variable, state / 4).  The
//      draws do not depend on the schedule, and a run resumed from a
//      checkpoint of the generator continues as the uninterrupted run.  An
//      explicit noise tensor (log E, states x chains) may replace the
//      generator: then the logits are summed in the tables' type in factor
//      order and compared as the plain version does (the first maximum
//      wins), and the kernel's draws are the plain version's to the bit.
//
// The wrapper (pgmpy_tpu_torch/ops/gibbs.py) builds the tables and the
// schedule, plans the tile and calls the extern "C" launcher through ctypes
// on PyTorch's current stream; it returns the launch's cudaError_t.

#include <cuda_runtime.h>

#include <cstdint>

#include "race.cuh"

namespace {

using pgmpy_race::counter;
using pgmpy_race::philox;
using pgmpy_race::race;

constexpr int kVar = 4;   // card, noise offset, first factor, factor count
constexpr int kSpec = 3;  // table offset, other count, first other

// One variable of one chain: its new code into the chain's tile.
template <typename T, typename C>
__device__ __forceinline__ void draw_variable(int i, const int* __restrict__ vars,
                                              const int* __restrict__ specs,
                                              const int* __restrict__ others, C* mine,
                                              long long row, long long n,
                                              const T* __restrict__ tables,
                                              const T* __restrict__ noise, uint2 key) {
  const int* vr = vars + (long long)i * kVar;
  const int card = __ldg(vr), first_state = __ldg(vr + 1);
  const int k0 = __ldg(vr + 2), k1 = k0 + __ldg(vr + 3);
  int best = 0;
  T best_v = T(0);
  for (int s0 = 0; s0 < card; s0 += 4) {
    T acc[4] = {T(0), T(0), T(0), T(0)};
    for (int k = k0; k < k1; ++k) {
      const int* sp = specs + (long long)k * kSpec;
      const int* o = others + 2LL * __ldg(sp + 2);
      const int n_others = __ldg(sp + 1);
      int flat = 0;
      for (int j = 0; j < n_others; ++j) flat += (int)mine[__ldg(o + 2 * j)] * __ldg(o + 2 * j + 1);
      const T* t = tables + __ldg(sp) + (long long)flat * card + s0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (s0 + q < card) acc[q] = acc[q] + t[q];
      }
    }
    if (noise != nullptr) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int s = s0 + q;
        if (s < card) {
          const T v = acc[q] - noise[(long long)(first_state + s) * n + row];
          if (s == 0 || v > best_v) {
            best_v = v;
            best = s;
          }
        }
      }
    } else {
      const uint4 r = philox(counter(row, i, s0), key);
      const unsigned bits[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int s = s0 + q;
        if (s < card) {
          const T v = race(acc[q], bits[q]);
          if (s == 0 || v > best_v) {
            best_v = v;
            best = s;
          }
        }
      }
    }
  }
  mine[i] = (C)best;
}

// blockDim.x = rows * groups; thread t is chain t % rows of group t / rows.
// in and out are row-major (n, d) and may be the same buffer.
template <typename T, typename C>
__global__ void __launch_bounds__(1024)
    gibbs_sweep_kernel(long long n, int d, const int* __restrict__ vars,
                       const int* __restrict__ specs, const int* __restrict__ others,
                       const int* __restrict__ schedule, const int* __restrict__ starts,
                       int n_levels, int groups, const T* __restrict__ tables, const C* in,
                       const T* __restrict__ noise, const unsigned long long* __restrict__ key,
                       int stride, C* out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* tile = reinterpret_cast<C*>(smem_raw);
  const int rows = blockDim.x / groups;
  const int r = threadIdx.x % rows, g = threadIdx.x / rows;
  const long long row0 = (long long)blockIdx.x * rows;
  const int count = (int)min((long long)rows, n - row0);
  // the block's chains are count x d consecutive codes: read them whole
  const long long total = (long long)count * d;
  for (long long t = threadIdx.x; t < total; t += blockDim.x) {
    const int rr = (int)(t / d), c = (int)(t - (long long)rr * d);
    tile[(long long)rr * stride + c] = in[row0 * d + t];
  }
  __syncthreads();
  const uint2 k = noise == nullptr ? pgmpy_race::launch_key(key) : make_uint2(0u, 0u);
  const long long row = row0 + r;
  C* mine = tile + (long long)r * stride;
  for (int level = 0; level < n_levels; ++level) {
    if (r < count) {
      const int hi = __ldg(starts + level * groups + g + 1);
      for (int x = __ldg(starts + level * groups + g); x < hi; ++x) {
        draw_variable<T, C>(__ldg(schedule + x), vars, specs, others, mine, row, n, tables,
                            noise, k);
      }
    }
    __syncthreads();  // the level's codes are in the tile
  }
  for (long long t = threadIdx.x; t < total; t += blockDim.x) {
    const int rr = (int)(t / d), c = (int)(t - (long long)rr * d);
    out[row0 * d + t] = tile[(long long)rr * stride + c];
  }
}

template <typename T, typename C>
cudaError_t launch_gibbs(long long n, int d, const void* vars, const void* specs,
                         const void* others, const void* schedule, const void* starts,
                         int n_levels, int groups, const void* tables, const void* in,
                         const void* noise, const void* key, int stride, void* out, int threads,
                         long long blocks, long long smem, cudaStream_t stream) {
  gibbs_sweep_kernel<T, C><<<(unsigned)blocks, threads, (size_t)smem, stream>>>(
      n, d, static_cast<const int*>(vars), static_cast<const int*>(specs),
      static_cast<const int*>(others), static_cast<const int*>(schedule),
      static_cast<const int*>(starts), n_levels, groups, static_cast<const T*>(tables),
      static_cast<const C*>(in), static_cast<const T*>(noise),
      static_cast<const unsigned long long*>(key), stride, static_cast<C*>(out));
  return cudaGetLastError();
}

}  // namespace

// One sweep of n chains over d variables.  table_bytes: 4 (float) or 8
// (double) log tables and noise; code_bytes: 1 (int8) or 4 (int32) codes, in
// and out row-major (n, d) (out may be in).  vars: d int32 rows (card, noise
// offset, first factor, factor count); specs: int32 rows (table offset, other
// count, first other); others: (column, row stride) int32 pairs; schedule /
// starts: the variables level by level, group by group (starts has n_levels *
// groups + 1 offsets into schedule).  noise ((sum of cards, n), log E) may be
// null; key (one uint64 on the card) is read when it is.  `threads` = rows *
// groups a block (at most 1024), each row `stride` codes of the shared tile
// (smem bytes).
extern "C" int pgmpy_gibbs_sweep(long long n, int d, const void* vars, const void* specs,
                                 const void* others, const void* schedule, const void* starts,
                                 int n_levels, int groups, const void* tables, int table_bytes,
                                 const void* in, const void* noise, const void* key, void* out,
                                 int code_bytes, int stride, int threads, long long blocks,
                                 long long smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (groups < 1 || threads < groups || threads > 1024 || threads % groups != 0 ||
      (noise == nullptr && key == nullptr))
    return (int)cudaErrorInvalidValue;
#define PGMPY_GIBBS(T, C)                                                                      \
  return (int)launch_gibbs<T, C>(n, d, vars, specs, others, schedule, starts, n_levels, groups, \
                                 tables, in, noise, key, stride, out, threads, blocks, smem, s)
  if (table_bytes == 4 && code_bytes == 1) PGMPY_GIBBS(float, int8_t);
  if (table_bytes == 4 && code_bytes == 4) PGMPY_GIBBS(float, int32_t);
  if (table_bytes == 8 && code_bytes == 1) PGMPY_GIBBS(double, int8_t);
  if (table_bytes == 8 && code_bytes == 4) PGMPY_GIBBS(double, int32_t);
#undef PGMPY_GIBBS
  return (int)cudaErrorInvalidValue;
}
