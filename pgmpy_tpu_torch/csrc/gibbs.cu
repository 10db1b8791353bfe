// The Gibbs sweep for Hopper (sm_90a): one launch takes every chain through
// one systematic-scan sweep of a discrete Bayesian or Markov network.
//
//   for each chain r, for each variable i in the scan order:
//     logit[s] = sum over i's blanket factors k of table_k[row_k][s],
//                row_k = sum_j code[r][o_kj] * stride_kj
//     code[r][i] = argmax_s (logit[s] - log E[r][i][s])
//   table_k: factor k's log table with i's axis moved last, (rows, card_i);
//   o_kj: the factor's other variables; E ~ Exp(1) clamped at 1e-20 (the
//   exponential race, race.cuh).  A variable in no factor is drawn uniform.
//   The sum's association is fixed by the network alone: a variable's
//   factors are cut into pieces of at most kPieceFactors (ops/gibbs.py:
//   piece_cuts), each piece summed in factor order from zero, the pieces'
//   sums added in piece order.
//
// Replaces, from the JAX package: pgmpy_tpu/sampling/gibbs.py:120
// `_conditional_logits`, :148 `_sweep` and :160 `_run_chains` (one sweep per
// step of the `scan` at :172).  The port's plain version (ops/gibbs.py) makes
// a few torch kernels per (variable, blanket factor) and per draw: 13,714
// per sweep of MUNIN.
//
// Bound: operations.  A sweep reads and writes n x d codes (MUNIN's 4,096 x
// 1041 int8: 8.5 MB, 0.003 ms at 3.35 TB/s); the log tables stay in L2 or
// in shared memory.  A draw costs, per state, one Philox block per four
// states, two logarithms and one add per blanket factor, and per factor one
// multiply-add per other variable (MUNIN: 5,651 states a chain).  The work
// of one chain is a chain of dependent memory reads (the factor's spec, the
// other variables' codes, the table entry), level after level, so the
// kernel is latency-bound long before either bound.
//
// What the design does about it:
//   1. The order is the contract, and it allows parallelism.  Variable i is
//      drawn from the newest states of its blanket.  Its level is one more
//      than the highest level of its blanket neighbours earlier in the scan
//      (ops/gibbs.py:blanket_levels), so two variables of one level share no
//      factor, and drawing a level at once gives the sequential sweep's
//      draws exactly (MUNIN: 16 levels, HEPAR2 13, ALARM 11).
//   2. A level is bounded by its mean load, not by its heaviest variable.
//      The work of a level is a list of pieces, (variable, range of at most
//      kPieceFactors blanket factors), dealt to `groups` threads per chain by
//      load.  A variable of one piece is drawn by the thread that sums it.
//      A variable of several pieces has each piece's sums written to a
//      scratch row of the chain in shared memory; after a barrier one
//      thread adds them in piece order and draws (MUNIN's level 0: one
//      variable of 5 states and 70 factors, 9 pieces).
//   3. A piece forms each factor's row once: the row bases of its (at most
//      8) factors are held in registers, and the states are read four at a
//      time as one 16-byte load per factor (every table row padded to a
//      multiple of four entries, every table from a 32-byte boundary, so a
//      float row of 5 to 8 states is one sector), the factors' loads
//      independent of one another.
//   4. Tables that fit (HEPAR2: 11,182 entries, 18,888 padded, 75 KB in
//      float) are staged into shared memory once a block; the others
//      (MUNIN: 297,219 entries, 393,096 padded) are read through L1 from L2.
//      The int32 plan (variables, specs, others, pieces, schedules; MUNIN
//      105 KB) is staged beside them where the block's shared memory holds
//      it: every piece starts with a chain of dependent reads of it.
//   5. The tile: a block holds its chains' codes in shared memory (rows x d
//      codes, each row padded to an odd number of 4-byte words), read in and
//      written out whole and coalesced; thread (chain r, group g) works
//      group g's pieces for chain r.  The wrapper plans the grid from the
//      chain count and the card's multiprocessors: at least one block per
//      multiprocessor, the chains dealt evenly over the blocks (MUNIN's
//      4,096 chains: 132 blocks of 31 or 32).
//   6. Randomness from a counter: Philox keyed on one 64-bit draw per sweep
//      from the call's generator, counter (chain, variable, state / 4).  The
//      draws do not depend on the schedule, and a run resumed from a
//      checkpoint of the generator continues as the uninterrupted run.  An
//      explicit noise tensor (log E, states x chains) may replace the
//      generator: then the logits are compared as the plain version does
//      (the first maximum wins), and the kernel's draws are the plain
//      version's to the bit.
//
// The wrapper (pgmpy_tpu_torch/ops/gibbs.py) builds the tables, pieces and
// schedule, plans the grid and calls the extern "C" launcher through ctypes
// on PyTorch's current stream; it returns the launch's cudaError_t.

#include <cuda_runtime.h>

#include <cstdint>

#include "race.cuh"

namespace {

using pgmpy_race::counter;
using pgmpy_race::philox;
using pgmpy_race::race;

constexpr int kVar = 4;           // card, noise offset, first factor, factor count
constexpr int kSpec = 3;          // table offset, other count, first other
constexpr int kPiece = 4;         // variable, first factor, factor count, slot (-1: drawn here)
constexpr int kCombine = 3;       // variable, first slot, pieces
constexpr int kPieceFactors = 8;  // ops/gibbs.py: PIECE_FACTORS

// One int of the launch plan, which lies in shared memory or in global memory
__device__ __forceinline__ int ld(const int* p) { return *p; }

// acc += four consecutive entries at p (16-byte aligned): from shared memory
// when the tables are staged, else through the read-only path from L2
template <bool STAGED>
__device__ __forceinline__ void add4(float (&acc)[4], const float* p) {
  const float4 v = STAGED ? *reinterpret_cast<const float4*>(p)
                          : __ldg(reinterpret_cast<const float4*>(p));
  acc[0] += v.x;
  acc[1] += v.y;
  acc[2] += v.z;
  acc[3] += v.w;
}

template <bool STAGED>
__device__ __forceinline__ void add4(double (&acc)[4], const double* p) {
  const double2 a = STAGED ? *reinterpret_cast<const double2*>(p)
                           : __ldg(reinterpret_cast<const double2*>(p));
  const double2 b = STAGED ? *reinterpret_cast<const double2*>(p + 2)
                           : __ldg(reinterpret_cast<const double2*>(p + 2));
  acc[0] += a.x;
  acc[1] += a.y;
  acc[2] += b.x;
  acc[3] += b.y;
}

// The race over states s0 .. s0 + 3 of variable i: the running argmax
template <typename T>
__device__ __forceinline__ void race_chunk(const T (&acc)[4], int s0, int card, int first_state,
                                           int i, long long row, long long n,
                                           const T* __restrict__ noise, uint2 key, int& best,
                                           T& best_v) {
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

// One piece of one chain: the sums of its factors' rows, drawn here when the
// piece is the whole variable, else written to the chain's scratch slots.
template <typename T, typename C, bool STAGED>
__device__ __forceinline__ void work_piece(const int* __restrict__ piece,
                                           const int* __restrict__ vars,
                                           const int* __restrict__ specs,
                                           const int* __restrict__ others, C* mine, long long row,
                                           long long n, const T* tables,
                                           const T* __restrict__ noise, uint2 key, T* scratch,
                                           int rows, int r) {
  const int i = ld(piece), k0 = ld(piece + 1), nk = ld(piece + 2);
  const int slot = ld(piece + 3);
  const int card = ld(vars + i * kVar), first_state = ld(vars + i * kVar + 1);
  const int width = (card + 3) & ~3;
  int base[kPieceFactors];
#pragma unroll
  for (int q = 0; q < kPieceFactors; ++q) {
    base[q] = 0;
    if (q < nk) {
      const int* sp = specs + (k0 + q) * kSpec;
      const int* o = others + 2 * ld(sp + 2);
      const int n_others = ld(sp + 1);
      int flat = 0;
      for (int j = 0; j < n_others; ++j) flat += (int)mine[ld(o + 2 * j)] * ld(o + 2 * j + 1);
      base[q] = ld(sp) + flat * width;
    }
  }
  int best = 0;
  T best_v = T(0);
  for (int s0 = 0; s0 < card; s0 += 4) {
    T acc[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
    for (int q = 0; q < kPieceFactors; ++q) {
      if (q < nk) add4<STAGED>(acc, tables + base[q] + s0);
    }
    if (slot < 0) {
      race_chunk<T>(acc, s0, card, first_state, i, row, n, noise, key, best, best_v);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (s0 + q < card) scratch[(long long)(slot + s0 + q) * rows + r] = acc[q];
      }
    }
  }
  if (slot < 0) mine[i] = (C)best;
}

// A variable of several pieces: its pieces' sums added in piece order, drawn
template <typename T, typename C>
__device__ __forceinline__ void combine_pieces(const int* __restrict__ comb,
                                               const int* __restrict__ vars, C* mine,
                                               long long row, long long n,
                                               const T* __restrict__ noise, uint2 key,
                                               const T* scratch, int rows, int r) {
  const int i = ld(comb), slot = ld(comb + 1), n_pieces = ld(comb + 2);
  const int card = ld(vars + i * kVar), first_state = ld(vars + i * kVar + 1);
  int best = 0;
  T best_v = T(0);
  for (int s0 = 0; s0 < card; s0 += 4) {
    T acc[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      acc[q] = s0 + q < card ? scratch[(long long)(slot + s0 + q) * rows + r] : T(0);
    }
    for (int p = 1; p < n_pieces; ++p) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (s0 + q < card)
          acc[q] = acc[q] + scratch[(long long)(slot + p * card + s0 + q) * rows + r];
      }
    }
    race_chunk<T>(acc, s0, card, first_state, i, row, n, noise, key, best, best_v);
  }
  mine[i] = (C)best;
}

__host__ __device__ constexpr long long align16(long long bytes) { return (bytes + 15) & ~15LL; }

// Where each part of the int32 launch plan starts: variables, specs, others,
// pieces, combines, piece schedule and starts, combine schedule and starts;
// and its length (a multiple of 4)
struct PlanLayout {
  int at[9];
  int total;
};

// blockDim.x = rows * groups; thread t is chain t % rows of group t / rows.
// Block b holds chains [b q + min(b, rem), ...), q + (b < rem) of them.  in
// and out are row-major (n, d) and may be the same buffer.  Shared memory,
// each part from a 16-byte boundary: the tile (rows x stride codes), the
// scratch (slots x rows), the staged tables (`staged` padded entries, when
// STAGED), the plan (when plan_staged).
template <typename T, typename C, bool STAGED>
__global__ void __launch_bounds__(1024)
    gibbs_sweep_kernel(long long n, int d, const int* __restrict__ plan, PlanLayout layout,
                       int plan_staged, int n_levels, int groups, const T* __restrict__ tables,
                       long long staged, const C* in, const T* __restrict__ noise,
                       const unsigned long long* __restrict__ key, int stride, int rows,
                       long long q, long long rem, int slots, C* out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* tile = reinterpret_cast<C*>(smem_raw);
  T* scratch = reinterpret_cast<T*>(smem_raw + align16((long long)rows * stride * sizeof(C)));
  unsigned char* past = reinterpret_cast<unsigned char*>(scratch) +
                        align16((long long)slots * rows * sizeof(T));
  const T* tab = tables;
  if (STAGED) {
    T* copy = reinterpret_cast<T*>(past);
    const long long units = staged * (long long)sizeof(T) / 16;
    for (long long u = threadIdx.x; u < units; u += blockDim.x)
      reinterpret_cast<int4*>(copy)[u] = __ldg(reinterpret_cast<const int4*>(tables) + u);
    tab = copy;
    past += align16(staged * (long long)sizeof(T));
  }
  const int* base = plan;
  if (plan_staged) {
    int* copy = reinterpret_cast<int*>(past);
    for (int u = threadIdx.x; u < layout.total / 4; u += blockDim.x)
      reinterpret_cast<int4*>(copy)[u] = __ldg(reinterpret_cast<const int4*>(plan) + u);
    base = copy;
  }
  const int *vars = base + layout.at[0], *specs = base + layout.at[1];
  const int *others = base + layout.at[2], *pieces = base + layout.at[3];
  const int *combines = base + layout.at[4], *sched_a = base + layout.at[5];
  const int *starts_a = base + layout.at[6], *sched_b = base + layout.at[7];
  const int* starts_b = base + layout.at[8];
  const int r = threadIdx.x % rows, g = threadIdx.x / rows;
  const long long b = blockIdx.x;
  const long long row0 = b * q + (b < rem ? b : rem);
  const int count = (int)(q + (b < rem ? 1 : 0));
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
    const int at = level * groups + g;
    if (r < count) {
      const int hi = ld(starts_a + at + 1);
      for (int x = ld(starts_a + at); x < hi; ++x)
        work_piece<T, C, STAGED>(pieces + ld(sched_a + x) * kPiece, vars, specs, others, mine,
                                 row, n, tab, noise, k, scratch, rows, r);
    }
    __syncthreads();  // the level's codes and partial sums are in shared memory
    if (ld(starts_b + level * groups) != ld(starts_b + (level + 1) * groups)) {
      if (r < count) {
        const int hi = ld(starts_b + at + 1);
        for (int x = ld(starts_b + at); x < hi; ++x)
          combine_pieces<T, C>(combines + ld(sched_b + x) * kCombine, vars, mine, row, n,
                               noise, k, scratch, rows, r);
      }
      __syncthreads();  // the split variables' codes are in the tile
    }
  }
  for (long long t = threadIdx.x; t < total; t += blockDim.x) {
    const int rr = (int)(t / d), c = (int)(t - (long long)rr * d);
    out[row0 * d + t] = tile[(long long)rr * stride + c];
  }
}

template <typename T, typename C, bool STAGED>
cudaError_t launch_gibbs(long long n, int d, const int* plan, const PlanLayout& layout,
                         int plan_staged, int n_levels, int groups, const void* tables,
                         long long staged, const void* in, const void* noise, const void* key,
                         int stride, int rows, long long blocks, int slots, long long smem,
                         void* out, cudaStream_t stream) {
  auto kernel = gibbs_sweep_kernel<T, C, STAGED>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long q = n / blocks, rem = n % blocks;
  kernel<<<(unsigned)blocks, rows * groups, (size_t)smem, stream>>>(
      n, d, plan, layout, plan_staged, n_levels, groups, static_cast<const T*>(tables), staged,
      static_cast<const C*>(in), static_cast<const T*>(noise),
      static_cast<const unsigned long long*>(key), stride, rows, q, rem, slots,
      static_cast<C*>(out));
  return cudaGetLastError();
}

}  // namespace

// One sweep of n chains over d variables.  table_bytes: 4 (float) or 8
// (double) log tables and noise; code_bytes: 1 (int8) or 4 (int32) codes, in
// and out row-major (n, d) (out may be in).  plan: one int32 buffer of
// plan_ints (a multiple of 4) holding, at the offsets sections[0..8], the
// variables (card, noise offset, first factor, factor count), the factor
// specs (padded table offset, other count, first other), the others
// (column, row stride), the pieces (variable, first factor, factor count,
// slot), the combines (variable, first slot, pieces), and the level
// schedules of pieces and combines with their starts (n_levels * groups + 1
// offsets each); plan_staged copies it into shared memory.  staged: the
// padded tables' entries copied into shared memory, 0 to read them from L2.
// noise ((sum of cards, n), log E) may be null; key (one uint64 on the card)
// is read when it is.  Each of `blocks` blocks has rows * groups threads (at
// most 1024); smem: the tile of rows x stride codes, slots x rows scratch
// sums, the staged tables and the staged plan, each from a 16-byte boundary.
extern "C" int pgmpy_gibbs_sweep(long long n, int d, const void* plan, const void* sections,
                                 int plan_ints, int plan_staged, int n_levels, int groups,
                                 const void* tables, int table_bytes, long long staged,
                                 const void* in, const void* noise, const void* key, void* out,
                                 int code_bytes, int stride, int rows, long long blocks,
                                 int slots, long long smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (groups < 1 || rows < 1 || rows * groups > 1024 || blocks < 1 ||
      plan_ints % 4 != 0 || (noise == nullptr && key == nullptr))
    return (int)cudaErrorInvalidValue;
  const int* p = static_cast<const int*>(plan);
  PlanLayout layout;
  for (int i = 0; i < 9; ++i) layout.at[i] = (int)static_cast<const long long*>(sections)[i];
  layout.total = plan_ints;
#define PGMPY_GIBBS(T, C)                                                                     \
  return (int)(staged ? launch_gibbs<T, C, true>(n, d, p, layout, plan_staged, n_levels,      \
                                                 groups, tables, staged, in, noise, key,      \
                                                 stride, rows, blocks, slots, smem, out, s)   \
                      : launch_gibbs<T, C, false>(n, d, p, layout, plan_staged, n_levels,     \
                                                  groups, tables, 0, in, noise, key, stride,  \
                                                  rows, blocks, slots, smem, out, s))
  if (table_bytes == 4 && code_bytes == 1) PGMPY_GIBBS(float, int8_t);
  if (table_bytes == 4 && code_bytes == 4) PGMPY_GIBBS(float, int32_t);
  if (table_bytes == 8 && code_bytes == 1) PGMPY_GIBBS(double, int8_t);
  if (table_bytes == 8 && code_bytes == 4) PGMPY_GIBBS(double, int32_t);
#undef PGMPY_GIBBS
  return (int)cudaErrorInvalidValue;
}
