// Junction-tree calibration kernels for Hopper (sm_90a): the clique
// potentials and the two-pass messages of one calibration, wave by wave.
//
//   clique_potentials  arena[c][x] = prod_f factor_f[x restricted to f's axes]
//                      (1 for a clique with no factor), ONE launch for all cliques
//   sepset_wave        per message m = (src -> dst over edge e) of a wave:
//                      sigma[j] = sum (or max) of src over the entries that
//                      project onto sepset entry j (canonical sepset order);
//                      with normalize_messages sigma /= max(sum sigma, TINY);
//                      ratio = fresh ? sigma : sigma / max(mu_e, TINY); mu_e = sigma
//   absorb_wave        dst[x] *= ratio_m[x restricted to the sepset], for every
//                      message of the wave into dst, in schedule order
//
// Replaces, from the JAX package: pgmpy_tpu/inference/bp.py:396
// (JunctionTreeProgram._build): stage0 at :406-420, the fused two-pass
// schedule at :436-465 and the chunked segments at :467-545, which XLA
// compiles and fuses.  Here the schedule is DATA: int64 descriptor tables
// (pgmpy_tpu_torch/ops/jt.py:build_plan) uploaded once per program, so a new
// tree never recompiles anything.  The messages of one wave are independent
// (upward: sources of one height; downward: destinations of one depth; the
// sources of a wave are never its destinations), so a wave is one launch of
// sepset_wave and one of absorb_wave: MUNIN's 662-710 messages (the tree
// follows PYTHONHASHSEED) take 1 + 2 x 26-34 launches against about 3,000
// eager kernels.
//
// Bound: bytes.  A calibration must write every clique once in stage 0
// (reading its factors), read each source once per wave it sends in (a
// downward wave's messages to a parent's children share one read of it), read
// and write each destination once per wave it receives in, and read and write
// the sepsets.  On MUNIN (76.6 M clique entries, f32) that is under 1 ms at
// 3.35 TB/s.  A message does a few operations per byte: tensor cores
// (wgmma) have no part here.
//
// What bounds each kernel in practice, and what the design does about it:
//   1. clique_potentials.  Its first form (one thread per entry, a full
//      decode of up to 16 digits by division, then per factor an int64 row of
//      1 + W strides read from device memory and a pointer chased) took 1.27
//      ms on MUNIN, 14x its byte bound: integer instructions and descriptor
//      loads, not bytes, bounded it.  Now the host merges each clique's
//      adjacent axes wherever every one of its factors treats them alike (6.1
//      merged axes per factored entry on MUNIN's seed-0 tree, against 8.6)
//      and lays out one row per clique: merged sizes with multiply-shift
//      constants, per factor its stride along each merged axis.  Runs of
//      factorless cliques (26% of MUNIN's entries) are rows of their own at
//      the grid's head, whose blocks only store ones, 16 bytes a thread.
//      Each thread of a factored block owns 16-byte slots of consecutive
//      entries: a slot's first entry splits off its innermost digit, the next
//      entries step it (each factor its innermost stride on), and 16 bytes
//      are stored; the factors multiply in potential_specs order, as the
//      plain version does, so the two are equal to the bit.  A carry of the
//      innermost digit used to decode the rest of the entry again; on MUNIN
//      most innermost runs are shorter than a warp's 128 entries, so some
//      lane carried at nearly every step and the warp paid a full decode per
//      entry (0.44-0.50 ms).  So a block first decodes, once and together,
//      every row of the innermost axis that its run touches into a shared
//      table of each factor's row offset, and a carry reads the next row's
//      offsets.  A row splits as low + R high (R the product of the merged
//      axes next to the innermost, chosen per clique): the block decodes the
//      R low rows and the few high rows it touches, 101 rows per block on
//      MUNIN where one table of rows took 2,293, and a carry reads two table
//      entries per factor.  Measured on an H100 (700 W): 0.174-0.176 ms, 1.9x
//      the byte bound and 1.8x one fill of the arena; staging the factors'
//      values in shared memory gained nothing over L1 and was left out.  A
//      clique whose tables would outgrow TABLE_BYTES gets smaller blocks.
//   2. sepset_wave: a wave cannot end before its longest block, so the host
//      cuts every message (ops/jt.py:message_cut) into blocks that each read
//      at most BLOCK * max(2 MIN_WALK, MAX_WALK) source entries (8,192),
//      whatever the sepset's size.  A block owns a run of sepset entries and
//      one chunk of the reduced space; 2^k lanes reduce one entry (so that a
//      lane walks at least MIN_WALK entries of it; a lone lane of a short
//      reduction owns several entries instead), and the lanes of an entry are
//      adjacent threads when the source's innermost axis is reduced, or the
//      entries are, when it is kept: consecutive threads read consecutive
//      addresses.  A lane keeps kWalkUnroll loads in flight.  A message whose
//      reduced space fits one chunk keeps this gather form and writes its
//      sigma directly.  A split message (or any message with
//      normalize_messages) writes one double partial per (chunk, entry); the
//      last of its blocks, found by a per-message ticket that it sets back to
//      0, combines them in chunk order (and with normalize_messages forms the
//      total and divides).  Sums are double throughout, lanes combine by a
//      fixed tree (shuffles within a warp, shared memory across warps), and
//      every combination has a fixed order: the result is the same from run
//      to run and at least as accurate as the eager float sum; max is exact.
//   3. No division chain per entry.  Axes that are adjacent in the source (and,
//      for kept axes, in the sepset too) are merged on the host, and a digit is
//      split off by a host-computed multiply-shift (__umulhi) instead of an
//      integer division; most messages walk one or two merged reduced axes.
//      The tables are staged as 32-bit values in shared memory once per block,
//      and a block reads its offsets from its own row (message rows are
//      uploaded in wave order): two dependent reads before its data.
//   4. absorb_wave: one block owns 2,048 destination entries that start on a
//      16-byte boundary; a thread keeps two (float) or four (double) 16-byte
//      slots in registers, loaded together before any arithmetic.  The
//      destination's axes are merged wherever every incoming message treats
//      them alike, a slot's first entry is decoded by multiply-shift, and the
//      next ones step the innermost digit (an odometer that re-decodes only
//      on a carry).  Each incoming message's strides are staged in shared
//      memory, eight messages per pass, and the ratios multiply in schedule
//      order, as the plain version does.
//   5. Occupancy: both wave kernels are latency-bound per block (a chain of
//      dependent reads, then the data), so their registers are capped for
//      kSepsetMinBlocks / kAbsorbMinBlocks blocks per SM: absorb_wave
//      uncapped took 132 registers and ran at under half the rate.
//   6. Not done: one read of a parent for all its children in a downward wave
//      (each message reads its own source; children reduce a parent over
//      different axes, so one walk that serves them all needs a common order
//      and per-child partials, and MUNIN's largest clique, 16.5 MB, fits the
//      50 MB L2), TMA or cp.async rings, a CUDA graph or a persistent kernel
//      over the schedule.  A block finds its potential row, message or group
//      in the per-launch block prefix table (clique_potentials with the whole
//      block, 256 entries per step; the wave kernels with one warp, 32).

// The wrapper (pgmpy_tpu_torch/ops/jt.py) allocates the arenas, the ratio and
// partial scratch, uploads the tables (and the tickets, zero, once per card
// and stream) and calls these extern "C" launchers through ctypes; each
// returns the launch's cudaError_t.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kBlock = 256;
constexpr int kBlockLog2 = 8;
static_assert(kBlock == 1 << kBlockLog2, "kBlock is 2^kBlockLog2");
constexpr int kAbsorbEntries = 2048;  // destination entries one absorb_wave block owns
constexpr int kAlign = 4;             // an absorb_wave or clique_potentials block starts on a
                                      // 4-entry boundary
constexpr int kStage = 8;             // incoming messages one absorb_wave pass stages
constexpr int kWalkUnroll = 4;        // loads in flight per lane of sepset_wave
constexpr int kFactorPass = 4;        // factors one clique_potentials pass holds in registers
// blocks per SM that the registers must allow (float; double needs more
// registers, and takes fewer blocks rather than spill)
template <typename T>
constexpr int kSepsetMinBlocks = sizeof(T) == 4 ? 8 : 6;
template <typename T>
constexpr int kAbsorbMinBlocks = sizeof(T) == 4 ? 6 : 4;
template <typename T>
constexpr int kPotentialMinBlocks = sizeof(T) == 4 ? 4 : 4;
enum {
  kPotClique, kPotOffset, kPotSize, kPotFactors, kPotNDim, kPotFactor, kPotEntries, kPotLowAxes,
  kPotLow, kPotLowMagic, kPotHigh, kPotHeader
};
enum { kFacTable, kFacHeader };
enum {
  kMsgSrc, kMsgDst, kMsgEdge, kMsgFresh, kMsgSize, kMsgReduced, kMsgRatio, kMsgSepset,
  kMsgNKeep, kMsgNRed, kMsgLanesLog2, kMsgEntryMajor, kMsgChunks, kMsgChunkLen, kMsgRuns,
  kMsgPartial, kMsgSrcOffset, kMsgPerThread, kMsgHeader
};
enum {
  kGroupDst, kGroupBegin, kGroupEnd, kGroupNDim, kGroupNDecode, kGroupOffset, kGroupSize,
  kGroupHeader
};
enum { kAbsorbMsg, kAbsorbRatio, kAbsorbHeader };

// The table rows for W axes: the plan's width, 16 (MUNIN's widest clique has
// 16) or 24.  Shared arrays and per-axis loads are sized to W, so a tree that
// fits 16 axes does not pay for 24.
//   potential row (a run of factorless cliques, then one per factored
//     clique): kPot*, then the clique's merged axes (innermost first): sizes
//     and multiply-shift constants
//   potential factor row (the clique's factors in potential_specs order):
//     factor id, stride along each merged axis
//   message row (uploaded in wave order, so that a wave's rows are one slice):
//     kMsg*, then (innermost axis first) the kept axes' sizes,
//     source strides, canonical sepset strides and multiply-shift constants,
//     and the reduced axes' sizes, source strides and multiply-shift constants
//   group row: kGroup*, then the destination's merged axes (innermost first):
//     sizes and multiply-shift constants
//   absorb row (one per incoming message of a group): message id, its ratio's
//     offset in the scratch, its ratio stride along each merged axis
template <int W>
struct Rows {
  static constexpr int kPotDims = kPotHeader;
  static constexpr int kPotMagic = kPotDims + W;
  static constexpr int kPotential = kPotMagic + W;
  static constexpr int kFactor = kFacHeader + W;
  static constexpr int kKeepDims = kMsgHeader;
  static constexpr int kKeepStrides = kKeepDims + W;
  static constexpr int kKeepSepset = kKeepStrides + W;
  static constexpr int kKeepMagic = kKeepSepset + W;
  static constexpr int kRedDims = kKeepMagic + W;
  static constexpr int kRedStrides = kRedDims + W;
  static constexpr int kRedMagic = kRedStrides + W;
  static constexpr int kMsg = kRedMagic + W;
  static constexpr int kGroupDims = kGroupHeader;
  static constexpr int kGroupMagic = kGroupDims + W;
  static constexpr int kGroup = kGroupMagic + W;
  static constexpr int kAbsorb = kAbsorbHeader + W;
};

// The last slot k of starts[0, n) with starts[k] <= b (starts increase from 0).
__device__ __forceinline__ int find_slot(const long long* starts, int n, long long b) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (starts[mid] <= b) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// find_slot by the block's first warp, 32 starts per step (independent loads
// instead of a chain of dependent ones); every lane of warp 0 must call it.
__device__ __forceinline__ int find_slot_warp(const long long* starts, int n, long long b) {
  const int lane = threadIdx.x & 31;
  int below = 0;
  for (int k0 = 0; k0 < n; k0 += 32) {
    const unsigned le = __ballot_sync(0xffffffffu, k0 + lane < n && starts[k0 + lane] <= b);
    below += __popc(le);
    if (le != 0xffffffffu) break;
  }
  return below - 1;
}

// find_slot by the whole block, kBlock starts per step (one round of loads
// for up to kBlock slots); every thread must call it, and all get the slot.
__device__ __forceinline__ int find_slot_block(const long long* starts, int n, long long b) {
  int below = 0;
  for (int k0 = 0; k0 < n; k0 += kBlock) {
    const int k = k0 + (int)threadIdx.x;
    const int le = __syncthreads_count(k < n && starts[k] <= b);
    below += le;
    if (le < kBlock) break;
  }
  return below - 1;
}

// An axis of size d >= 2 with its multiply-shift constants (ops/jt.py:magic):
// floor(n / d) == __umulhi(n, mul) >> shift for every n < 2^31.
struct Axis {
  unsigned size, mul, shift;
};

__device__ __forceinline__ Axis load_axis(long long size, long long magic) {
  return Axis{(unsigned)size, (unsigned)magic, (unsigned)(magic >> 32)};
}

// Split the innermost digit off i (i becomes the rest) and return it.
__device__ __forceinline__ unsigned split_digit(unsigned& i, const Axis& ax) {
  const unsigned q = __umulhi(i, ax.mul) >> ax.shift;
  const unsigned digit = i - q * ax.size;
  i = q;
  return digit;
}

// Offset of the row-major entry i of a walk over n axes (innermost first).
__device__ __forceinline__ unsigned walk(unsigned i, int n, const Axis* ax,
                                         const unsigned* strides) {
  if (n == 0) return 0;
  unsigned off = 0;
  for (int a = 0; a + 1 < n; ++a) off += split_digit(i, ax[a]) * strides[a];
  return off + i * strides[n - 1];  // the outermost digit is what is left
}

template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) {
  return x < lo ? lo : x;  // NaN stays NaN, as torch.clamp_min
}

template <bool kMax>
__device__ __forceinline__ double combine(double acc, double v) {
  if (kMax) return (v > acc || v != v) ? v : acc;  // a NaN propagates, as torch.amax
  return acc + v;
}

template <typename T>
__device__ __forceinline__ T ratio_of(T sigma, T mu_old, bool fresh, T tiny) {
  return fresh ? sigma : sigma / clamp_min(mu_old, tiny);
}

// Blocks over (message, chunk of its reduced space, run of its sepset
// entries): the block prefix msg_blocks maps a block to its message, and
// within the message block b is run b % runs of chunk b / runs.
template <typename T, bool kMax, bool kNorm, int W>
__global__ void __launch_bounds__(kBlock, kSepsetMinBlocks<T>) sepset_wave_kernel(
    const T* __restrict__ arena, T* __restrict__ mu, T* __restrict__ scratch,
    double* __restrict__ partial, unsigned* __restrict__ tickets,
    const long long* __restrict__ msgs, const long long* __restrict__ msg_blocks, int n_msgs,
    T tiny) {
  __shared__ int s_slot;
  __shared__ bool s_last;
  __shared__ Axis s_kax[W], s_rax[W];
  __shared__ unsigned s_ks[W], s_kj[W], s_rs[W];
  __shared__ double s_part[kBlock];
  const unsigned t = threadIdx.x;
  if (t < 32) {
    const int slot = find_slot_warp(msg_blocks, n_msgs, blockIdx.x);
    if (t == 0) s_slot = slot;
  }
  __syncthreads();
  const long long* row = msgs + (long long)s_slot * Rows<W>::kMsg;
  if (t < W) {
    s_kax[t] = load_axis(row[Rows<W>::kKeepDims + t], row[Rows<W>::kKeepMagic + t]);
    s_ks[t] = (unsigned)row[Rows<W>::kKeepStrides + t];
    s_kj[t] = (unsigned)row[Rows<W>::kKeepSepset + t];
    s_rax[t] = load_axis(row[Rows<W>::kRedDims + t], row[Rows<W>::kRedMagic + t]);
    s_rs[t] = (unsigned)row[Rows<W>::kRedStrides + t];
  }
  __syncthreads();
  const unsigned size = (unsigned)row[kMsgSize], reduced = (unsigned)row[kMsgReduced];
  const unsigned lanes_log2 = (unsigned)row[kMsgLanesLog2], lanes = 1u << lanes_log2;
  const unsigned per_block = kBlock >> lanes_log2;  // sepset entries of a block
  const unsigned runs = (unsigned)row[kMsgRuns], chunks = (unsigned)row[kMsgChunks];
  const unsigned chunk_len = (unsigned)row[kMsgChunkLen];
  const int nkeep = (int)row[kMsgNKeep], nred = (int)row[kMsgNRed];
  const unsigned b = (unsigned)(blockIdx.x - msg_blocks[s_slot]);
  const unsigned run = b % runs, chunk = b / runs;
  // entry-major: an entry's lanes lie per_block threads apart, and
  // consecutive threads own consecutive entries (the innermost source axis is
  // kept); lane-major: an entry's lanes are consecutive threads
  const bool entry_major = row[kMsgEntryMajor] != 0;
  const unsigned lane = entry_major ? t >> (kBlockLog2 - lanes_log2) : t & (lanes - 1);
  const unsigned e = entry_major ? t & (per_block - 1) : t >> lanes_log2;
  const unsigned lane_step = entry_major ? per_block : 1u;
  // a lane without partners (a short reduction) owns per_thread entries, one
  // block apart
  const unsigned per_thread = (unsigned)row[kMsgPerThread];
  const long long ratio_at = row[kMsgRatio], sep_at = row[kMsgSepset];
  const bool fresh = row[kMsgFresh] != 0;
  const bool direct = !kNorm && chunks == 1;  // the gather form: a block's entries are final
  double* part = partial + row[kMsgPartial];
  for (unsigned n = 0; n < per_thread; ++n) {
    const unsigned q = (run * per_thread + n) * per_block + e;
    double acc = kMax ? -INFINITY : 0.0;
    if (q < size) {
      const T* src = arena + row[kMsgSrcOffset] + walk(q, nkeep, s_kax, s_ks);
      const unsigned r_end = min(reduced, (chunk + 1) * chunk_len);
      for (unsigned r = chunk * chunk_len + lane; r < r_end; r += kWalkUnroll * lanes) {
        T v[kWalkUnroll];  // kWalkUnroll loads in flight, then added in walk order
#pragma unroll
        for (int u = 0; u < kWalkUnroll; ++u)
          if (r + u * lanes < r_end) v[u] = src[walk(r + u * lanes, nred, s_rax, s_rs)];
#pragma unroll
        for (int u = 0; u < kWalkUnroll; ++u)
          if (r + u * lanes < r_end) acc = combine<kMax>(acc, (double)v[u]);
      }
    }
    if (lanes > 1) {  // the lanes of each entry, by a fixed tree (per_thread is 1)
      // lanes in other warps through shared memory; lane-major lanes of one
      // warp (partners under 32 apart) through shuffles: the same pairs
      const unsigned in_warp = entry_major ? 0u : min(lanes, 32u);
      if (lanes > in_warp) {
        s_part[t] = acc;
        __syncthreads();
        for (unsigned s = lanes >> 1; s >= max(in_warp, 1u); s >>= 1) {
          if (lane < s) s_part[t] = combine<kMax>(s_part[t], s_part[t + s * lane_step]);
          __syncthreads();
        }
        acc = s_part[t];
      }
      for (unsigned s = in_warp >> 1; s > 0; s >>= 1)
        acc = combine<kMax>(acc, __shfl_down_sync(0xffffffffu, acc, s));
    }
    if (lane == 0 && q < size) {
      const unsigned j = walk(q, nkeep, s_kax, s_kj);  // canonical sepset index
      if (direct) {
        const T sigma = (T)acc;
        scratch[ratio_at + j] = ratio_of(sigma, mu[sep_at + j], fresh, tiny);
        mu[sep_at + j] = sigma;
      } else {
        part[(long long)chunk * size + j] = acc;
      }
    }
  }
  if (direct) return;
  __threadfence();
  __syncthreads();
  if (t == 0) s_last = atomicAdd(tickets + s_slot, 1u) == runs * chunks - 1;
  __syncthreads();
  if (!s_last) return;
  // the message's last block: every chunk's partials, in chunk order
  __threadfence();
  double total = 0.0;
  for (unsigned k = t; k < size; k += kBlock) {
    double s = __ldcg(part + k);
    for (unsigned c = 1; c < chunks; ++c) s = combine<kMax>(s, __ldcg(part + (long long)c * size + k));
    const T sigma = (T)s;
    if (kNorm) {
      scratch[ratio_at + k] = sigma;
      total += (double)sigma;
    } else {
      scratch[ratio_at + k] = ratio_of(sigma, mu[sep_at + k], fresh, tiny);
      mu[sep_at + k] = sigma;
    }
  }
  if (kNorm) {
    __syncthreads();  // s_part is reused for the total
    s_part[t] = total;
    __syncthreads();
    for (unsigned s = kBlock >> 1; s > 0; s >>= 1) {
      if (t < s) s_part[t] += s_part[t + s];
      __syncthreads();
    }
    const T denom = clamp_min((T)s_part[0], tiny);
    for (unsigned k = t; k < size; k += kBlock) {
      const T s = scratch[ratio_at + k] / denom;
      scratch[ratio_at + k] = ratio_of(s, mu[sep_at + k], fresh, tiny);
      mu[sep_at + k] = s;
    }
  }
  if (t == 0) tickets[s_slot] = 0u;  // ready for the next calibration
}

__device__ __forceinline__ void load16(const float* p, float* x) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}
__device__ __forceinline__ void load16(const double* p, double* x) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  x[0] = v.x, x[1] = v.y;
}
__device__ __forceinline__ void store16(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store16(double* p, const double* x) {
  *reinterpret_cast<double2*>(p) = make_double2(x[0], x[1]);
}

// One destination's slot of kVec entries: the entries [i, i + kVec) of dst
// that lie in [lo, hi) (a contiguous run), held in x; one 16-byte access
// where the whole slot lies in the run.
template <typename T, int kVec>
__device__ __forceinline__ void load_slot(const T* dst, int i, int lo, int hi, T* x) {
  if (i >= lo && i + kVec <= hi) {
    load16(dst + i, x);
  } else {
#pragma unroll
    for (int v = 0; v < kVec; ++v)
      if (i + v >= lo && i + v < hi) x[v] = dst[i + v];
  }
}

template <typename T, int kVec>
__device__ __forceinline__ void store_slot(T* dst, int i, int lo, int hi, const T* x) {
  if (i >= lo && i + kVec <= hi) {
    store16(dst + i, x);
  } else {
#pragma unroll
    for (int v = 0; v < kVec; ++v)
      if (i + v >= lo && i + v < hi) dst[i + v] = x[v];
  }
}

// Each of a group's n factors' (n <= N) part of the offset of row q of a
// clique from the merged axes [a0, a1): q's digits over them, split off by
// multiply-shift (the last takes what is left), times the factors' strides
// (st: W per factor).
template <int W, int N>
__device__ __forceinline__ void row_offsets(unsigned q, int a0, int a1, int n, const Axis* ax,
                                            const unsigned* st, unsigned* off) {
#pragma unroll
  for (int p = 0; p < N; ++p) off[p] = 0;
  for (int a = a0; a < a1; ++a) {
    const unsigned digit = a + 1 < a1 ? split_digit(q, ax[a]) : q;
#pragma unroll
    for (int p = 0; p < N; ++p)
      if (p < n) off[p] += digit * st[p * W + a];
  }
}

// The innermost digit of clique entry i (all of i with one merged axis); i
// becomes its row.
__device__ __forceinline__ unsigned first_digit(unsigned& i, int nd, const Axis& ax0) {
  if (nd > 1) return split_digit(i, ax0);
  const unsigned d0 = i;
  i = 0;
  return d0;
}

// A row's low part (the row modulo the low axes' product, low.size); q
// becomes its high part.
__device__ __forceinline__ unsigned low_part(unsigned& q, const Axis& low) {
  if (low.size > 1) return split_digit(q, low);
  return 0;
}

// The block's tables: each factor's offset part of every low row (n_low per
// factor) and of the run's high rows (n_high per factor, from its first).
struct RowTables {
  const unsigned *low, *high;
  int n_low, n_high;
};

// One pass of N factors over a whole 16-byte slot of kVec entries whose
// first entry has innermost digit d0 in the row of low part ql and high part
// jh (from the run's first): each factor's offset from the row's two table
// parts, the next entries the innermost digit on (each factor its innermost
// stride on), the next row's parts from the tables on a carry.  x[v] becomes
// x[v] * f0 * f1 ... in factor order (f0 * f1 ... when first).
template <typename T, int W, int N>
__device__ __forceinline__ void slot_pass(T* x, unsigned d0, unsigned ql, unsigned jh,
                                          unsigned size0, bool first, const RowTables& tab,
                                          const unsigned* st, const T* const* s_src) {
  constexpr int kVec = 16 / sizeof(T);
  const T* src[N];
  unsigned st0[N], off[N];
#pragma unroll
  for (int p = 0; p < N; ++p) {
    src[p] = s_src[p], st0[p] = st[p * W];
    off[p] = tab.low[p * tab.n_low + ql] + tab.high[p * tab.n_high + jh] + d0 * st0[p];
  }
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    T y = first ? src[0][off[0]] : x[v] * src[0][off[0]];
#pragma unroll
    for (int p = 1; p < N; ++p) y = y * src[p][off[p]];  // the eager order: ((f0 * f1) * f2) ...
    x[v] = y;
    if (v + 1 < kVec) {
      if (++d0 < size0) {
#pragma unroll
        for (int p = 0; p < N; ++p) off[p] += st0[p];
      } else {
        d0 = 0;
        if (++ql == (unsigned)tab.n_low) ql = 0, ++jh;
#pragma unroll
        for (int p = 0; p < N; ++p)
          off[p] = tab.low[p * tab.n_low + ql] + tab.high[p * tab.n_high + jh];
      }
    }
  }
}

// slot_pass for the pass's n factors (1 <= n <= N), one instance per count
template <typename T, int W, int N>
__device__ __forceinline__ void slot_pass_of(int n, T* x, unsigned d0, unsigned ql, unsigned jh,
                                             unsigned size0, bool first, const RowTables& tab,
                                             const unsigned* st, const T* const* s_src) {
  if constexpr (N > 1) {
    if (n < N) return slot_pass_of<T, W, N - 1>(n, x, d0, ql, jh, size0, first, tab, st, s_src);
  }
  slot_pass<T, W, N>(x, d0, ql, jh, size0, first, tab, st, s_src);
}

// Blocks over potential rows (runs of factorless cliques first, then one row
// per factored clique), each block kPotEntries entries of its row from the
// 4-entry boundary at or below the row's offset: the block prefix row_blocks
// maps a block to its row.  A thread owns slots of kVec entries (16 bytes),
// slot k of thread t at (k kBlock + t) kVec; a whole slot passes over its
// factors kFactorPass at a time, a slot at either end of the run entry by
// entry.  A clique entry lies in a row of its innermost merged axis, and a
// row q = low + kPotLow high is split at the merged axis kPotLowAxes: the
// block decodes every low row and the high rows its run touches (at most
// kPotHigh) into tables of each factor's offset parts, once.  The factors'
// values are read through L1.  Dynamic shared memory: the factors' table
// pointers, their strides (W each) and the block's two tables.
template <typename T, int W>
__global__ void __launch_bounds__(kBlock, kPotentialMinBlocks<T>) clique_potentials_kernel(
    T* __restrict__ arena, const long long* __restrict__ rows,
    const long long* __restrict__ row_blocks, int n_rows,
    const long long* __restrict__ factor_rows, const T* const* __restrict__ tables) {
  constexpr int kVec = 16 / sizeof(T);
  static_assert(kAlign % kVec == 0, "a block starts on a 16-byte boundary");
  extern __shared__ __align__(16) unsigned char s_dyn[];
  __shared__ Axis s_ax[W];
  const unsigned t = threadIdx.x;
  const int r = find_slot_block(row_blocks, n_rows, blockIdx.x);
  const long long* row = rows + (long long)r * Rows<W>::kPotential;
  const long long offset = row[kPotOffset];
  const int size = (int)row[kPotSize], nf = (int)row[kPotFactors];
  const int per_block = (int)row[kPotEntries];
  T* dst = arena + offset;
  const int i0 = (int)(offset & (kAlign - 1)) * -1 + (int)(blockIdx.x - row_blocks[r]) * per_block;
  const int lo = max(i0, 0), hi = min(i0 + per_block, size);
  const int slots = (per_block + kBlock * kVec - 1) / (kBlock * kVec);
  if (nf == 0) {  // a run of factorless cliques: ones, no decode, no table read
    T one[kVec];
#pragma unroll
    for (int v = 0; v < kVec; ++v) one[v] = T(1);
    for (int k = 0; k < slots; ++k)
      store_slot<T, kVec>(dst, i0 + (k * kBlock + (int)t) * kVec, lo, hi, one);
    return;
  }
  // stage the clique's axes, and its factors' table pointers and strides
  const int nd = (int)row[kPotNDim], low_axes = (int)row[kPotLowAxes];
  const Axis low = load_axis(row[kPotLow], row[kPotLowMagic]);
  const long long* frows = factor_rows + row[kPotFactor] * Rows<W>::kFactor;
  const T** s_src = reinterpret_cast<const T**>(s_dyn);
  unsigned* s_st = reinterpret_cast<unsigned*>(s_dyn + sizeof(T*) * nf);
  if ((int)t < nd) s_ax[t] = load_axis(row[Rows<W>::kPotDims + t], row[Rows<W>::kPotMagic + t]);
  for (int j = t; j < nf * W; j += kBlock)
    s_st[j] = (unsigned)frows[(j / W) * Rows<W>::kFactor + kFacHeader + j % W];
  if ((int)t < nf) s_src[t] = tables[frows[t * Rows<W>::kFactor + kFacTable]];
  __syncthreads();
  // the tables: every low row, and the high rows that the run touches
  const Axis ax0 = s_ax[0];
  const unsigned size0 = ax0.size;  // with one merged axis, the clique's size: one row
  unsigned h_lo = (unsigned)lo, h_hi = (unsigned)(hi - 1);
  first_digit(h_lo, nd, ax0), low_part(h_lo, low);
  first_digit(h_hi, nd, ax0), low_part(h_hi, low);
  const int n_low = (int)low.size, n_high = (int)(h_hi - h_lo) + 1;
  unsigned* s_low = s_st + nf * W;
  unsigned* s_high = s_low + nf * n_low;
  for (int j = t; j < n_low + n_high; j += kBlock) {
    const bool is_low = j < n_low;
    const unsigned q = is_low ? (unsigned)j : h_lo + (unsigned)(j - n_low);
    const int a0 = is_low ? 1 : low_axes, a1 = is_low ? low_axes : nd;
    unsigned* out = is_low ? s_low + j : s_high + (j - n_low);
    const int stride = is_low ? n_low : n_high;
    for (int f0 = 0; f0 < nf; f0 += kFactorPass) {
      const int n = min(kFactorPass, nf - f0);
      unsigned off[kFactorPass];
      row_offsets<W, kFactorPass>(q, a0, a1, n, s_ax, s_st + f0 * W, off);
#pragma unroll
      for (int p = 0; p < kFactorPass; ++p)
        if (p < n) out[(f0 + p) * stride] = off[p];
    }
  }
  __syncthreads();
  for (int k = 0; k < slots; ++k) {
    const int i = i0 + (k * kBlock + (int)t) * kVec;
    T x[kVec];
    if (i >= lo && i + kVec <= hi) {
      unsigned q = (unsigned)i;
      const unsigned d0 = first_digit(q, nd, ax0);
      const unsigned ql = low_part(q, low);
      for (int f0 = 0; f0 < nf; f0 += kFactorPass) {
        const RowTables tab{s_low + f0 * n_low, s_high + f0 * n_high, n_low, n_high};
        slot_pass_of<T, W, kFactorPass>(min(kFactorPass, nf - f0), x, d0, ql, q - h_lo, size0,
                                        f0 == 0, tab, s_st + f0 * W, s_src + f0);
      }
      store16(dst + i, x);
    } else {  // a slot at either end of the run: entry by entry
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        if (i + v < lo || i + v >= hi) continue;
        unsigned q = (unsigned)(i + v);
        const unsigned d0 = first_digit(q, nd, ax0);
        const unsigned ql = low_part(q, low);
        for (int f = 0; f < nf; ++f) {
          const unsigned off = s_low[f * n_low + ql] + s_high[f * n_high + q - h_lo] +
                               d0 * s_st[f * W];
          x[v] = f == 0 ? s_src[f][off] : x[v] * s_src[f][off];
        }
        dst[i + v] = x[v];
      }
    }
  }
}

// The ratio entry of destination entry i: its digits over the merged axes
// (innermost first) up to the last one any incoming ratio uses; d0 is the
// innermost digit (0 where no axis is decoded).
__device__ __forceinline__ unsigned ratio_index(unsigned i, int ndec, const Axis* ax,
                                                const unsigned* st, unsigned& d0) {
  unsigned idx = 0;
  d0 = 0;
  for (int a = 0; a < ndec; ++a) {
    const unsigned digit = split_digit(i, ax[a]);
    if (a == 0) d0 = digit;
    idx += digit * st[a];
  }
  return idx;
}

// Blocks over (destination group, run of 2,048 arena entries starting on a
// 4-entry boundary): the block prefix group_blocks maps a block to its group.
template <typename T, int W>
__global__ void __launch_bounds__(kBlock, kAbsorbMinBlocks<T>) absorb_wave_kernel(
    T* __restrict__ arena, const T* __restrict__ scratch, const long long* __restrict__ groups,
    const long long* __restrict__ group_blocks, int n_groups,
    const long long* __restrict__ absorb_rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kSlots = kAbsorbEntries / (kBlock * kVec);
  static_assert(kAlign % kVec == 0, "a block starts on a 16-byte boundary");
  __shared__ int s_group;
  __shared__ Axis s_ax[W];
  __shared__ unsigned s_stride[kStage][W];
  __shared__ long long s_ratio[kStage];
  const unsigned t = threadIdx.x;
  if (t < 32) {
    const int group = find_slot_warp(group_blocks, n_groups, blockIdx.x);
    if (t == 0) s_group = group;
  }
  __syncthreads();
  const long long* grow = groups + (long long)s_group * Rows<W>::kGroup;
  const int nd = (int)grow[kGroupNDim], ndec = (int)grow[kGroupNDecode];
  // axes past nd read as size 1: the odometer then re-decodes, to index 0
  if (t < W)
    s_ax[t] = (int)t < nd ? load_axis(grow[Rows<W>::kGroupDims + t], grow[Rows<W>::kGroupMagic + t])
                          : Axis{1u, 0u, 0u};
  // the block's run, in entries of the destination: from the 4-entry
  // boundary at or below its offset (so i0 may be negative), clipped to it
  const long long offset = grow[kGroupOffset];
  const int size = (int)grow[kGroupSize];
  T* dst = arena + offset;
  const int i0 = (int)(offset & (kAlign - 1)) * -1 +
                 (int)(blockIdx.x - group_blocks[s_group]) * kAbsorbEntries;
  const int lo = max(i0, 0), hi = min(i0 + kAbsorbEntries, size);
  T x[kSlots][kVec];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) load_slot<T, kVec>(dst, i0 + (k * kBlock + (int)t) * kVec, lo, hi, x[k]);
  const long long in_begin = grow[kGroupBegin], in_end = grow[kGroupEnd];
  for (long long k0 = in_begin; k0 < in_end; k0 += kStage) {
    const int n = (int)min((long long)kStage, in_end - k0);
    __syncthreads();  // s_ax is staged; the previous pass is done with the strides
    for (int i = t; i < n * W; i += kBlock)
      s_stride[i / W][i % W] = (unsigned)absorb_rows[(k0 + i / W) * Rows<W>::kAbsorb +
                                                     kAbsorbHeader + i % W];
    if ((int)t < n) s_ratio[t] = absorb_rows[(k0 + t) * Rows<W>::kAbsorb + kAbsorbRatio];
    __syncthreads();
    const unsigned size0 = s_ax[0].size;
    for (int m = 0; m < n; ++m) {
      const T* ratio = scratch + s_ratio[m];
      const unsigned* st = s_stride[m];
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const int i = i0 + (k * kBlock + (int)t) * kVec;
        unsigned d0;
        if (i >= lo && i + kVec <= hi) {
          // a whole slot: decode its first entry, then step the innermost
          // digit, decoding again only where it carries
          unsigned idx = ratio_index(i, ndec, s_ax, st, d0);
          x[k][0] *= ratio[idx];
#pragma unroll
          for (int v = 1; v < kVec; ++v) {
            if (++d0 < size0) idx += st[0];
            else idx = ratio_index(i + v, ndec, s_ax, st, d0);
            x[k][v] *= ratio[idx];
          }
        } else {  // the slot at either end of the block's run: entry by entry
#pragma unroll
          for (int v = 0; v < kVec; ++v)
            if (i + v >= lo && i + v < hi) x[k][v] *= ratio[ratio_index(i + v, ndec, s_ax, st, d0)];
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kSlots; ++k) store_slot<T, kVec>(dst, i0 + (k * kBlock + (int)t) * kVec, lo, hi, x[k]);
}

bool bad_launch(long long n_blocks) { return n_blocks <= 0 || n_blocks > 0x7fffffffLL; }

template <typename T, int W>
void launch_potentials(dim3 grid, size_t shared, cudaStream_t s, void* arena,
                       const long long* rows, const long long* row_blocks, int n_rows,
                       const long long* factor_rows, const void* tables) {
  clique_potentials_kernel<T, W><<<grid, kBlock, shared, s>>>(
      static_cast<T*>(arena), rows, row_blocks, n_rows, factor_rows,
      static_cast<const T* const*>(tables));
}

template <typename T, int W>
void launch_sepset_wave(int maximize, int normalize, const void* arena, void* mu, void* scratch,
                        void* partial, void* tickets, const long long* m, const long long* mb,
                        int n_msgs, long long n_blocks, double tiny, cudaStream_t s) {
  const auto* a = static_cast<const T*>(arena);
  auto* u = static_cast<T*>(mu);
  auto* r = static_cast<T*>(scratch);
  auto* p = static_cast<double*>(partial);
  auto* k = static_cast<unsigned*>(tickets);
  const T t = (T)tiny;
  const dim3 grid((unsigned)n_blocks);
  if (normalize) {
    if (maximize)
      sepset_wave_kernel<T, true, true, W><<<grid, kBlock, 0, s>>>(a, u, r, p, k, m, mb, n_msgs, t);
    else
      sepset_wave_kernel<T, false, true, W><<<grid, kBlock, 0, s>>>(a, u, r, p, k, m, mb, n_msgs, t);
  } else {
    if (maximize)
      sepset_wave_kernel<T, true, false, W><<<grid, kBlock, 0, s>>>(a, u, r, p, k, m, mb, n_msgs, t);
    else
      sepset_wave_kernel<T, false, false, W><<<grid, kBlock, 0, s>>>(a, u, r, p, k, m, mb, n_msgs, t);
  }
}

template <typename T, int W>
void launch_absorb_wave(dim3 grid, cudaStream_t s, void* arena, const void* scratch,
                        const long long* g, const long long* gb, int n_groups,
                        const long long* ar) {
  absorb_wave_kernel<T, W><<<grid, kBlock, 0, s>>>(
      static_cast<T*>(arena), static_cast<const T*>(scratch), g, gb, n_groups, ar);
}

// The instance for an element size (4: float, 8: double) and a table width
// (16 or 24), or nullptr.
#define PGMPY_JT_PICK(fn, elem_bytes, width)                                  \
  ((elem_bytes) == 4 && (width) == 16   ? &fn<float, 16>                      \
   : (elem_bytes) == 4 && (width) == 24 ? &fn<float, 24>                      \
   : (elem_bytes) == 8 && (width) == 16 ? &fn<double, 16>                     \
   : (elem_bytes) == 8 && (width) == 24 ? &fn<double, 24>                     \
                                        : nullptr)

}  // namespace

// rows, row_blocks: the potential rows (each with its entries per block, a
// multiple of kAlign) and each one's first block; tables: the factor tables'
// addresses; shared_bytes: the dynamic shared memory, the largest of
// (8 + 4 W + 4 (kPotLow + kPotHigh)) bytes per factor of a row.
extern "C" int pgmpy_jt_clique_potentials(int elem_bytes, void* arena, const void* rows,
                                          const void* row_blocks, int n_rows,
                                          const void* factor_rows, const void* tables,
                                          long long n_blocks, int shared_bytes, int width,
                                          void* stream) {
  const auto launch = PGMPY_JT_PICK(launch_potentials, elem_bytes, width);
  if (!launch || bad_launch(n_blocks) || n_rows <= 0 || shared_bytes < 0 ||
      shared_bytes > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  launch(dim3((unsigned)n_blocks), (size_t)shared_bytes, static_cast<cudaStream_t>(stream),
         arena, static_cast<const long long*>(rows), static_cast<const long long*>(row_blocks),
         n_rows, static_cast<const long long*>(factor_rows), tables);
  return (int)cudaGetLastError();
}

// msgs, msg_blocks, tickets: the wave's slices (its message rows, their first
// blocks, one zero unsigned per message, left zero by the launch); partial:
// double scratch of the wave's partials.
extern "C" int pgmpy_jt_sepset_wave(int elem_bytes, int maximize, int normalize,
                                    const void* arena, void* mu, void* scratch, void* partial,
                                    void* tickets, const void* msgs, const void* msg_blocks,
                                    int n_msgs, long long n_blocks, int width, double tiny,
                                    void* stream) {
  const auto launch = PGMPY_JT_PICK(launch_sepset_wave, elem_bytes, width);
  if (!launch || bad_launch(n_blocks) || n_msgs <= 0) return (int)cudaErrorInvalidValue;
  launch(maximize, normalize, arena, mu, scratch, partial, tickets,
         static_cast<const long long*>(msgs), static_cast<const long long*>(msg_blocks), n_msgs,
         n_blocks, tiny, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

extern "C" int pgmpy_jt_absorb_wave(int elem_bytes, void* arena, const void* scratch,
                                    const void* groups, const void* group_blocks, int n_groups,
                                    const void* absorb_rows, long long n_blocks, int width,
                                    void* stream) {
  const auto launch = PGMPY_JT_PICK(launch_absorb_wave, elem_bytes, width);
  if (!launch || bad_launch(n_blocks) || n_groups <= 0) return (int)cudaErrorInvalidValue;
  launch(dim3((unsigned)n_blocks), static_cast<cudaStream_t>(stream), arena, scratch,
         static_cast<const long long*>(groups), static_cast<const long long*>(group_blocks),
         n_groups, static_cast<const long long*>(absorb_rows));
  return (int)cudaGetLastError();
}
