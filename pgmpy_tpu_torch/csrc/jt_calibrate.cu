// Junction-tree calibration kernels for Hopper (sm_90a): the clique
// potentials and the two-pass messages of one calibration, wave by wave.
//
//   clique_potentials  arena[c][x] = prod_f factor_f[x restricted to f's axes]
//                      (1 for a clique with no factor), ONE launch for all cliques
//   sepset_wave        per message m = (src -> dst over edge e) of a wave:
//                      sigma[j] = sum (or max) of src over the entries that
//                      project onto sepset entry j (canonical sepset order);
//                      with normalize_messages sigma /= max(sum sigma, TINY),
//                      one block per message (the total is a dependency across
//                      the message); ratio = fresh ? sigma : sigma / max(mu_e,
//                      TINY); mu_e = sigma
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
// the sepsets.  On MUNIN (76.6 M clique entries, f32) that is well under 1 ms
// at 3.35 TB/s; the arithmetic is a few operations per byte at most.  This
// kernel reads a source once per message, so a downward wave reads a parent
// as many times as it has children in that wave.
//
// What the design does about it:
//   1. Every arena entry is owned by one thread in clique_potentials and
//      absorb_wave, which decodes its clique-axis digits once (in registers,
//      loops unrolled to the tables' width) and gathers each factor / ratio entry
//      through per-axis strides (0 where the table lacks the axis).  No entry
//      has two writers and there are no atomics.
//   2. sepset_wave uses the gather form: a group of 2^k lanes (chosen per
//      message on the host so that a lane walks at least 32 source entries,
//      at most a block) owns one sepset entry and walks its reduced sub-space
//      with stride 2^k; consecutive lanes read consecutive offsets of the
//      innermost reduced axis.  Sums are accumulated in double and the group
//      is reduced by a fixed tree in shared memory: results are the same from
//      run to run, and at least as accurate as the eager float sum.
//   3. Adjacent axes are merged on the host (a walk over the merged axes
//      visits the same offsets), so a message decodes few digits per entry.
//   4. A block finds its clique, message or destination group by a binary
//      search over the per-launch block prefix table, so no per-block tile
//      table is stored.
// A simple kernel first: no TMA, no wgmma, no persistent kernel over the
// schedule, no CUDA graph of the launch sequence.
//
// The wrapper (pgmpy_tpu_torch/ops/jt.py) allocates the arenas and the ratio
// scratch, uploads the tables and calls these extern "C" launchers through
// ctypes; each returns the launch's cudaError_t.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kBlock = 256;
constexpr int kCliqueHeader = 3;
enum {
  kMsgSrc, kMsgDst, kMsgEdge, kMsgFresh, kMsgSize, kMsgReduced, kMsgLanesLog2,
  kMsgRatio, kMsgSepset, kMsgNKeep, kMsgNRed, kMsgHeader
};

// The table rows for W axes: the plan's width, 16 (MUNIN's widest clique has
// 16) or 24.  Every per-axis loop is unrolled to W, so a tree that fits 16
// axes does not pay for 24.
//   clique row: offset into the belief arena, size, axis count, sizes[W]
//   factor row: factor id, stride along each clique axis
//   message row: kMsg*, then the kept axes' sizes and source strides, the
//   reduced axes' sizes and source strides, the ratio's destination strides
template <int W>
struct Rows {
  static constexpr int kClique = kCliqueHeader + W;
  static constexpr int kFactor = 1 + W;
  static constexpr int kKeepDims = kMsgHeader;
  static constexpr int kKeepStrides = kKeepDims + W;
  static constexpr int kRedDims = kKeepStrides + W;
  static constexpr int kRedStrides = kRedDims + W;
  static constexpr int kDstStrides = kRedStrides + W;
  static constexpr int kMsg = kDstStrides + W;
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

// Row-major digits of a clique entry (last axis fastest); 0 beyond nd.
template <int W>
__device__ __forceinline__ void decode(unsigned i, int nd, const unsigned* dims,
                                       unsigned* digit) {
#pragma unroll
  for (int a = W - 1; a >= 0; --a) {
    if (a < nd) {
      digit[a] = i % dims[a];
      i /= dims[a];
    } else {
      digit[a] = 0;
    }
  }
}

// Offset of the row-major entry i of a walk over n axes of the given sizes and strides.
template <int W>
__device__ __forceinline__ unsigned walk_offset(unsigned i, int n, const unsigned* dims,
                                                const unsigned* strides) {
  unsigned off = 0;
#pragma unroll
  for (int a = W - 1; a >= 0; --a) {
    if (a < n) {
      off += (i % dims[a]) * strides[a];
      i /= dims[a];
    }
  }
  return off;
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

template <typename T, int W>
__global__ void __launch_bounds__(kBlock) clique_potentials_kernel(
    T* __restrict__ arena, const long long* __restrict__ cliques,
    const long long* __restrict__ clique_blocks, int n_cliques,
    const long long* __restrict__ clique_factors, const long long* __restrict__ factors,
    const T* const* __restrict__ tables, int per_block) {
  __shared__ int s_clique;
  __shared__ unsigned s_dims[W];
  if (threadIdx.x == 0) s_clique = find_slot(clique_blocks, n_cliques, blockIdx.x);
  __syncthreads();
  const int c = s_clique;
  const long long* row = cliques + (long long)c * Rows<W>::kClique;
  if (threadIdx.x < W) s_dims[threadIdx.x] = (unsigned)row[kCliqueHeader + threadIdx.x];
  __syncthreads();
  const long long offset = row[0];
  const unsigned size = (unsigned)row[1];
  const int nd = (int)row[2];
  const long long f_begin = clique_factors[c], f_end = clique_factors[c + 1];
  const unsigned begin = (unsigned)(blockIdx.x - clique_blocks[c]) * (unsigned)per_block;
  const unsigned end = min(size, begin + (unsigned)per_block);
  for (unsigned i = begin + threadIdx.x; i < end; i += kBlock) {
    unsigned digit[W];
    decode<W>(i, nd, s_dims, digit);
    T x = T(1);
    for (long long f = f_begin; f < f_end; ++f) {
      const long long* fr = factors + f * Rows<W>::kFactor;
      long long idx = 0;
#pragma unroll
      for (int a = 0; a < W; ++a) idx += (long long)digit[a] * fr[1 + a];
      const T v = tables[fr[0]][idx];
      x = (f == f_begin) ? v : x * v;  // the eager order: ((f0 * f1) * f2) ...
    }
    arena[offset + i] = x;
  }
}

struct MessageShape {
  unsigned size, reduced, lanes_log2;
  int nkeep, nred;
  long long src;
};

// One message's row: its sizes, and its kept / reduced axes staged in shared memory.
template <int W>
__device__ __forceinline__ MessageShape load_message(const long long* row,
                                                     const long long* cliques, unsigned* kd,
                                                     unsigned* ks, unsigned* rd, unsigned* rs) {
  if (threadIdx.x < W) {
    kd[threadIdx.x] = (unsigned)row[Rows<W>::kKeepDims + threadIdx.x];
    ks[threadIdx.x] = (unsigned)row[Rows<W>::kKeepStrides + threadIdx.x];
    rd[threadIdx.x] = (unsigned)row[Rows<W>::kRedDims + threadIdx.x];
    rs[threadIdx.x] = (unsigned)row[Rows<W>::kRedStrides + threadIdx.x];
  }
  __syncthreads();
  return MessageShape{(unsigned)row[kMsgSize], (unsigned)row[kMsgReduced],
                      (unsigned)row[kMsgLanesLog2], (int)row[kMsgNKeep], (int)row[kMsgNRed],
                      cliques[row[kMsgSrc] * Rows<W>::kClique]};
}

// sigma of sepset entry j (j < size), reduced over this block's lanes of j:
// every lane walks its share of the reduced sub-space, then a fixed tree in
// s_part combines the lanes.  All threads of the block must call it.  The
// result is valid in lane 0 of each entry.
template <typename T, bool kMax, int W>
__device__ __forceinline__ double sigma_entry(const T* __restrict__ arena, const MessageShape& m,
                                              unsigned j, const unsigned* kd, const unsigned* ks,
                                              const unsigned* rd, const unsigned* rs,
                                              double* s_part) {
  const unsigned lanes = 1u << m.lanes_log2;
  const unsigned lane = threadIdx.x & (lanes - 1);
  double acc = kMax ? -INFINITY : 0.0;
  if (j < m.size) {
    const T* src = arena + m.src + walk_offset<W>(j, m.nkeep, kd, ks);
    for (unsigned r = lane; r < m.reduced; r += lanes)
      acc = combine<kMax>(acc, (double)src[walk_offset<W>(r, m.nred, rd, rs)]);
  }
  s_part[threadIdx.x] = acc;
  __syncthreads();
  for (unsigned s = lanes >> 1; s > 0; s >>= 1) {
    if (lane < s) s_part[threadIdx.x] = combine<kMax>(s_part[threadIdx.x], s_part[threadIdx.x + s]);
    __syncthreads();
  }
  return s_part[threadIdx.x];
}

template <typename T>
__device__ __forceinline__ T ratio_of(T sigma, T mu_old, bool fresh, T tiny) {
  return fresh ? sigma : sigma / clamp_min(mu_old, tiny);
}

// Blocks over (message, run of sepset entries): the block prefix msg_blocks
// maps a block to its message.
template <typename T, bool kMax, int W>
__global__ void __launch_bounds__(kBlock) sepset_wave_kernel(
    const T* __restrict__ arena, T* __restrict__ mu, T* __restrict__ scratch,
    const long long* __restrict__ cliques, const long long* __restrict__ msgs,
    const long long* __restrict__ wave_msgs, const long long* __restrict__ msg_blocks,
    int n_msgs, T tiny) {
  __shared__ int s_slot;
  __shared__ unsigned s_kd[W], s_ks[W], s_rd[W], s_rs[W];
  __shared__ double s_part[kBlock];
  if (threadIdx.x == 0) s_slot = find_slot(msg_blocks, n_msgs, blockIdx.x);
  __syncthreads();
  const long long* row = msgs + wave_msgs[s_slot] * Rows<W>::kMsg;
  const MessageShape m = load_message<W>(row, cliques, s_kd, s_ks, s_rd, s_rs);
  const unsigned j = (unsigned)(blockIdx.x - msg_blocks[s_slot]) * (kBlock >> m.lanes_log2) +
                     (threadIdx.x >> m.lanes_log2);
  const double sigma = sigma_entry<T, kMax, W>(arena, m, j, s_kd, s_ks, s_rd, s_rs, s_part);
  if ((threadIdx.x & ((1u << m.lanes_log2) - 1)) == 0 && j < m.size) {
    const T s = (T)sigma;
    const long long sep = row[kMsgSepset] + j;
    scratch[row[kMsgRatio] + j] = ratio_of(s, mu[sep], row[kMsgFresh] != 0, tiny);
    mu[sep] = s;
  }
}

// With normalize_messages: one block per message walks all its sepset
// entries, run by run, keeping sigma in scratch, then divides by the total.
template <typename T, bool kMax, int W>
__global__ void __launch_bounds__(kBlock) sepset_wave_normalized_kernel(
    const T* __restrict__ arena, T* __restrict__ mu, T* __restrict__ scratch,
    const long long* __restrict__ cliques, const long long* __restrict__ msgs,
    const long long* __restrict__ wave_msgs, T tiny) {
  __shared__ unsigned s_kd[W], s_ks[W], s_rd[W], s_rs[W];
  __shared__ double s_part[kBlock];
  const long long* row = msgs + wave_msgs[blockIdx.x] * Rows<W>::kMsg;
  const MessageShape m = load_message<W>(row, cliques, s_kd, s_ks, s_rd, s_rs);
  T* sig = scratch + row[kMsgRatio];
  const unsigned per_run = kBlock >> m.lanes_log2;
  const bool lead = (threadIdx.x & ((1u << m.lanes_log2) - 1)) == 0;
  double total = 0.0;
  for (unsigned j0 = 0; j0 < m.size; j0 += per_run) {
    const unsigned j = j0 + (threadIdx.x >> m.lanes_log2);
    const double sigma = sigma_entry<T, kMax, W>(arena, m, j, s_kd, s_ks, s_rd, s_rs, s_part);
    if (lead && j < m.size) {
      const T s = (T)sigma;
      sig[j] = s;
      total += (double)s;
    }
    __syncthreads();  // s_part is reused by the next run
  }
  s_part[threadIdx.x] = total;
  __syncthreads();
  for (int s = kBlock >> 1; s > 0; s >>= 1) {
    if (threadIdx.x < s) s_part[threadIdx.x] += s_part[threadIdx.x + s];
    __syncthreads();
  }
  const T denom = clamp_min((T)s_part[0], tiny);
  const bool fresh = row[kMsgFresh] != 0;
  T* old = mu + row[kMsgSepset];
  for (unsigned j = threadIdx.x; j < m.size; j += kBlock) {
    const T s = sig[j] / denom;
    sig[j] = ratio_of(s, old[j], fresh, tiny);
    old[j] = s;
  }
}

template <typename T, int W>
__global__ void __launch_bounds__(kBlock) absorb_wave_kernel(
    T* __restrict__ arena, const T* __restrict__ scratch, const long long* __restrict__ cliques,
    const long long* __restrict__ msgs, const long long* __restrict__ groups,
    const long long* __restrict__ group_blocks, int n_groups,
    const long long* __restrict__ group_msgs, int per_block) {
  __shared__ int s_group;
  __shared__ unsigned s_dims[W];
  if (threadIdx.x == 0) s_group = find_slot(group_blocks, n_groups, blockIdx.x);
  __syncthreads();
  const int g = s_group;
  const long long* grow = groups + 3LL * g;
  const long long* row = cliques + grow[0] * Rows<W>::kClique;
  if (threadIdx.x < W) s_dims[threadIdx.x] = (unsigned)row[kCliqueHeader + threadIdx.x];
  __syncthreads();
  const long long offset = row[0];
  const unsigned size = (unsigned)row[1];
  const int nd = (int)row[2];
  const long long in_begin = grow[1], in_end = grow[2];
  const unsigned begin = (unsigned)(blockIdx.x - group_blocks[g]) * (unsigned)per_block;
  const unsigned end = min(size, begin + (unsigned)per_block);
  for (unsigned i = begin + threadIdx.x; i < end; i += kBlock) {
    unsigned digit[W];
    decode<W>(i, nd, s_dims, digit);
    T x = arena[offset + i];
    for (long long k = in_begin; k < in_end; ++k) {
      const long long* mrow = msgs + group_msgs[k] * Rows<W>::kMsg;
      long long idx = 0;
#pragma unroll
      for (int a = 0; a < W; ++a) idx += (long long)digit[a] * mrow[Rows<W>::kDstStrides + a];
      x = x * scratch[mrow[kMsgRatio] + idx];
    }
    arena[offset + i] = x;
  }
}

bool bad_launch(long long n_blocks) { return n_blocks <= 0 || n_blocks > 0x7fffffffLL; }

template <typename T, int W>
void launch_potentials(dim3 grid, cudaStream_t s, void* arena, const long long* c,
                       const long long* cb, int n_cliques, const long long* cf,
                       const long long* f, const void* tables, int per_block) {
  clique_potentials_kernel<T, W><<<grid, kBlock, 0, s>>>(
      static_cast<T*>(arena), c, cb, n_cliques, cf, f, static_cast<const T* const*>(tables),
      per_block);
}

template <typename T, int W>
void launch_sepset_wave(int maximize, int normalize, const void* arena, void* mu, void* scratch,
                        const long long* c, const long long* m, const long long* wm,
                        const long long* mb, int n_msgs, long long n_blocks, double tiny,
                        cudaStream_t s) {
  const auto* a = static_cast<const T*>(arena);
  auto* u = static_cast<T*>(mu);
  auto* r = static_cast<T*>(scratch);
  const T t = (T)tiny;
  if (normalize) {
    if (maximize)
      sepset_wave_normalized_kernel<T, true, W><<<n_msgs, kBlock, 0, s>>>(a, u, r, c, m, wm, t);
    else
      sepset_wave_normalized_kernel<T, false, W><<<n_msgs, kBlock, 0, s>>>(a, u, r, c, m, wm, t);
  } else {
    const dim3 grid((unsigned)n_blocks);
    if (maximize)
      sepset_wave_kernel<T, true, W><<<grid, kBlock, 0, s>>>(a, u, r, c, m, wm, mb, n_msgs, t);
    else
      sepset_wave_kernel<T, false, W><<<grid, kBlock, 0, s>>>(a, u, r, c, m, wm, mb, n_msgs, t);
  }
}

template <typename T, int W>
void launch_absorb_wave(dim3 grid, cudaStream_t s, void* arena, const void* scratch,
                        const long long* c, const long long* m, const long long* g,
                        const long long* gb, int n_groups, const long long* gm, int per_block) {
  absorb_wave_kernel<T, W><<<grid, kBlock, 0, s>>>(
      static_cast<T*>(arena), static_cast<const T*>(scratch), c, m, g, gb, n_groups, gm,
      per_block);
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

extern "C" int pgmpy_jt_clique_potentials(int elem_bytes, void* arena, const void* cliques,
                                          const void* clique_blocks, int n_cliques,
                                          const void* clique_factors, const void* factors,
                                          const void* tables, long long n_blocks, int per_block,
                                          int width, void* stream) {
  const auto launch = PGMPY_JT_PICK(launch_potentials, elem_bytes, width);
  if (!launch || bad_launch(n_blocks) || per_block <= 0) return (int)cudaErrorInvalidValue;
  launch(dim3((unsigned)n_blocks), static_cast<cudaStream_t>(stream), arena,
         static_cast<const long long*>(cliques), static_cast<const long long*>(clique_blocks),
         n_cliques, static_cast<const long long*>(clique_factors),
         static_cast<const long long*>(factors), tables, per_block);
  return (int)cudaGetLastError();
}

// n_blocks: the wave's block count, or n_msgs with normalize (one block per message).
extern "C" int pgmpy_jt_sepset_wave(int elem_bytes, int maximize, int normalize,
                                    const void* arena, void* mu, void* scratch,
                                    const void* cliques, const void* msgs, const void* wave_msgs,
                                    const void* msg_blocks, int n_msgs, long long n_blocks,
                                    int width, double tiny, void* stream) {
  const auto launch = PGMPY_JT_PICK(launch_sepset_wave, elem_bytes, width);
  if (!launch || bad_launch(n_blocks) || n_msgs <= 0 || (normalize && n_blocks != n_msgs))
    return (int)cudaErrorInvalidValue;
  launch(maximize, normalize, arena, mu, scratch, static_cast<const long long*>(cliques),
         static_cast<const long long*>(msgs), static_cast<const long long*>(wave_msgs),
         static_cast<const long long*>(msg_blocks), n_msgs, n_blocks, tiny,
         static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

extern "C" int pgmpy_jt_absorb_wave(int elem_bytes, void* arena, const void* scratch,
                                    const void* cliques, const void* msgs, const void* groups,
                                    const void* group_blocks, int n_groups,
                                    const void* group_msgs, long long n_blocks, int per_block,
                                    int width, void* stream) {
  const auto launch = PGMPY_JT_PICK(launch_absorb_wave, elem_bytes, width);
  if (!launch || bad_launch(n_blocks) || n_groups <= 0 || per_block <= 0)
    return (int)cudaErrorInvalidValue;
  launch(dim3((unsigned)n_blocks), static_cast<cudaStream_t>(stream), arena, scratch,
         static_cast<const long long*>(cliques), static_cast<const long long*>(msgs),
         static_cast<const long long*>(groups), static_cast<const long long*>(group_blocks),
         n_groups, static_cast<const long long*>(group_msgs), per_block);
  return (int)cudaGetLastError();
}
