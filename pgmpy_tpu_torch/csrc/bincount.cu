// Count kernels for Hopper (sm_90a): every count table of a fit in one launch.
//
//   table count   out[offset_s + sum_j codes[col_sj][i] * stride_sj] += w_i
//                 for every row i of every spec s whose k_s codes are all >= 0
//   bincount      out[idx[i]] += w[i] for 0 <= idx[i] < length
//                 (the table count with one spec, one column, stride 1)
//
// Replaces, from the JAX package:
//   * pgmpy_tpu/ops/pallas_kernels.py:_bincount_kernel (weighted_bincount_pallas),
//     a one-hot (chunk, length) matrix contracted with the weights on the MXU,
//     capped at 1024 bins by VMEM;
//   * pgmpy_tpu/estimators/base.py:_multi_counts_kernel and
//     _padded_counts_kernel, which build an (n_specs x n_rows) flat-index array
//     and a repeated weight array for one scatter-add and rely on XLA to fuse
//     them (the padded one also buckets shapes so that XLA does not retrace).
// Here the spec list is DATA: a descriptor table in device memory, one row per
// spec.  No index vector and no repeated weight vector exist anywhere, and a
// new spec list never recompiles anything.
//
// Bound: bytes.  The work is one integer multiply-add and one atomic per
// (row, column); the card is limited by reading the codes.  A fit must read the
// code matrix once: MUNIN's 50,000 x 1041 codes are 208.2 MB as int32, 0.062 ms
// at 3.35 TB/s, and 52 MB (0.016 ms) in the int8 storage described below, plus
// the weights (n_rows * 4 or 8 bytes) and the tables written once.  A single
// 50,000-row histogram moves 0.4 MB, 0.00012 ms, far below any launch's
// latency: only many tables per launch can come near the bound.
//
// What the design does about it:
//   1. Grid over (spec, row tile): blockIdx.x is the spec, blockIdx.y the row
//      tile.  A block reads its spec's descriptor, zeroes a private histogram
//      in dynamic shared memory, walks its rows, computes the flat index in
//      registers, adds into shared memory and flushes the non-zero bins to
//      out[offset_s + b].  The wrapper plans the tiles: enough to fill the
//      card about once, never so short that a thread has less than one
//      16-byte load, never with fewer rows than the histogram has entries
//      (zeroing and flushing stay under the adds).  A spec goes straight to
//      global atomics when its table has more bins than its tile has rows or
//      does not fit the shared-memory budget: the 48 KB a launch gets without
//      opting in to more, static arrays included.  A larger budget did not
//      pay at any shape the port produces (PERF.md section 6).
//   2. Coalesced code reads from a column-major copy.  The caller's matrix is
//      row-major n_rows x n_vars, where one column costs a 32-byte sector per
//      4-byte code.  The kernel takes a second, column-major copy
//      (n_vars x ld, ld a multiple of 16, made once when the data is coded),
//      stored as int8 or int16 when every cardinality allows: a block's reads
//      are contiguous runs of its columns, 16 bytes per thread per load.
//      Staging row tiles through shared memory instead would still read every
//      column of a tile for a spec that needs two of them.
//   3. Small tables are replicated in shared memory (up to 32 interleaved
//      copies, one per lane residue) so that lanes of a warp that hit the same
//      bin hit different addresses; the flush sums the copies with shuffles.
//   4. Unweighted counts are int32 in shared and global memory: no weight
//      vector is read, counts are exact at any n_rows below 2^31 and the same
//      from run to run.  Weighted sums use float or double atomics, whose
//      order changes from run to run, so they agree with a sequential sum only
//      to rounding (rtol 1e-5 in f32).
//   5. The launcher zeroes `out` with cudaMemsetAsync on the launch's stream:
//      one allocation and one launch per call, whatever the number of specs.
//
// The wrapper (pgmpy_tpu_torch/ops/bincount.py) allocates `out`, plans tiles
// and replication, uploads the descriptor table and calls the extern "C"
// launchers through ctypes; each returns the launch's cudaError_t.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kMaxCols = 32;
// Descriptor row (int64): k, offset, size, tiles, rows_per_tile, repl_log2
// (-1: global atomics), then max_cols column numbers, then max_cols strides.
constexpr int kHeader = 6;

struct Tile {
  int k;
  long long offset;
  long long size;
  long long row_begin;
  long long row_end;
  int repl_log2;
};

template <typename C, int VEC>
struct alignas(sizeof(C) * VEC) CodePack {
  C v[VEC];
};

template <typename H, int VEC>
struct alignas(sizeof(H) * VEC < 16 ? sizeof(H) * VEC : 16) WeightPack {
  H v[VEC];
};

// One block's share of one table.  `codes` is column-major with leading
// dimension `ld`; column starts and row_begin are 16-byte aligned.
template <typename C, typename H, bool WEIGHTED>
__device__ __forceinline__ void count_tile(const C* __restrict__ codes, long long ld,
                                           const H* __restrict__ w, H* __restrict__ out,
                                           const Tile& t, const int* s_cols,
                                           const long long* s_strides, H* hist) {
  constexpr int VEC = 16 / (int)sizeof(C);
  using F = typename std::conditional<sizeof(C) == 8, long long, int>::type;

  const bool shared = t.repl_log2 >= 0;
  const int r = shared ? t.repl_log2 : 0;
  const int entries = shared ? (int)(t.size << r) : 0;
  for (int e = threadIdx.x; e < entries; e += blockDim.x) hist[e] = H(0);
  __syncthreads();  // also publishes s_cols / s_strides

  H* dst = shared ? hist : out + t.offset;
  const F copy = (F)(threadIdx.x & ((1u << r) - 1u));
  const long long step = (long long)blockDim.x * VEC;
  for (long long row0 = t.row_begin + (long long)threadIdx.x * VEC; row0 < t.row_end;
       row0 += step) {
    const bool full = row0 + VEC <= t.row_end;
    F flat[VEC];
    F neg[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      flat[v] = 0;
      neg[v] = 0;
    }
    for (int j = 0; j < t.k; ++j) {
      const C* p = codes + (long long)s_cols[j] * ld + row0;
      const F stride = (F)s_strides[j];
      if (full) {
        const CodePack<C, VEC> pack = *reinterpret_cast<const CodePack<C, VEC>*>(p);
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const F c = (F)pack.v[v];
          flat[v] += c * stride;
          neg[v] |= c;
        }
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const F c = row0 + v < t.row_end ? (F)p[v] : (F)-1;
          flat[v] += c * stride;
          neg[v] |= c;
        }
      }
    }
    H wv[VEC];
    if (WEIGHTED) {
      if (full) {
        const WeightPack<H, VEC> pack = *reinterpret_cast<const WeightPack<H, VEC>*>(w + row0);
#pragma unroll
        for (int v = 0; v < VEC; ++v) wv[v] = pack.v[v];
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) wv[v] = row0 + v < t.row_end ? w[row0 + v] : H(0);
      }
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) wv[v] = H(1);
    }
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      if (neg[v] >= 0 && (long long)flat[v] < t.size) atomicAdd(dst + ((flat[v] << r) | copy), wv[v]);
    }
  }

  if (shared) {
    __syncthreads();
    const int copies = 1 << r;
    H* table = out + t.offset;
    // Lanes e .. e + copies - 1 hold the copies of bin e >> r; base and
    // blockDim.x are multiples of 32, so a group never straddles a warp.
    for (int base = 0; base < entries; base += blockDim.x) {
      const int e = base + (int)threadIdx.x;
      H v = e < entries ? hist[e] : H(0);
      for (int o = copies >> 1; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
      if ((threadIdx.x & (copies - 1)) == 0 && e < entries && v != H(0)) {
        atomicAdd(table + (e >> r), v);
      }
    }
  }
}

template <typename C, typename H, bool WEIGHTED>
__global__ void table_count_kernel(const C* __restrict__ codes, long long ld, long long n_rows,
                                   const H* __restrict__ w, H* __restrict__ out,
                                   const long long* __restrict__ desc, int max_cols) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_cols[kMaxCols];
  __shared__ long long s_strides[kMaxCols];
  const long long* d = desc + (long long)blockIdx.x * (kHeader + 2 * max_cols);
  if ((long long)blockIdx.y >= d[3]) return;  // this spec has fewer tiles
  Tile t;
  t.k = (int)d[0];
  t.offset = d[1];
  t.size = d[2];
  t.row_begin = (long long)blockIdx.y * d[4];
  t.row_end = min(n_rows, t.row_begin + d[4]);
  t.repl_log2 = (int)d[5];
  if ((int)threadIdx.x < t.k) {
    s_cols[threadIdx.x] = (int)d[kHeader + threadIdx.x];
    s_strides[threadIdx.x] = d[kHeader + max_cols + threadIdx.x];
  }
  count_tile<C, H, WEIGHTED>(codes, ld, w, out, t, s_cols, s_strides,
                             reinterpret_cast<H*>(smem_raw));
}

// The TPU kernel's own contract: one histogram of a caller's index vector.
template <typename C, typename H>
__global__ void bincount_kernel(const C* __restrict__ idx, const H* __restrict__ w,
                                H* __restrict__ out, long long n, long long length,
                                long long rows_per_tile, int repl_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_cols[1];
  __shared__ long long s_strides[1];
  Tile t;
  t.k = 1;
  t.offset = 0;
  t.size = length;
  t.row_begin = (long long)blockIdx.x * rows_per_tile;
  t.row_end = min(n, t.row_begin + rows_per_tile);
  t.repl_log2 = repl_log2;
  if (threadIdx.x == 0) {
    s_cols[0] = 0;
    s_strides[0] = 1;
  }
  count_tile<C, H, true>(idx, 0, w, out, t, s_cols, s_strides, reinterpret_cast<H*>(smem_raw));
}

template <typename C, typename H, bool WEIGHTED>
cudaError_t launch_table(const void* codes, long long ld, long long n_rows, const void* w,
                         void* out, const void* desc, int n_specs, int max_cols, int max_tiles,
                         int block, long long smem, cudaStream_t stream) {
  const dim3 grid((unsigned)n_specs, (unsigned)max_tiles);
  table_count_kernel<C, H, WEIGHTED><<<grid, block, (size_t)smem, stream>>>(
      static_cast<const C*>(codes), ld, n_rows, static_cast<const H*>(w), static_cast<H*>(out),
      static_cast<const long long*>(desc), max_cols);
  return cudaGetLastError();
}

template <typename C>
cudaError_t launch_table_codes(const void* codes, long long ld, long long n_rows, const void* w,
                               int weight_bytes, void* out, const void* desc, int n_specs,
                               int max_cols, int max_tiles, int block, long long smem,
                               cudaStream_t stream) {
  if (weight_bytes == 0)
    return launch_table<C, int, false>(codes, ld, n_rows, w, out, desc, n_specs, max_cols,
                                       max_tiles, block, smem, stream);
  if (weight_bytes == 4)
    return launch_table<C, float, true>(codes, ld, n_rows, w, out, desc, n_specs, max_cols,
                                        max_tiles, block, smem, stream);
  if (weight_bytes == 8)
    return launch_table<C, double, true>(codes, ld, n_rows, w, out, desc, n_specs, max_cols,
                                         max_tiles, block, smem, stream);
  return cudaErrorInvalidValue;
}

template <typename C, typename H>
cudaError_t launch_bincount(const void* idx, const void* w, void* out, long long n,
                            long long length, long long rows_per_tile, int tiles, int repl_log2,
                            int block, long long smem, cudaStream_t stream) {
  bincount_kernel<C, H><<<tiles, block, (size_t)smem, stream>>>(
      static_cast<const C*>(idx), static_cast<const H*>(w), static_cast<H*>(out), n, length,
      rows_per_tile, repl_log2);
  return cudaGetLastError();
}

}  // namespace

// Zeroes `out` (out_bytes) and counts n_specs tables into it in one launch.
// code_bytes: 1, 2 or 4 (int8, int16, int32 codes, column-major, leading
// dimension ld).  weight_bytes: 0 (unweighted, int32 out), 4 (float) or
// 8 (double); out has the weights' type.  desc: int64, n_specs rows of
// 6 + 2 * max_cols entries.  smem: dynamic shared memory per block.
extern "C" int pgmpy_table_count(const void* codes, int code_bytes, long long ld, long long n_rows,
                                 const void* weights, int weight_bytes, void* out,
                                 long long out_bytes, const void* desc, int n_specs, int max_cols,
                                 int max_tiles, int block, long long smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (max_cols < 1 || max_cols > kMaxCols || block % 32 != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)out_bytes, s);
  if (err != cudaSuccess) return (int)err;
  if (code_bytes == 1)
    return launch_table_codes<int8_t>(codes, ld, n_rows, weights, weight_bytes, out, desc,
                                      n_specs, max_cols, max_tiles, block, smem, s);
  if (code_bytes == 2)
    return launch_table_codes<int16_t>(codes, ld, n_rows, weights, weight_bytes, out, desc,
                                       n_specs, max_cols, max_tiles, block, smem, s);
  if (code_bytes == 4)
    return launch_table_codes<int32_t>(codes, ld, n_rows, weights, weight_bytes, out, desc,
                                       n_specs, max_cols, max_tiles, block, smem, s);
  return (int)cudaErrorInvalidValue;
}

// Zeroes `out` (length values) and adds w[i] into out[idx[i]]; indices outside
// [0, length) are skipped.  value_bytes: 4 (float) or 8 (double); index_bytes:
// 4 (int32) or 8 (int64).  repl_log2 < 0 selects direct global atomics.
extern "C" int pgmpy_weighted_bincount(const void* idx, const void* w, void* out, long long n,
                                       long long length, int value_bytes, int index_bytes,
                                       long long rows_per_tile, int tiles, int repl_log2,
                                       int block, long long smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block % 32 != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)(length * value_bytes), s);
  if (err != cudaSuccess) return (int)err;
  if (value_bytes == 4 && index_bytes == 4)
    return launch_bincount<int32_t, float>(idx, w, out, n, length, rows_per_tile, tiles,
                                           repl_log2, block, smem, s);
  if (value_bytes == 4 && index_bytes == 8)
    return launch_bincount<int64_t, float>(idx, w, out, n, length, rows_per_tile, tiles,
                                           repl_log2, block, smem, s);
  if (value_bytes == 8 && index_bytes == 4)
    return launch_bincount<int32_t, double>(idx, w, out, n, length, rows_per_tile, tiles,
                                            repl_log2, block, smem, s);
  if (value_bytes == 8 && index_bytes == 8)
    return launch_bincount<int64_t, double>(idx, w, out, n, length, rows_per_tile, tiles,
                                            repl_log2, block, smem, s);
  return (int)cudaErrorInvalidValue;
}
