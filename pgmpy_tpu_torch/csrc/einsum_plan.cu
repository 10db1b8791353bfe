// The planned contraction (K3) and the exact filter's scan (K10) for Hopper
// (sm_90a).
//
// A contraction is a cached plan of steps (pgmpy_tpu_torch/ops/einsum.py:
// PlanTable).  Each step has one or two inputs and computes
//
//   out[o] = sum over r of A[a(o) + a(r)] * B[b(o) + b(r)]
//
// where o runs over the step's output entries (row-major, the result's label
// order) and r over its reduced entries; a(.) and b(.) are the inputs' offsets
// of a mixed-radix index, sum over labels of digit * stride (stride 0 where a
// label is absent).  A one-input step is a reduction.  An input is an operand
// (a pointer of the launch's parameter block) or an intermediate in the arena;
// the last step writes the call's output in its label order.
//
// Replaces, from the JAX package: pgmpy_tpu/ops/einsum.py:26 `sum_product`,
// :57 `_cached_path` and :73 `sum_product_planned` (one XLA program per
// signature), and pgmpy_tpu/inference/dbn.py:131 `forward_scan` (its
// `contract` :174 and `step` :206 inside the `lax.scan` :227).  The port's
// plain versions: one `torch.einsum` per plan step (1-3 kernels each), and a
// host loop of (1 + queries) contractions per filter slice (ALARM as a 2-TBN:
// 692.6 kernels per slice).
//
// Bound: small plans are latency; large steps bytes.  The ALARM filter's
// contractions are 74 steps of at most 864 union entries (about 5,300
// multiply-adds each): a slice is ~518 dependent steps, far below what one
// launch per step can carry.  A MUNIN query_batch step walks 289 M union
// entries, each reading two inputs.
//
// What the design does about it:
//   1. Two schedules, chosen on the host from the plan alone.  `plan_block`
//      runs the whole plan in ONE launch of one block when every step's union
//      is within ops/einsum.py:BLOCK_UNION (2^16): a step's descriptor is
//      staged in shared memory while the previous step runs, one barrier per
//      step, the intermediates in shared memory when they fit.  `plan_step`
//      makes one launch per step over the whole grid for the rest.
//   2. Few outputs, long reductions: each output entry is summed by `lanes`
//      threads (a power of two chosen per step: ~32 reduced entries a lane,
//      more lanes while the block would idle), each over a contiguous chunk
//      of the reduced entries walked by an odometer (no division per entry),
//      then combined by warp shuffles and, past 32 lanes, shared memory, in a
//      fixed order: a 3-state marginal of 141 k entries runs on 3 x 256
//      threads, not on 3.
//   3. Labels are merged on the host where every tensor walks two neighbours
//      as one, and extent-1 labels dropped, so steps decode few digits (at
//      most kMaxLabels output and kMaxLabels reduced labels; wider raises).
//   4. Sums in double for both float and double tables (no TF32 anywhere);
//      results are stored in the tables' type, as the plain version stores
//      them.
//   5. K10: `filter_scan` loops over the slices inside one block: it fills
//      the slice's evidence deltas in the arena from its row of codes, runs
//      the slice's steps with the block executor above, then normalises
//      each result (a sum of 0 gives NaN, as m / m.sum() does): the queries
//      into the output row, the interface into alpha.  Where the joint over
//      the interface and the queries holds at most BLOCK_UNION entries, the
//      slice is one contraction to that joint and a one-input step from it
//      per output (ALARM: 81 steps a slice, where the 1 + 6 separate plans
//      of the plain version take 518).
//
// The wrapper (pgmpy_tpu_torch/ops/einsum.py) compiles and uploads the step
// tables and calls the extern "C" launchers through ctypes on PyTorch's
// current stream; each returns the launch's cudaError_t.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxLabels = 12;   // ops/einsum.py: MAX_LABELS
constexpr int kHeader = 10;      // len(ops/einsum.py: HEADER)
constexpr int kStepWords = kHeader + 6 * kMaxLabels;
constexpr int kMaxOperands = 448;  // ops/einsum.py: MAX_OPERANDS
constexpr int kBlockThreads = 512;  // ops/einsum.py: BLOCK_THREADS
constexpr int kStepThreads = 256;   // ops/einsum.py: STEP_THREADS

// header words of a step
constexpr int kNIn = 0, kIn0 = 1, kIn1 = 2, kOut = 3, kNOut = 4, kNRed = 5, kOutCount = 6,
              kRedCount = 7, kLanes = 8, kChunk = 9;

// The operands' pointers, by value in the launch's parameter block; `many`
// (a device array) replaces them when a call has more than kMaxOperands.
struct Operands {
  const void* p[kMaxOperands];
  const void* const* many;
};

// An input slot: >= 0 an operand, < 0 the arena at -(slot + 1).
template <typename T>
__device__ __forceinline__ const T* input(long long slot, const Operands& ops, const T* arena) {
  if (slot >= 0) return static_cast<const T*>(ops.many != nullptr ? ops.many[slot] : ops.p[slot]);
  return arena + (-slot - 1);
}

// The next mixed-radix digit of `rest` (extent e), in 32 bits where the
// step's counts fit (`narrow`): a 64-bit division costs several times more.
__device__ __forceinline__ long long next_digit(long long& rest, long long e, bool narrow) {
  if (narrow) {
    const unsigned r = (unsigned)rest, q = r / (unsigned)e;
    rest = q;
    return (long long)(r - q * (unsigned)e);
  }
  const long long q = rest / e, digit = rest - q * e;
  rest = q;
  return digit;
}

// One lane's partial sum: output entry o, reduced entries [lane * chunk,
// (lane + 1) * chunk) of the step described by d.
template <typename T>
__device__ double partial(const long long* d, const T* a, const T* b, long long o, long long lane) {
  const int n_out = (int)d[kNOut], n_red = (int)d[kNRed];
  const long long* out_ext = d + kHeader;
  const long long* red_ext = out_ext + kMaxLabels;
  const long long* a_out = red_ext + kMaxLabels;
  const long long* a_red = a_out + kMaxLabels;
  const long long* b_out = a_red + kMaxLabels;
  const long long* b_red = b_out + kMaxLabels;
  const long long chunk = d[kChunk];
  long long r = lane * chunk;
  const long long hi = min(r + chunk, d[kRedCount]);
  if (r >= hi) return 0.0;
  const bool narrow = d[kOutCount] <= 0xffffffffLL && d[kRedCount] <= 0xffffffffLL;
  long long oa = 0, ob = 0, rest = o;
  for (int l = 0; l < n_out; ++l) {
    const long long digit = next_digit(rest, out_ext[l], narrow);
    oa += digit * a_out[l];
    ob += digit * b_out[l];
  }
  long long digits[kMaxLabels];
  rest = r;
  for (int l = 0; l < n_red; ++l) {
    const long long digit = next_digit(rest, red_ext[l], narrow);
    digits[l] = digit;
    oa += digit * a_red[l];
    ob += digit * b_red[l];
  }
  double acc = 0.0;
  for (; r < hi; ++r) {
    acc += b != nullptr ? (double)a[oa] * (double)b[ob] : (double)a[oa];
    // the odometer: innermost label first
    for (int l = 0; l < n_red; ++l) {
      oa += a_red[l];
      ob += b_red[l];
      if (++digits[l] < red_ext[l]) break;
      digits[l] = 0;
      oa -= a_red[l] * red_ext[l];
      ob -= b_red[l] * red_ext[l];
    }
  }
  return acc;
}

// The sum of v over each group of `lanes` consecutive threads (a power of
// two dividing blockDim.x), in a fixed order; the group's first thread holds
// it.  Every thread of the block calls it.
__device__ __forceinline__ double group_sum(double v, int lanes, double* scratch) {
  const int width = lanes < 32 ? lanes : 32;
  for (int s = width >> 1; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s, width);
  if (lanes > 32) {  // the group's warps meet in shared memory
    const int warp = threadIdx.x >> 5;
    __syncthreads();  // the previous round's scratch is read
    if ((threadIdx.x & 31) == 0) scratch[warp] = v;
    __syncthreads();
    if ((threadIdx.x & (lanes - 1)) == 0) {
      double s = 0.0;
      for (int w = 0; w < lanes / 32; ++w) s += scratch[warp + w];
      v = s;
    }
  }
  return v;
}

// Tasks [first, end) of one step, `stride` apart per round, by every thread
// of the block: task t is output t / lanes, lane t % lanes.
template <typename T>
__device__ void run_tasks(const long long* d, const Operands& ops, T* arena, T* out,
                          double* scratch, long long first, long long stride) {
  const T* a = input<T>(d[kIn0], ops, arena);
  const T* b = d[kNIn] > 1 ? input<T>(d[kIn1], ops, arena) : nullptr;
  T* dst = d[kOut] < 0 ? out : arena + d[kOut];
  const int lanes = (int)d[kLanes], shift = __ffs(lanes) - 1;  // lanes: a power of two
  const long long tasks = d[kOutCount] * lanes;
  for (long long base = first; base < tasks; base += stride) {
    const long long t = base + threadIdx.x;
    double v = 0.0;
    if (t < tasks) v = partial<T>(d, a, b, t >> shift, t & (lanes - 1));
    v = group_sum(v, lanes, scratch);
    if (t < tasks && (t & (lanes - 1)) == 0) dst[t >> shift] = (T)v;
  }
}

// Every step of a plan by one block, a barrier after each; the next step's
// descriptor is staged while the current one runs.
template <typename T>
__device__ void run_steps(const long long* steps, int n_steps, const Operands& ops, T* arena,
                          T* out, long long (*desc)[kStepWords], double* scratch) {
  if (n_steps == 0) return;
  for (int i = threadIdx.x; i < kStepWords; i += blockDim.x) desc[0][i] = steps[i];
  __syncthreads();
  for (int s = 0; s < n_steps; ++s) {
    if (s + 1 < n_steps) {
      const long long* next = steps + (long long)(s + 1) * kStepWords;
      for (int i = threadIdx.x; i < kStepWords; i += blockDim.x) desc[(s + 1) & 1][i] = next[i];
    }
    run_tasks<T>(desc[s & 1], ops, arena, out, scratch, 0, blockDim.x);
    __syncthreads();  // the step's result is written
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlockThreads)
    plan_block_kernel(const long long* __restrict__ steps, int n_steps,
                      const __grid_constant__ Operands ops, T* arena_global, T* out,
                      int shared_arena) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ long long desc[2][kStepWords];
  __shared__ double scratch[kBlockThreads / 32];
  T* arena = shared_arena ? reinterpret_cast<T*>(smem_raw) : arena_global;
  run_steps<T>(steps, n_steps, ops, arena, out, desc, scratch);
}

template <typename T>
__global__ void __launch_bounds__(kStepThreads)
    plan_step_kernel(const long long* __restrict__ step, const __grid_constant__ Operands ops,
                     T* arena, T* out) {
  __shared__ long long desc[kStepWords];
  __shared__ double scratch[kStepThreads / 32];
  for (int i = threadIdx.x; i < kStepWords; i += blockDim.x) desc[i] = step[i];
  __syncthreads();
  run_tasks<T>(desc, ops, arena, out, scratch, (long long)blockIdx.x * blockDim.x,
               (long long)gridDim.x * blockDim.x);
}

// K10.  deltas: (arena offset, variable, state) per delta entry; results:
// (arena offset, entries, output column or -1 for the interface, 0) per
// output; codes: (n_slices, n_vars) int32, -1 where unobserved; out:
// (n_slices, width).  Alpha lives at arena offset 0.
template <typename T>
__global__ void __launch_bounds__(kBlockThreads)
    filter_scan_kernel(const long long* __restrict__ steps, int n_steps,
                       const long long* __restrict__ deltas, int n_delta,
                       const long long* __restrict__ results, int n_results,
                       const __grid_constant__ Operands ops, T* arena_global, int shared_arena,
                       const T* __restrict__ alpha0, int alpha_size,
                       const int* __restrict__ codes, int n_vars, int n_slices, T* out,
                       int width) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ long long desc[2][kStepWords];
  __shared__ double scratch[kBlockThreads / 32];
  T* arena = shared_arena ? reinterpret_cast<T*>(smem_raw) : arena_global;
  for (int i = threadIdx.x; i < alpha_size; i += blockDim.x) arena[i] = alpha0[i];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int t = 0; t < n_slices; ++t) {
    const int* row = codes + (long long)t * n_vars;
    for (int e = threadIdx.x; e < n_delta; e += blockDim.x) {
      const long long* de = deltas + 3LL * e;
      const int code = row[de[1]];
      arena[de[0]] = (code < 0 || code == (int)de[2]) ? T(1) : T(0);
    }
    __syncthreads();  // the deltas (and the new alpha) are in the arena
    run_steps<T>(steps, n_steps, ops, arena, nullptr, desc, scratch);
    for (int r = warp; r < n_results; r += warps) {
      const long long* re = results + 4LL * r;
      const T* m = arena + re[0];
      const int entries = (int)re[1];
      double s = 0.0;
      for (int k = lane; k < entries; k += 32) s += (double)m[k];
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      T* dst = re[2] < 0 ? arena : out + (long long)t * width + re[2];
      for (int k = lane; k < entries; k += 32) dst[k] = (T)((double)m[k] / s);
    }
    __syncthreads();
  }
}

// Dynamic shared memory past the default 48 KB, which the kernels' static
// shared memory (at most 1,440 bytes) counts against too, needs an opt-in.
template <typename K>
cudaError_t allow_shared(K kernel, long long bytes) {
  if (bytes <= 46 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

cudaError_t pack(Operands& ops, const void* const* host_ptrs, int n_ptrs, const void* many) {
  if (n_ptrs < 0 || (n_ptrs > kMaxOperands && many == nullptr)) return cudaErrorInvalidValue;
  for (int i = 0; i < kMaxOperands; ++i) ops.p[i] = i < n_ptrs ? host_ptrs[i] : nullptr;
  ops.many = static_cast<const void* const*>(many);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_block(const void* steps, int n_steps, const Operands& ops, void* arena,
                         void* out, long long shared_bytes, cudaStream_t stream) {
  cudaError_t err = allow_shared(plan_block_kernel<T>, shared_bytes);
  if (err != cudaSuccess) return err;
  plan_block_kernel<T><<<1, kBlockThreads, (size_t)shared_bytes, stream>>>(
      static_cast<const long long*>(steps), n_steps, ops, static_cast<T*>(arena),
      static_cast<T*>(out), shared_bytes > 0);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_steps(const void* steps, const long long* blocks, int n_steps,
                         const Operands& ops, void* arena, void* out, cudaStream_t stream) {
  const long long* table = static_cast<const long long*>(steps);
  for (int s = 0; s < n_steps; ++s) {
    plan_step_kernel<T><<<(unsigned)blocks[s], kStepThreads, 0, stream>>>(
        table + (long long)s * kStepWords, ops, static_cast<T*>(arena), static_cast<T*>(out));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_scan(const void* steps, int n_steps, const void* deltas, int n_delta,
                        const void* results, int n_results, const Operands& ops, void* arena,
                        long long shared_bytes, const void* alpha0, int alpha_size,
                        const void* codes, int n_vars, int n_slices, void* out, int width,
                        cudaStream_t stream) {
  cudaError_t err = allow_shared(filter_scan_kernel<T>, shared_bytes);
  if (err != cudaSuccess) return err;
  filter_scan_kernel<T><<<1, kBlockThreads, (size_t)shared_bytes, stream>>>(
      static_cast<const long long*>(steps), n_steps, static_cast<const long long*>(deltas),
      n_delta, static_cast<const long long*>(results), n_results, ops, static_cast<T*>(arena),
      shared_bytes > 0, static_cast<const T*>(alpha0), alpha_size,
      static_cast<const int*>(codes), n_vars, n_slices, static_cast<T*>(out), width);
  return cudaGetLastError();
}

}  // namespace

// The whole plan in one launch of one block.  steps: n_steps rows of
// kStepWords int64 on the card; host_ptrs: the operands' n_ptrs data
// pointers (or, past kMaxOperands, `many`, the same on the card); arena:
// the intermediates in global memory, or null with shared_bytes > 0 to keep
// them in shared memory; elem: 4 (float) or 8 (double).
extern "C" int pgmpy_plan_block(const void* steps, int n_steps, const void* const* host_ptrs,
                                int n_ptrs, const void* many, void* arena, void* out,
                                long long shared_bytes, int elem, void* stream) {
  Operands ops;  // copied into the launch's parameter block
  cudaError_t err = pack(ops, host_ptrs, n_ptrs, many);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem == 4) return (int)launch_block<float>(steps, n_steps, ops, arena, out, shared_bytes, s);
  if (elem == 8) return (int)launch_block<double>(steps, n_steps, ops, arena, out, shared_bytes, s);
  return (int)cudaErrorInvalidValue;
}

// One launch per step, blocks[s] blocks of kStepThreads for step s (a host
// array); arena: the intermediates in global memory.
extern "C" int pgmpy_plan_step(const void* steps, const long long* blocks, int n_steps,
                               const void* const* host_ptrs, int n_ptrs, const void* many,
                               void* arena, void* out, int elem, void* stream) {
  Operands ops;  // copied into the launch's parameter block
  cudaError_t err = pack(ops, host_ptrs, n_ptrs, many);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem == 4) return (int)launch_steps<float>(steps, blocks, n_steps, ops, arena, out, s);
  if (elem == 8) return (int)launch_steps<double>(steps, blocks, n_steps, ops, arena, out, s);
  return (int)cudaErrorInvalidValue;
}

// Every filter slice in one launch of one block (K10); host_ptrs: the
// transition factors; alpha0: the slice-0 interface posterior (alpha_size
// entries), copied into the arena.
extern "C" int pgmpy_filter_scan(const void* steps, int n_steps, const void* deltas, int n_delta,
                                 const void* results, int n_results, const void* const* host_ptrs,
                                 int n_ptrs, const void* many, void* arena,
                                 long long shared_bytes, const void* alpha0, int alpha_size,
                                 const void* codes, int n_vars, int n_slices, void* out,
                                 int width, int elem, void* stream) {
  Operands ops;  // copied into the launch's parameter block
  cudaError_t err = pack(ops, host_ptrs, n_ptrs, many);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PGMPY_SCAN(T)                                                                        \
  return (int)launch_scan<T>(steps, n_steps, deltas, n_delta, results, n_results, ops, arena, \
                             shared_bytes, alpha0, alpha_size, codes, n_vars, n_slices, out,   \
                             width, s)
  if (elem == 4) PGMPY_SCAN(float);
  if (elem == 8) PGMPY_SCAN(double);
#undef PGMPY_SCAN
  return (int)cudaErrorInvalidValue;
}
