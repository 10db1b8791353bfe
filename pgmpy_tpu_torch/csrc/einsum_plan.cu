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
// Bound: small plans are latency; large steps bytes.  A MUNIN VE query is 28
// steps of at most 1,080 union entries (6,459 in all: a few microseconds of
// arithmetic for one SM), whose chain of 12 dependency levels bounds it; the
// ALARM filter's plain version runs 1 + 6 plans a slice (~518 dependent
// steps of at most 864 union entries), far below what one launch per step can
// carry.  A MUNIN query_batch step walks 289 M union entries, each reading two
// inputs.
//
// What the design does about it:
//   1. Two schedules, chosen on the host from the plan alone, each ONE launch
//      a contraction.  `plan_block` runs the whole plan in one block of 512
//      threads where every step's union is within ops/einsum.py:BLOCK_UNION
//      and its level model's time is at most the grid's (a long reduction
//      with few outputs walks on one warp: the grid), as K10 runs a slice
//      (item 5, `run_levels`): its steps grouped by
//      dependency level, one barrier a level (the MUNIN VE query: 12 levels
//      where its 28 steps ran one after another).  `plan_grid` runs the rest
//      as one cooperative launch of as many blocks as the card holds at once
//      (the occupancy API), at most as many as the largest step's tasks fill:
//      each step's (output, lane) tasks are strided over the whole grid, one
//      grid barrier (grid.sync()) between consecutive steps, the next step's
//      descriptor staged in shared memory while the current one runs, the
//      intermediates in the global arena (a 2,048-row MUNIN query_batch:
//      36,900 entries, which L2 holds); a launch per step would pay a launch
//      latency and a kernel tail per step, eight in a row on that
//      query_batch.
//   2. `plan_grid`: few outputs, long reductions.  Each output entry is
//      summed by `lanes` threads (a power of two chosen per step: ~8 reduced
//      entries a lane, more lanes while the grid would idle), each over a
//      contiguous chunk of the reduced entries walked by an odometer (no
//      division per entry), then combined by warp shuffles and, past 32
//      lanes, shared memory, in a fixed order.  Labels are merged on the
//      host where every tensor walks two neighbours as one, and extent-1
//      labels dropped, so steps decode few digits (at most kMaxLabels output
//      and kMaxLabels reduced labels; wider raises).
//   3. Sums in double for both float and double tables (no TF32 anywhere),
//      in a fixed order; results are stored once in the tables' type, as the
//      plain version stores them.
//   4. K10: `filter_scan` loops over the slices inside one block.  Where
//      the joint over the interface and the queries holds at most
//      SCAN_JOINT entries, a slice is one contraction of alpha and the
//      transition factors to that joint and a one-input step from it per
//      output (ALARM: 37 pair steps and 7 output steps).  Evidence is not a
//      factor: each label whose variable the call observes is pinned to the
//      slice's code (staged in shared memory): an output entry with another
//      digit is 0, a reduced label walks the code alone; an unobserved
//      variable costs nothing.  After the slice's levels each result is
//      normalised (a sum of 0 gives NaN, as m / m.sum() does): the queries
//      into the output row, the interface into alpha.
//   5. The level schedule `plan_block` and `filter_scan` share
//      (`run_levels`, `scan_tasks`, `scan_partial`, `stage_levels`): the
//      host groups the steps by dependency level (a step's level is one more
//      than the highest level of the steps whose results it reads) and places
//      the intermediates so that no step reads or overwrites what another
//      step of its level writes; a level's steps run at once, its 16 warps
//      and each step's lanes (at most a warp: shuffles only) dealt by a cost
//      model, one barrier after each level.  A chain of levels bounds such a
//      launch, not its arithmetic, so a task is kept short: its step is an
//      int32 row and the host's tables of offset pairs give each output
//      entry's and each reduced entry's input offsets (no digit decoded on
//      the card), and the rows, the tables and the operands are staged in
//      shared memory by asynchronous copies (cp.async) once per launch where
//      they fit, beside the arena, else read from global memory.
//
// The wrapper (pgmpy_tpu_torch/ops/einsum.py) compiles and uploads the step
// tables and calls the extern "C" launchers through ctypes on PyTorch's
// current stream; each returns the launch's cudaError_t.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLabels = 12;   // ops/einsum.py: MAX_LABELS
constexpr int kHeader = 10;      // len(ops/einsum.py: HEADER)
constexpr int kStepWords = kHeader + 6 * kMaxLabels;
constexpr int kMaxOperands = 448;  // ops/einsum.py: MAX_OPERANDS
constexpr int kBlockThreads = 512;  // ops/einsum.py: BLOCK_THREADS
constexpr int kGridThreads = 256;   // ops/einsum.py: GRID_THREADS

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

// Every step of a plan over the whole grid, one grid barrier between
// consecutive steps (it also orders the block's staged descriptor).  The
// barrier makes each step's writes to the arena visible to every block
// before the next step reads them.
template <typename T>
__global__ void __launch_bounds__(kGridThreads)
    plan_grid_kernel(const long long* __restrict__ steps, int n_steps,
                     const __grid_constant__ Operands ops, T* arena, T* out) {
  cg::grid_group grid = cg::this_grid();
  __shared__ long long desc[2][kStepWords];
  __shared__ double scratch[kGridThreads / 32];
  for (int i = threadIdx.x; i < kStepWords; i += blockDim.x) desc[0][i] = steps[i];
  __syncthreads();
  const long long first = (long long)blockIdx.x * blockDim.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (int s = 0; s < n_steps; ++s) {
    if (s + 1 < n_steps) {
      const long long* next = steps + (long long)(s + 1) * kStepWords;
      for (int i = threadIdx.x; i < kStepWords; i += blockDim.x) desc[(s + 1) & 1][i] = next[i];
    }
    run_tasks<T>(desc[s & 1], ops, arena, out, scratch, first, stride);
    if (s + 1 < n_steps) grid.sync();
  }
}

// The level steps' rows (plan_block and K10; int32, ops/einsum.py:SCAN_ROW):
// a header, then kMaxLabels (variable, place, extent) triples of pinned
// output labels and kMaxLabels of pinned reduced labels (none in plan_block).
constexpr int kScanHeader = 12;
constexpr int kScanRow = kScanHeader + 6 * kMaxLabels;
constexpr int kScanWarps = kBlockThreads / 32;  // ops/einsum.py: SCAN_WARPS
constexpr int sNIn = 0, sIn0 = 1, sIn1 = 2, sOut = 3, sOutCount = 4, sFree = 5, sLanes = 6,
              sPinOut = 7, sPinRed = 8, sOutPairs = 9, sRedPairs = 10;

// An input slot of a level step: >= 0 an operand (staged in shared memory
// where `staged` is not null), < 0 the arena.
template <typename T>
__device__ __forceinline__ const T* scan_input(int slot, const T* staged, const int* op_off,
                                               const Operands& ops, const T* arena) {
  if (slot < 0) return arena + (-slot - 1);
  if (staged != nullptr) return staged + op_off[slot];
  return static_cast<const T*>(ops.many != nullptr ? ops.many[slot] : ops.p[slot]);
}

// One lane's partial sum of output entry o of a level step.  The
// host's offset pairs give the inputs' offsets of each output entry and of
// each reduced entry (the unpinned reduced labels innermost, F of them, the
// pinned ones outermost), so no digit is decoded: an output entry whose
// pinned digit differs from this slice's code is 0; the pinned reduced
// labels this slice observes fix one block of F reduced entries, and the
// lanes share it in chunks.  A pinned label the slice leaves unobserved is
// walked (a slower loop that decodes it).
template <typename T>
__device__ double scan_partial(const int* d, const int2* pairs, const int* code, const T* a,
                               const T* b, int o, int lane) {
  const int* pin = d + kScanHeader;
  for (int i = 0; i < d[sPinOut]; ++i, pin += 3) {
    const int c = code[pin[0]];
    if (c >= 0 && (o / pin[1]) % pin[2] != c) return 0.0;
  }
  const int2 base = pairs[d[sOutPairs] + o];
  const int free = d[sFree], n_pin = d[sPinRed];
  pin = d + kScanHeader + 3 * kMaxLabels;
  int q = 0, walked = 1;
  for (int i = 0; i < n_pin; ++i) {
    const int c = code[pin[3 * i]];
    if (c >= 0) {
      q += c * pin[3 * i + 1];
    } else {
      walked *= pin[3 * i + 2];
    }
  }
  const int lanes = d[sLanes], count = free * walked;
  const int chunk = (count + lanes - 1) >> (__ffs(lanes) - 1);  // lanes: a power of two
  int r = lane * chunk;
  const int hi = min(r + chunk, count);
  const int2* red = pairs + d[sRedPairs];
  double acc = 0.0;
  if (walked == 1) {
    const int2* e = red + free * q;
    for (; r < hi; ++r) {
      const int2 x = e[r];
      acc += b != nullptr ? (double)a[base.x + x.x] * (double)b[base.y + x.y]
                          : (double)a[base.x + x.x];
    }
    return acc;
  }
  for (; r < hi; ++r) {
    int rest = r / free, at = q;
    for (int i = 0; i < n_pin; ++i) {
      if (code[pin[3 * i]] < 0) {
        const int e = pin[3 * i + 2];
        at += rest % e * pin[3 * i + 1];
        rest /= e;
      }
    }
    const int2 x = red[r % free + free * at];
    acc += b != nullptr ? (double)a[base.x + x.x] * (double)b[base.y + x.y]
                        : (double)a[base.x + x.x];
  }
  return acc;
}

// One warp's share of a level step: it is warp `rank` of the `group` warps
// the level gave the step, striding over the step's (output, lane) tasks;
// the lanes of an output (at most 32, a power of two) meet by shuffles.  A
// step whose output slot is negative writes `out` (plan_block's last step).
template <typename T>
__device__ void scan_tasks(const int* d, const int2* pairs, const int* code, const T* staged,
                           const int* op_off, const Operands& ops, T* arena, T* out, int rank,
                           int group) {
  const T* a = scan_input<T>(d[sIn0], staged, op_off, ops, arena);
  const T* b = d[sNIn] > 1 ? scan_input<T>(d[sIn1], staged, op_off, ops, arena) : nullptr;
  T* dst = d[sOut] < 0 ? out : arena + d[sOut];
  const int lanes = d[sLanes], shift = __ffs(lanes) - 1, tasks = d[sOutCount] * lanes;
  const int lane = threadIdx.x & 31;
  for (int first = 32 * rank; first < tasks; first += 32 * group) {
    const int t = first + lane;
    double v = t < tasks ? scan_partial<T>(d, pairs, code, a, b, t >> shift, t & (lanes - 1))
                         : 0.0;
    for (int s = lanes >> 1; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s, lanes);
    if (t < tasks && (t & (lanes - 1)) == 0) dst[t >> shift] = (T)v;
  }
}

// A level launch's int32 buffer (ops/einsum.py:level_buffer): n_steps rows
// of kScanRow, the results (K10: arena offset, entries, output column or -1
// for the interface, 0; none in plan_block), level_start (per (level, warp)
// the first of its work items, n_levels * kScanWarps + 1 words), the work
// items (step, rank, group), each operand's offset and span in the staged
// operands, then (8-byte aligned) the offset pairs.
struct LevelTable {
  const int* rows;
  const int* results;
  const int* level_start;
  const int* work;
  const int* op_off;
  const int2* pairs;
};

__device__ __forceinline__ LevelTable level_table(const int* buf, int n_steps, int n_results,
                                                  int n_levels, int n_work, int n_ptrs) {
  LevelTable t;
  t.rows = buf;
  t.results = buf + (long long)n_steps * kScanRow;
  t.level_start = t.results + 4LL * n_results;
  t.work = t.level_start + (long long)n_levels * kScanWarps + 1;
  t.op_off = t.work + 3LL * n_work;
  const long long head = (t.op_off + 2LL * n_ptrs) - buf;
  t.pairs = reinterpret_cast<const int2*>(buf + ((head + 1) & ~1LL));
  return t;
}

// The buffer (`words` int32) into s_table and each operand's span into s_ops
// at its offset (g_off: the offsets, then the spans), by asynchronous copies
// that every thread issues without waiting: 16 bytes a copy for the buffer
// (both 16-byte aligned), an element for the operands (a warp per operand).
// Returns when this thread's copies have landed; the caller's barrier makes
// them the block's.
template <typename T>
__device__ void stage_levels(const int* __restrict__ table, long long words, int* s_table,
                             const Operands& ops, int n_ptrs, const int* g_off, T* s_ops) {
  const long long vec = words >> 2;
  for (long long i = threadIdx.x; i < vec; i += blockDim.x)
    __pipeline_memcpy_async(s_table + 4 * i, table + 4 * i, 16);
  for (long long i = 4 * vec + threadIdx.x; i < words; i += blockDim.x)
    __pipeline_memcpy_async(s_table + i, table + i, 4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int p = warp; p < n_ptrs; p += warps) {
    const T* src = static_cast<const T*>(ops.many != nullptr ? ops.many[p] : ops.p[p]);
    T* dst = s_ops + g_off[p];
    const int span = g_off[n_ptrs + p];
    for (int e = lane; e < span; e += 32) __pipeline_memcpy_async(dst + e, src + e, sizeof(T));
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

// Every level of a plan: each warp runs its work items of the level, then
// one barrier.  code: the slice's codes for the pinned labels (K10), else
// unread.
template <typename T>
__device__ void run_levels(const LevelTable& t, int n_levels, const int* code, const T* s_ops,
                           const Operands& ops, T* arena, T* out) {
  const int warp = threadIdx.x >> 5;
  for (int level = 0; level < n_levels; ++level) {
    const int* at = t.level_start + level * kScanWarps + warp;
    for (int w = at[0]; w < at[1]; ++w) {
      const int* item = t.work + 3 * w;
      scan_tasks<T>(t.rows + (long long)item[0] * kScanRow, t.pairs, code, s_ops, t.op_off, ops,
                    arena, out, item[1], item[2]);
    }
    __syncthreads();  // the level's results are written
  }
}

// plan_block: the whole plan in one block, level by level.  Where `staged`,
// the buffer sits in shared memory at byte table_at and the operands at
// operands_at; the arena at the start of shared memory where shared_arena.
template <typename T>
__global__ void __launch_bounds__(kBlockThreads)
    plan_block_kernel(const int* __restrict__ table, int n_steps, int n_levels, int n_work,
                      long long words, int staged, const __grid_constant__ Operands ops,
                      int n_ptrs, T* arena_global, int shared_arena, long long operands_at,
                      long long table_at, T* out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* arena = shared_arena ? reinterpret_cast<T*>(smem_raw) : arena_global;
  T* s_ops = staged ? reinterpret_cast<T*>(smem_raw + operands_at) : nullptr;
  int* s_table = reinterpret_cast<int*>(smem_raw + table_at);
  if (staged) {
    const LevelTable g = level_table(table, n_steps, 0, n_levels, n_work, n_ptrs);
    stage_levels<T>(table, words, s_table, ops, n_ptrs, g.op_off, s_ops);
    __syncthreads();
  }
  const LevelTable t = level_table(staged ? s_table : table, n_steps, 0, n_levels, n_work,
                                   n_ptrs);
  run_levels<T>(t, n_levels, nullptr, s_ops, ops, arena, out);
}

// K10.  table: ops/einsum.py:ScanProgram.table (a LevelTable with one result
// per output), staged in shared memory at byte table_at, the transition
// factors at operands_at, where `staged`.  codes: (n_slices, n_vars) int32,
// -1 where unobserved; out: (n_slices, width).  Alpha lives at arena offset
// 0.  A slice: its levels, one barrier after each, then the normalisations
// while the next slice's codes are staged, one barrier.
template <typename T>
__global__ void __launch_bounds__(kBlockThreads)
    filter_scan_kernel(const int* __restrict__ table, int n_steps, int n_results, int n_levels,
                       int n_work, long long words, int staged,
                       const __grid_constant__ Operands ops, int n_ptrs, T* arena_global,
                       int shared_arena, long long operands_at, long long table_at,
                       const T* __restrict__ alpha0, int alpha_size,
                       const int* __restrict__ codes, int n_vars, int n_slices, T* out,
                       int width) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* arena = shared_arena ? reinterpret_cast<T*>(smem_raw) : arena_global;
  T* s_ops = staged ? reinterpret_cast<T*>(smem_raw + operands_at) : nullptr;
  int* s_table = reinterpret_cast<int*>(smem_raw + table_at);
  int* s_code = reinterpret_cast<int*>(smem_raw + table_at + (staged ? words * 4 : 0));
  if (staged) {
    const LevelTable g = level_table(table, n_steps, n_results, n_levels, n_work, n_ptrs);
    stage_levels<T>(table, words, s_table, ops, n_ptrs, g.op_off, s_ops);
  }
  const LevelTable lt = level_table(staged ? s_table : table, n_steps, n_results, n_levels,
                                    n_work, n_ptrs);
  for (int i = threadIdx.x; i < alpha_size; i += blockDim.x) arena[i] = alpha0[i];
  for (int i = threadIdx.x; i < n_vars; i += blockDim.x) s_code[i] = n_slices > 0 ? codes[i] : -1;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int t = 0; t < n_slices; ++t) {
    run_levels<T>(lt, n_levels, s_code, s_ops, ops, arena, nullptr);
    for (int r = warp; r < n_results; r += warps) {
      const int* re = lt.results + 4 * r;
      const T* m = arena + re[0];
      const int entries = re[1];
      double s = 0.0;
      for (int k = lane; k < entries; k += 32) s += (double)m[k];
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      T* dst = re[2] < 0 ? arena : out + (long long)t * width + re[2];
      for (int k = lane; k < entries; k += 32) dst[k] = (T)((double)m[k] / s);
    }
    if (t + 1 < n_slices) {
      for (int i = threadIdx.x; i < n_vars; i += blockDim.x)
        s_code[i] = codes[(long long)(t + 1) * n_vars + i];
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
cudaError_t launch_block(const void* table, int n_steps, int n_levels, int n_work,
                         long long words, int staged, const Operands& ops, int n_ptrs,
                         void* arena, int shared_arena, long long operands_at,
                         long long table_at, long long shared_bytes, void* out,
                         cudaStream_t stream) {
  cudaError_t err = allow_shared(plan_block_kernel<T>, shared_bytes);
  if (err != cudaSuccess) return err;
  plan_block_kernel<T><<<1, kBlockThreads, (size_t)shared_bytes, stream>>>(
      static_cast<const int*>(table), n_steps, n_levels, n_work, words, staged, ops, n_ptrs,
      static_cast<T*>(arena), shared_arena, operands_at, table_at, static_cast<T*>(out));
  return cudaGetLastError();
}

// blocks of a plan_grid launch: as many as the card holds at once (the
// kernel's occupancy times the SMs, read once per device and type), at most
// `wanted` (the largest step's tasks over kGridThreads)
template <typename T>
cudaError_t grid_blocks(long long wanted, int* blocks) {
  static int resident[2][64];  // per element type and device; 0 until read
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  int& cached = resident[sizeof(T) == 8][device];
  if (cached == 0) {
    int sms = 0, cooperative = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&cooperative, cudaDevAttrCooperativeLaunch, device);
    if (err == cudaSuccess && !cooperative) err = cudaErrorNotSupported;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, plan_grid_kernel<T>,
                                                          kGridThreads, 0);
    if (err != cudaSuccess) return err;
    if (per_sm * sms < 1) return cudaErrorInvalidConfiguration;
    cached = per_sm * sms;
  }
  *blocks = (int)(wanted < cached ? (wanted < 1 ? 1 : wanted) : cached);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_grid(const void* steps, int n_steps, long long wanted, const Operands& ops,
                        void* arena, void* out, cudaStream_t stream) {
  int blocks = 0;
  cudaError_t err = grid_blocks<T>(wanted, &blocks);
  if (err != cudaSuccess) return err;
  const long long* table = static_cast<const long long*>(steps);
  T* arena_t = static_cast<T*>(arena);
  T* out_t = static_cast<T*>(out);
  void* args[] = {(void*)&table, (void*)&n_steps, (void*)&ops, (void*)&arena_t, (void*)&out_t};
  err = cudaLaunchCooperativeKernel((const void*)plan_grid_kernel<T>, dim3(blocks),
                                    dim3(kGridThreads), args, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_scan(const void* table, int n_steps, int n_results, int n_levels, int n_work,
                        long long words, int staged, const Operands& ops, int n_ptrs,
                        void* arena, int shared_arena, long long operands_at,
                        long long table_at, long long shared_bytes, const void* alpha0,
                        int alpha_size, const void* codes, int n_vars, int n_slices, void* out,
                        int width, cudaStream_t stream) {
  cudaError_t err = allow_shared(filter_scan_kernel<T>, shared_bytes);
  if (err != cudaSuccess) return err;
  filter_scan_kernel<T><<<1, kBlockThreads, (size_t)shared_bytes, stream>>>(
      static_cast<const int*>(table), n_steps, n_results, n_levels, n_work, words, staged, ops,
      n_ptrs, static_cast<T*>(arena), shared_arena, operands_at, table_at,
      static_cast<const T*>(alpha0), alpha_size, static_cast<const int*>(codes), n_vars,
      n_slices, static_cast<T*>(out), width);
  return cudaGetLastError();
}

}  // namespace

// The whole plan in one launch of one block (plan_block), level by level.
// table: the int32 buffer of PlanTable.buffer (`words` of them), staged in
// shared memory at byte table_at, with the operands at operands_at, when
// `staged`; host_ptrs: the operands' n_ptrs data pointers (or, past
// kMaxOperands, `many`, the same on the card); arena: the intermediates in
// global memory, or null with shared_arena to keep them at the start of
// shared memory; shared_bytes: the arena and the staged operands and
// buffer; elem: 4 (float) or 8 (double).
extern "C" int pgmpy_plan_block(const void* table, int n_steps, int n_levels, int n_work,
                                long long words, int staged, const void* const* host_ptrs,
                                int n_ptrs, const void* many, void* arena, int shared_arena,
                                long long operands_at, long long table_at,
                                long long shared_bytes, void* out, int elem, void* stream) {
  Operands ops;  // copied into the launch's parameter block
  cudaError_t err = pack(ops, host_ptrs, n_ptrs, many);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PGMPY_BLOCK(T)                                                                    \
  return (int)launch_block<T>(table, n_steps, n_levels, n_work, words, staged, ops, n_ptrs, \
                              arena, shared_arena, operands_at, table_at, shared_bytes, out, s)
  if (elem == 4) PGMPY_BLOCK(float);
  if (elem == 8) PGMPY_BLOCK(double);
#undef PGMPY_BLOCK
  return (int)cudaErrorInvalidValue;
}

// The whole plan in one cooperative launch over the grid (plan_grid):
// wanted, the blocks the largest step's tasks fill (the launch takes at most
// as many as the card holds at once); arena: the intermediates in global
// memory.
extern "C" int pgmpy_plan_grid(const void* steps, int n_steps, long long wanted,
                               const void* const* host_ptrs, int n_ptrs, const void* many,
                               void* arena, void* out, int elem, void* stream) {
  Operands ops;  // copied into the launch's parameter block
  cudaError_t err = pack(ops, host_ptrs, n_ptrs, many);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem == 4) return (int)launch_grid<float>(steps, n_steps, wanted, ops, arena, out, s);
  if (elem == 8) return (int)launch_grid<double>(steps, n_steps, wanted, ops, arena, out, s);
  return (int)cudaErrorInvalidValue;
}

// Every filter slice in one launch of one block (K10); table: the int32
// buffer of ScanProgram.table (`words` of them), staged in shared memory at
// byte table_at, with the transition factors at operands_at, when `staged`;
// host_ptrs: the transition factors; arena: global memory, or null with
// shared_arena to keep it at the start of shared memory; alpha0: the slice-0
// interface posterior (alpha_size entries), copied into the arena;
// shared_bytes: the arena, the staged factors and table and the slice's
// n_vars codes.
extern "C" int pgmpy_filter_scan(const void* table, int n_steps, int n_results, int n_levels,
                                 int n_work, long long words, int staged,
                                 const void* const* host_ptrs, int n_ptrs, const void* many,
                                 void* arena, int shared_arena, long long operands_at,
                                 long long table_at, long long shared_bytes, const void* alpha0,
                                 int alpha_size, const void* codes, int n_vars, int n_slices,
                                 void* out, int width, int elem, void* stream) {
  Operands ops;  // copied into the launch's parameter block
  cudaError_t err = pack(ops, host_ptrs, n_ptrs, many);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PGMPY_SCAN(T)                                                                          \
  return (int)launch_scan<T>(table, n_steps, n_results, n_levels, n_work, words, staged, ops,  \
                             n_ptrs, arena, shared_arena, operands_at, table_at, shared_bytes, \
                             alpha0, alpha_size, codes, n_vars, n_slices, out, width, s)
  if (elem == 4) PGMPY_SCAN(float);
  if (elem == 8) PGMPY_SCAN(double);
#undef PGMPY_SCAN
  return (int)cudaErrorInvalidValue;
}
