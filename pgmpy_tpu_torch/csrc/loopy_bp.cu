// Loopy belief propagation's flooding engine for Hopper (sm_90a): every
// round of a query in ONE cooperative launch, until the largest change of a
// message falls below the tolerance or max_iter rounds have run.
//
// Messages are (E, C) rows, edge e the e-th (factor, variable) incidence in
// factor order, entries past the edge's cardinality 0.  A round:
//   phase 1, a thread per edge e: the variable -> factor message.  Walk the
//     CSR row of e's variable and sum the centred logs of its OTHER edges'
//     factor -> variable messages, add the log of e's fixed message,
//     subtract the row's finite maximum, exp, normalise; write v2f[e].
//   grid barrier
//   phase 2, a thread per edge e = (f, k): the new factor -> variable
//     message.  For each state s of k's variable, walk the entries of f's
//     table with axis k held at s (an odometer over the other axes, the
//     last fastest), each times the other positions' v2f entries; normalise
//     and write into the other buffer of the double-buffered f2v, with its
//     centred log (the next round's phase 1 reads it), and fold
//     |new - old| into a block maximum, then atomicMax it, on the float's
//     bits, into the round's slot.
//   grid barrier; every thread reads the slot and stops when it is below
//     the tolerance.
// Before round 0 the initial messages are masked to their cardinalities and
// their centred logs taken; after the last round the result is copied into
// `out` if it lies in the other buffer.  max_iter = 0 returns the initial
// messages, 0 rounds and delta inf, as the JAX while_loop does.
//
// Replaces, from the JAX package: pgmpy_tpu/inference/fg_bp.py:148
// `round_fn` and :188 `engine` (its lax.while_loop :199).  The arithmetic is
// the port's round (ops/loopy.py: flood_round_reference), with the log-space
// exclusive product that keeps a hub of hundreds of factors from
// underflowing, not the JAX package's linear product.  The tables are read
// at their true shapes: the power-of-two buckets and the padded (E, D)
// neighbour table of the JAX program are the TPU's batched formulation, and
// the neighbour table would hold E x 599 entries for one 600-leaf hub.
//
// Special values are the plain version's: log 0 = -inf; a row whose maximum
// is not finite is shifted by 0; a row that sums to 0 stays 0; a NaN wins a
// maximum (torch.amax), and a NaN delta does not stop the flood.
//
// Accumulation: phase 1's sum of logs and phase 2's table sums and products
// in double, rounded once to the message type; everything else in the
// message type (float or double), as the plain version.
//
// Bound: bytes.  A flood must read the plan's int32 tables, the factor
// tables and the fixed and initial messages once (they do not change between
// rounds), and each round read the messages and write the new ones (a block
// reads what other blocks wrote before the barrier): on the 128 x 128 grid
// (65,024 edges, C = 2, 32,512 2 x 2 tables, float) 3.3 MB once and 1.04 MB
// a round, 12.7 MB for 9 rounds, 3.8 us at 3.35 TB/s; its operations (an add
// per other edge and state, arity ops per table entry and edge) take a
// fraction of that.
// Barriers, not bytes, set the time of a small graph's round: two grid-wide
// barriers a round, each a few microseconds.
//
// Limit: a factor of at most kMaxArity variables (the digits a thread
// holds); ops/loopy.py raises past it.  The plan's indices are int32.
//
// Built with nvcc at first use (ops/_build.py); ops/loopy.py calls the
// extern "C" launcher through ctypes on PyTorch's current stream; it returns
// the launch's cudaError_t.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxArity = 16;
constexpr int kThreads = 256;
constexpr int kEdgeWords = 4;    // factor, cardinality, stride in the table, variable row
constexpr int kFactorWords = 3;  // table offset, arity, first edge

template <typename T>
struct Bits;
template <>
struct Bits<float> {
  using type = unsigned int;
  static __device__ __forceinline__ type of(float x) { return __float_as_uint(x); }
  static __device__ __forceinline__ float value(type b) { return __uint_as_float(b); }
};
template <>
struct Bits<double> {
  using type = unsigned long long;
  static __device__ __forceinline__ type of(double x) {
    return (unsigned long long)__double_as_longlong(x);
  }
  static __device__ __forceinline__ double value(type b) { return __longlong_as_double((long long)b); }
};

__device__ __forceinline__ float ln(float x) { return logf(x); }
__device__ __forceinline__ double ln(double x) { return log(x); }
__device__ __forceinline__ float ex(float x) { return expf(x); }
__device__ __forceinline__ double ex(double x) { return exp(x); }
__device__ __forceinline__ float absval(float x) { return fabsf(x); }
__device__ __forceinline__ double absval(double x) { return fabs(x); }

// torch.amax's maximum: a NaN wins
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a > b || a != a) ? a : b;
}

template <typename T>
__device__ __forceinline__ T finite_or_zero(T x) {
  return isfinite(x) ? x : T(0);
}

template <typename T>
struct FloodArgs {
  int E, C;
  const int* edges;        // (E, kEdgeWords)
  const int* factors;      // (F, kFactorWords)
  const int* var_offsets;  // (V + 1): CSR offsets of each variable's edges
  const int* var_ids;      // (E): the edges, variable by variable
  const T* arena;          // every factor's table, row-major, in factor order
  const T* fixed;          // (E, C) fixed messages
  const T* init;           // (E, C) initial factor -> variable messages
  T* f2v[2];               // `out` and the other buffer
  T* v2f;                  // (E, C)
  T* logs;                 // (E, C) centred logs of the current f2v
  typename Bits<T>::type* deltas;  // (max_iter) each round's delta, as bits
  int* rounds_out;
  T* delta_out;
  int max_iter;
  double tol;
};

// logs = log(row) - its finite maximum (0 if that is not finite)
template <typename T>
__device__ void centred_log(const T* row, T* logs, int C) {
  T top = T(-CUDART_INF);
  for (int c = 0; c < C; ++c) top = nan_max(top, ln(row[c]));
  const T shift = finite_or_zero(top);
  for (int c = 0; c < C; ++c) logs[c] = ln(row[c]) - shift;
}

// phase 1: v2f[e] from the other edges of e's variable
template <typename T>
__device__ void variable_to_factor(const FloodArgs<T>& a, int e) {
  const int C = a.C;
  const int var = a.edges[kEdgeWords * e + 3];
  const int lo = a.var_offsets[var], hi = a.var_offsets[var + 1];
  T* out = a.v2f + (long long)e * C;
  const T* fixed = a.fixed + (long long)e * C;
  T top = T(-CUDART_INF);
  for (int c = 0; c < C; ++c) {
    double total = 0.0;
    for (int i = lo; i < hi; ++i) {
      const int e2 = a.var_ids[i];
      if (e2 != e) total += (double)a.logs[(long long)e2 * C + c];
    }
    const T v = (T)(total + (double)ln(fixed[c]));
    out[c] = v;
    top = nan_max(top, v);
  }
  const T shift = finite_or_zero(top);
  double sum = 0.0;
  for (int c = 0; c < C; ++c) {
    const T x = ex(out[c] - shift);
    out[c] = x;
    sum += (double)x;
  }
  const T total = (T)sum;
  if (total > T(0))
    for (int c = 0; c < C; ++c) out[c] = out[c] / total;
}

// phase 2: the new f2v[e] of e = (f, k) into `next`, its centred log; returns
// the largest |new - old| of the row, as bits
template <typename T>
__device__ typename Bits<T>::type factor_to_variable(const FloodArgs<T>& a, int e,
                                                     const T* cur, T* next) {
  const int C = a.C;
  const int* er = a.edges + kEdgeWords * e;
  const int f = er[0], card = er[1], stride_k = er[2];
  const int* fr = a.factors + kFactorWords * f;
  const int offset = fr[0], arity = fr[1], first = fr[2];
  const int k = e - first;
  int n = 0;
  int ocard[kMaxArity], ostride[kMaxArity], digit[kMaxArity];
  const T* omsg[kMaxArity];
  for (int j = 0; j < arity; ++j) {
    if (j == k) continue;
    ocard[n] = a.edges[kEdgeWords * (first + j) + 1];
    ostride[n] = a.edges[kEdgeWords * (first + j) + 2];
    omsg[n] = a.v2f + (long long)(first + j) * C;
    ++n;
  }
  T* row = next + (long long)e * C;
  double total = 0.0;
  for (int s = 0; s < card; ++s) {
    for (int j = 0; j < n; ++j) digit[j] = 0;
    int pos = offset + s * stride_k;
    double sum = 0.0;
    while (true) {
      double p = (double)a.arena[pos];
      for (int j = 0; j < n; ++j) p *= (double)omsg[j][digit[j]];
      sum += p;
      int j = n - 1;
      for (; j >= 0; --j) {
        if (++digit[j] < ocard[j]) {
          pos += ostride[j];
          break;
        }
        pos -= (ocard[j] - 1) * ostride[j];
        digit[j] = 0;
      }
      if (j < 0) break;
    }
    const T v = (T)sum;
    row[s] = v;
    total += (double)v;
  }
  for (int s = card; s < C; ++s) row[s] = T(0);
  const T norm = (T)total;
  const T* old = cur + (long long)e * C;
  typename Bits<T>::type worst = 0;
  for (int c = 0; c < C; ++c) {
    T v = row[c];
    if (norm > T(0)) v = v / norm;
    row[c] = v;
    const typename Bits<T>::type d = Bits<T>::of(absval(v - old[c]));
    worst = d > worst ? d : worst;  // a NaN's bits exceed inf's
  }
  centred_log(row, a.logs + (long long)e * C, C);
  return worst;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flood_kernel(FloodArgs<T> a) {
  using B = typename Bits<T>::type;
  cg::grid_group grid = cg::this_grid();
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const int E = a.E, C = a.C;
  __shared__ B warp_max[kThreads / 32];

  // the initial messages, masked, and their centred logs
  for (int e = tid; e < E; e += stride) {
    const int card = a.edges[kEdgeWords * e + 1];
    T* row = a.f2v[0] + (long long)e * C;
    const T* init = a.init + (long long)e * C;
    for (int c = 0; c < C; ++c) row[c] = c < card ? init[c] : T(0);
    centred_log(row, a.logs + (long long)e * C, C);
  }
  for (int i = tid; i < a.max_iter; i += stride) a.deltas[i] = 0;
  grid.sync();

  int rounds = 0;
  T last = T(CUDART_INF);
  for (int r = 0; r < a.max_iter; ++r) {
    const T* cur = a.f2v[r & 1];
    T* next = a.f2v[(r + 1) & 1];
    for (int e = tid; e < E; e += stride) variable_to_factor(a, e);
    grid.sync();
    B worst = 0;
    for (int e = tid; e < E; e += stride) {
      const B d = factor_to_variable(a, e, cur, next);
      worst = d > worst ? d : worst;
    }
    for (int o = 16; o > 0; o >>= 1) {
      const B other = __shfl_xor_sync(0xffffffffu, worst, o);
      worst = other > worst ? other : worst;
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) warp_max[warp] = worst;
    __syncthreads();
    if (warp == 0) {
      worst = lane < kThreads / 32 ? warp_max[lane] : 0;
      for (int o = 16; o > 0; o >>= 1) {
        const B other = __shfl_xor_sync(0xffffffffu, worst, o);
        worst = other > worst ? other : worst;
      }
      if (lane == 0) atomicMax(a.deltas + r, worst);
    }
    grid.sync();
    last = Bits<T>::value(((volatile B*)a.deltas)[r]);
    rounds = r + 1;
    if ((double)last < a.tol) break;
  }
  if (rounds & 1) {
    for (long long i = tid; i < (long long)E * C; i += stride) a.f2v[0][i] = a.f2v[1][i];
  }
  if (tid == 0) {
    *a.rounds_out = rounds;
    *a.delta_out = last;
  }
}

// blocks of a flood over `E` edges: as many as the card holds at once (the
// kernel's occupancy times the SMs), at most one per kThreads edges
template <typename T>
cudaError_t flood_blocks(int E, int* blocks) {
  int device = 0, sms = 0, cooperative = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&cooperative, cudaDevAttrCooperativeLaunch, device);
  if (err == cudaSuccess && !cooperative) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flood_kernel<T>, kThreads, 0);
  const int wanted = (E + kThreads - 1) / kThreads;
  *blocks = wanted < per_sm * sms ? wanted : per_sm * sms;
  if (*blocks < 1) *blocks = 1;
  return err;
}

template <typename T>
cudaError_t launch_flood(int E, int C, const void* edges, const void* factors,
                         const void* var_offsets, const void* var_ids, const void* arena,
                         const void* fixed, const void* init, void* out, void* other, void* v2f,
                         void* logs, void* deltas, void* rounds, void* delta, int max_iter,
                         double tol, cudaStream_t stream) {
  int blocks = 0;
  cudaError_t err = flood_blocks<T>(E, &blocks);
  if (err != cudaSuccess) return err;
  FloodArgs<T> a;
  a.E = E;
  a.C = C;
  a.edges = (const int*)edges;
  a.factors = (const int*)factors;
  a.var_offsets = (const int*)var_offsets;
  a.var_ids = (const int*)var_ids;
  a.arena = (const T*)arena;
  a.fixed = (const T*)fixed;
  a.init = (const T*)init;
  a.f2v[0] = (T*)out;
  a.f2v[1] = (T*)other;
  a.v2f = (T*)v2f;
  a.logs = (T*)logs;
  a.deltas = (typename Bits<T>::type*)deltas;
  a.rounds_out = (int*)rounds;
  a.delta_out = (T*)delta;
  a.max_iter = max_iter;
  a.tol = tol;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)flood_kernel<T>, dim3(blocks), dim3(kThreads),
                                    args, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" int pgmpy_loopy_flood(int elem, int E, int C, const void* edges, const void* factors,
                                 const void* var_offsets, const void* var_ids, const void* arena,
                                 const void* fixed, const void* init, void* out, void* other,
                                 void* v2f, void* logs, void* deltas, void* rounds, void* delta,
                                 int max_iter, double tol, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (elem == 4)
    return (int)launch_flood<float>(E, C, edges, factors, var_offsets, var_ids, arena, fixed,
                                    init, out, other, v2f, logs, deltas, rounds, delta, max_iter,
                                    tol, s);
  if (elem == 8)
    return (int)launch_flood<double>(E, C, edges, factors, var_offsets, var_ids, arena, fixed,
                                     init, out, other, v2f, logs, deltas, rounds, delta,
                                     max_iter, tol, s);
  return (int)cudaErrorInvalidValue;
}
