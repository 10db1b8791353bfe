// The NUTS transition and the HMC trajectory for Hopper (sm_90a), on a
// Gaussian target log p(x) = -0.5 (x - mu)^T P (x - mu) (P symmetric):
//
//   gradient g = -(x - mu) P, log-density 0.5 (x - mu) . g
//   leapfrog: r' = r + eps/2 g; x' = x + eps r'; g' = grad(x'); r'' = r' + eps/2 g'
//
// `nuts_step`: one multinomial No-U-Turn transition of every chain, in ONE
// launch: up to max_depth doublings in a random direction, each a subtree
// grown leaf by leaf (one leapfrog a leaf) with the progressive multinomial
// proposal, momentum checkpoints at even leaves and the U-turn checks of the
// closed power-of-two subtrees at odd leaves, divergence below -1000; the
// halves coupled by biased progressive sampling and the whole tree checked
// after each doubling.  Out: the proposal, the mean leaf acceptance
// statistic, the leapfrog count and the U-turn / divergence flags.
// `hmc_step`: `transitions` HMC transitions of every chain in ONE launch,
// each n_steps leapfrog steps and a Metropolis accept, log(u) < min(0, dH);
// out the positions after each transition, the accept flags and
// exp(min(0, dH)).
//
// Replaces, from the JAX package: pgmpy_tpu/sampling/nuts_jax.py:88
// `_build_subtree` (its `while_loop` :182, the turning check :146-160),
// :185 `_nuts_step` (`while_loop` :261) and the `vmap` over chains inside
// :266 `sample`; pgmpy_tpu/sampling/hmc.py:121 `_leapfrog` (`scan` :130),
// :135 `_kernel` and the transitions of :147 `sample` (`scan` :181).  The
// port's plain version (ops/hmc.py) makes about 4,465 torch kernels and 75
// host reads per ecoli70 transition of 1,024 chains.
//
// Bound: operations.  A leapfrog of one chain costs the matrix-vector
// product (2 dim^2) and about 12 dim more (the updates, |r|^2, the U-turn
// dot products), over the leapfrogs the step actually took; the bytes (P,
// mu, the positions in and out) are negligible.  ecoli70 (dim 46, condition
// number 1,148) at 1,024 chains takes ~50 leapfrogs a chain at its adapted
// step: ~2.5e8 operations, ~4 us at 67 TFLOP/s.
// The work is a chain of dependent steps per chain (one leapfrog needs the
// last), so the kernel is latency-bound long before it is operation-bound.
//
// What the design does about it:
//   1. One warp per chain.  Lane l holds coordinates l, l + 32, ...
//      (K = dim / 32 rounded up to a power of two, a template argument) of
//      every vector of the tree: both ends (z, r, g), the momentum sum, the
//      proposals, in registers.  Every reduction (the log-density, |r|^2,
//      the U-turn dot products) is a butterfly of __shfl_xor_sync in a fixed
//      order, which leaves the same bits in every lane: the warp takes every
//      branch together, and the same key gives the same samples.
//   2. P is staged once per block into shared memory, its rows padded to
//      32 K columns with zeros (lane j reads column j: no bank conflict, and
//      the padding coordinates stay 0).  A warp writes its (x - mu) to a row
//      of its own and reads it back as broadcasts, so the product is dim
//      fused multiply-adds per coordinate from shared memory.  Its momentum
//      checkpoints (max_depth rows of r and of rho) live there too.
//   3. The JAX control flow runs per warp with no host read: the doublings,
//      the leaf loop, the checkpoint slot popc(n >> 1), the closed subtrees
//      from the trailing ones of n, the divergence cap, the coupling.
//   4. Random numbers from a counter: Philox keyed on one 64-bit draw per
//      launch from the caller's generator, at counter (chain, depth, leaf,
//      stream) for NUTS and (chain, transition, coordinate, stream) for HMC;
//      normals by Box-Muller (race.cuh).  An explicit noise layout (the plain
//      version's) may replace them, for the checks against it.
//   5. Limits: a lane holds at most 8 coordinates (4 in double), and one
//      warp's block must fit 227 KB of shared memory (ops/hmc.py: max_dim;
//      float32 NUTS at max_depth 6: 214 dimensions).  The wrapper raises
//      past them.  4 warps a block where they fit.
//
// The wrapper (pgmpy_tpu_torch/ops/hmc.py) checks the tensors, plans the
// launch and calls the extern "C" launchers through ctypes on PyTorch's
// current stream; they return the launch's cudaError_t.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "race.cuh"

namespace {

using pgmpy_race::launch_key;
using pgmpy_race::normal;
using pgmpy_race::philox;
using pgmpy_race::uniform;

// Philox streams
constexpr unsigned kMomentum = 0, kDirection = 1, kBias = 2, kTake = 3;
constexpr unsigned kHmcMomentum = 4, kHmcAccept = 5;
constexpr double kDeltaMax = 1000.0;

__device__ __forceinline__ uint4 counter(long long chain, unsigned a, unsigned b,
                                         unsigned stream) {
  return make_uint4((unsigned)chain, (unsigned)(chain >> 32), a, (b << 3) | stream);
}

template <typename T>
__device__ __forceinline__ T neg_inf() {
  return T(-CUDART_INF);
}

// The math functions by argument type
__device__ __forceinline__ float ex(float x) { return expf(x); }
__device__ __forceinline__ double ex(double x) { return exp(x); }
__device__ __forceinline__ float ln(float x) { return logf(x); }
__device__ __forceinline__ double ln(double x) { return log(x); }
__device__ __forceinline__ float ln1p(float x) { return log1pf(x); }
__device__ __forceinline__ double ln1p(double x) { return log1p(x); }
__device__ __forceinline__ float absval(float x) { return fabsf(x); }
__device__ __forceinline__ double absval(double x) { return fabs(x); }
__device__ __forceinline__ float fmadd(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fmadd(double a, double b, double c) { return fma(a, b, c); }

// The same sum in every lane: floating-point addition commutes, so the two
// lanes of each butterfly pair add the same two numbers
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

// torch.logaddexp's definition
template <typename T>
__device__ __forceinline__ T logaddexp(T a, T b) {
  if (a == b && absval(a) == T(CUDART_INF)) return a;
  const T m = a > b ? a : b;
  return m + ln1p(ex(-absval(a - b)));
}

// g = -(z - mu) P into g; returns the log-density 0.5 (z - mu) . g, the same
// in every lane.  P: dim rows of 32 K entries in shared memory; row: the
// warp's (z - mu) buffer of 32 K entries.
template <typename T, int K>
__device__ __forceinline__ T grad_value(const T* __restrict__ P, int dim, T* row, const T (&mu)[K],
                                        const T (&z)[K], T (&g)[K], int lane) {
  constexpr int LD = 32 * K;
  T d[K], acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    d[k] = z[k] - mu[k];
    row[lane + 32 * k] = d[k];
    acc[k] = T(0);
  }
  __syncwarp();
  const T* p = P + lane;
#pragma unroll 4
  for (int i = 0; i < dim; ++i) {
    const T di = row[i];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = fmadd(p[i * LD + 32 * k], di, acc[k]);
  }
  __syncwarp();  // every lane has read the row before it is written again
  T part = T(0);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    g[k] = -acc[k];
    part += d[k] * g[k];
  }
  return T(0.5) * warp_sum(part);
}

// |v|^2 over the warp
template <typename T, int K>
__device__ __forceinline__ T norm2(const T (&v)[K]) {
  T s = T(0);
#pragma unroll
  for (int k = 0; k < K; ++k) s += v[k] * v[k];
  return warp_sum(s);
}

// The generalized no-U-turn criterion: rho . a <= 0 or rho . b <= 0
template <typename T, int K>
__device__ __forceinline__ bool is_turning(const T (&a)[K], const T (&b)[K], const T (&rho)[K]) {
  T x = T(0), y = T(0);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    x += rho[k] * a[k];
    y += rho[k] * b[k];
  }
  x = warp_sum(x);
  y = warp_sum(y);
  return x <= T(0) || y <= T(0);
}

// Copy the block's P into shared memory, rows padded to 32 K columns
template <typename T, int K>
__device__ __forceinline__ void stage_precision(T* P, const T* __restrict__ prec, int dim) {
  constexpr int LD = 32 * K;
  for (int idx = threadIdx.x; idx < dim * LD; idx += blockDim.x) {
    const int i = idx / LD, j = idx - i * LD;
    P[idx] = j < dim ? prec[(long long)i * dim + j] : T(0);
  }
  __syncthreads();
}

template <typename T, int K>
__global__ void __launch_bounds__(128) nuts_kernel(
    long long n, int dim, int max_depth, const T* __restrict__ mu_in, const T* __restrict__ prec,
    const T* __restrict__ z_in, double eps_in, const T* __restrict__ r0_in,
    const T* __restrict__ dir_in, const T* __restrict__ bias_in, const T* __restrict__ take_in,
    const unsigned long long* __restrict__ key_in, T* __restrict__ z_out,
    T* __restrict__ accept_out, int* __restrict__ leapfrogs_out,
    signed char* __restrict__ flags_out) {
  constexpr int LD = 32 * K;
  extern __shared__ __align__(16) unsigned char smem[];
  T* P = reinterpret_cast<T*>(smem);
  stage_precision<T, K>(P, prec, dim);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long chain = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (chain >= n) return;
  T* row = P + dim * LD + (long long)warp * LD * (1 + 2 * max_depth);
  T* r_ck = row + LD;                     // max_depth checkpoints of r
  T* rho_ck = r_ck + max_depth * LD;      // and of the momentum sum
  const bool given = r0_in != nullptr;    // explicit noise, else Philox
  const uint2 key = given ? make_uint2(0u, 0u) : launch_key(key_in);
  const T eps = T(eps_in), half = T(0.5 * eps_in);
  const int width = 1 << (max_depth - 1);

  T mu[K], zl[K], rl[K], gl[K], zr[K], rr[K], gr[K], rho[K], zp[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane + 32 * k;
    const bool in = j < dim;
    mu[k] = in ? mu_in[j] : T(0);
    zl[k] = in ? z_in[chain * dim + j] : T(0);
    rl[k] = !in ? T(0)
                : given ? r0_in[chain * dim + j]
                        : normal<T>(philox(counter(chain, 0u, (unsigned)j, kMomentum), key));
  }
  const T logp0 = grad_value<T, K>(P, dim, row, mu, zl, gl, lane);
  const T energy0 = logp0 - T(0.5) * norm2<T, K>(rl);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    zr[k] = zp[k] = zl[k];
    rr[k] = rho[k] = rl[k];
    gr[k] = gl[k];
  }
  T logw = T(0), sum_accept = T(0);
  int n_leaf = 0;
  bool stopped = false, turned = false, diverged = false;

  for (int depth = 0; depth < max_depth && !stopped; ++depth) {
    const long long at = chain * max_depth + depth;
    const T du = given ? dir_in[at]
                       : uniform<T>(philox(counter(chain, depth, 0u, kDirection), key).x);
    const bool right = du < T(0.5);
    const T d = right ? T(1) : T(-1);

    // the subtree, grown from the chosen end with time-oriented momentum
    T z[K], r[K], g[K], rho_s[K], zps[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      z[k] = zps[k] = right ? zr[k] : zl[k];
      r[k] = d * (right ? rr[k] : rl[k]);
      g[k] = right ? gr[k] : gl[k];
      rho_s[k] = T(0);
    }
    T logw_s = neg_inf<T>(), sub_accept = T(0);
    bool sub_turning = false, sub_diverging = false;
    int sub_leaves = 0;
    const T* take_row = given ? take_in + at * width : nullptr;
    for (int leaf = 0; leaf < (1 << depth) && !sub_turning && !sub_diverging; ++leaf) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        r[k] = r[k] + half * g[k];
        z[k] = z[k] + eps * r[k];
      }
      const T logp = grad_value<T, K>(P, dim, row, mu, z, g, lane);
#pragma unroll
      for (int k = 0; k < K; ++k) r[k] = r[k] + half * g[k];
      const T delta = logp - T(0.5) * norm2<T, K>(r) - energy0;
      const bool diverging = delta < T(-kDeltaMax);
      const T logw_leaf = diverging ? neg_inf<T>() : delta;
      const T e = ex(delta);
      const T accept_stat = e > T(1) ? T(1) : e;  // a NaN stays NaN, as clamp_max keeps it
      // progressive multinomial proposal within the subtree
      const T logw_new = logaddexp(logw_s, logw_leaf);
      const T p_leaf = logw_new == neg_inf<T>() ? T(0) : ex(logw_leaf - logw_new);
      const T tu = given ? take_row[leaf]
                         : uniform<T>(philox(counter(chain, depth, leaf, kTake), key).x);
#pragma unroll
      for (int k = 0; k < K; ++k) rho_s[k] += r[k];
      const int idx_max = __popc(leaf >> 1);
      if ((leaf & 1) == 0) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          r_ck[idx_max * LD + lane + 32 * k] = r[k];
          rho_ck[idx_max * LD + lane + 32 * k] = rho_s[k];
        }
      } else {
        // every power-of-two subtree that this odd leaf closes, newest first
        const int idx_min = idx_max - (__popc(leaf ^ (leaf + 1)) - 1) + 1;
        for (int i = idx_max; i >= idx_min && !sub_turning; --i) {
          T rc[K], sub[K];
#pragma unroll
          for (int k = 0; k < K; ++k) {
            rc[k] = r_ck[i * LD + lane + 32 * k];
            sub[k] = rho_s[k] - rho_ck[i * LD + lane + 32 * k] + rc[k];
          }
          sub_turning = is_turning<T, K>(rc, r, sub);
        }
      }
      if (tu < p_leaf) {
#pragma unroll
        for (int k = 0; k < K; ++k) zps[k] = z[k];
      }
      logw_s = logw_new;
      sub_diverging = sub_diverging || diverging;
      sub_accept += accept_stat;
      ++sub_leaves;
    }

    // biased progressive coupling: take the new half's proposal
    // w.p. min(1, W_new / W_old)
    const bool valid = !sub_turning && !sub_diverging;
    const T gap = logw_s - logw;
    const T accept_p = ex(gap > T(0) ? T(0) : gap);
    const T bu = given ? bias_in[at] : uniform<T>(philox(counter(chain, depth, 0u, kBias), key).x);
    if (valid) {
      if (bu < accept_p) {
#pragma unroll
        for (int k = 0; k < K; ++k) zp[k] = zps[k];
      }
      logw = logaddexp(logw, logw_s);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (right) {
          zr[k] = z[k];
          rr[k] = d * r[k];
          gr[k] = g[k];
        } else {
          zl[k] = z[k];
          rl[k] = d * r[k];
          gl[k] = g[k];
        }
        rho[k] = rho[k] + d * rho_s[k];
      }
    }
    const bool whole = is_turning<T, K>(rl, rr, rho);
    turned = turned || sub_turning || (valid && whole);
    diverged = diverged || sub_diverging;
    stopped = !valid || whole;
    sum_accept += sub_accept;
    n_leaf += sub_leaves;
  }

#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane + 32 * k;
    if (j < dim) z_out[chain * dim + j] = zp[k];
  }
  if (lane == 0) {
    accept_out[chain] = sum_accept / T(n_leaf > 1 ? n_leaf : 1);
    leapfrogs_out[chain] = n_leaf;
    flags_out[chain] = (signed char)((turned ? 1 : 0) | (diverged ? 2 : 0));
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(128) hmc_kernel(
    long long n, int dim, int n_steps, int transitions, const T* __restrict__ mu_in,
    const T* __restrict__ prec, const T* __restrict__ z_in, double eps_in,
    const T* __restrict__ momentum_in, const T* __restrict__ accept_in,
    const unsigned long long* __restrict__ key_in, T* __restrict__ z_out,
    unsigned char* __restrict__ accepted_out, T* __restrict__ rate_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* P = reinterpret_cast<T*>(smem);
  stage_precision<T, K>(P, prec, dim);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long chain = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (chain >= n) return;
  T* row = P + dim * 32 * K + (long long)warp * 32 * K;
  const bool given = momentum_in != nullptr;
  const uint2 key = given ? make_uint2(0u, 0u) : launch_key(key_in);
  const T eps = T(eps_in), half = T(0.5 * eps_in);

  T mu[K], q[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane + 32 * k;
    mu[k] = j < dim ? mu_in[j] : T(0);
    q[k] = j < dim ? z_in[chain * dim + j] : T(0);
  }
  for (int t = 0; t < transitions; ++t) {
    const long long at = (long long)t * n + chain;
    T p[K], g[K], qn[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = lane + 32 * k;
      p[k] = j >= dim ? T(0)
                      : given ? momentum_in[at * dim + j]
                              : normal<T>(philox(counter(chain, t, (unsigned)j, kHmcMomentum), key));
      qn[k] = q[k];
    }
    T logp = grad_value<T, K>(P, dim, row, mu, q, g, lane);
    const T current_h = logp - T(0.5) * norm2<T, K>(p);
    for (int s = 0; s < n_steps; ++s) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        p[k] = p[k] + half * g[k];
        qn[k] = qn[k] + eps * p[k];
      }
      logp = grad_value<T, K>(P, dim, row, mu, qn, g, lane);
#pragma unroll
      for (int k = 0; k < K; ++k) p[k] = p[k] + half * g[k];
    }
    const T dh = logp - T(0.5) * norm2<T, K>(p) - current_h;
    const T log_accept = dh > T(0) ? T(0) : dh;
    const T u = given ? accept_in[at] : uniform<T>(philox(counter(chain, t, 0u, kHmcAccept), key).x);
    const bool accept = ln(u) < log_accept;  // a NaN energy never accepts
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (accept) q[k] = qn[k];
      const int j = lane + 32 * k;
      if (j < dim) z_out[at * dim + j] = q[k];
    }
    if (lane == 0) {
      accepted_out[at] = accept ? 1 : 0;
      rate_out[at] = ex(log_accept);
    }
  }
}

template <typename F>
cudaError_t allow_shared(F* kernel, long long bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int K>
cudaError_t launch_nuts(long long n, int dim, int max_depth, const void* mu, const void* prec,
                        const void* z, double eps, const void* r0, const void* dir_u,
                        const void* bias_u, const void* take_u, const void* key, void* z_out,
                        void* accept, void* leapfrogs, void* flags, int warps, long long shared,
                        cudaStream_t stream) {
  cudaError_t err = allow_shared(nuts_kernel<T, K>, shared);
  if (err != cudaSuccess) return err;
  const long long blocks = (n + warps - 1) / warps;
  nuts_kernel<T, K><<<(unsigned)blocks, 32 * warps, shared, stream>>>(
      n, dim, max_depth, (const T*)mu, (const T*)prec, (const T*)z, eps, (const T*)r0,
      (const T*)dir_u, (const T*)bias_u, (const T*)take_u, (const unsigned long long*)key,
      (T*)z_out, (T*)accept, (int*)leapfrogs, (signed char*)flags);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t launch_hmc(long long n, int dim, int n_steps, int transitions, const void* mu,
                       const void* prec, const void* z, double eps, const void* momentum,
                       const void* accept_u, const void* key, void* z_out, void* accepted,
                       void* rate, int warps, long long shared, cudaStream_t stream) {
  cudaError_t err = allow_shared(hmc_kernel<T, K>, shared);
  if (err != cudaSuccess) return err;
  const long long blocks = (n + warps - 1) / warps;
  hmc_kernel<T, K><<<(unsigned)blocks, 32 * warps, shared, stream>>>(
      n, dim, n_steps, transitions, (const T*)mu, (const T*)prec, (const T*)z, eps,
      (const T*)momentum, (const T*)accept_u, (const unsigned long long*)key, (T*)z_out,
      (unsigned char*)accepted, (T*)rate);
  return cudaGetLastError();
}

}  // namespace

// NUTS: elem 4 (float) or 8 (double); lanes = K in {1, 2, 4, 8} (double: up
// to 4); noise pointers all 0 to draw from Philox under *key.
extern "C" int pgmpy_nuts_step(int elem, int lanes, long long n, int dim, int max_depth,
                               const void* mu, const void* prec, const void* z, double eps,
                               const void* r0, const void* dir_u, const void* bias_u,
                               const void* take_u, const void* key, void* z_out, void* accept,
                               void* leapfrogs, void* flags, int warps, long long shared,
                               void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
#define PGMPY_NUTS(T, K)                                                                         \
  return (int)launch_nuts<T, K>(n, dim, max_depth, mu, prec, z, eps, r0, dir_u, bias_u, take_u, \
                                key, z_out, accept, leapfrogs, flags, warps, shared, s)
  if (elem == 4) {
    switch (lanes) {
      case 1: PGMPY_NUTS(float, 1);
      case 2: PGMPY_NUTS(float, 2);
      case 4: PGMPY_NUTS(float, 4);
      case 8: PGMPY_NUTS(float, 8);
    }
  } else if (elem == 8) {
    switch (lanes) {
      case 1: PGMPY_NUTS(double, 1);
      case 2: PGMPY_NUTS(double, 2);
      case 4: PGMPY_NUTS(double, 4);
    }
  }
#undef PGMPY_NUTS
  return (int)cudaErrorInvalidValue;
}

// HMC: as above; every transition of the call in the one launch.
extern "C" int pgmpy_hmc_step(int elem, int lanes, long long n, int dim, int n_steps,
                              int transitions, const void* mu, const void* prec, const void* z,
                              double eps, const void* momentum, const void* accept_u,
                              const void* key, void* z_out, void* accepted, void* rate,
                              int warps, long long shared, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
#define PGMPY_HMC(T, K)                                                                      \
  return (int)launch_hmc<T, K>(n, dim, n_steps, transitions, mu, prec, z, eps, momentum,    \
                               accept_u, key, z_out, accepted, rate, warps, shared, s)
  if (elem == 4) {
    switch (lanes) {
      case 1: PGMPY_HMC(float, 1);
      case 2: PGMPY_HMC(float, 2);
      case 4: PGMPY_HMC(float, 4);
      case 8: PGMPY_HMC(float, 8);
    }
  } else if (elem == 8) {
    switch (lanes) {
      case 1: PGMPY_HMC(double, 1);
      case 2: PGMPY_HMC(double, 2);
      case 4: PGMPY_HMC(double, 4);
    }
  }
#undef PGMPY_HMC
  return (int)cudaErrorInvalidValue;
}
