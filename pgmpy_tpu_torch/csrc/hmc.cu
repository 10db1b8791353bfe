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
//      proposals, in registers.  Every reduction is a butterfly of
//      __shfl_xor_sync in a fixed order, which leaves the same bits in every
//      lane: the warp takes every branch together, and the same key gives
//      the same samples.  A leaf carries its reductions through ONE
//      butterfly, several values a shuffle round: the log-density and |r|^2,
//      at an odd leaf also the first closed subtree's two U-turn dot
//      products; an HMC step needs none, its trajectory's end two.
//   2. The product g = -(x - mu) P is a chain of dim dependent multiply-adds
//      per coordinate; it is cut into kSplit independent partial sums (the
//      rows i = m mod kSplit), added in a fixed order at the end.  Where a
//      lane's columns fit its registers (float32 up to 64 dimensions, K <= 2;
//      float64 up to 32: ecoli70's 46 are 92 float32 values a lane) P lives
//      there, loaded once, and (x - mu)_i reaches every lane by a shuffle:
//      no shared row, no __syncwarp.  Wider targets keep P in shared memory,
//      staged once per block with its rows padded to 32 K columns with zeros
//      (lane j reads column j: no bank conflict), the warp's (x - mu) written
//      to a row of its own and read back as broadcasts.  Both forms compute
//      the same sums in the same order.  A NUTS warp's momentum checkpoints
//      (max_depth rows of r and of rho) live in shared memory.
//   3. The JAX control flow runs per warp with no host read: the doublings,
//      the leaf loop, the checkpoint slot popc(n >> 1), the closed subtrees
//      from the trailing ones of n, the divergence cap, the coupling.
//   4. Random numbers from a counter: Philox keyed on one 64-bit draw per
//      launch from the caller's generator, at counter (chain, depth, leaf,
//      stream) for NUTS and (chain, transition, coordinate, stream) for HMC;
//      normals by Box-Muller (race.cuh).  An explicit noise layout (the plain
//      version's) may replace them, for the checks against it.
//   5. Limits: a lane holds at most 8 coordinates (4 in double), and one
//      warp's block must fit 227 KB of shared memory in the shared form
//      (ops/hmc.py: max_dim; float32 NUTS at max_depth 6: 214 dimensions).
//      The wrapper raises past them.  4 warps a block where they fit.

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

// The same sums in every lane, several values a shuffle round: floating-point
// addition commutes, so the two lanes of each butterfly pair add the same two
// numbers
template <typename T, int N>
__device__ __forceinline__ void warp_sums(T (&v)[N]) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] += __shfl_xor_sync(0xffffffffu, v[j], offset);
  }
}

// torch.logaddexp's definition
template <typename T>
__device__ __forceinline__ T logaddexp(T a, T b) {
  if (a == b && absval(a) == T(CUDART_INF)) return a;
  const T m = a > b ? a : b;
  return m + ln1p(ex(-absval(a - b)));
}

constexpr int kSplit = 4;  // independent partial sums of each coordinate of the product

// Where the product's P lives: a lane's K columns in registers (REG), or the
// block's copy in shared memory with the warp's (x - mu) row beside it
template <typename T, int K, bool REG>
struct Precision;

template <typename T, int K>
struct Precision<T, K, true> {
  T p[K][32 * K];  // p[k][i] = P[i][lane + 32 k], 0 past dim
  __device__ __forceinline__ void load(const T* __restrict__ prec, int dim, int lane) {
#pragma unroll
    for (int i = 0; i < 32 * K; ++i) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = lane + 32 * k;
        p[k][i] = i < dim && j < dim ? prec[(long long)i * dim + j] : T(0);
      }
    }
  }
  // acc[k][m] += P[i][lane + 32 k] d_i over the rows i = m mod kSplit: every
  // row of the lanes' width, with no branch between the shuffles (the rows
  // past dim are zeros, and so are their d_i)
  __device__ __forceinline__ void product(int, const T (&d)[K], T (&acc)[K][kSplit]) const {
#pragma unroll
    for (int i = 0; i < 32 * K; ++i) {
      const T di = __shfl_sync(0xffffffffu, d[i >> 5], i & 31);
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k][i % kSplit] = fmadd(p[k][i], di, acc[k][i % kSplit]);
    }
  }
};

template <typename T, int K>
struct Precision<T, K, false> {
  const T* P;  // dim rows of 32 K entries in shared memory
  T* row;      // the warp's (x - mu), 32 K entries
  int lane;
  __device__ __forceinline__ void product(int dim, const T (&d)[K], T (&acc)[K][kSplit]) const {
    constexpr int LD = 32 * K;
#pragma unroll
    for (int k = 0; k < K; ++k) row[lane + 32 * k] = d[k];
    __syncwarp();
    const T* p = P + lane;
    int i0 = 0;
    for (; i0 + kSplit <= dim; i0 += kSplit) {  // whole groups of rows: no branch inside
#pragma unroll
      for (int m = 0; m < kSplit; ++m) {
        const T di = row[i0 + m];
#pragma unroll
        for (int k = 0; k < K; ++k) acc[k][m] = fmadd(p[(i0 + m) * LD + 32 * k], di, acc[k][m]);
      }
    }
#pragma unroll
    for (int m = 0; m < kSplit - 1; ++m) {
      if (i0 + m < dim) {
        const T di = row[i0 + m];
#pragma unroll
        for (int k = 0; k < K; ++k) acc[k][m] = fmadd(p[(i0 + m) * LD + 32 * k], di, acc[k][m]);
      }
    }
    __syncwarp();  // every lane has read the row before it is written again
  }
};

// g = -(z - mu) P into g; returns this lane's share of (z - mu) . g (the
// log-density is half its warp sum)
template <typename T, int K, bool REG>
__device__ __forceinline__ T gradient(const Precision<T, K, REG>& P, int dim, const T (&mu)[K],
                                      const T (&z)[K], T (&g)[K]) {
  T d[K], acc[K][kSplit];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    d[k] = z[k] - mu[k];
#pragma unroll
    for (int m = 0; m < kSplit; ++m) acc[k][m] = T(0);
  }
  P.product(dim, d, acc);
  T part = T(0);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    g[k] = -((acc[k][0] + acc[k][1]) + (acc[k][2] + acc[k][3]));
    part += d[k] * g[k];
  }
  return part;
}

// This lane's share of a . b
template <typename T, int K>
__device__ __forceinline__ T dot(const T (&a)[K], const T (&b)[K]) {
  T s = T(0);
#pragma unroll
  for (int k = 0; k < K; ++k) s += a[k] * b[k];
  return s;
}

// The generalized no-U-turn criterion: rho . a <= 0 or rho . b <= 0
template <typename T, int K>
__device__ __forceinline__ bool is_turning(const T (&a)[K], const T (&b)[K], const T (&rho)[K]) {
  T v[2] = {dot<T, K>(rho, a), dot<T, K>(rho, b)};
  warp_sums<T, 2>(v);
  return v[0] <= T(0) || v[1] <= T(0);
}

// Copy the block's P into shared memory, rows padded to 32 K columns (the
// shared form), and return the warp's product; `rest` is the shared memory
// past P and the warps' rows (the register form keeps nothing else there)
template <typename T, int K, bool REG>
__device__ __forceinline__ Precision<T, K, REG> precision(unsigned char* smem,
                                                          const T* __restrict__ prec, int dim,
                                                          int warp, int lane, T*& rest);

template <typename T, int K>
__device__ __forceinline__ Precision<T, K, false> precision_shared(unsigned char* smem,
                                                                   const T* __restrict__ prec,
                                                                   int dim, int warp, int lane,
                                                                   T*& rest) {
  constexpr int LD = 32 * K;
  T* P = reinterpret_cast<T*>(smem);
  for (int idx = threadIdx.x; idx < dim * LD; idx += blockDim.x) {
    const int i = idx / LD, j = idx - i * LD;
    P[idx] = j < dim ? prec[(long long)i * dim + j] : T(0);
  }
  __syncthreads();
  const int warps = blockDim.x >> 5;
  rest = P + dim * LD + warps * LD;
  return Precision<T, K, false>{P, P + dim * LD + warp * LD, lane};
}

template <typename T, int K, bool REG>
__device__ __forceinline__ Precision<T, K, REG> precision(unsigned char* smem,
                                                          const T* __restrict__ prec, int dim,
                                                          int warp, int lane, T*& rest) {
  if constexpr (REG) {
    Precision<T, K, true> P;
    P.load(prec, dim, lane);
    rest = reinterpret_cast<T*>(smem);
    return P;
  } else {
    return precision_shared<T, K>(smem, prec, dim, warp, lane, rest);
  }
}

template <typename T, int K, bool REG>
__global__ void __launch_bounds__(128) nuts_kernel(
    long long n, int dim, int max_depth, const T* __restrict__ mu_in, const T* __restrict__ prec,
    const T* __restrict__ z_in, double eps_in, const T* __restrict__ r0_in,
    const T* __restrict__ dir_in, const T* __restrict__ bias_in, const T* __restrict__ take_in,
    const unsigned long long* __restrict__ key_in, T* __restrict__ z_out,
    T* __restrict__ accept_out, int* __restrict__ leapfrogs_out,
    signed char* __restrict__ flags_out) {
  constexpr int LD = 32 * K;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* rest;
  const Precision<T, K, REG> P = precision<T, K, REG>(smem, prec, dim, warp, lane, rest);
  const long long chain = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (chain >= n) return;
  T* r_ck = rest + (long long)warp * LD * 2 * max_depth;  // max_depth checkpoints of r
  T* rho_ck = r_ck + max_depth * LD;                      // and of the momentum sum
  const bool given = r0_in != nullptr;                    // explicit noise, else Philox
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
  T start[2] = {gradient<T, K, REG>(P, dim, mu, zl, gl), dot<T, K>(rl, rl)};
  warp_sums<T, 2>(start);
  const T energy0 = T(0.5) * start[0] - T(0.5) * start[1];
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
      T sums[4];
      sums[0] = gradient<T, K, REG>(P, dim, mu, z, g);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        r[k] = r[k] + half * g[k];
        rho_s[k] += r[k];
      }
      sums[1] = dot<T, K>(r, r);
      const int idx_max = __popc(leaf >> 1);
      const bool odd = leaf & 1;
      if (odd) {
        // the newest power-of-two subtree this odd leaf closes rides along
        T rc[K], sub[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          rc[k] = r_ck[idx_max * LD + lane + 32 * k];
          sub[k] = rho_s[k] - rho_ck[idx_max * LD + lane + 32 * k] + rc[k];
        }
        sums[2] = dot<T, K>(sub, rc);
        sums[3] = dot<T, K>(sub, r);
        warp_sums<T, 4>(sums);
        sub_turning = sums[2] <= T(0) || sums[3] <= T(0);
      } else {
        T two[2] = {sums[0], sums[1]};
        warp_sums<T, 2>(two);
        sums[0] = two[0];
        sums[1] = two[1];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          r_ck[idx_max * LD + lane + 32 * k] = r[k];
          rho_ck[idx_max * LD + lane + 32 * k] = rho_s[k];
        }
      }
      const T delta = T(0.5) * sums[0] - T(0.5) * sums[1] - energy0;
      const bool diverging = delta < T(-kDeltaMax);
      const T logw_leaf = diverging ? neg_inf<T>() : delta;
      const T e = ex(delta);
      const T accept_stat = e > T(1) ? T(1) : e;  // a NaN stays NaN, as clamp_max keeps it
      // progressive multinomial proposal within the subtree
      const T logw_new = logaddexp(logw_s, logw_leaf);
      const T p_leaf = logw_new == neg_inf<T>() ? T(0) : ex(logw_leaf - logw_new);
      const T tu = given ? take_row[leaf]
                         : uniform<T>(philox(counter(chain, depth, leaf, kTake), key).x);
      if (odd) {
        // the older subtrees it closes, newest first
        const int idx_min = idx_max - (__popc(leaf ^ (leaf + 1)) - 1) + 1;
        for (int i = idx_max - 1; i >= idx_min && !sub_turning; --i) {
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

template <typename T, int K, bool REG>
__global__ void __launch_bounds__(128) hmc_kernel(
    long long n, int dim, int n_steps, int transitions, const T* __restrict__ mu_in,
    const T* __restrict__ prec, const T* __restrict__ z_in, double eps_in,
    const T* __restrict__ momentum_in, const T* __restrict__ accept_in,
    const unsigned long long* __restrict__ key_in, T* __restrict__ z_out,
    unsigned char* __restrict__ accepted_out, T* __restrict__ rate_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* rest;
  const Precision<T, K, REG> P = precision<T, K, REG>(smem, prec, dim, warp, lane, rest);
  const long long chain = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (chain >= n) return;
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
    T sums[2] = {gradient<T, K, REG>(P, dim, mu, q, g), dot<T, K>(p, p)};
    warp_sums<T, 2>(sums);
    const T current_h = T(0.5) * sums[0] - T(0.5) * sums[1];
    // only the trajectory's end needs the log-density
    T part = sums[0];
    for (int s = 0; s < n_steps; ++s) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        p[k] = p[k] + half * g[k];
        qn[k] = qn[k] + eps * p[k];
      }
      part = gradient<T, K, REG>(P, dim, mu, qn, g);
#pragma unroll
      for (int k = 0; k < K; ++k) p[k] = p[k] + half * g[k];
    }
    if (n_steps > 0) {
      sums[0] = part;
      sums[1] = dot<T, K>(p, p);
      warp_sums<T, 2>(sums);
    }
    const T dh = T(0.5) * sums[0] - T(0.5) * sums[1] - current_h;
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

template <typename T, int K, bool REG>
cudaError_t launch_nuts(long long n, int dim, int max_depth, const void* mu, const void* prec,
                        const void* z, double eps, const void* r0, const void* dir_u,
                        const void* bias_u, const void* take_u, const void* key, void* z_out,
                        void* accept, void* leapfrogs, void* flags, int warps, long long shared,
                        cudaStream_t stream) {
  cudaError_t err = allow_shared(nuts_kernel<T, K, REG>, shared);
  if (err != cudaSuccess) return err;
  const long long blocks = (n + warps - 1) / warps;
  nuts_kernel<T, K, REG><<<(unsigned)blocks, 32 * warps, shared, stream>>>(
      n, dim, max_depth, (const T*)mu, (const T*)prec, (const T*)z, eps, (const T*)r0,
      (const T*)dir_u, (const T*)bias_u, (const T*)take_u, (const unsigned long long*)key,
      (T*)z_out, (T*)accept, (int*)leapfrogs, (signed char*)flags);
  return cudaGetLastError();
}

template <typename T, int K, bool REG>
cudaError_t launch_hmc(long long n, int dim, int n_steps, int transitions, const void* mu,
                       const void* prec, const void* z, double eps, const void* momentum,
                       const void* accept_u, const void* key, void* z_out, void* accepted,
                       void* rate, int warps, long long shared, cudaStream_t stream) {
  cudaError_t err = allow_shared(hmc_kernel<T, K, REG>, shared);
  if (err != cudaSuccess) return err;
  const long long blocks = (n + warps - 1) / warps;
  hmc_kernel<T, K, REG><<<(unsigned)blocks, 32 * warps, shared, stream>>>(
      n, dim, n_steps, transitions, (const T*)mu, (const T*)prec, (const T*)z, eps,
      (const T*)momentum, (const T*)accept_u, (const unsigned long long*)key, (T*)z_out,
      (unsigned char*)accepted, (T*)rate);
  return cudaGetLastError();
}

}  // namespace

// NUTS: elem 4 (float) or 8 (double); lanes = K in {1, 2, 4, 8} (double: up
// to 4); reg 1 for P in registers (float K <= 2, double K = 1), 0 for P in
// shared memory; noise pointers all 0 to draw from Philox under *key.
extern "C" int pgmpy_nuts_step(int elem, int lanes, int reg, long long n, int dim, int max_depth,
                               const void* mu, const void* prec, const void* z, double eps,
                               const void* r0, const void* dir_u, const void* bias_u,
                               const void* take_u, const void* key, void* z_out, void* accept,
                               void* leapfrogs, void* flags, int warps, long long shared,
                               void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
#define PGMPY_NUTS(T, K, R)                                                                       \
  return (int)launch_nuts<T, K, R>(n, dim, max_depth, mu, prec, z, eps, r0, dir_u, bias_u,       \
                                   take_u, key, z_out, accept, leapfrogs, flags, warps, shared, s)
  if (elem == 4) {
    switch (lanes * 2 + (reg ? 1 : 0)) {
      case 3: PGMPY_NUTS(float, 1, true);
      case 5: PGMPY_NUTS(float, 2, true);
      case 2: PGMPY_NUTS(float, 1, false);
      case 4: PGMPY_NUTS(float, 2, false);
      case 8: PGMPY_NUTS(float, 4, false);
      case 16: PGMPY_NUTS(float, 8, false);
    }
  } else if (elem == 8) {
    switch (lanes * 2 + (reg ? 1 : 0)) {
      case 3: PGMPY_NUTS(double, 1, true);
      case 2: PGMPY_NUTS(double, 1, false);
      case 4: PGMPY_NUTS(double, 2, false);
      case 8: PGMPY_NUTS(double, 4, false);
    }
  }
#undef PGMPY_NUTS
  return (int)cudaErrorInvalidValue;
}

// HMC: as above; every transition of the call in the one launch.
extern "C" int pgmpy_hmc_step(int elem, int lanes, int reg, long long n, int dim, int n_steps,
                              int transitions, const void* mu, const void* prec, const void* z,
                              double eps, const void* momentum, const void* accept_u,
                              const void* key, void* z_out, void* accepted, void* rate,
                              int warps, long long shared, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
#define PGMPY_HMC(T, K, R)                                                                   \
  return (int)launch_hmc<T, K, R>(n, dim, n_steps, transitions, mu, prec, z, eps, momentum, \
                                  accept_u, key, z_out, accepted, rate, warps, shared, s)
  if (elem == 4) {
    switch (lanes * 2 + (reg ? 1 : 0)) {
      case 3: PGMPY_HMC(float, 1, true);
      case 5: PGMPY_HMC(float, 2, true);
      case 2: PGMPY_HMC(float, 1, false);
      case 4: PGMPY_HMC(float, 2, false);
      case 8: PGMPY_HMC(float, 4, false);
      case 16: PGMPY_HMC(float, 8, false);
    }
  } else if (elem == 8) {
    switch (lanes * 2 + (reg ? 1 : 0)) {
      case 3: PGMPY_HMC(double, 1, true);
      case 2: PGMPY_HMC(double, 1, false);
      case 4: PGMPY_HMC(double, 2, false);
      case 8: PGMPY_HMC(double, 4, false);
    }
  }
#undef PGMPY_HMC
  return (int)cudaErrorInvalidValue;
}
