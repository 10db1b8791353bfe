// The random draws shared by the kernels (ancestral.cu, gibbs.cu, hmc.cu):
// Philox-4x32-10, the exponential race, uniforms in (0, 1) and Box-Muller
// normals.
//
// A categorical draw is argmax_s (logit_s - log E_s) with E_s ~ Exp(1),
// clamped at 1e-20 so that a state of zero probability (its logit at a clamp
// such as log(1e-38)) never beats one of real mass.  The uniform behind E_s
// is 32 bits of Philox under a key drawn once per launch from the caller's
// torch.Generator, at a counter the caller chooses (row, node, state / 4):
// no state is carried between threads or launches.

#pragma once

#include <cuda_runtime.h>

namespace pgmpy_race {

__device__ __forceinline__ uint4 philox(uint4 c, uint2 k) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    if (round) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const unsigned lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const unsigned lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// logit - log(max(E, 1e-20)), E = -log(U), U uniform in (0, 1) from 32 bits
__device__ __forceinline__ float race(float logit, unsigned x) {
  const float u = ((float)(x >> 9) + 0.5f) * 1.1920928955078125e-07f;  // 2^-23
  return logit - logf(fmaxf(-logf(u), 1e-20f));
}

__device__ __forceinline__ double race(double logit, unsigned x) {
  const double u = ((double)x + 0.5) * 2.3283064365386962890625e-10;  // 2^-32
  return logit - log(fmax(-log(u), 1e-20));
}

// A uniform in (0, 1), never 0 nor 1, from 32 random bits (24 of them in float)
template <typename T>
__device__ __forceinline__ T uniform(unsigned x);

template <>
__device__ __forceinline__ float uniform<float>(unsigned x) {
  return ((float)(x >> 8) + 0.5f) * 5.9604644775390625e-08f;  // 2^-24
}

template <>
__device__ __forceinline__ double uniform<double>(unsigned x) {
  return ((double)x + 0.5) * 2.3283064365386962890625e-10;  // 2^-32
}

// A standard normal by Box-Muller from the first two words of a Philox block
template <typename T>
__device__ __forceinline__ T normal(uint4 r);

template <>
__device__ __forceinline__ float normal<float>(uint4 r) {
  return sqrtf(-2.0f * logf(uniform<float>(r.x))) * cospif(2.0f * uniform<float>(r.y));
}

template <>
__device__ __forceinline__ double normal<double>(uint4 r) {
  return sqrt(-2.0 * log(uniform<double>(r.x))) * cospi(2.0 * uniform<double>(r.y));
}

// The launch's Philox key: one 64-bit draw from the generator, on the card
__device__ __forceinline__ uint2 launch_key(const unsigned long long* key) {
  const unsigned long long seed = *key;
  return make_uint2((unsigned)seed, (unsigned)(seed >> 32));
}

// The Philox counter of (row, node, states s0 .. s0 + 3)
__device__ __forceinline__ uint4 counter(long long row, int node, int s0) {
  return make_uint4((unsigned)row, (unsigned)(row >> 32), (unsigned)node, (unsigned)(s0 >> 2));
}

}  // namespace pgmpy_race
