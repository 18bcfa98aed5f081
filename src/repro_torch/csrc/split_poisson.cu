// split_poisson: the ensembles' member weights, JAX's exact draws,
//
//   (key', k1) = jax.random.split(key)
//   w          = jax.random.poisson(k1, lam, (M, B)).astype(float32)
//
// in one launch (src/repro/ml/ensemble.py:154,178).  It replaces no TPU
// kernel: the JAX package leaves the draw to XLA, as a while loop whose
// every round splits the key, draws a uniform for each element and ends
// when no element's running sum of log-uniforms is above -lam.  Its plain
// PyTorch version (core/prng.py::poisson_knuth) reads that condition on
// the host, so it cannot be captured in a CUDA graph.
//
// The generator is threefry2x32 with jax_threefry_partitionable (JAX's
// default): split key i is the hash of the counter pair (0, i); the 32
// random bits of element j are the xor of the two words of the hash of
// (j >> 32, j & 0xffffffff); a float32 uniform is those bits >> 9 as the
// mantissa of a number in [1, 2), minus 1.  Knuth's sampler counts the
// rounds that begin with the sum above -lam, less one; lam < 10 only,
// where JAX takes Knuth's loop (the ensembles' lam is 1 + 2 * cum_err,
// at most 3; the launcher reads nothing back and checks nothing).
//
// Design: one thread per draw.  An element that is done keeps its count,
// so each thread walks its own copy of the chain of round keys (one hash
// a round for the next key, one for the round's subkey, one for its
// uniform) until its own sum is at or below -lam, with no global loop and
// no host read.  The key words live in registers as native uint32.  The
// sum adds logf(u) in float32, the libdevice logf that torch.log calls on
// the card (no --use_fast_math), so the draws equal the plain version's
// bit for bit there.  Thread 0 writes key' to its own output: the input
// key is read by every block, so it is not overwritten in place.
//
// What bounds it on the H100: integer work at the INT32 rate.  The
// function needs one hash of 20 rounds (some 80 add, rotate and xor
// operations) for each draw's uniform in each of its lam + 1 rounds on
// average, and two a round for the whole launch (the next key and the
// round's subkey, the same for every draw); a few hundredths of a
// microsecond for the ensembles' 10 x 512 draws.  Its bytes (lam read, w
// written) are fewer.  This kernel hashes the shared two in every thread,
// three times the work the function needs, and each of its rounds waits
// on two dependent hashes: the longest thread (the largest draw) and the
// launch set its time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr uint32_t PARITY = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return (v << r) | (v >> (32 - r));
}

// Threefry-2x32, 20 rounds: the hash of (x0, x1) under the key (k0, k1).
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t x0, uint32_t x1,
                                         uint32_t& y0, uint32_t& y1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ PARITY};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = x0 ^ rotl(x1, rot[i & 1][j]);
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  y0 = x0;
  y1 = x1;
}

__global__ void __launch_bounds__(THREADS)
split_poisson_kernel(const uint32_t* __restrict__ key,
                     const float* __restrict__ lam, int lam_cols,
                     float* __restrict__ w, uint32_t* __restrict__ key_out,
                     int n, int B) {
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= n) return;
  const uint32_t k0 = key[0], k1 = key[1];
  if (j == 0) {
    uint32_t a0, a1;
    threefry(k0, k1, 0u, 0u, a0, a1);
    key_out[0] = a0;
    key_out[1] = a1;
  }
  // the poisson key: the second key of the split
  uint32_t r0, r1;
  threefry(k0, k1, 0u, 1u, r0, r1);
  const float l = lam[lam_cols == 1 ? j / B : j];
  const float neg = -l;
  const uint32_t hi = (uint32_t)((uint64_t)j >> 32), lo = (uint32_t)j;
  float log_prod = 0.0f;
  int k = 0;
  while (log_prod > neg) {
    ++k;
    uint32_t n0, n1, s0, s1, b0, b1;
    threefry(r0, r1, 0u, 0u, n0, n1);     // the next round's key
    threefry(r0, r1, 0u, 1u, s0, s1);     // this round's subkey
    threefry(s0, s1, hi, lo, b0, b1);     // its bits at this element
    const float u = __uint_as_float(((b0 ^ b1) >> 9) | 0x3F800000u) - 1.0f;
    log_prod = log_prod + logf(u);
    r0 = n0;
    r1 = n1;
  }
  w[j] = l == 0.0f ? 0.0f : (float)(k - 1);
}

}  // namespace

// key, key_out: uint32 [2]; lam: f32 [M, lam_cols] with lam_cols 1 or B;
// w: f32 [M, B]; n = M * B.
extern "C" int split_poisson_launch(const void* key, const void* lam,
                                    int lam_cols, void* w, void* key_out,
                                    int n, int B, void* stream) {
  if (n <= 0 || B <= 0 || (lam_cols != 1 && lam_cols != B))
    return (int)cudaErrorInvalidValue;
  const int blocks = (n + THREADS - 1) / THREADS;
  split_poisson_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)key, (const float*)lam, lam_cols, (float*)w,
      (uint32_t*)key_out, n, B);
  return (int)cudaGetLastError();
}
