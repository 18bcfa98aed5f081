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
// Design: the chain of round keys is the same for every draw, so a block
// works it out once.  A block has three warps of draws, a thread each, and
// one warp for the chain: a warp on each of an SM's four schedulers, so
// that the chain's hashes do not wait behind the draws' for the INT32
// units.  The chain warp hashes both keys of a split in
// one instruction stream (its even lanes the counter (0, 0), the next
// round's key; its odd lanes (0, 1), the round's subkey) and writes the
// subkeys of CHUNK rounds into a shared table; while the draw warps take
// one chunk, it works out the next one into the table's other half, and
// the block goes on while any of its draws does (__syncthreads_or), so the
// table grows with the longest draw and caps no rounds.  A draw thread
// pays one hash a round, its bits at its element under the round's
// subkey; the hashes of a chunk's rounds do not depend on each other, so
// they are in flight together, and their logf's are added in round order.
// Lane 0 of the first block's chain warp writes key': the input key is
// read by every block, so it is not overwritten in place.
//
// What bounds it on the H100: integer work at the INT32 rate.  The
// function needs one hash of 20 rounds (some 80 add, rotate and xor
// operations) for each draw's uniform in each of its lam + 1 rounds on
// average, and two a round for the whole launch (the next key and the
// round's subkey); a few hundredths of a microsecond for the ensembles'
// 10 x 512 draws.  Its bytes (lam read, w written) are fewer.  The kernel
// is held back by the chain instead: R + 2 dependent hashes for a largest
// draw of R - 1 (the split, R round keys, the last bits), each some 45
// dependent add, rotate and xor steps, and a barrier a chunk.  Measured
// at [10, 512] (tools/kernel_ab.py, NVIDIA H100 80GB HBM3 at 700 W): 0.0038
// ms at lam 1 (largest draw 6), 0.0042 at boosting's rates, 0.0068 at lam
// 9.99 (largest draw 24), against a bound of 0.0000489 at lam 1; the first
// design, which walked the whole chain in every thread, three
// hashes a round and two of them dependent, took 0.0049, 0.0058 and
// 0.0111.  Chunks of one round took 0.0044, 0.0054 and 0.0098 (a barrier
// a round), of four 0.0038, 0.0044 and 0.0067.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DRAW_WARPS = 3;           // warps of draws in a block
constexpr int DRAWS = 32 * DRAW_WARPS;  // draws in a block, a thread each
constexpr int THREADS = DRAWS + 32;     // and the chain's warp
constexpr int CHUNK = 2;                // rounds of the table's each half
constexpr uint32_t PARITY = 0x1BD11BDAu;
constexpr unsigned FULL = 0xffffffffu;

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

// One split of (k0, k1) in the chain warp: its even lanes hash the counter
// (0, 0), its odd lanes (0, 1).  Returns the first key in (n0, n1) and the
// second in (s0, s1), in every lane.
__device__ __forceinline__ void split2(uint32_t k0, uint32_t k1,
                                       uint32_t& n0, uint32_t& n1,
                                       uint32_t& s0, uint32_t& s1) {
  uint32_t h0, h1;
  threefry(k0, k1, 0u, threadIdx.x & 1u, h0, h1);
  n0 = __shfl_sync(FULL, h0, 0);
  n1 = __shfl_sync(FULL, h1, 0);
  s0 = __shfl_sync(FULL, h0, 1);
  s1 = __shfl_sync(FULL, h1, 1);
}

// The chain warp: the subkeys of the next CHUNK rounds into `half`, one
// half of the table, (r0, r1) advanced past them.
__device__ __forceinline__ void fill(uint32_t (*half)[2], uint32_t& r0,
                                     uint32_t& r1) {
#pragma unroll
  for (int c = 0; c < CHUNK; ++c) {
    uint32_t s0, s1;
    split2(r0, r1, r0, r1, s0, s1);
    if ((threadIdx.x & 31) == 0) {
      half[c][0] = s0;
      half[c][1] = s1;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
split_poisson_kernel(const uint32_t* __restrict__ key,
                     const float* __restrict__ lam, int lam_cols,
                     float* __restrict__ w, uint32_t* __restrict__ key_out,
                     int n, int B) {
  __shared__ uint32_t s_sub[2][CHUNK][2];  // the round subkeys, two halves
  const int tid = threadIdx.x;
  const bool chain = tid >= DRAWS;
  const int j = blockIdx.x * DRAWS + tid;
  uint32_t r0 = 0, r1 = 0;                 // the chain: the next round's key
  float l = 0.0f, neg = 0.0f, log_prod = 0.0f;
  int k = 0;
  bool drawing = false;
  if (chain) {
    // the split of the key: key' and the poisson key
    uint32_t a0, a1;
    split2(key[0], key[1], a0, a1, r0, r1);
    if (blockIdx.x == 0 && tid == DRAWS) {
      key_out[0] = a0;
      key_out[1] = a1;
    }
    fill(s_sub[0], r0, r1);
  } else if (j < n) {
    l = lam[lam_cols == 1 ? j / B : j];
    neg = -l;
    drawing = log_prod > neg;
  }
  const uint32_t hi = (uint32_t)((uint64_t)j >> 32), lo = (uint32_t)j;
  __syncthreads();
  for (int h = 0;; h ^= 1) {
    if (chain) {
      fill(s_sub[h ^ 1], r0, r1);
    } else if (drawing) {
      // this chunk's rounds: their bits all at once, their logs in order
      float lg[CHUNK];
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) {
        uint32_t b0, b1;
        threefry(s_sub[h][c][0], s_sub[h][c][1], hi, lo, b0, b1);
        lg[c] = logf(__uint_as_float(((b0 ^ b1) >> 9) | 0x3F800000u) -
                     1.0f);
      }
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) {
        if (drawing) {
          ++k;
          log_prod = log_prod + lg[c];
          drawing = log_prod > neg;
        }
      }
    }
    if (!__syncthreads_or(drawing)) break;
  }
  if (!chain && j < n) w[j] = l == 0.0f ? 0.0f : (float)(k - 1);
}

}  // namespace

// key, key_out: uint32 [2]; lam: f32 [M, lam_cols] with lam_cols 1 or B;
// w: f32 [M, B]; n = M * B.
extern "C" int split_poisson_launch(const void* key, const void* lam,
                                    int lam_cols, void* w, void* key_out,
                                    int n, int B, void* stream) {
  if (n <= 0 || B <= 0 || (lam_cols != 1 && lam_cols != B))
    return (int)cudaErrorInvalidValue;
  const int blocks = (n + DRAWS - 1) / DRAWS;
  split_poisson_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)key, (const float*)lam, lam_cols, (float*)w,
      (uint32_t*)key_out, n, B);
  return (int)cudaGetLastError();
}
