// vht_stats: accumulate the VHT sufficient statistics of one micro-batch,
//
//   stats[leaf_i, j, xbin_ij, y_i] += w_i     for every instance i, attribute j,
//
// in place on stats [N, m, bins, C] f32.
//
// Replaces src/repro/kernels/vht_stats/kernel.py::stats_update_pallas
// (kernel.py:55, its pallas_call at :69), which wrote the scatter as
// one-hot [N, B] x [B, ja*bins*C] matmuls on the TPU's matrix unit and so
// read and rewrote the whole statistics tensor (N * m * bins * C floats)
// on every call.
//
// What bounds it on the H100: the function reads xbin (B * m ints) and
// reads and writes each hit cell once, 1.77 us at the VHT main path's
// [255, 1000, 8, 2], B = 512, at 3.35 TB/s.  The first kernel, one thread
// per (instance, attribute) and one global atomicAdd per hit, took 8.3 us
// on a batch routed through a 51-node tree: B * m = 512 000 float atomics
// that the L2 takes one element at a time (by these timings about 100 a
// nanosecond on the whole card), although on the main path a batch falls in only 1 to 26
// leaves, so that some 20 instances hit each (leaf, attribute) and most
// atomics go to cells that others of the same launch also hit.
//
// Design: sum a batch that falls in few leaves on the SM, then write each
// hit cell once.
//  1. A block owns a tile of JA attributes (4 at the main path's shape:
//     250 blocks), stats[:, j0 .. j0+JA, :, :].  Each thread takes two
//     instances and starts all their loads at once: leaf, class, weight
//     and the tile's JA bins of each row, one 16-byte load where the rows
//     are aligned.  That round, 512 rows of 16 bytes a block, is the
//     kernel's longest wait (about 1.2 us); the block zeroes its histogram
//     meanwhile.
//  2. It flags the leaves that instances of nonzero weight fall in, in a
//     bitmap over N in shared memory, counts them (L), and checks that
//     every weight is an integer small enough for exact int sums.
//  3. A batch in more than B / DENSE leaves has too few hits a cell to
//     sum, and a batch of fractional weights (which no VHT path sends)
//     cannot be summed in ints: each hit goes straight to stats by a
//     fire-and-forget atomic add, as in the first kernel.
//  4. Otherwise the leaves are numbered 0 .. L-1 by a prefix count of the
//     bitmap's words, and each instance's weight goes into a shared
//     histogram [leaf][JA][bins][C] of int counts by native shared atomics
//     (ATOMS.ADD).
//  5. The block adds each nonzero cell into stats once.  No other block
//     touches these cells, so that is a plain 16-byte load, add and store
//     of four cells, loads of two such groups in flight together, where
//     bins * C is a multiple of 4 and stats is aligned (else one atomic add
//     a cell): the flush costs one round trip, where atomics cost one L2
//     operation a cell.
// The histogram serves at most B / DENSE leaves; the launcher takes the
// largest JA (1, 2 or 4) for which min(N, B / DENSE) leaves fit in BUDGET
// bytes of shared memory, and where not even JA = 1 fits, the block loops
// over groups of `group` leaves, a pass over the batch each.
// kernels/vht_stats/ops.py::tile_plan computes the same plan in Python,
// and vht_stats_plan below returns this file's, so a test holds the two
// together.
//
// Measured with tools/kernel_ab.py against the first kernel (NVIDIA H100
// 80GB HBM3, 700 W; device ms): 0.0056 (0.0083) on a batch routed through
// a 51-node tree, 0.0053 (0.0086) in one leaf, 0.0080 (0.0075) uniform
// over 255 leaves, where the direct path (3) pays the step 2 before its
// atomics.  Tried and dropped (51-node batch unless said): float shared
// atomics for integer weights, 0.0094 (the compare-and-swap loop); a
// histogram for every batch, 0.0169 uniform (a flush of some 2000
// scattered atomics a block); a flush by atomics, 0.0065;
// warp-aggregated (__match_any_sync) int atomics, 0.0209; 8-attribute
// tiles, about 5 % slower uniform.
//
// Semantics as the first kernel's: instances of weight 0 (shed by the wok
// variant, or not replayed by wk(z)) do nothing, and indices out of range
// are skipped, as the one-hot formulation drops them.  Float atomics sum
// in no fixed order, and a cell takes its batch's sum in one add: with
// integer counts and weights (every VHT path: 0/1 weights on counts) all
// partial sums below 2^24 are exact, so the result is bit-identical to the
// plain version and to the first kernel; with fractional weights it
// agrees to rounding.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int BUDGET = 72 * 1024;   // shared memory bytes a block may take
constexpr int JA_MAX = 4;           // attributes a block takes at most
constexpr int UNROLL = 2;           // instances a thread holds at once
constexpr int CHUNK = UNROLL * THREADS;
constexpr int DENSE = 8;            // instances a leaf for the histogram
constexpr int FLUSH = 2;            // 16-byte cells a thread flushes at once

struct Plan {
  int ja;       // attributes per block: 1, 2 or 4
  int group;    // leaves per pass over the batch
  int smem;     // dynamic shared memory bytes; 0: the shape does not fit
};

// The histogram serves batches of at most B / DENSE leaves, so it holds
// min(N, B / DENSE) leaves.  Shared memory: the histogram [group][ja][bins]
// [C] (4-byte counts), then the bitmap and its words' prefix counts (one
// int each per 32 leaves), then the leaf id of each histogram leaf.
Plan make_plan(int N, int B, int bins, int C) {
  const long long words = (N + 31) / 32;
  const long long most = B / DENSE > 1 ? B / DENSE : 1;
  const long long worst = N < most ? N : most;
  const long long fixed = 8 * words + 4 * worst;
  const long long cell = 4LL * bins * C;          // one (leaf, attribute)
  const long long room = BUDGET - fixed;
  if (worst < 1 || room < cell) return {0, 0, 0};
  int ja = JA_MAX;
  while (ja > 1 && ja * worst * cell > room) ja /= 2;
  long long group = room / (ja * cell);
  if (group > worst) group = worst;
  return {ja, (int)group, (int)(fixed + group * ja * cell)};
}

__device__ __forceinline__ bool counted(float wi, int n, int c, int N,
                                        int C) {
  return wi != 0.0f && n >= 0 && n < N && c >= 0 && c < C;
}

// One thread's instances of a chunk, i0 + u * THREADS for u < UNROLL: leaf,
// class, weight and the bins of the block's JA attributes (-1 past m).
template <int JA>
struct Hits {
  int n[UNROLL], c[UNROLL], bin[UNROLL][JA];
  float w[UNROLL];
};

// vec: the JA bins of a row in one 8- or 16-byte load (aligned, jn == JA).
template <int JA>
__device__ __forceinline__ void load(Hits<JA>& h, int i0,
                                     const int* __restrict__ leaf,
                                     const int* __restrict__ xbin,
                                     const int* __restrict__ y,
                                     const float* __restrict__ w, int B,
                                     int m, int j0, int jn, bool vec) {
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int i = i0 + u * THREADS;
    h.w[u] = 0.0f;
    h.n[u] = h.c[u] = -1;
    if (i >= B) continue;
    h.n[u] = leaf[i];
    h.c[u] = y[i];
    h.w[u] = w[i];
    const int* row = xbin + (size_t)i * m + j0;
    if constexpr (JA == 2) {
      if (vec) {
        const int2 v = __ldcg(reinterpret_cast<const int2*>(row));
        h.bin[u][0] = v.x;
        h.bin[u][1] = v.y;
        continue;
      }
    } else if constexpr (JA == 4) {
      if (vec) {
        const int4 v = __ldcg(reinterpret_cast<const int4*>(row));
        h.bin[u][0] = v.x;
        h.bin[u][1] = v.y;
        h.bin[u][2] = v.z;
        h.bin[u][3] = v.w;
        continue;
      }
    }
#pragma unroll
    for (int jj = 0; jj < JA; ++jj)
      h.bin[u][jj] = jj < jn ? __ldcg(row + jj) : -1;
  }
}

__device__ __forceinline__ int rank(const unsigned* bits, const int* prefix,
                                    int n) {
  return prefix[n >> 5] + __popc(bits[n >> 5] & ((1u << (n & 31)) - 1u));
}

// The weights of h, integers, into the histogram's compact leaves
// g0 .. g0+gl-1.
template <int JA>
__device__ __forceinline__ void accumulate(int* hist, const Hits<JA>& h,
                                           const unsigned* bits,
                                           const int* prefix, int g0, int gl,
                                           int cells, int bins, int C,
                                           int N) {
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int n = h.n[u];
    if (!counted(h.w[u], n, h.c[u], N, C)) continue;
    const int k = rank(bits, prefix, n) - g0;
    if (k < 0 || k >= gl) continue;
    int* p = hist + k * JA * cells + h.c[u];
    const int v = static_cast<int>(h.w[u]);
#pragma unroll
    for (int jj = 0; jj < JA; ++jj) {
      const int b = h.bin[u][jj];
      if (b >= 0 && b < bins) atomicAdd(p + jj * cells + b * C, v);
    }
  }
}

// Each nonzero cell of the histogram into stats, once.  vec4 (bins * C a
// multiple of 4, stats 16-byte aligned): four cells a thread, as plain
// 16-byte loads and stores, since no other block touches these cells, with
// the loads of FLUSH groups in flight together; else one fire-and-forget
// atomic add a cell.  Either way a cell takes one rounding, old + sum.
template <int JA>
__device__ __forceinline__ void flush(float* __restrict__ stats,
                                      const int* hist, const int* ids, int g0,
                                      int gl, int cells, int m, int j0,
                                      int jn, bool vec4) {
  const int tile = JA * cells;
  if (vec4) {
    const int per = tile / 4, lim = jn * cells / 4, n4 = gl * per;
    const int4* h4 = reinterpret_cast<const int4*>(hist);
    for (int e0 = threadIdx.x; e0 < n4; e0 += FLUSH * THREADS) {
      float4* dst[FLUSH];
      float4 old[FLUSH];
      int4 add[FLUSH];
#pragma unroll
      for (int q = 0; q < FLUSH; ++q) {
        const int e = e0 + q * THREADS;
        const int k = e / per, r = e - k * per;
        dst[q] = nullptr;
        if (e >= n4 || r >= lim) continue;
        add[q] = h4[e];
        if ((add[q].x | add[q].y | add[q].z | add[q].w) == 0) continue;
        dst[q] = reinterpret_cast<float4*>(
                     stats + ((size_t)ids[g0 + k] * m + j0) * cells) + r;
        old[q] = __ldcg(dst[q]);
      }
#pragma unroll
      for (int q = 0; q < FLUSH; ++q) {
        if (dst[q] == nullptr) continue;
        if (add[q].x != 0) old[q].x += static_cast<float>(add[q].x);
        if (add[q].y != 0) old[q].y += static_cast<float>(add[q].y);
        if (add[q].z != 0) old[q].z += static_cast<float>(add[q].z);
        if (add[q].w != 0) old[q].w += static_cast<float>(add[q].w);
        *dst[q] = old[q];
      }
    }
    return;
  }
  for (int e = threadIdx.x; e < gl * tile; e += THREADS) {
    const int v = hist[e];
    if (v == 0) continue;
    const int k = e / tile;
    const int r = e - k * tile;             // jj * cells + b * C + c
    if (r >= jn * cells) continue;          // past the last attribute
    atomicAdd(stats + ((size_t)ids[g0 + k] * m + j0) * cells + r,
              static_cast<float>(v));
  }
}

// A batch spread over many leaves: each hit straight into stats.
template <int JA>
__device__ __forceinline__ void scatter(float* __restrict__ stats,
                                        const Hits<JA>& h, int m, int j0,
                                        int bins, int C, int N) {
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    if (!counted(h.w[u], h.n[u], h.c[u], N, C)) continue;
    float* p = stats + ((size_t)h.n[u] * m + j0) * bins * C + h.c[u];
#pragma unroll
    for (int jj = 0; jj < JA; ++jj) {
      const int b = h.bin[u][jj];
      if (b >= 0 && b < bins) atomicAdd(p + (jj * bins + b) * C, h.w[u]);
    }
  }
}

template <int JA>
__global__ void __launch_bounds__(THREADS)
vht_stats_kernel(float* __restrict__ stats, const int* __restrict__ leaf,
                 const int* __restrict__ xbin, const int* __restrict__ y,
                 const float* __restrict__ w, int N, int B, int m, int bins,
                 int C, int group) {
  extern __shared__ int4 smem[];
  int* hist = reinterpret_cast<int*>(smem);
  const int cells = bins * C;               // one (leaf, attribute)
  const int tile = JA * cells;              // one leaf's cells in the block
  const int words = (N + 31) >> 5;
  unsigned* bits = reinterpret_cast<unsigned*>(hist + (size_t)group * tile);
  int* prefix = reinterpret_cast<int*>(bits + words);
  int* ids = prefix + words;
  const int t = threadIdx.x;
  const int j0 = blockIdx.x * JA;
  const int jn = min(JA, m - j0);
  const bool vec = JA > 1 && jn == JA && m % JA == 0 &&
                   reinterpret_cast<uintptr_t>(xbin) % (4 * JA) == 0;
  const bool vec4 = cells % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(stats) % 16 == 0;

  // 1. the first chunk's loads, all in flight while the histogram is zeroed
  Hits<JA> first;
  load(first, t, leaf, xbin, y, w, B, m, j0, jn, vec);
  const int hist4 = group * tile / 4;
  for (int e = t; e < hist4; e += THREADS) smem[e] = make_int4(0, 0, 0, 0);
  for (int e = 4 * hist4 + t; e < group * tile; e += THREADS) hist[e] = 0;
  for (int k = t; k < words; k += THREADS) bits[k] = 0u;
  __syncthreads();

  // 2. the leaves present, numbered in the order of their ids; whether
  // every weight is an integer whose batch sums are exact in an int
  const float wmax = 16777216.0f / B;
  bool integral = true;
  auto mark = [&](float wi, int n, int c) {
    integral = integral && wi == truncf(wi) && fabsf(wi) <= wmax;
    if (counted(wi, n, c, N, C)) atomicOr(&bits[n >> 5], 1u << (n & 31));
  };
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) mark(first.w[u], first.n[u], first.c[u]);
  for (int i = t + CHUNK; i < B; i += THREADS) mark(w[i], leaf[i], y[i]);
  integral = __syncthreads_and(integral);
  const int lane = t & 31;
  int L = 0;                                // leaves present, every warp
  for (int k = lane; k < words; k += 32) L += __popc(bits[k]);
  L = __reduce_add_sync(0xffffffffu, L);

  if (!integral || DENSE * L > B) {         // nothing to sum in ints
    for (int i0 = t; i0 < B; i0 += CHUNK) {
      Hits<JA> h = first;
      if (i0 != t) load(h, i0, leaf, xbin, y, w, B, m, j0, jn, vec);
      scatter(stats, h, m, j0, bins, C, N);
    }
    return;
  }
  if (t < 32) {                             // prefix of the words, warp 0
    int run = 0;
    for (int k0 = 0; k0 < words; k0 += 32) {
      const int k = k0 + t;
      const int own = k < words ? __popc(bits[k]) : 0;
      int inc = own;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(0xffffffffu, inc, d);
        if (t >= d) inc += o;
      }
      if (k < words) prefix[k] = run + inc - own;
      run += __shfl_sync(0xffffffffu, inc, 31);
    }
  }
  __syncthreads();
  for (int k = t; k < words; k += THREADS) {
    unsigned b = bits[k];
    for (int r = prefix[k]; b; b &= b - 1, ++r) ids[r] = 32 * k + __ffs(b) - 1;
  }
  for (int g0 = 0; g0 < L; g0 += group) {
    const int gl = min(group, L - g0);
    if (g0 > 0) {
      for (int e = t; e < gl * tile; e += THREADS) hist[e] = 0;
      __syncthreads();
    }
    // 3. each instance's weight into its compact leaf's cells
    for (int i0 = t; i0 < B; i0 += CHUNK) {
      Hits<JA> h = first;
      if (i0 != t) load(h, i0, leaf, xbin, y, w, B, m, j0, jn, vec);
      accumulate(hist, h, bits, prefix, g0, gl, cells, bins, C, N);
    }
    __syncthreads();
    // 4. each nonzero cell into stats, once
    flush<JA>(stats, hist, ids, g0, gl, cells, m, j0, jn, vec4);
    __syncthreads();                        // before the next group
  }
}

template <int JA>
int launch(const Plan& p, float* stats, const int* leaf, const int* xbin,
           const int* y, const float* w, int N, int B, int m, int bins, int C,
           cudaStream_t stream) {
  if (p.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        vht_stats_kernel<JA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        p.smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)((m + JA - 1) / JA);
  vht_stats_kernel<JA><<<blocks, THREADS, p.smem, stream>>>(
      stats, leaf, xbin, y, w, N, B, m, bins, C, p.group);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vht_stats_plan(int N, int B, int bins, int C, int* out) {
  const Plan p = make_plan(N, B, bins, C);
  out[0] = p.ja;
  out[1] = p.group;
  out[2] = p.smem;
  return p.smem > 0 ? 0 : (int)cudaErrorInvalidValue;
}

extern "C" int vht_stats_launch(void* stats, const void* leaf, const void* xbin,
                                const void* y, const void* w, int N, int B,
                                int m, int bins, int C, void* stream) {
  if (N <= 0 || B <= 0 || m <= 0 || bins <= 0 || C <= 0) return 0;
  const Plan p = make_plan(N, B, bins, C);
  float* s = (float*)stats;
  const int *l = (const int*)leaf, *x = (const int*)xbin, *c = (const int*)y;
  const float* wt = (const float*)w;
  cudaStream_t st = (cudaStream_t)stream;
  switch (p.ja) {
    case 1: return launch<1>(p, s, l, x, c, wt, N, B, m, bins, C, st);
    case 2: return launch<2>(p, s, l, x, c, wt, N, B, m, bins, C, st);
    case 4: return launch<4>(p, s, l, x, c, wt, N, B, m, bins, C, st);
    default: return (int)cudaErrorInvalidValue;   // does not fit
  }
}
