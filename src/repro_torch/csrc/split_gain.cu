// split_gain: information gain of every (node, attribute, threshold bin),
//
//   stats [N, m, bins, C] f32  ->  gain [N, m, bins] f32,
//
// with NEG = -1e30 where either side of the threshold is empty.
//
// Replaces src/repro/kernels/split_gain/kernel.py::split_gain_pallas
// (kernel.py:47, its pallas_call at :58), which ran the cumsum over bins,
// the three entropies and the weighted gain on (node tile, attribute tile)
// blocks held in VMEM.
//
// What bounds it: each input byte read once and each output byte written
// once, 0.46 us at the 16-row tile VHT's split check gathers
// ([16, 1000, 8, 2]) and 7.3 us at the full [255, 1000, 8, 2] at 3.35 TB/s.
// Neither is reached: the work is C divisions and C accurate log2f per
// entropy, two entropies per output and one per row, and the rate at which
// the SMs execute that arithmetic sets the time on both shapes.  One
// thread per (node, attribute) row is a serial chain of 17 entropies,
// which the tile's 16 000 rows give too few threads to hide.
//
// Design, by row count:
// - Up to ROWS_FOR_ROW_THREADS rows (the tile): one thread per output
//   element, (node, attribute, bin), 128 000 threads at the tile.  A block
//   takes 256 / bins rows (fewer when a row is large), stages them in
//   shared memory with 16-byte cp.async copies (4-byte copies where the
//   rows are not 16-byte aligned), and each thread sums its row's total and
//   its own left prefix over the bins in the first version's order, in one
//   running sum.  At the last bin the left prefix is the row total bit for
//   bit, so that thread's left entropy is the total's: it hands it to its
//   row through shared memory, and no thread computes an extra entropy.
//   Each thread's chain is two entropies, in parallel, instead of 17.
// - From ROWS_FOR_ROW_THREADS rows on (the full fallback): one thread per
//   row, walking its bins, which fills the card at that count and does the
//   least arithmetic per output.
// Both compute an output's two entropies only where both sides hold
// counts: elsewhere the output is NEG whatever they are (the last bin's
// right side is always empty).  Measured with tools/kernel_ab.py on an
// NVIDIA H100 80GB HBM3 at 700 W: tile 0.0056 ms (first version 0.0128),
// full 0.0374 ms (0.0402).  A thread per (row, bin) took 0.062 ms on the
// full shape, and a thread per row 0.0136 ms on the tile.
//
// The arithmetic follows split_gain/ref.py operation by operation, as the
// first version did: the max(tot, 1e-12) guards, the p > 0 mask,
// (nl / n) * hl + (nr / n) * hr, in the same order, with the _rn intrinsics
// so that the compiler fuses no multiply-add the reference does not have.
// So the gains and the NEG mask are bit for bit the first version's.
// log2f is the accurate library function (no fast math); it can differ from
// the host's log2 by an ulp.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kTiny = 1e-12f;
constexpr int THREADS = 256;             // threads per block, at most
constexpr int SMEM_BYTES = 48 * 1024;    // static limit of one block
// from this many rows on, one thread per row (132 SMs x 1024 threads)
constexpr long long ROWS_FOR_ROW_THREADS = 132LL * 1024;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// p * log2(p) of one class, 0 where p is 0: a term of entropy()
__device__ __forceinline__ float plogp(float cnt, float denom) {
  const float p = __fdiv_rn(cnt, denom);
  return p > 0.0f ? __fmul_rn(p, log2f(fmaxf(p, kTiny))) : 0.0f;
}

// sum_c cnt[c] in class order
template <int CMAX>
__device__ __forceinline__ float total_of(const float (&cnt)[CMAX], int C) {
  float tot = 0.0f;
#pragma unroll
  for (int c = 0; c < CMAX; ++c)
    if (c < C) tot = __fadd_rn(tot, cnt[c]);
  return tot;
}

// the entropy of cnt, whose total is tot (0 for an empty side)
template <int CMAX>
__device__ __forceinline__ float entropy(const float (&cnt)[CMAX], int C,
                                         float tot) {
  const float denom = fmaxf(tot, kTiny);
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < CMAX; ++c)
    if (c < C) acc = __fadd_rn(acc, plogp(cnt[c], denom));
  return tot > 0.0f ? -acc : 0.0f;
}

// One threshold's two sides: their totals and, where both hold counts,
// their entropies.  An output with an empty side is NEG and needs neither
// entropy, so they are skipped there.
struct Sides {
  float nl, nr, hl, hr;
};

// the sides of threshold bin b.  left runs on from bin *next to b, in bin
// order, as the first version's running sum; right is total - left.
// With want_hl the left entropy is computed in any case (at the last bin,
// where left is the row total bit for bit, it is the total's entropy).
template <int CMAX>
__device__ __forceinline__ Sides sides_at(const float* s, int C, int b,
                                          int* next,
                                          const float (&total)[CMAX],
                                          float (&left)[CMAX],
                                          bool want_hl = false) {
  for (; *next <= b; ++*next) {
#pragma unroll
    for (int c = 0; c < CMAX; ++c)
      if (c < C) left[c] = __fadd_rn(left[c], s[*next * C + c]);
  }
  float right[CMAX];
#pragma unroll
  for (int c = 0; c < CMAX; ++c)
    right[c] = c < C ? __fsub_rn(total[c], left[c]) : 0.0f;
  Sides sd{total_of<CMAX>(left, C), total_of<CMAX>(right, C), 0.0f, 0.0f};
  const bool both = sd.nl > 0.0f && sd.nr > 0.0f;
  if (both || want_hl) sd.hl = entropy<CMAX>(left, C, sd.nl);
  if (both) sd.hr = entropy<CMAX>(right, C, sd.nr);
  return sd;
}

// the gain h_tot - (nl / n) hl - (nr / n) hr, NEG where a side is empty
__device__ __forceinline__ float gain_of(float h_tot, const Sides& sd) {
  if (!(sd.nl > 0.0f && sd.nr > 0.0f)) return kNeg;
  const float n = fmaxf(__fadd_rn(sd.nl, sd.nr), kTiny);
  const float weighted = __fadd_rn(__fmul_rn(__fdiv_rn(sd.nl, n), sd.hl),
                                   __fmul_rn(__fdiv_rn(sd.nr, n), sd.hr));
  return __fsub_rn(h_tot, weighted);
}

// the row's class totals, summed over its bins in bin order
template <int CMAX>
__device__ __forceinline__ void row_total(const float* s, int bins, int C,
                                          float (&total)[CMAX]) {
#pragma unroll
  for (int c = 0; c < CMAX; ++c) total[c] = 0.0f;
  for (int b = 0; b < bins; ++b) {
#pragma unroll
    for (int c = 0; c < CMAX; ++c)
      if (c < C) total[c] = __fadd_rn(total[c], s[b * C + c]);
  }
}

// One thread per (row, bin): tpr threads per row (one bin each, or a
// stride of bins when bins > THREADS), rpb rows per block, staged in
// shared memory.
template <int CMAX>
__global__ void __launch_bounds__(THREADS)
split_gain_bins_kernel(const float* __restrict__ stats,
                       float* __restrict__ gain, long long rows, int bins,
                       int C, int tpr, int rpb) {
  extern __shared__ __align__(16) float smem[];
  const int row_words = bins * C;
  float* s_htot = smem + rpb * row_words;        // one per row
  const long long row0 = (long long)blockIdx.x * rpb;
  const int nrows = (int)min((long long)rpb, rows - row0);
  const float* src = stats + row0 * row_words;
  const int n = nrows * row_words;
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    head = n & ~3;
    for (int k = 4 * threadIdx.x; k < head; k += 4 * blockDim.x)
      cp_async16(smem + k, src + k);
  }
  for (int k = head + threadIdx.x; k < n; k += blockDim.x)
    cp_async4(smem + k, src + k);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int lr = threadIdx.x / tpr, tb = threadIdx.x - lr * tpr;
  const bool live = lr < nrows;
  const float* s = smem + lr * row_words;
  float total[CMAX], left[CMAX];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) left[c] = 0.0f;
  int next = 0;
  Sides sd{};
  float h_tot = 0.0f;
  if (live) {
    // one running sum over the row's bins in order: left at this thread's
    // bin, the total at the last (the first version's two sums, bit for bit)
    float run[CMAX];
#pragma unroll
    for (int c = 0; c < CMAX; ++c) run[c] = 0.0f;
    for (int b = 0; b < bins; ++b) {
#pragma unroll
      for (int c = 0; c < CMAX; ++c)
        if (c < C) run[c] = __fadd_rn(run[c], s[b * C + c]);
      if (b == tb) {
#pragma unroll
        for (int c = 0; c < CMAX; ++c) left[c] = run[c];
      }
    }
#pragma unroll
    for (int c = 0; c < CMAX; ++c) total[c] = run[c];
    next = tb + 1;
    // the last bin's thread gives the row its total's entropy; a row
    // wider than the block computes it in every thread
    const bool last = tpr == bins && tb == bins - 1;
    sd = sides_at<CMAX>(s, C, tb, &next, total, left, last);
    if (last) s_htot[lr] = sd.hl;
    if (tpr < bins) h_tot = entropy<CMAX>(total, C, total_of<CMAX>(total, C));
  }
  __syncthreads();
  if (!live) return;
  if (tpr == bins) h_tot = s_htot[lr];
  float* g = gain + (row0 + lr) * bins;
  for (int b = tb; b < bins; b += tpr) {
    if (b != tb) sd = sides_at<CMAX>(s, C, b, &next, total, left);
    g[b] = gain_of(h_tot, sd);
  }
}

// One thread per row, walking its bins in order from device memory.
template <int CMAX>
__global__ void __launch_bounds__(THREADS)
split_gain_rows_kernel(const float* __restrict__ stats,
                       float* __restrict__ gain, long long rows, int bins,
                       int C) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float* s = stats + r * bins * C;
  float total[CMAX], left[CMAX];
  row_total<CMAX>(s, bins, C, total);
  const float h_tot = entropy<CMAX>(total, C, total_of<CMAX>(total, C));
#pragma unroll
  for (int c = 0; c < CMAX; ++c) left[c] = 0.0f;
  float* g = gain + r * bins;
  int next = 0;
  for (int b = 0; b < bins; ++b)
    g[b] = gain_of(h_tot, sides_at<CMAX>(s, C, b, &next, total, left));
}

template <int CMAX>
int launch(const float* stats, float* gain, long long rows, int bins, int C,
           cudaStream_t stream) {
  if (rows >= ROWS_FOR_ROW_THREADS) {
    const unsigned blocks = (unsigned)((rows + THREADS - 1) / THREADS);
    split_gain_rows_kernel<CMAX><<<blocks, THREADS, 0, stream>>>(
        stats, gain, rows, bins, C);
    return (int)cudaGetLastError();
  }
  // threads per row, one per bin up to THREADS; rows per block, as many as
  // fill THREADS threads and fit in shared memory with their h_tot
  const int tpr = bins < THREADS ? bins : THREADS;
  const size_t row_bytes = ((size_t)bins * C + 1) * sizeof(float);
  int rpb = THREADS / tpr;
  if ((size_t)rpb * row_bytes > SMEM_BYTES) rpb = (int)(SMEM_BYTES / row_bytes);
  if (rpb == 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((rows + rpb - 1) / rpb);
  split_gain_bins_kernel<CMAX><<<blocks, rpb * tpr, rpb * row_bytes, stream>>>(
      stats, gain, rows, bins, C, tpr, rpb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int split_gain_launch(const void* stats, void* gain, long long rows,
                                 int bins, int C, void* stream) {
  const float* s = (const float*)stats;
  float* g = (float*)gain;
  cudaStream_t st = (cudaStream_t)stream;
  if (C <= 2) return launch<2>(s, g, rows, bins, C, st);
  if (C <= 4) return launch<4>(s, g, rows, bins, C, st);
  if (C <= 8) return launch<8>(s, g, rows, bins, C, st);
  if (C <= 16) return launch<16>(s, g, rows, bins, C, st);
  if (C <= 32) return launch<32>(s, g, rows, bins, C, st);
  return (int)cudaErrorInvalidValue;
}
