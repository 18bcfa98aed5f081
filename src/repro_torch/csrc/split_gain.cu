// split_gain: information gain of every (node, attribute, threshold bin),
//
//   stats [N, m, bins, C] f32  ->  gain [N, m, bins] f32,
//
// with NEG = -1e30 where either side of the threshold is empty.
//
// Replaces src/repro/kernels/split_gain/kernel.py::split_gain_pallas (the
// `_kernel` body), which ran the cumsum over bins, the three entropies and
// the weighted gain on (node tile, attribute tile) blocks held in VMEM.
//
// On the H100 one thread takes one (node, attribute) row: it sums the row's
// bins x C counts for the class totals, then walks the bins once more with
// the running cumsum in registers and writes one gain per bin.  Nothing
// between the stages touches device memory, so the kernel moves each input
// byte in and each output byte out once: on all N rows its bound is those
// bytes.  On the 16-row tile the split check gathers, the rows fill fewer
// blocks than the card has SMs, and the latency of each thread's serial
// chain (bins x C divisions and log2f) bounds it instead; a thread per
// (row, bin) would spread that, in a later change.  The arithmetic follows
// split_gain/ref.py operation by operation: the max(tot, 1e-12) guards, the
// p > 0 mask, (nl / n) * hl + (nr / n) * hr, in the same order, with the _rn
// intrinsics so that the compiler fuses no multiply-add the reference does
// not have.  log2f is the accurate library function (no fast math); it can
// differ from the host's log2 by an ulp.

#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kTiny = 1e-12f;

template <int CMAX>
__device__ __forceinline__ float entropy(const float (&cnt)[CMAX], int C,
                                         float* total_out) {
  float tot = 0.0f;
#pragma unroll
  for (int c = 0; c < CMAX; ++c)
    if (c < C) tot = __fadd_rn(tot, cnt[c]);
  const float denom = fmaxf(tot, kTiny);
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < CMAX; ++c) {
    if (c < C) {
      const float p = __fdiv_rn(cnt[c], denom);
      const float term = p > 0.0f ? __fmul_rn(p, log2f(fmaxf(p, kTiny))) : 0.0f;
      acc = __fadd_rn(acc, term);
    }
  }
  *total_out = tot;
  return tot > 0.0f ? -acc : 0.0f;
}

template <int CMAX>
__global__ void split_gain_kernel(const float* __restrict__ stats,
                                  float* __restrict__ gain, long long rows,
                                  int bins, int C) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float* s = stats + (size_t)r * bins * C;
  float* g = gain + (size_t)r * bins;

  float total[CMAX], left[CMAX], right[CMAX];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) total[c] = 0.0f;
  for (int b = 0; b < bins; ++b) {
#pragma unroll
    for (int c = 0; c < CMAX; ++c)
      if (c < C) total[c] = __fadd_rn(total[c], s[b * C + c]);
  }
  float unused;
  const float h_tot = entropy<CMAX>(total, C, &unused);

#pragma unroll
  for (int c = 0; c < CMAX; ++c) left[c] = 0.0f;
  for (int b = 0; b < bins; ++b) {
#pragma unroll
    for (int c = 0; c < CMAX; ++c) {
      if (c < C) {
        left[c] = __fadd_rn(left[c], s[b * C + c]);
        right[c] = __fsub_rn(total[c], left[c]);
      } else {
        right[c] = 0.0f;
      }
    }
    float nl, nr;
    const float hl = entropy<CMAX>(left, C, &nl);
    const float hr = entropy<CMAX>(right, C, &nr);
    const float n = fmaxf(__fadd_rn(nl, nr), kTiny);
    const float weighted = __fadd_rn(__fmul_rn(__fdiv_rn(nl, n), hl),
                                     __fmul_rn(__fdiv_rn(nr, n), hr));
    const float gv = __fsub_rn(h_tot, weighted);
    g[b] = (nl > 0.0f && nr > 0.0f) ? gv : kNeg;
  }
}

template <int CMAX>
void launch(const float* stats, float* gain, long long rows, int bins, int C,
            cudaStream_t stream) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((rows + threads - 1) / threads);
  split_gain_kernel<CMAX><<<blocks, threads, 0, stream>>>(stats, gain, rows,
                                                          bins, C);
}

}  // namespace

extern "C" int split_gain_launch(const void* stats, void* gain, long long rows,
                                 int bins, int C, void* stream) {
  const float* s = (const float*)stats;
  float* g = (float*)gain;
  cudaStream_t st = (cudaStream_t)stream;
  if (C <= 2) launch<2>(s, g, rows, bins, C, st);
  else if (C <= 4) launch<4>(s, g, rows, bins, C, st);
  else if (C <= 8) launch<8>(s, g, rows, bins, C, st);
  else if (C <= 16) launch<16>(s, g, rows, bins, C, st);
  else if (C <= 32) launch<32>(s, g, rows, bins, C, st);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
