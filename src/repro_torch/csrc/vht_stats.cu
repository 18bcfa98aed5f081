// vht_stats: accumulate the VHT sufficient statistics of one micro-batch,
//
//   stats[leaf_i, j, xbin_ij, y_i] += w_i     for every instance i, attribute j,
//
// in place on stats [N, m, bins, C] f32.
//
// Replaces src/repro/kernels/vht_stats/kernel.py::stats_update_pallas (the
// `_kernel` body), which wrote the scatter as one-hot matmuls on the TPU's
// matrix unit and so read and rewrote the whole statistics tensor
// (N * m * bins * C floats) on every call.
//
// On the H100 a scatter is native: one thread per (instance, attribute)
// does one atomicAdd, and instances of weight 0 (shed by the wok variant,
// or not replayed by wk(z)) do nothing.  The kernel touches only the <= B*m
// cells it hits, so it is bound by the bytes of xbin it reads and by the
// atomics' read-modify-write of the hit cells (one 32-byte sector each),
// not by the size of the tensor.  Consecutive threads take consecutive
// attributes of one instance, so the xbin reads are coalesced.  Indices out
// of range are skipped, as the one-hot formulation drops them.  Float
// atomics sum in no fixed order: for integer weights (the VHT path's 0/1)
// every partial sum below 2^24 is exact, so the result is bit-identical to
// the plain version; for fractional weights it agrees to rounding.

#include <cuda_runtime.h>

namespace {

__global__ void vht_stats_kernel(float* __restrict__ stats,
                                 const int* __restrict__ leaf,
                                 const int* __restrict__ xbin,
                                 const int* __restrict__ y,
                                 const float* __restrict__ w,
                                 int N, int B, int m, int bins, int C) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)B * m) return;
  const int i = (int)(t / m);
  const int j = (int)(t - (long long)i * m);
  const float wi = w[i];
  if (wi == 0.0f) return;
  const int n = leaf[i];
  const int b = xbin[t];
  const int c = y[i];
  if (n < 0 || n >= N || b < 0 || b >= bins || c < 0 || c >= C) return;
  atomicAdd(stats + (((size_t)n * m + j) * bins + b) * C + c, wi);
}

}  // namespace

extern "C" int vht_stats_launch(void* stats, const void* leaf, const void* xbin,
                                const void* y, const void* w, int N, int B,
                                int m, int bins, int C, void* stream) {
  const int threads = 256;
  const long long work = (long long)B * m;
  const unsigned blocks = (unsigned)((work + threads - 1) / threads);
  vht_stats_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (float*)stats, (const int*)leaf, (const int*)xbin, (const int*)y,
      (const float*)w, N, B, m, bins, C);
  return (int)cudaGetLastError();
}
