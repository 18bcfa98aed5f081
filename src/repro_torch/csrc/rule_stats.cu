// rule_stats: accumulate the AMRules weighted-moment statistics of one
// micro-batch, in place on stats [R, m, bins, C] f32,
//
//   stats[r, j, b, c] += sum_i 1[seg_i = r] 1[xbin_ij = b] mom[i, c],
//
// where instances with seg_i outside [0, R) and bins outside [0, bins) are
// dropped (AMRules passes seg = R, one past the last row, to discard).
//
// Replaces src/repro/kernels/rule_stats/kernel.py::rule_stats_pallas (the
// `_kernel` body), which wrote the scatter as a one-hot [R, B] x
// [B, ja*bins*C] matmul on the TPU's matrix unit.  That sums each cell in
// the matrix unit's order.  Here the sums are order-exact instead: every
// cell starts from its old value and adds its instances' moments in
// ascending instance order, one __fadd_rn at a time.  That is the order of
// XLA's CPU scatter (the JAX package's default off the TPU) and of the
// plain version in kernels/rule_stats/ref.py, so the kernel, the plain
// version and the JAX package agree bit for bit, and two runs of the same
// stream learn the same rules.  No atomics: a float atomicAdd sums in
// whatever order the threads arrive.
//
// Design: one thread per (attribute j, row r, bin b) cell, all C moments of
// the cell in registers; blockIdx.y is the attribute, blockIdx.x a group of
// CELLS cells of it.  The block stages the instances in tiles of TILE in
// shared memory: the cell key seg_i * bins + xbin_ij (-1 when dropped) and
// the moments.  Every thread then walks the tile in order and adds the
// moments where the key is its own; all threads of a warp read the same
// key, a shared-memory broadcast.
//
// What bounds it: the function needs each input read once and stats read
// and written once, 0.59 MB at the AMRules main path's [65, 40, 8, 3] and
// B = 512, about 0.18 us at 3.35 TB/s, and only B * m * C float adds.  The
// kernel does far more than that: every thread walks all B keys, one
// dependent shared-memory read after another, so R * m * bins * B compares
// (10.6 M here) on about 7 warps per SM.  It is bound by that serial walk
// and by its launch, some microseconds; making it fast (sorting the
// instances by cell first, say) is later work.  Being exact comes first.

#include <cuda_runtime.h>

namespace {

constexpr int CELLS = 256;       // threads per block: one cell each
constexpr int TILE = 1024;       // instances staged per pass
constexpr int MAX_MOMENTS = 8;   // the largest C the kernel takes

__global__ void __launch_bounds__(CELLS)
rule_stats_kernel(float* __restrict__ stats, const int* __restrict__ seg,
                  const int* __restrict__ xbin, const float* __restrict__ mom,
                  int R, int m, int bins, int C, int B) {
  __shared__ int key[TILE];
  __shared__ float val[TILE * MAX_MOMENTS];

  const int j = blockIdx.y;
  const int cell = blockIdx.x * CELLS + threadIdx.x;    // r * bins + b
  const bool mine = cell < R * bins;
  float* out = nullptr;
  float acc[MAX_MOMENTS];
  if (mine) {
    const int r = cell / bins, b = cell - r * bins;
    out = stats + (((size_t)r * m + j) * bins + b) * C;
#pragma unroll
    for (int c = 0; c < MAX_MOMENTS; ++c) acc[c] = c < C ? out[c] : 0.0f;
  }
  for (int base = 0; base < B; base += TILE) {
    const int n = min(TILE, B - base);
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      const int i = base + t;
      const int s = seg[i];
      const int xb = xbin[(size_t)i * m + j];
      key[t] = (s >= 0 && s < R && xb >= 0 && xb < bins) ? s * bins + xb : -1;
    }
    for (int t = threadIdx.x; t < n * C; t += blockDim.x)
      val[t] = mom[(size_t)base * C + t];
    __syncthreads();
    if (mine) {
      for (int t = 0; t < n; ++t) {
        if (key[t] != cell) continue;
#pragma unroll
        for (int c = 0; c < MAX_MOMENTS; ++c)
          if (c < C) acc[c] = __fadd_rn(acc[c], val[t * C + c]);
      }
    }
    __syncthreads();
  }
  if (mine) {
#pragma unroll
    for (int c = 0; c < MAX_MOMENTS; ++c)
      if (c < C) out[c] = acc[c];
  }
}

}  // namespace

extern "C" int rule_stats_launch(void* stats, const void* seg,
                                 const void* xbin, const void* mom, int R,
                                 int m, int bins, int C, int B, void* stream) {
  const dim3 grid((unsigned)((R * bins + CELLS - 1) / CELLS), (unsigned)m);
  rule_stats_kernel<<<grid, CELLS, 0, (cudaStream_t)stream>>>(
      (float*)stats, (const int*)seg, (const int*)xbin, (const float*)mom, R,
      m, bins, C, B);
  return (int)cudaGetLastError();
}
