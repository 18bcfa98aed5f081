// tree_route: sort one shared [B, m] micro-batch to a leaf in each of M trees.
//
// Replaces src/repro/kernels/tree_route/kernel.py::tree_route_pallas (the
// `_kernel` body), which made every depth step a [B, N] x [N, 4] one-hot
// matmul on the TPU's matrix unit because a pointer chase is slow there.
//
// On the H100 the pointer chase is cheap: one thread per (member, instance)
// walks its tree, and a block first copies its member's four node tables
// (split_attr, split_bin, left, right; N x 16 bytes) into shared memory, so
// each depth step is one shared-memory read of the node and one
// device-memory read of xbin[b, attr].  The work is a few bytes per
// instance and depth step, so at the main path's B = 512 the kernel is bound
// by its launch, not by bytes or operations.  A thread stops as soon as its
// node is a leaf (attr < 0): the reference keeps the node fixed from then
// on, so the leaf ids are the same.  Integer-only, so bit-identical to the
// plain version.

#include <cuda_runtime.h>

namespace {

__global__ void tree_route_kernel(const int* __restrict__ split_attr,
                                  const int* __restrict__ split_bin,
                                  const int* __restrict__ children,
                                  const int* __restrict__ xbin,
                                  int* __restrict__ leaf,
                                  int N, int B, int m, int max_depth) {
  extern __shared__ int table[];          // [N][4]: attr, bin, left, right
  const int member = blockIdx.y;
  const int* sa = split_attr + (size_t)member * N;
  const int* sb = split_bin + (size_t)member * N;
  const int* ch = children + (size_t)member * N * 2;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    table[4 * n + 0] = sa[n];
    table[4 * n + 1] = sb[n];
    table[4 * n + 2] = ch[2 * n + 0];
    table[4 * n + 3] = ch[2 * n + 1];
  }
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int* row = xbin + (size_t)b * m;
  int node = 0;
  for (int d = 0; d < max_depth; ++d) {
    const int attr = table[4 * node];
    if (attr < 0) break;
    const int v = row[attr];
    node = v > table[4 * node + 1] ? table[4 * node + 3] : table[4 * node + 2];
  }
  leaf[(size_t)member * B + b] = node;
}

}  // namespace

extern "C" int tree_route_launch(const void* split_attr, const void* split_bin,
                                 const void* children, const void* xbin,
                                 void* leaf, int M, int N, int B, int m,
                                 int max_depth, void* stream) {
  const int threads = 256;
  const size_t smem = (size_t)N * 4 * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        tree_route_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((B + threads - 1) / threads, M);
  tree_route_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const int*)split_attr, (const int*)split_bin, (const int*)children,
      (const int*)xbin, (int*)leaf, N, B, m, max_depth);
  return (int)cudaGetLastError();
}
