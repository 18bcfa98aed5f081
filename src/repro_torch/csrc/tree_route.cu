// tree_route: sort one shared [B, m] micro-batch to a leaf in each of M trees.
// Two more forms serve a fleet of M = F learners, each with its own batch:
// tree_route_batched (one [B, m] batch per member, xbin [M, B, m]) and
// tree_route_rows (a member per row, xbin [R, m] and member [R]); see
// the end of this file.
//
// Replaces src/repro/kernels/tree_route/kernel.py::tree_route_pallas
// (kernel.py:61, its pallas_call at :68), which made every depth step a
// [B, N] x [N, 4] one-hot matmul on the TPU's matrix unit because a
// pointer chase is slow there.
//
// What bounds it on the H100: a few bytes per instance and depth step,
// 0.0000046 ms of bytes at the VHT main path's B = 512, so neither bytes
// nor operations.  A first kernel with one thread per (member, instance)
// walking its tree made every depth step a device-memory read of
// xbin[b, attr] that waited on the one before: a chain of up to max_depth
// round trips to L2 or HBM, after the launch and the table's staging, in
// only 2 blocks of 256 threads at M = 1, B = 512.
//
// Design: no device-memory read waits on another.
//  1. A warp takes one (member, instance); a block of 8 warps takes 8
//     instances of one member (grid: B / 8 by M; 64 blocks at the main
//     path's shape).
//  2. The block stages its member's children in shared memory, packed as
//     two 16-bit ids a node, and numbers the member's inner nodes
//     (split_attr >= 0) 0 .. K-1, with their split attribute and bin in
//     that order: K <= (N - 1) / 2 in a tree, 25 on the main path's
//     learned tree of 51 nodes.
//  3. Each warp's lanes load xbin[b, attr_k] for every inner node k at
//     once (up to ROUNDS loads a lane in flight) and keep one decision bit
//     per inner node, "go right", from a warp vote.
//  4. The walk from the root then runs in shared memory alone, a few
//     reads a level, with the same rules as before: it stops at a leaf
//     (split_attr < 0), and after max_depth steps.
// So the kernel's reads of device memory are two rounds, the table and
// then the gather, whatever the depth.  A warp reads xbin for every inner
// node, reached or not, K loads where the walk needs its depth: a few KB
// more from L2 per launch at the main path's shape.  A read past the end
// of xbin (a split attribute >= m, which no valid tree has) gives 0.
// Integer-only, so bit-identical to the plain version.  N is limited by
// shared memory (about 15 000 nodes) and by the 16-bit child ids.
//
// Measured with tools/kernel_ab.py against the first kernel (NVIDIA H100
// 80GB HBM3, 700 W; device ms): 0.0033 (0.0039) on a 51-node tree, 0.0036
// (0.0042) on a random full tree of 255 nodes, 0.0049 (0.0056) on five
// such trees; a one-node tree at B = 1, what any launch of this shape
// pays, takes 0.0023 (0.0022).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int WARPS = 8;                 // instances per block
constexpr int THREADS = 32 * WARPS;
constexpr int ROUNDS = 4;                // xbin loads a lane keeps in flight

// Shared memory: children [N] (left | right << 16), the inner nodes'
// attribute and bin [N] each, each warp's decision bits [WARPS][words],
// and each node's inner number [N] (16-bit, -1 at a leaf).
size_t smem_bytes(int N) {
  const size_t words = (N + 31) / 32;
  return 12 * (size_t)N + 4 * WARPS * words + 2 * (size_t)N;
}

__global__ void __launch_bounds__(THREADS)
tree_route_kernel(const int* __restrict__ split_attr,
                  const int* __restrict__ split_bin,
                  const int* __restrict__ children,
                  const int* __restrict__ xbin, int* __restrict__ leaf,
                  int N, int B, int m, int max_depth, size_t xstride) {
  extern __shared__ unsigned lr[];
  __shared__ int n_inner;
  const int words = (N + 31) >> 5;
  int* iattr = reinterpret_cast<int*>(lr + N);
  int* ibin = iattr + N;
  unsigned* dec = reinterpret_cast<unsigned*>(ibin + N);
  short* inner_of = reinterpret_cast<short*>(dec + WARPS * words);
  const int member = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* sa = split_attr + (size_t)member * N;
  const int* sb = split_bin + (size_t)member * N;
  const int* ch = children + (size_t)member * N * 2;

  // 2. the member's table; inner nodes numbered by a vote per 32 nodes
  if (threadIdx.x == 0) n_inner = 0;
  __syncthreads();
  for (int n0 = warp * 32; n0 < N; n0 += THREADS) {
    const int n = n0 + lane;
    int a = -1, bn = 0, l = 0, r = 0;
    if (n < N) {
      a = sa[n];
      bn = sb[n];
      l = ch[2 * n];
      r = ch[2 * n + 1];
    }
    const unsigned inner = __ballot_sync(0xffffffffu, a >= 0);
    int base = 0;
    if (lane == 0 && inner) base = atomicAdd(&n_inner, __popc(inner));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (n < N) {
      lr[n] = ((unsigned)l & 0xffffu) | ((unsigned)r << 16);
      int k = -1;
      if (a >= 0) {
        k = base + __popc(inner & ((1u << lane) - 1u));
        iattr[k] = a;
        ibin[k] = bn;
      }
      inner_of[n] = (short)k;
    }
  }
  __syncthreads();

  const int b = blockIdx.x * WARPS + warp;
  if (b >= B) return;
  // 3. one decision bit per inner node, all loads of a batch in flight;
  // the member's batch starts xstride ints into xbin (0: one shared batch)
  const int K = n_inner;
  const size_t first = (size_t)member * xstride;
  const size_t row = first + (size_t)b * m, end = first + (size_t)B * m;
  unsigned* d = dec + warp * words;
  for (int k0 = 0; k0 < K; k0 += 32 * ROUNDS) {
    int v[ROUNDS];
#pragma unroll
    for (int u = 0; u < ROUNDS; ++u) {
      const int k = k0 + 32 * u + lane;
      const size_t at = k < K ? row + iattr[k] : end;
      v[u] = at < end ? xbin[at] : 0;
    }
#pragma unroll
    for (int u = 0; u < ROUNDS; ++u) {
      const int k = k0 + 32 * u + lane;
      const unsigned right =
          __ballot_sync(0xffffffffu, k < K && v[u] > ibin[k]);
      if (lane == 0 && k0 + 32 * u < K) d[(k0 >> 5) + u] = right;
    }
  }
  __syncwarp();
  // 4. the walk, in shared memory
  int node = 0;
  for (int depth = 0; depth < max_depth; ++depth) {
    const int k = inner_of[node];
    if (k < 0) break;
    const unsigned c = lr[node];
    node = (d[k >> 5] >> (k & 31)) & 1u ? (int)(c >> 16) : (int)(c & 0xffffu);
  }
  if (lane == 0) leaf[(size_t)member * B + b] = node;
}

}  // namespace

namespace {

int launch(const void* split_attr, const void* split_bin, const void* children,
           const void* xbin, void* leaf, int M, int N, int B, int m,
           int max_depth, size_t xstride, void* stream) {
  if (N <= 0 || N > 0x8000) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(N);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tree_route_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((B + WARPS - 1) / WARPS, M);
  tree_route_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)split_attr, (const int*)split_bin, (const int*)children,
      (const int*)xbin, (int*)leaf, N, B, m, max_depth, xstride);
  return (int)cudaGetLastError();
}

// The form for rows of mixed members (a served batch of a fleet): a
// thread per row walks its member's tree from device memory, split
// attribute, bin, the row's value and the child id at each level, a chain
// of dependent reads max_depth long at most (5 levels on a fleet's
// 31-node trees).  A block cannot stage one table for rows of different
// members, and at the server's batch of 16 rows the tables' reads, not
// the walk, are the work; the tables of a fleet (F x N nodes) stay in L2.
// A row whose member is outside [0, M) gets -1; a split attribute >= m,
// which no valid tree has, reads 0, as the other forms do.
constexpr int ROW_THREADS = 128;

__global__ void __launch_bounds__(ROW_THREADS)
tree_route_rows_kernel(const int* __restrict__ split_attr,
                       const int* __restrict__ split_bin,
                       const int* __restrict__ children,
                       const int* __restrict__ xbin,
                       const int* __restrict__ member, int* __restrict__ leaf,
                       int M, int N, int R, int m, int max_depth) {
  const int r = blockIdx.x * ROW_THREADS + threadIdx.x;
  if (r >= R) return;
  const int t = member[r];
  if (t < 0 || t >= M) {
    leaf[r] = -1;
    return;
  }
  const size_t base = (size_t)t * N;
  const int* x = xbin + (size_t)r * m;
  int node = 0;
  for (int depth = 0; depth < max_depth; ++depth) {
    const int a = split_attr[base + node];
    if (a < 0) break;
    const int v = a < m ? x[a] : 0;
    node = children[2 * (base + node) + (v > split_bin[base + node])];
  }
  leaf[r] = node;
}

}  // namespace

// One shared batch: xbin [B, m] -> leaf [M, B].
extern "C" int tree_route_launch(const void* split_attr, const void* split_bin,
                                 const void* children, const void* xbin,
                                 void* leaf, int M, int N, int B, int m,
                                 int max_depth, void* stream) {
  return launch(split_attr, split_bin, children, xbin, leaf, M, N, B, m,
                max_depth, 0, stream);
}

// One batch per member (a fleet's step, M = F): xbin [M, B, m] -> leaf
// [M, B].  The same kernel; a block reads its own member's rows.
extern "C" int tree_route_batched_launch(const void* split_attr,
                                         const void* split_bin,
                                         const void* children,
                                         const void* xbin, void* leaf, int M,
                                         int N, int B, int m, int max_depth,
                                         void* stream) {
  return launch(split_attr, split_bin, children, xbin, leaf, M, N, B, m,
                max_depth, (size_t)B * m, stream);
}

// A member per row: xbin [R, m], member [R] -> leaf [R].
extern "C" int tree_route_rows_launch(const void* split_attr,
                                      const void* split_bin,
                                      const void* children, const void* xbin,
                                      const void* member, void* leaf, int M,
                                      int N, int R, int m, int max_depth,
                                      void* stream) {
  if (N <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((R + ROW_THREADS - 1) / ROW_THREADS);
  tree_route_rows_kernel<<<grid, ROW_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)split_attr, (const int*)split_bin, (const int*)children,
      (const int*)xbin, (const int*)member, (int*)leaf, M, N, R, m,
      max_depth);
  return (int)cudaGetLastError();
}

// The dynamic shared memory bytes a block takes for trees of N nodes.
extern "C" int tree_route_smem(int N) { return (int)smem_bytes(N); }
