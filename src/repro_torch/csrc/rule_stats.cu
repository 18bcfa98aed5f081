// rule_stats: accumulate the AMRules weighted-moment statistics of one
// micro-batch, in place on stats [R, m, bins, C] f32,
//
//   stats[r, j, b, c] += sum_i 1[seg_i = r] 1[xbin_ij = b] mom[i, c],
//
// where instances with seg_i outside [0, R) and bins outside [0, bins) are
// dropped (AMRules passes seg = R, one past the last row, to discard).  The
// same kernel sums AMRules' float reductions (the wrapper's segment_sum:
// m = 1, bins = 1, the rule or the XLA window as the row) and CluStream's
// CF scatter (m = 1, bins = 1, K + 1 segments, K the discard; the 2d
// columns of x | x^2 in one launch, the 3 of 1 | t | t^2 in another).  Up
// to 8 columns (C) a thread keeps its cell's C sums in registers; 9 to
// MAX_WIDE = 4096 columns take the wide form (rule_stats_wide_kernel,
// below), a lane per column of a block's slab of 32.  Both add in
// instance order.  A fleet of F CluStreams takes the tenant form
// (segment_sum_tenant_kernel, at the end): F independent segment sums in
// one launch, each tenant's rows summed in its own segments, in instance
// order.
//
// Replaces src/repro/kernels/rule_stats/kernel.py::rule_stats_pallas
// (kernel.py:57, its pallas_call at :71), which wrote the scatter as a
// one-hot [R, B] x [B, ja*bins*C] matmul on the TPU's matrix unit.  That
// sums each cell in the matrix unit's order.  Here the sums are order-exact
// instead: every cell starts from its old value and adds its instances'
// moments in ascending instance order, one __fadd_rn at a time.  That is
// the order of XLA's CPU scatter (the JAX package's default off the TPU)
// and of the plain version in kernels/rule_stats/ref.py, so the kernel, the
// plain version and the JAX package agree bit for bit, and two runs of the
// same stream learn the same rules.  No float atomics (they sum in whatever
// order the threads arrive) and no matrix product.
//
// What bounds it: the function reads each input once and reads and writes
// stats once, 0.59 MB at the AMRules main path's [65, 40, 8, 3] and
// B = 512, about 0.18 us at 3.35 TB/s, and does B * m * C float adds; the
// reductions move a few KB.  Neither is near: the kernel is bound by its
// launch and by the latency of its dependent steps (two trips to device
// memory, the ranking's warp steps, four barriers), and by the longest
// chain of adds, the fullest cell's instances in order, which no design
// can cut.
//
// Design: a block takes one attribute j and a range of up to 256 of its
// (row, bin) cells, one per thread (blockIdx.y: j, blockIdx.x: the range;
// 120 blocks at the main path's shape, one for each reduction).  For each
// tile of TILE instances it
//  1. stages seg, the attribute's xbin column and mom in shared memory by
//     cp.async (16-byte copies of seg and mom, 4-byte copies of the
//     column);
//  2. gives each instance its local cell, or none, and its rank among the
//     instances of that cell: each warp takes a contiguous run of
//     instances 32 at a time, in order, and __match_any_sync ranks the
//     lanes of one key inside the step, after the warp's earlier steps;
//  3. scans the cells' counts and prefixes each cell's per-warp counts, so
//     that a stable counting sort puts each cell's instances in one list,
//     in instance order, each warp placing its own run;
//  4. lets each cell's thread walk its own list, its C sums in registers,
//     reading eight list entries ahead of their adds.
// Lists carry across tiles in order, so B is not limited.  Work per launch
// is about B * m instances ranked plus the cells, not cells x B compares.
// A batch of at most SMALL instances (the batch sum's last level, 16
// window sums) skips all that: each cell's thread reads every instance
// from device memory in order, with no staging or barrier.
//
// Blocks of 2 or 4 attributes, whose xbin rows come in one coalesced 8- or
// 16-byte copy per instance, were measured slower (tools/kernel_ab.py on
// an NVIDIA H100 80GB HBM3 at 700 W: 0.0057 and 0.0068 ms against 0.0053
// ms at the main path's shape): each block then ranks 2 or 4 times the
// instances in as many warp steps, while the strided column, 80 KB for
// the whole batch, comes from L2 either way.
//
// Measured the same way after that (device ms; first version in
// brackets): moment statistics 0.0049 (0.0206), per-rule sums 0.0048
// (0.0331), batch sum levels 0.0047 (0.0505) and 0.0032 (0.0038).

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int THREADS = 256;            // threads per block
constexpr int WARPS = THREADS / 32;
constexpr int CELLS = THREADS;          // cells per block, one per thread
constexpr int TILE = 512;               // instances staged per pass
constexpr int KEY_BITS = 8;             // a local cell is < CELLS = 2^8
constexpr int SMALL = 64;               // a batch every cell reads whole
constexpr int WIDE_COLS = 32;           // columns a block of the wide form takes
constexpr int MAX_WIDE = 4096;          // columns the wide form takes

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

// n 4-byte words from src to dst (16-byte aligned): 16-byte copies when
// src is aligned too, the tail word by word
__device__ __forceinline__ void stage_words(void* dst, const void* src,
                                            int n) {
  const uint32_t* s = static_cast<const uint32_t*>(src);
  uint32_t* d = static_cast<uint32_t*>(dst);
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(s) & 15) == 0) {
    head = n & ~3;
    for (int k = 4 * threadIdx.x; k < head; k += 4 * THREADS)
      cp_async16(d + k, s + k);
  }
  for (int k = head + threadIdx.x; k < n; k += THREADS) cp_async4(d + k, s + k);
}

// acc += the moments of the listed instances, in list order; eight list
// entries are read ahead of their adds
template <int C>
__device__ __forceinline__ void walk(float (&acc)[C], const int* list, int n,
                                     const float* mom) {
  int q = 0;
  for (; q + 8 <= n; q += 8) {
    float v[8][C];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float* src = mom + list[q + k] * C;
#pragma unroll
      for (int c = 0; c < C; ++c) v[k][c] = src[c];
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = __fadd_rn(acc[c], v[k][c]);
    }
  }
  for (; q < n; ++q) {
    const float* src = mom + list[q] * C;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = __fadd_rn(acc[c], src[c]);
  }
}

// steps 2 and 3 for a staged tile of n instances (s_seg; s_ent holding
// their xbin column): the lists of the block's cells [c0, c0 + cr), each
// in instance order, one after the other in s_sorted.  s_wcnt must be 0.
// Returns the list of cell c0 + threadIdx.x as (start, count).
__device__ __forceinline__ int2 sort_tile(int n, int R, int bins, int c0,
                                          int cr, const int* s_seg,
                                          int* s_ent, int* s_sorted,
                                          int (*s_wcnt)[CELLS], int* s_wsum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // 2. each instance's local cell and its rank in it, warp by warp in
  // instance order; -1 when it is dropped or another block's
  const int per_warp = (n + 32 * WARPS - 1) / (32 * WARPS) * 32;
  const int i_lo = warp * per_warp, i_hi = min(n, i_lo + per_warp);
  for (int i0 = i_lo; i0 < i_hi; i0 += 32) {
    const int i = i0 + lane;
    int key = -1;
    if (i < i_hi) {
      const int s = s_seg[i], xb = s_ent[i];
      if (s >= 0 && s < R && xb >= 0 && xb < bins) {
        const int cell = s * bins + xb - c0;
        if (cell >= 0 && cell < cr) key = cell;
      }
    }
    const unsigned same = __match_any_sync(0xffffffffu, key);
    const unsigned before = same & ((1u << lane) - 1u);
    int packed = -1;
    if (key >= 0)
      packed = ((s_wcnt[warp][key] + __popc(before)) << KEY_BITS) | key;
    __syncwarp();
    if (key >= 0 && before == 0) s_wcnt[warp][key] += __popc(same);
    if (i < i_hi) s_ent[i] = packed;
    __syncwarp();
  }
  __syncthreads();

  // 3. each cell's count, and its list's start: the cells' counts
  // scanned; then each warp's place in each list, its start plus the
  // earlier warps' counts of the cell
  int count = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) count += s_wcnt[w][tid];
  int incl = count;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) s_wsum[warp] = incl;
  __syncthreads();
  int start = incl - count;
  for (int w = 0; w < warp; ++w) start += s_wsum[w];
  int place = start;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int v = s_wcnt[w][tid];
    s_wcnt[w][tid] = place;
    place += v;
  }
  __syncthreads();
  // each warp puts its own run of instances in place
  for (int i = i_lo + lane; i < i_hi; i += 32) {
    const int p = s_ent[i];
    if (p >= 0)
      s_sorted[s_wcnt[warp][p & ((1 << KEY_BITS) - 1)] + (p >> KEY_BITS)] =
          i;
  }
  __syncthreads();
  return make_int2(start, count);
}

// blockIdx.y: the attribute j; blockIdx.x: its cells [c0, c0 + cr)
template <int C>
__global__ void __launch_bounds__(THREADS)
rule_stats_kernel(float* __restrict__ stats, const int* __restrict__ seg,
                  const int* __restrict__ xbin, const float* __restrict__ mom,
                  int R, int m, int bins, int B, int cr) {
  __shared__ __align__(16) int s_seg[TILE];
  __shared__ __align__(16) int s_ent[TILE];     // xbin, then (rank, cell)
  __shared__ __align__(16) float s_mom[TILE * C];
  __shared__ int s_sorted[TILE];                // tile instances, by cell
  __shared__ int s_wcnt[WARPS][CELLS];          // per warp and cell
  __shared__ int s_wsum[WARPS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = blockIdx.y;
  const int c0 = blockIdx.x * cr;               // first (row, bin) cell
  const int* xj = xbin + j;                     // column j, stride m

  // this thread's cell, c0 + tid, and its old sums
  const int cell_t = c0 + tid;
  const bool mine = tid < cr && cell_t < R * bins;
  float acc[C];
  float* out = nullptr;
  if (mine) {
    const int r = cell_t / bins, b = cell_t - r * bins;
    out = stats + (((size_t)r * m + j) * bins + b) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = out[c];
  }

  if (B <= SMALL) {
    // a batch this small: each cell's thread reads all the instances from
    // device memory, in order; no staging, sort or barrier pays for itself
    // here.  The loads do not wait on the adds, so they are all in flight
    // at once.
    if (mine) {
      for (int i = 0; i < B; ++i) {
        const int s = seg[i], xb = xj[(size_t)i * m];
        const bool hit = s >= 0 && s < R && xb >= 0 && xb < bins &&
                         s * bins + xb == cell_t;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float v = mom[(size_t)i * C + c];
          if (hit) acc[c] = __fadd_rn(acc[c], v);
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) out[c] = acc[c];
    }
    return;
  }

  for (int base = 0; base < B; base += TILE) {
    const int n = min(TILE, B - base);
    // 1. stage the tile
    stage_words(s_seg, seg + base, n);
    stage_words(s_mom, mom + (size_t)base * C, n * C);
    for (int i = tid; i < n; i += THREADS)
      cp_async4(&s_ent[i], xj + (size_t)(base + i) * m);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    for (int k = lane; k < CELLS; k += 32) s_wcnt[warp][k] = 0;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    const int2 list = sort_tile(n, R, bins, c0, cr, s_seg, s_ent, s_sorted,
                                s_wcnt, s_wsum);

    // 4. each cell's thread adds its own list, in instance order
    if (mine) walk<C>(acc, s_sorted + list.x, list.y, s_mom);
    if (base + TILE < B) __syncthreads();   // the buffers are staged again
  }
  if (mine) {
#pragma unroll
    for (int c = 0; c < C; ++c) out[c] = acc[c];
  }
}

// The wide form, for C > 8 columns (CluStream's CF scatter: x and x^2 of
// [B, d], 2d columns; up to MAX_WIDE).  A block takes one attribute, a
// range of at most WARPS * WIDE_WARP_CELLS = 16 cells and a slab of
// WIDE_COLS = 32 of the columns (grid: ranges x m x column slabs, 136
// blocks at d128-K256), a lane per column: so a warp adds one cell's 32
// sums at a time, each starting from its old value and adding its cell's
// instances in instance order, one __fadd_rn at a time, as the narrow form
// does; it gives the same bits.
//
// What bounds it: CluStream's CF scatter at d128-K256 ([257, 1, 1, 256],
// B = 512) reads 0.52 MB of rows and reads and writes only the sums of
// the segments its rows hit (13 of 257 on a blob stream's batch, 0.03
// MB), 0.17 us at 3.35 TB/s; its adds are nothing.  What the function itself
// imposes is the busiest cell's chain of dependent adds (a blob stream
// puts some hundred rows in one; all 512 in the worst case), a few cycles
// an add when the values wait in shared memory.
//
// Design, per tile of TILE instances:
//  1. cp.async stages seg and the xbin column, and on the first tile the
//     block's old sums, [cells][32] floats;
//  2. the tile is sorted by cell, stably (the narrow form's sort_tile);
//     then cp.async gathers the values of the block's own instances, 32
//     columns a row, in that order, so that each cell's rows lie one after
//     another in shared memory (16-byte copies where C is a multiple of 4,
//     4-byte ones else);
//  3. warp w walks the cells w, w + 8: lane c adds column c of the cell's
//     rows to the cell's sum in shared memory, in order, reading the next
//     16 rows while it adds the current 16, so the chain waits on the
//     adds.
// The sums stay in shared memory across tiles, so B is not limited; after
// the last tile each warp writes its hit cells' 32 sums back to stats in
// one coalesced write, and a cell no instance hit is never written.  Each
// block reads only its own instances' values, so small ranges, many
// blocks and short walks cost no more reads of the batch; every block
// sorts the tile, which the blocks do in parallel.  A warp walks its two
// cells in their order: a longest-first order would change no warp's
// total.
//
// Measured (tools/kernel_ab.py, NVIDIA H100 80GB HBM3 at 700 W; device ms
// at d128-K256, blob-spread and all rows in one segment): this design
// 0.0050 and 0.0066 (chip_smoke.py, on the main path's last batch: 0.0054
// against index_add_'s 0.0040, in its atomics' order); the first
// design, each row's value read from L2 in the chain, eight reads
// in flight, in 16 blocks whose warps walked their cells one after
// another, 0.0142 and 0.0447; the whole tile's 32 columns staged in every
// block while it sorts and each cell's rows read through the sorted list,
// 72 blocks of 29 cells, 0.0068 and 0.0080 (136 blocks: 0.0059, 0.0081):
// issuing the 64 KB slab held each block's ids for about 2500 cycles, and
// the chain took about 14 cycles a row.  Of this design's blocks (blob,
// clock64 in an instrumented copy) the ids take some 1650 cycles, the
// sort 1900, the gather 800 and the walks 1900; a warp with no list to
// walk still takes some 850.  One cell a warp (264 blocks) took 0.0049 and
// 0.0071, four (72 blocks) 0.0056 and 0.0067.
//
// A batch of at most SMALL instances keeps its own path: a thread per
// (cell, column) pair reads every instance from device memory in order,
// with no staging, sort or barrier.
constexpr int WIDE_AHEAD = 16;          // rows read ahead of their adds
constexpr int WIDE_WARP_CELLS = 2;      // cells a warp walks, at most

// the dynamic shared memory of the wide form's staged path: the tile's
// slab of values and the block's sums, [TILE + cr][WIDE_COLS] floats
constexpr size_t wide_smem(int cr) {
  return (size_t)(TILE + cr) * WIDE_COLS * sizeof(float);
}

// rows [0, rows) of WIDE_COLS-column slabs, row(i) the first of ncols
// floats of row i in device memory, into dst [rows][WIDE_COLS] by
// cp.async: eight threads a row in 16-byte copies when vec (ncols and
// every row(i) a multiple of 4 floats, 16-byte aligned), else a warp a
// row in 4-byte copies
template <class Row>
__device__ __forceinline__ void stage_slab(float* dst, int rows, int ncols,
                                           bool vec, Row row) {
  if (vec) {
    const int p = 4 * (threadIdx.x & 7);
    if (p < ncols)
      for (int i = threadIdx.x >> 3; i < rows; i += THREADS / 8)
        cp_async16(dst + i * WIDE_COLS + p, row(i) + p);
  } else {
    const int c = threadIdx.x & 31;
    if (c < ncols)
      for (int i = threadIdx.x >> 5; i < rows; i += WARPS)
        cp_async4(dst + i * WIDE_COLS + c, row(i) + c);
  }
}

// acc plus v[q * WIDE_COLS] for q in [0, n), in order: the values of the
// next WIDE_AHEAD rows are read while the current ones are added, and the
// last fewer than WIDE_AHEAD all at once
__device__ __forceinline__ float walk_rows(float acc, const float* v, int n) {
  constexpr int A = WIDE_AHEAD;
  int q = 0;
  if (n >= A) {
    float cur[A];                       // the rows [q, q + A)
#pragma unroll
    for (int k = 0; k < A; ++k) cur[k] = v[k * WIDE_COLS];
    for (; q + 2 * A <= n; q += A) {
      float nxt[A];
#pragma unroll
      for (int k = 0; k < A; ++k) nxt[k] = v[(q + A + k) * WIDE_COLS];
#pragma unroll
      for (int k = 0; k < A; ++k) acc = __fadd_rn(acc, cur[k]);
#pragma unroll
      for (int k = 0; k < A; ++k) cur[k] = nxt[k];
    }
#pragma unroll
    for (int k = 0; k < A; ++k) acc = __fadd_rn(acc, cur[k]);
    q += A;
  }
  float tail[A];
#pragma unroll
  for (int k = 0; k < A; ++k)
    if (q + k < n) tail[k] = v[(q + k) * WIDE_COLS];
#pragma unroll
  for (int k = 0; k < A; ++k)
    if (q + k < n) acc = __fadd_rn(acc, tail[k]);
  return acc;
}

// blockIdx.y: the attribute j; blockIdx.x: its cells [c0, c0 + cr);
// blockIdx.z: the columns [col0, col0 + WIDE_COLS)
__global__ void __launch_bounds__(THREADS)
rule_stats_wide_kernel(float* __restrict__ stats, const int* __restrict__ seg,
                       const int* __restrict__ xbin,
                       const float* __restrict__ mom, int R, int m, int bins,
                       int C, int B, int cr) {
  extern __shared__ __align__(16) float s_dyn[];  // wide_smem(cr) bytes
  __shared__ __align__(16) int s_seg[TILE];
  __shared__ __align__(16) int s_ent[TILE];     // xbin, then (rank, cell)
  __shared__ int s_sorted[TILE];                // tile instances, by cell
  __shared__ int s_wcnt[WARPS][CELLS];          // per warp and cell
  __shared__ int s_wsum[WARPS];
  __shared__ int s_start[CELLS], s_count[CELLS];
  __shared__ int s_hit[CELLS];                  // instances of the cell seen

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = blockIdx.y;
  const int c0 = blockIdx.x * cr;
  const int ncell = min(cr, R * bins - c0);
  const int col0 = blockIdx.z * WIDE_COLS;
  const int ncols = min(WIDE_COLS, C - col0);
  const int* xj = xbin + j;
  // the first of this block's columns in cell `local`'s row of stats
  auto sums = [&](int local) {
    const int cell = c0 + local, r = cell / bins, b = cell - r * bins;
    return stats + (((size_t)r * m + j) * bins + b) * C + col0;
  };

  if (B <= SMALL) {
    // a batch this small: a thread per (cell, column) pair reads all the
    // instances from device memory, in order; the loads do not wait on
    // the adds, so they are all in flight at once
    for (int p = tid; p < ncell * ncols; p += THREADS) {
      const int local = p / ncols, col = p - local * ncols;
      const int cell = c0 + local;
      float* out = sums(local) + col;
      float acc = *out;
      for (int i = 0; i < B; ++i) {
        const int s = seg[i], xb = xj[(size_t)i * m];
        const bool hit = s >= 0 && s < R && xb >= 0 && xb < bins &&
                         s * bins + xb == cell;
        const float v = mom[(size_t)i * C + col0 + col];
        if (hit) acc = __fadd_rn(acc, v);
      }
      *out = acc;
    }
    return;
  }

  float* s_vals = s_dyn;                        // [TILE][WIDE_COLS], sorted
  float* s_acc = s_dyn + TILE * WIDE_COLS;      // [cr][WIDE_COLS]
  const bool vec4 = C % 4 == 0;
  const bool vec_mom = vec4 && reinterpret_cast<uintptr_t>(mom) % 16 == 0;
  const bool vec_stats =
      vec4 && reinterpret_cast<uintptr_t>(stats) % 16 == 0;
  s_hit[tid] = 0;
  for (int base = 0; base < B; base += TILE) {
    const int n = min(TILE, B - base);
    // 1. stage the ids (and, on the first tile, the old sums)
    stage_words(s_seg, seg + base, n);
    for (int i = tid; i < n; i += THREADS)
      cp_async4(&s_ent[i], xj + (size_t)(base + i) * m);
    if (base == 0) stage_slab(s_acc, ncell, ncols, vec_stats, sums);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    for (int k = lane; k < CELLS; k += 32) s_wcnt[warp][k] = 0;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    // 2. sort the tile by cell; then stage the values of the block's
    // instances in that order, so that each cell's rows lie together
    const int2 list = sort_tile(n, R, bins, c0, cr, s_seg, s_ent, s_sorted,
                                s_wcnt, s_wsum);
    s_start[tid] = list.x;
    s_count[tid] = list.y;
    int total = 0;                      // the block's instances in the tile
#pragma unroll
    for (int w = 0; w < WARPS; ++w) total += s_wsum[w];
    const float* tile = mom + (size_t)base * C + col0;
    stage_slab(s_vals, total, ncols, vec_mom,
               [&](int p) { return tile + (size_t)s_sorted[p] * C; });
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    // 3. each warp adds its cells' rows, a lane per column
    for (int local = warp; local < ncell; local += WARPS) {
      const int cnt = s_count[local];
      if (cnt == 0) continue;
      float* acc = s_acc + local * WIDE_COLS + lane;
      *acc = walk_rows(*acc, s_vals + s_start[local] * WIDE_COLS + lane, cnt);
      s_hit[local] = 1;
    }
    if (base + TILE < B) __syncthreads();   // the buffers are staged again
  }
  // each warp writes back the sums of its cells that instances hit (only
  // it has read or written them since the staging)
  for (int local = warp; local < ncell; local += WARPS)
    if (s_hit[local] && lane < ncols)
      sums(local)[lane] = s_acc[local * WIDE_COLS + lane];
}

template <int C>
void launch(float* stats, const int* seg, const int* xbin, const float* mom,
            int R, int m, int bins, int B, cudaStream_t stream) {
  // as few ranges of an attribute's R * bins cells as give each thread at
  // most one cell
  const int per_attr = R * bins;
  const int ranges = (per_attr + CELLS - 1) / CELLS;
  const int cr = (per_attr + ranges - 1) / ranges;
  const dim3 grid((unsigned)ranges, (unsigned)m);
  rule_stats_kernel<C><<<grid, THREADS, 0, stream>>>(stats, seg, xbin, mom, R,
                                                     m, bins, B, cr);
}

// The staged path's dynamic shared memory limit, set once a device to its
// largest value: cr is at most WARPS * WIDE_WARP_CELLS.  Two threads that
// set it at once set the same value.
constexpr int WIDE_DEVICES = 64;

cudaError_t wide_smem_attribute() {
  static std::atomic<bool> done[WIDE_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < WIDE_DEVICES && done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(rule_stats_wide_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)wide_smem(WARPS * WIDE_WARP_CELLS));
  if (err == cudaSuccess && dev < WIDE_DEVICES)
    done[dev].store(true, std::memory_order_release);
  return err;
}

cudaError_t launch_wide(float* stats, const int* seg, const int* xbin,
                        const float* mom, int R, int m, int bins, int C,
                        int B, cudaStream_t stream) {
  // ranges of about WIDE_WARP_CELLS cells a warp, so that the walk is
  // spread over many blocks
  const int per_attr = R * bins;
  const int ranges = (per_attr + WARPS * WIDE_WARP_CELLS - 1) /
                     (WARPS * WIDE_WARP_CELLS);
  const int cr = (per_attr + ranges - 1) / ranges;
  const dim3 grid((unsigned)ranges, (unsigned)m,
                  (unsigned)((C + WIDE_COLS - 1) / WIDE_COLS));
  size_t smem = 0;
  if (B > SMALL) {
    smem = wide_smem(cr);
    const cudaError_t err = wide_smem_attribute();
    if (err != cudaSuccess) return err;
  }
  rule_stats_wide_kernel<<<grid, THREADS, smem, stream>>>(
      stats, seg, xbin, mom, R, m, bins, C, B, cr);
  return cudaSuccess;
}

// The tenant form: F independent segment sums in one launch, out [F, S,
// C] += the rows of vals [F * B, C] by seg [F * B] (tenant f's rows are
// [f * B, (f + 1) * B), its segment ids local, in [0, S); others are
// dropped).  Folding the tenants into the segment ids would make every
// block of the wide form scan all F * B rows: its work would grow as F^2.
//
// Design: a block takes one tenant and 32 columns (grid: F x column
// tiles) and touches only the segments its tenant's rows hit.  It stages
// a tile of THREADS of the tenant's segment ids in shared memory; thread i
// links row i to the next row of the tile in the same segment (a scan
// forward) and the first row of each segment leads it.  Warp w takes the
// leaders i = w, w + 8, ...: lane l reads out[s, col0 + l], adds the
// segment's rows along the links and writes the sum back.  So each
// (segment, column) sum is one thread's chain of adds in instance order:
// the order of the narrow and wide forms, of the plain version and of
// XLA's CPU scatter, whatever the tenant count.  A segment that rows of
// two tiles hit is read and written once a tile, the tiles in order.  A
// row's values are read once, 32 columns in one coalesced read.  The
// columns of a narrow sum (1 | t | t^2, 3; a batch sum, 1) take as many
// lanes of the 32; the rest idle.
//
// What bounds it: it reads the F * B rows and their segment ids, and
// reads and writes the segments they hit: at the fleet's CF scatter
// (F = 1000 tenants of d32-K100, B = 16, 64 columns) 4.1 MB of rows and
// at most 16 000 (tenant, segment) rows of sums, 8.2 MB, read and
// written.  Its adds, B * C a tenant, are nothing; a segment's chain of
// dependent reads and adds is at most B long.  The segments no row hits
// (85 of 101 a tenant at least) it never reads: the caller's buffer of
// zeros holds them.
constexpr int TENANT_COLS = 32;         // columns a block takes, a lane each

__global__ void __launch_bounds__(THREADS)
segment_sum_tenant_kernel(float* __restrict__ out, const int* __restrict__ seg,
                          const float* __restrict__ vals, int S, int C,
                          int B) {
  __shared__ int s_seg[THREADS];        // the tile's segment ids, -1 dropped
  __shared__ int s_next[THREADS];       // the next row of the same segment
  __shared__ int s_lead[THREADS];       // the segment's first row in the tile
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t f = blockIdx.x;
  const int col = blockIdx.y * TENANT_COLS + lane;
  float* o = out + f * S * C;
  const int* sg = seg + f * B;
  const float* v = vals + f * B * C;
  const bool live = col < C;

  for (int base = 0; base < B; base += THREADS) {
    const int n = min(THREADS, B - base);
    if (base) __syncthreads();          // the previous tile is summed
    int s = -1;
    if (tid < n) {
      s = sg[base + tid];
      if (s < 0 || s >= S) s = -1;
      s_seg[tid] = s;
      s_lead[tid] = s >= 0;
    }
    __syncthreads();
    if (tid < n) {
      int nxt = n;
      if (s >= 0)
        for (int k = tid + 1; k < n; ++k)
          if (s_seg[k] == s) {
            nxt = k;
            break;
          }
      s_next[tid] = nxt;
      if (nxt < n) s_lead[nxt] = 0;     // only row tid links to row nxt
    }
    __syncthreads();
    if (!live) continue;
    for (int i = warp; i < n; i += WARPS) {
      if (!s_lead[i]) continue;
      float* cell = o + (size_t)s_seg[i] * C + col;
      float acc = *cell;
      for (int k = i; k < n; k = s_next[k])
        acc = __fadd_rn(acc, v[(size_t)(base + k) * C + col]);
      *cell = acc;
    }
  }
}

}  // namespace

extern "C" int rule_stats_launch(void* stats, const void* seg,
                                 const void* xbin, const void* mom, int R,
                                 int m, int bins, int C, int B, void* stream) {
  float* s = (float*)stats;
  const int* sg = (const int*)seg;
  const int* xb = (const int*)xbin;
  const float* mo = (const float*)mom;
  cudaStream_t st = (cudaStream_t)stream;
  switch (C) {
    case 1: launch<1>(s, sg, xb, mo, R, m, bins, B, st); break;
    case 2: launch<2>(s, sg, xb, mo, R, m, bins, B, st); break;
    case 3: launch<3>(s, sg, xb, mo, R, m, bins, B, st); break;
    case 4: launch<4>(s, sg, xb, mo, R, m, bins, B, st); break;
    case 5: launch<5>(s, sg, xb, mo, R, m, bins, B, st); break;
    case 6: launch<6>(s, sg, xb, mo, R, m, bins, B, st); break;
    case 7: launch<7>(s, sg, xb, mo, R, m, bins, B, st); break;
    case 8: launch<8>(s, sg, xb, mo, R, m, bins, B, st); break;
    default: {
      if (C < 1 || C > MAX_WIDE) return (int)cudaErrorInvalidValue;
      const cudaError_t err = launch_wide(s, sg, xb, mo, R, m, bins, C, B, st);
      if (err != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaGetLastError();
}

// The tenant form: out [F, S, C], seg [F * B], vals [F * B, C].
extern "C" int segment_sum_tenant_launch(void* out, const void* seg,
                                         const void* vals, int F, int S,
                                         int C, int B, void* stream) {
  if (F < 0 || S < 0 || C < 1 || C > MAX_WIDE || B < 0)
    return (int)cudaErrorInvalidValue;
  if (F == 0 || S == 0 || B == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)F,
                  (unsigned)((C + TENANT_COLS - 1) / TENANT_COLS));
  segment_sum_tenant_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (float*)out, (const int*)seg, (const float*)vals, S, C, B);
  return (int)cudaGetLastError();
}
