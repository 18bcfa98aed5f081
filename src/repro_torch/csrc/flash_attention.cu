// flash_attention: causal, sliding-window or full attention with an online
// softmax, for q [B, S, H, hd] and k, v [B, T, K, hd] (H = K * G: query head
// h reads kv head h / G), bf16 or float32, out [B, S, H, hd] in q's type.
//
//   o[b, s, h] = sum_t softmax_t(q[b, s, h] . k[b, t, h/G] / sqrt(hd)) v[b, t, h/G]
//
// over the keys t with t <= s (causal), s - t < window (window > 0) and
// t < T; a masked score is -1e30, as in the JAX package, and the output is
// divided by max(l, 1e-30) (kernel.py:65).
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas
// (kernel.py:68, its pallas_call at :85; the TPU prefill path), which held
// one q tile in VMEM and streamed kv tiles through an online softmax, so
// that the [S, T] probabilities never reach device memory, after its
// wrapper had expanded the GQA kv heads with a copy.
//
// Bound on the card: the two products, 4 * hd flops per unmasked (row,
// key) pair, at the bf16 tensor-core peak; the bytes of q, k, v and o are
// a few percent of that time at a prefill shape.  So the bf16 kernel, the
// one every served config runs, is built around Hopper's tensor cores:
//
// - One warpgroup (128 threads) owns 64 query rows of one (batch, head),
//   wgmma's M.  Its Q tile comes in once by TMA.
// - K and V tiles of 64 keys stream through a ring of two shared-memory
//   stages by TMA (cp.async.bulk.tensor, completion on an mbarrier per
//   stage): tile j + 1 is in flight while tile j is used.  The tensor maps
//   describe q, k, v and o as the 4-D [B, len, heads, hd] tensors, so a
//   tile past S or T is zero-filled inside its own batch row (and a store
//   past S is dropped); the kv head h / G is a coordinate, never a copy.
//   Each box row is one swizzle span (128 bytes at hd >= 64, else hd * 2),
//   in the layout that wgmma's shared-memory descriptors read.
// - S = Q K^T: wgmma m64n64k16, bf16 in, float32 accumulators in
//   registers.  The scale, with log2(e) folded in, multiplies the float32
//   scores (not bf16 q, which would add a rounding that the plain version
//   does not have), and exp2f takes the place of expf.
// - The online softmax keeps each row's max and sum in float32 registers;
//   a row's 64 scores lie on the 4 lanes of a quad, reduced with two xor
//   shuffles.  Masks are applied only on tiles that cross T, the diagonal
//   or the window edge; tiles wholly masked for the block are skipped, and
//   the blocks with the most tiles start first.
// - O += P V: P is converted to bf16 in registers and is the register A
//   operand of a second wgmma (m64nNk16, N = min(hd, 64) per instruction);
//   V is read from shared memory as the MN-major B operand.
// - O is divided by the row sums, written in bf16 into the Q tile's
//   shared memory in the same swizzled layout, and stored by TMA, so the
//   stores to [B, S, H, hd] are whole rows.
//
// No served path feeds float32 (every config's dtype is bf16).  float32
// inputs keep the first CUDA-core design, off every served path: one block
// of 256 threads per 64 query rows, four lanes per row each holding a
// quarter of q and of the accumulator, key and value tiles of 32 rows in
// shared memory as float32, the products as float32 FMAs.

#include <cuda.h>   // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

// ------------------------------------------------ float32: CUDA cores

constexpr int BQ = 64;              // query rows per block
constexpr int BK = 32;              // keys per shared-memory tile
constexpr int TPR = 4;              // lanes per query row
constexpr int THREADS = BQ * TPR;   // 256
constexpr float NEG = -1e30f;      // a masked score

template <int HD>
__global__ void __launch_bounds__(THREADS) flash_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, int S, int Tk, int H,
    int KH, int causal, int window, float scale) {
  constexpr int DPT = HD / TPR;   // head dims per lane
  constexpr int V4 = DPT / 4;     // float4 groups per lane
  __shared__ __align__(16) float sK[BK][HD];
  __shared__ __align__(16) float sV[BK][HD];

  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int kh = h / (H / KH);
  const int q0 = blockIdx.x * BQ;
  const int r = threadIdx.x / TPR;
  const int g = threadIdx.x - r * TPR;
  const int qpos = q0 + r;
  const bool live = qpos < S;
  const size_t qoff = (((size_t)b * S + (live ? qpos : 0)) * H + h) * HD;

  float qr[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < V4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int dd = i * 4 * TPR + 4 * g + e;
      qr[i * 4 + e] = live ? q[qoff + dd] * scale : 0.f;
      acc[i * 4 + e] = 0.f;
    }
  float m = NEG, l = 0.f;

  const int q_last = min(q0 + BQ, S) - 1;
  const int k_hi = causal ? min(Tk, q_last + 1) : Tk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();   // the previous tile is consumed
    for (int i = threadIdx.x; i < BK * HD; i += THREADS) {
      const int j = i / HD;
      const int dd = i - j * HD;
      const int kp = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kp < Tk) {
        const size_t off = (((size_t)b * Tk + kp) * KH + kh) * HD + dd;
        kv = k[off];
        vv = v[off];
      }
      sK[j][dd] = kv;
      sV[j][dd] = vv;
    }
    __syncthreads();

    float s[BK];
    float mt = m;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < V4; ++i) {
        const float4 kk =
            *reinterpret_cast<const float4*>(&sK[j][i * 4 * TPR + 4 * g]);
        part += qr[i * 4 + 0] * kk.x + qr[i * 4 + 1] * kk.y +
                qr[i * 4 + 2] * kk.z + qr[i * 4 + 3] * kk.w;
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kp = k0 + j;
      bool ok = kp < Tk;
      if (causal) ok = ok && qpos >= kp;
      if (window > 0) ok = ok && qpos - kp < window;
      s[j] = ok ? part : NEG;
      mt = fmaxf(mt, s[j]);
    }
    const float corr = expf(m - mt);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      s[j] = expf(s[j] - mt);
      psum += s[j];
    }
    l = l * corr + psum;
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
#pragma unroll
      for (int i = 0; i < V4; ++i) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&sV[j][i * 4 * TPR + 4 * g]);
        acc[i * 4 + 0] += s[j] * vv.x;
        acc[i * 4 + 1] += s[j] * vv.y;
        acc[i * 4 + 2] += s[j] * vv.z;
        acc[i * 4 + 3] += s[j] * vv.w;
      }
    }
    m = mt;
  }

  if (live) {
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < V4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[qoff + i * 4 * TPR + 4 * g + e] = acc[i * 4 + e] / den;
  }
}

int launch_float(const void* q, const void* k, const void* v, void* o, int B,
                 int S, int Tk, int H, int KH, int hd, int causal, int window,
                 cudaStream_t stream) {
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  const float scale = (float)(1.0 / std::sqrt((double)hd));
  const float* q_ = (const float*)q;
  const float* k_ = (const float*)k;
  const float* v_ = (const float*)v;
  float* o_ = (float*)o;
  switch (hd) {
    case 16:
      flash_attention_kernel<16><<<grid, THREADS, 0, stream>>>(
          q_, k_, v_, o_, S, Tk, H, KH, causal, window, scale);
      break;
    case 32:
      flash_attention_kernel<32><<<grid, THREADS, 0, stream>>>(
          q_, k_, v_, o_, S, Tk, H, KH, causal, window, scale);
      break;
    case 64:
      flash_attention_kernel<64><<<grid, THREADS, 0, stream>>>(
          q_, k_, v_, o_, S, Tk, H, KH, causal, window, scale);
      break;
    case 128:
      flash_attention_kernel<128><<<grid, THREADS, 0, stream>>>(
          q_, k_, v_, o_, S, Tk, H, KH, causal, window, scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// ---------------------------------------- bf16: wgmma and TMA (sm_90a)

constexpr int WG_BM = 64;        // query rows per block: wgmma's M
constexpr int WG_BN = 64;        // keys per tile
constexpr int WG_THREADS = 128;  // one warpgroup
constexpr int STAGES = 2;        // K/V ring

template <int HD>
struct Tile {
  static constexpr int BC = HD < 64 ? HD : 64;   // head dims per TMA box
  static constexpr int NB = HD / BC;             // boxes per tile
  static constexpr int ROW = BC * 2;             // bytes per box row: the swizzle span
  // the swizzle code of a wgmma shared-memory descriptor: 128, 64, 32 bytes
  static constexpr int LAYOUT = ROW == 128 ? 1 : ROW == 64 ? 2 : 3;
  static constexpr int Q_BOX = WG_BM * ROW;
  static constexpr int KV_BOX = WG_BN * ROW;
  static constexpr int Q_BYTES = NB * Q_BOX;
  static constexpr int KV_BYTES = NB * KV_BOX;
  // Q, STAGES x (K, V), three mbarriers, and room to align the base to 1 KB
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + 64 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units) and the swizzle code
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)layout << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}
// waits for the phase with the given parity to complete; a copy that never
// lands is a fault, so after some 2^24 polls the kernel traps instead of
// spinning on
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, polls = 0;
  do {
    if (++polls == (1u << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of an accumulator across
// the wgmma fence and wait, which it cannot see
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64]: A and B K-major in shared
// memory; accumulate == 0 overwrites D
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64]: A in registers, B MN-major in
// shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 32] += A[64 x 16] * B[16 x 32]: A in registers, B MN-major in
// shared memory
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 16] += A[64 x 16] * B[16 x 16]: A in registers, B MN-major in
// shared memory
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n32(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n16(d, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The accumulator of a m64nN wgmma: lane l of warp w holds, for each block
// of 8 columns jj, d[4jj + e] at (row 16w + l/4, col 8jj + 2(l%4) + e) and
// d[4jj + 2 + e] at the row 8 below, e = 0, 1.
template <int HD>
__global__ void __launch_bounds__(WG_THREADS) flash_attention_wgmma(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap to, int S, int Tk, int H, int KH,
    int causal, int window, float scale_log2) {
  using TL = Tile<HD>;
  constexpr int BC = TL::BC, NB = TL::NB, ROW = TL::ROW;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // swizzle atoms need 1 KB
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t sQ = base;
  const uint32_t sKV = sQ + TL::Q_BYTES;   // stage s: K, then V
  const uint32_t bars = sKV + 2 * STAGES * TL::KV_BYTES;
  const uint32_t qbar = bars + 8 * STAGES;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int kh = h / (H / KH);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * WG_BM;   // most tiles first

  const int q_last = min(q0 + WG_BM, S) - 1;
  const int k_hi = causal ? min(Tk, q_last + 1) : Tk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int j0 = k_lo / WG_BN;
  const int j1 = (k_hi + WG_BN - 1) / WG_BN;   // key tiles [j0, j1)

  auto load_kv = [&](int j, int s) {
    const uint32_t bar = bars + 8 * s;
    const uint32_t dk = sKV + s * 2 * TL::KV_BYTES;
    mbar_expect(bar, 2 * TL::KV_BYTES);
#pragma unroll
    for (int p = 0; p < NB; ++p) {
      tma_load(dk + p * TL::KV_BOX, &tk, bar, p * BC, kh, j * WG_BN, b);
      tma_load(dk + TL::KV_BYTES + p * TL::KV_BOX, &tv, bar, p * BC, kh,
               j * WG_BN, b);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(bars + 8 * s);
    mbar_init(qbar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(qbar, TL::Q_BYTES);
#pragma unroll
    for (int p = 0; p < NB; ++p)
      tma_load(sQ + p * TL::Q_BOX, &tq, qbar, p * BC, h, q0, b);
    if (j0 < j1) load_kv(j0, 0);
  }
  __syncthreads();

  float o[NB][BC / 2];
#pragma unroll
  for (int p = 0; p < NB; ++p)
#pragma unroll
    for (int i = 0; i < BC / 2; ++i) o[p][i] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;   // rows r and r + 8
  const int r0 = q0 + warp * 16 + lane / 4;
  const int r1 = r0 + 8;
  const int cq = 2 * (lane % 4);

  mbar_wait(qbar, 0);
  for (int j = j0; j < j1; ++j) {
    const int it = j - j0;
    const int s = it & 1;
    const uint32_t dk = sKV + s * 2 * TL::KV_BYTES;
    const uint32_t dv = dk + TL::KV_BYTES;
    if (tid == 0 && j + 1 < j1) load_kv(j + 1, s ^ 1);   // freed at it - 1
    __syncwarp();
    mbar_wait(bars + 8 * s, (it >> 1) & 1);

    // S = Q K^T over HD / 16 steps of 16 head dims
    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t col = (16 * kk) / BC, off = ((16 * kk) % BC) * 2;
      wgmma_ss_n64(sc,
                   make_desc(sQ + col * TL::Q_BOX + off, 16, 8 * ROW,
                             TL::LAYOUT),
                   make_desc(dk + col * TL::KV_BOX + off, 16, 8 * ROW,
                             TL::LAYOUT),
                   kk);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // scale into log2 units, then mask where the tile crosses an edge
    const int k0 = j * WG_BN;
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] *= scale_log2;
    const bool edge = k0 + WG_BN > Tk || (causal && k0 + WG_BN - 1 > q0) ||
                      (window > 0 && q0 + WG_BM - 1 - k0 >= window);
    if (edge) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * jj + cq + e;
          bool ok0 = key < Tk, ok1 = key < Tk;
          if (causal) {
            ok0 = ok0 && key <= r0;
            ok1 = ok1 && key <= r1;
          }
          if (window > 0) {
            ok0 = ok0 && r0 - key < window;
            ok1 = ok1 && r1 - key < window;
          }
          if (!ok0) sc[4 * jj + e] = NEG;
          if (!ok1) sc[4 * jj + 2 + e] = NEG;
        }
    }

    // online softmax: the row max over the quad, the rescale, P
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * jj], sc[4 * jj + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * jj + 2], sc[4 * jj + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float corr0 = exp2f(m0 - mx0), corr1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      sc[4 * jj] = exp2f(sc[4 * jj] - mx0);
      sc[4 * jj + 1] = exp2f(sc[4 * jj + 1] - mx0);
      sc[4 * jj + 2] = exp2f(sc[4 * jj + 2] - mx1);
      sc[4 * jj + 3] = exp2f(sc[4 * jj + 3] - mx1);
      sum0 += sc[4 * jj] + sc[4 * jj + 1];
      sum1 += sc[4 * jj + 2] + sc[4 * jj + 3];
    }
    l0 = l0 * corr0 + sum0;   // this lane's share; the quad sums at the end
    l1 = l1 * corr1 + sum1;
#pragma unroll
    for (int p = 0; p < NB; ++p)
#pragma unroll
      for (int jj = 0; jj < BC / 8; ++jj) {
        o[p][4 * jj] *= corr0;
        o[p][4 * jj + 1] *= corr0;
        o[p][4 * jj + 2] *= corr1;
        o[p][4 * jj + 3] *= corr1;
      }

    // P in bf16 as wgmma's register A operand: 16 keys per step
    uint32_t pf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pf[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pf[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pf[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pf[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }

    // O += P V: V is [keys][hd] in shared memory, MN-major for wgmma
#pragma unroll
    for (int p = 0; p < NB; ++p) fence_regs(o[p]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = 0; p < NB; ++p)
        wgmma_rs<BC>(o[p], pf[kk],
                     make_desc(dv + p * TL::KV_BOX + kk * 16 * ROW, 8 * ROW,
                               8 * ROW, TL::LAYOUT));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int p = 0; p < NB; ++p) fence_regs(o[p]);
    __syncthreads();   // stage s is free for tile j + 2
  }

  // O / l in bf16 into the Q tile's swizzled layout, then one TMA store
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  const int row0 = warp * 16 + lane / 4;
  constexpr uint32_t SWZ = ROW / 16 - 1;
#pragma unroll
  for (int p = 0; p < NB; ++p)
#pragma unroll
    for (int jj = 0; jj < BC / 8; ++jj)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint32_t off = (row0 + 8 * half) * ROW + (8 * jj + cq) * 2;
        const uint32_t swz = off ^ (((off >> 7) & SWZ) << 4);
        const float den = half ? den1 : den0;
        *reinterpret_cast<uint32_t*>(gbase + p * TL::Q_BOX + swz) =
            pack_bf16(o[p][4 * jj + 2 * half] / den,
                      o[p][4 * jj + 2 * half + 1] / den);
      }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int p = 0; p < NB; ++p)
      tma_store(&to, sQ + p * TL::Q_BOX, p * BC, h, q0, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime, so that the
// library needs no link against libcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [B, len, heads, hd] bf16 as a 4-D map, innermost first, boxes of
// {box_cols head dims, 1 head, box_rows positions, 1 batch row}
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int B,
              int len, int heads, int hd, int box_cols, int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)len, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)len * heads * hd * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const int row = box_cols * 2;
  const CUtensorMapSwizzle swz = row == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : row == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                             : CU_TENSOR_MAP_SWIZZLE_32B;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                 int S, int Tk, int H, int KH, int causal, int window,
                 cudaStream_t stream) {
  using TL = Tile<HD>;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16)
    return (int)cudaErrorMisalignedAddress;
  CUtensorMap mq, mk, mv, mo;
  const int T1 = Tk > 0 ? Tk : 1;   // with T = 0 no key tile is loaded
  if (!make_map(enc, &mq, q, B, S, H, HD, TL::BC, WG_BM) ||
      !make_map(enc, &mk, k, B, T1, KH, HD, TL::BC, WG_BN) ||
      !make_map(enc, &mv, v, B, T1, KH, HD, TL::BC, WG_BN) ||
      !make_map(enc, &mo, o, B, S, H, HD, TL::BC, WG_BM))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      TL::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + WG_BM - 1) / WG_BM, B * H);
  const float scale_log2 = (float)(1.4426950408889634 / std::sqrt((double)HD));
  flash_attention_wgmma<HD><<<grid, WG_THREADS, TL::SMEM, stream>>>(
      mq, mk, mv, mo, S, Tk, H, KH, causal, window, scale_log2);
  return 0;
}

int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int S, int Tk, int H, int KH, int hd, int causal, int window,
                cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch_wgmma<16>(q, k, v, o, B, S, Tk, H, KH, causal, window,
                              stream);
    case 32:
      return launch_wgmma<32>(q, k, v, o, B, S, Tk, H, KH, causal, window,
                              stream);
    case 64:
      return launch_wgmma<64>(q, k, v, o, B, S, Tk, H, KH, causal, window,
                              stream);
    case 128:
      return launch_wgmma<128>(q, k, v, o, B, S, Tk, H, KH, causal, window,
                               stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// bf16 != 0: q, k, v and o are bf16 (16-byte aligned), else float32.
// hd in {16, 32, 64, 128}; H a multiple of KH; B * H <= 65535.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int T, int H, int KH, int hd,
                                      int causal, int window, int bf16,
                                      void* stream) {
  if (KH < 1 || H % KH != 0 || B * H > 65535) return (int)cudaErrorInvalidValue;
  const int err =
      bf16 ? launch_bf16(q, k, v, o, B, S, T, H, KH, hd, causal, window,
                         (cudaStream_t)stream)
           : launch_float(q, k, v, o, B, S, T, H, KH, hd, causal, window,
                          (cudaStream_t)stream);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}
