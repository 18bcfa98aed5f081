// flash_attention: causal, sliding-window or full attention with an online
// softmax, for q [B, S, H, hd] and k, v [B, T, K, hd] (H = K * G: query head
// h reads kv head h / G), float32 or bf16, out [B, S, H, hd] in q's type.
//
//   o[b, s, h] = sum_t softmax_t(q[b, s, h] . k[b, t, h/G] / sqrt(hd)) v[b, t, h/G]
//
// over the keys t with t <= s (causal), s - t < window (window > 0) and
// t < T; a masked score is -1e30, as in the JAX package.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas
// (the TPU prefill path), which held one q tile in VMEM and streamed kv tiles
// through an online softmax, so that the [S, T] probabilities never reach
// device memory, after its wrapper had expanded the GQA kv heads with a copy.
//
// Here one block of 256 threads owns 64 query rows of one (batch, head).  Four
// neighbouring lanes share a row: each holds a quarter of the head dims of
// the row's scaled query and of its float32 accumulator in registers, in
// float4 groups interleaved so that the four lanes read neighbouring shared
// memory words.  Key and value tiles of 32 rows stream through shared memory
// as float32.  Per tile, each lane takes its partial dot products with the
// 32 keys and two xor shuffles complete them; the running max, the sum and
// the rescaled accumulator stay in float32 (the scale is applied to q first,
// as kernel.py:28 does; the output divides by max(l, 1e-30), kernel.py:65).
// Tiles beyond the causal frontier of the block's last row, and before the
// window of its first row, are skipped; rows and keys beyond S and T are
// masked here, so S and T need not be multiples of the tiles (the Pallas
// kernel asserts that they are).  The GQA kv head is indexed, not copied.
//
// Bound: the products (4 * hd flops per unmasked (row, key) pair) are work
// for the tensor cores; this first version runs them as float32 FMAs on the
// CUDA cores, and reads each key and value tile from shared memory once per
// row group, so it runs far below the bf16 tensor-core peak it is held
// against.  mma/wgmma tiles are the redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int BQ = 64;              // query rows per block
constexpr int BK = 32;              // keys per shared-memory tile
constexpr int TPR = 4;              // lanes per query row
constexpr int THREADS = BQ * TPR;   // 256
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int S, int Tk, int H, int KH,
    int causal, int window, float scale) {
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
      qr[i * 4 + e] = live ? to_f(q[qoff + dd]) * scale : 0.f;
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
        kv = to_f(k[off]);
        vv = to_f(v[off]);
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
        store(o + qoff + i * 4 * TPR + 4 * g + e, acc[i * 4 + e] / den);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int Tk, int H, int KH, int hd, int causal, int window,
           cudaStream_t stream) {
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  const float scale = (float)(1.0 / std::sqrt((double)hd));
  const T* q_ = (const T*)q;
  const T* k_ = (const T*)k;
  const T* v_ = (const T*)v;
  T* o_ = (T*)o;
  switch (hd) {
    case 16:
      flash_attention_kernel<T, 16><<<grid, THREADS, 0, stream>>>(
          q_, k_, v_, o_, S, Tk, H, KH, causal, window, scale);
      break;
    case 32:
      flash_attention_kernel<T, 32><<<grid, THREADS, 0, stream>>>(
          q_, k_, v_, o_, S, Tk, H, KH, causal, window, scale);
      break;
    case 64:
      flash_attention_kernel<T, 64><<<grid, THREADS, 0, stream>>>(
          q_, k_, v_, o_, S, Tk, H, KH, causal, window, scale);
      break;
    case 128:
      flash_attention_kernel<T, 128><<<grid, THREADS, 0, stream>>>(
          q_, k_, v_, o_, S, Tk, H, KH, causal, window, scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// bf16 != 0: q, k, v and o are bf16, else float32.  hd in {16, 32, 64, 128};
// H a multiple of KH; B * H <= 65535.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int T, int H, int KH, int hd,
                                      int causal, int window, int bf16,
                                      void* stream) {
  if (KH < 1 || H % KH != 0 || B * H > 65535) return (int)cudaErrorInvalidValue;
  const int err =
      bf16 ? launch<__nv_bfloat16>(q, k, v, o, B, S, T, H, KH, hd, causal,
                                   window, (cudaStream_t)stream)
           : launch<float>(q, k, v, o, B, S, T, H, KH, hd, causal, window,
                           (cudaStream_t)stream);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}
