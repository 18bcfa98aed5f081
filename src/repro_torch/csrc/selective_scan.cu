// selective_scan: the Mamba-1 scan over one sequence, state in and out,
//
//   h  <- exp(dt_t * A) * h + (dt_t * x_t) * B_t        h: [dI, N] per batch row
//   y_t = sum_n h[:, n] * C_t[n]
//
// with dt, x [B, L, dI], Bm, Cm [B, L, N] (all float32, or all bf16),
// A [dI, N] f32, h0 [B, dI, N] f32; writes y [B, L, dI] in the inputs' type
// and hT [B, dI, N] f32.  All arithmetic is float32.
//
// Replaces src/repro/kernels/selective_scan/kernel.py::selective_scan_pallas
// (kernel.py:46, its pallas_call at :54), which on the TPU gave each grid
// step a tile of channels, kept its [dT, N] state in VMEM and walked time in
// order, so that the discretized tensors exp(dt*A) and dt*x*B
// ([B, L, dI, N]) never reach device memory.
//
// Bound on the card: each input byte read once and each output byte written
// once (dt, x and y dominate) against 7 float32 operations per state and
// step: at a prefill shape (B = 4, L = 2048, dI = 8192, N = 16) the bytes
// set the bound (0.24 ms at 3.35 TB/s), but every (batch row, channel) is a
// chain of L dependent steps, so what the card can do depends on how many
// chains are in flight and on whether a step ever waits on device memory.
//
// The design does three things about that:
//
// - Four neighbouring lanes share a channel, and each holds ceil(N/4)
//   states (lane g holds n = g*NPL .. g*NPL + NPL - 1) and the matching
//   entries of A in registers.  A block of 128 threads covers 32 channels
//   of one batch row, so at the prefill shape the grid has 1024 blocks
//   (four times the warps of one thread per channel), and the registers
//   per thread fall so that nothing spills.  y_t is each lane's partial sum
//   over its states, finished with two xor shuffles; the spare states of an
//   N that is not a multiple of 4 have A = 0, h = 0 and B = C = 0 and stay 0.
// - The chain never reads device memory: tiles of TT steps of dt and x
//   ([TT, 32 channels], one 128-byte row per step in float32) and of B and C
//   ([TT, N]) are copied into shared memory with cp.async, double-buffered,
//   so the next tile loads while this one is scanned.  The 16-byte copies
//   need 16-byte aligned rows; other shapes stage with plain loads.
// - y_t is written over x_t in the staged tile once the step has read it,
//   and the tile goes out to y in coalesced rows.
//
// Each state's arithmetic and its order are the first version's:
// expf(dt*a) * h + dx * B, without --use_fast_math, so hT is the same; only
// the order of y's sum over n changed.  The product order is the Pallas
// kernel's, (dt*x)*B; the plain version computes dt*B*x, as the JAX
// reference does: they differ by float32 rounding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int CH = 32;               // channels per block
constexpr int LPC = 4;               // lanes per channel
constexpr int THREADS = CH * LPC;    // 128

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// NPL states per lane, NP = 4 * NPL per channel (N rounded up), TT steps
// per staged tile.  vec_dx: dt, x and y rows go by 16-byte chunks; vec_bc:
// the B and C rows (N == NP) too.
template <typename T, int NPL, int TT>
__global__ void __launch_bounds__(THREADS) selective_scan_kernel(
    const T* __restrict__ dt, const T* __restrict__ x,
    const T* __restrict__ Bm, const T* __restrict__ Cm,
    const float* __restrict__ A, const float* __restrict__ h0,
    T* __restrict__ y, float* __restrict__ hT, int L, int dI, int N,
    int vec_dx, int vec_bc) {
  constexpr int NP = NPL * LPC;
  constexpr int EPC = 16 / sizeof(T);   // elements per 16-byte chunk
  __shared__ __align__(16) T sdt[2][TT][CH];
  __shared__ __align__(16) T sx[2][TT][CH];   // x_t, then y_t
  __shared__ __align__(16) T sB[2][TT][NP];
  __shared__ __align__(16) T sC[2][TT][NP];

  const int tid = threadIdx.x;
  const int c = tid / LPC;
  const int g = tid - c * LPC;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int d = d0 + c;
  const bool live = d < dI;
  const size_t row0 = (size_t)b * L;

  // the spare columns n >= N stay zero; the rows n < N are overwritten
  for (int i = tid; i < 2 * TT * NP; i += THREADS) {
    (&sB[0][0][0])[i] = from_f<T>(0.f);
    (&sC[0][0][0])[i] = from_f<T>(0.f);
  }

  float a[NPL], h[NPL];
  const size_t state = ((size_t)b * dI + (live ? d : 0)) * N;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int n = g * NPL + i;
    const bool on = live && n < N;
    a[i] = on ? A[(size_t)d * N + n] : 0.f;
    h[i] = on ? h0[state + n] : 0.f;
  }
  __syncthreads();

  // copy steps [t0, t0 + tn) into buffer buf
  auto stage = [&](int buf, int t0, int tn) {
    if (vec_dx) {
      constexpr int CPR = CH / EPC;   // chunks per row
      for (int i = tid; i < tn * CPR; i += THREADS) {
        const int tt = i / CPR;
        const int j = i - tt * CPR;
        const int dd = d0 + j * EPC;
        const size_t off = (row0 + t0 + tt) * dI + dd;
        const int bytes = dd < dI ? 16 : 0;   // dI % EPC == 0: whole chunks
        cp_async16(&sdt[buf][tt][j * EPC], bytes ? dt + off : dt, bytes);
        cp_async16(&sx[buf][tt][j * EPC], bytes ? x + off : x, bytes);
      }
    } else {
      for (int i = tid; i < tn * CH; i += THREADS) {
        const int tt = i / CH;
        const int cc = i - tt * CH;
        const size_t off = (row0 + t0 + tt) * dI + d0 + cc;
        const bool in = d0 + cc < dI;
        sdt[buf][tt][cc] = in ? dt[off] : from_f<T>(0.f);
        sx[buf][tt][cc] = in ? x[off] : from_f<T>(0.f);
      }
    }
    const size_t src = (row0 + t0) * N;   // tn rows of N, contiguous
    if (vec_bc) {
      for (int i = tid; i < tn * NP / EPC; i += THREADS) {
        cp_async16(&sB[buf][0][0] + i * EPC, Bm + src + i * EPC, 16);
        cp_async16(&sC[buf][0][0] + i * EPC, Cm + src + i * EPC, 16);
      }
    } else {
      for (int i = tid; i < tn * N; i += THREADS) {
        const int tt = i / N;
        const int n = i - tt * N;
        sB[buf][tt][n] = Bm[src + i];
        sC[buf][tt][n] = Cm[src + i];
      }
    }
    cp_async_commit();
  };

  stage(0, 0, min(TT, L));
  for (int k = 0, t0 = 0; t0 < L; ++k, t0 += TT) {
    const int buf = k & 1;
    const int tn = min(TT, L - t0);
    cp_async_wait_all();
    __syncthreads();   // tile k is staged; tile k - 1's y has gone out
    if (t0 + TT < L) stage(buf ^ 1, t0 + TT, min(TT, L - t0 - TT));

#pragma unroll 2
    for (int tt = 0; tt < tn; ++tt) {
      const float dtv = to_f(sdt[buf][tt][c]);
      const float dx = dtv * to_f(sx[buf][tt][c]);
      float bv[NPL], cv[NPL];
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        bv[i] = to_f(sB[buf][tt][g * NPL + i]);
        cv[i] = to_f(sC[buf][tt][g * NPL + i]);
      }
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        h[i] = expf(dtv * a[i]) * h[i] + dx * bv[i];
        acc += h[i] * cv[i];
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (g == 0) sx[buf][tt][c] = from_f<T>(acc);   // x_t was read above
    }
    __syncthreads();   // the tile's y is in sx[buf]

    if (vec_dx) {
      constexpr int CPR = CH / EPC;
      for (int i = tid; i < tn * CPR; i += THREADS) {
        const int tt = i / CPR;
        const int j = i - tt * CPR;
        const int dd = d0 + j * EPC;
        if (dd < dI)
          *reinterpret_cast<uint4*>(y + (row0 + t0 + tt) * dI + dd) =
              *reinterpret_cast<const uint4*>(&sx[buf][tt][j * EPC]);
      }
    } else {
      for (int i = tid; i < tn * CH; i += THREADS) {
        const int tt = i / CH;
        const int cc = i - tt * CH;
        if (d0 + cc < dI) y[(row0 + t0 + tt) * dI + d0 + cc] = sx[buf][tt][cc];
      }
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int n = g * NPL + i;
      if (n < N) hT[state + n] = h[i];
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, int NPL, int TT>
void run(const void* dt, const void* x, const void* Bm, const void* Cm,
         const void* A, const void* h0, void* y, void* hT, int B, int L,
         int dI, int N, cudaStream_t stream) {
  constexpr int EPC = 16 / sizeof(T);
  const dim3 grid((dI + CH - 1) / CH, B);
  const int vec_dx = dI % EPC == 0 && aligned16(dt) && aligned16(x) &&
                     aligned16(y);
  const int vec_bc = N == NPL * LPC && N % EPC == 0 && aligned16(Bm) &&
                     aligned16(Cm);
  selective_scan_kernel<T, NPL, TT><<<grid, THREADS, 0, stream>>>(
      (const T*)dt, (const T*)x, (const T*)Bm, (const T*)Cm, (const float*)A,
      (const float*)h0, (T*)y, (float*)hT, L, dI, N, vec_dx, vec_bc);
}

template <typename T>
void launch(const void* dt, const void* x, const void* Bm, const void* Cm,
            const void* A, const void* h0, void* y, void* hT, int B, int L,
            int dI, int N, cudaStream_t stream) {
  if (N <= 4)
    run<T, 1, 32>(dt, x, Bm, Cm, A, h0, y, hT, B, L, dI, N, stream);
  else if (N <= 8)
    run<T, 2, 32>(dt, x, Bm, Cm, A, h0, y, hT, B, L, dI, N, stream);
  else if (N <= 16)
    run<T, 4, 32>(dt, x, Bm, Cm, A, h0, y, hT, B, L, dI, N, stream);
  else if (N <= 32)
    run<T, 8, 32>(dt, x, Bm, Cm, A, h0, y, hT, B, L, dI, N, stream);
  else
    run<T, 16, 16>(dt, x, Bm, Cm, A, h0, y, hT, B, L, dI, N, stream);
}

}  // namespace

// bf16 != 0: dt, x, Bm, Cm and y are bf16, else float32.  1 <= N <= 64,
// B <= 65535.
extern "C" int selective_scan_launch(const void* dt, const void* x,
                                     const void* Bm, const void* Cm,
                                     const void* A, const void* h0, void* y,
                                     void* hT, int B, int L, int dI, int N,
                                     int bf16, void* stream) {
  if (N < 1 || N > 64 || B > 65535) return (int)cudaErrorInvalidValue;
  if (bf16)
    launch<__nv_bfloat16>(dt, x, Bm, Cm, A, h0, y, hT, B, L, dI, N,
                          (cudaStream_t)stream);
  else
    launch<float>(dt, x, Bm, Cm, A, h0, y, hT, B, L, dI, N,
                  (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
