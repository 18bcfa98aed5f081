// selective_scan: the Mamba-1 scan over one sequence, state in and out,
//
//   h  <- exp(dt_t * A) * h + (dt_t * x_t) * B_t        h: [dI, N] per batch row
//   y_t = sum_n h[:, n] * C_t[n]
//
// with dt, x [B, L, dI], Bm, Cm [B, L, N] (all float32, or all bf16),
// A [dI, N] f32, h0 [B, dI, N] f32; writes y [B, L, dI] in the inputs' type
// and hT [B, dI, N] f32.  All arithmetic is float32.
//
// Replaces src/repro/kernels/selective_scan/kernel.py::selective_scan_pallas,
// which on the TPU gave each grid step a tile of channels, kept its [dT, N]
// state in VMEM and walked time in order, so that the discretized tensors
// exp(dt*A) and dt*x*B ([B, L, dI, N]) never reach device memory.
//
// Here one thread owns one (batch row, channel): its N states and its row of
// A live in registers for the whole sequence, and it walks time in order.
// A block holds 128 consecutive channels of one batch row; it stages a tile
// of 64 time steps of B_t and C_t ([64, N], shared by all its channels) in
// shared memory.  Each thread reads dt and x and writes y at its channel, so
// a warp's reads and writes are coalesced.  The kernel moves each input byte
// once and each output byte once: bound by the bytes of dt, x and y (the
// B, C, A and state bytes are small); the N exponentials per (b, t, channel)
// run on the SFU.  At a prefill shape (B = 4, dI = 8192) there are only 256
// blocks of 128 threads, each a dependent chain of L steps: the kernel is
// latency-bound, not bandwidth-bound, until the sequence is split across
// blocks (a chunked scan with a second pass), which is later work.
//
// The product order is the Pallas kernel's, (dt*x)*B; the plain version
// computes dt*B*x, as the JAX reference does: they differ by float32
// rounding.  nvcc may contract exp(.)*h + dx*B into a fused multiply-add.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;   // channels per block
constexpr int T_TILE = 64;     // time steps of B and C staged at a time

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int NMAX>
__global__ void __launch_bounds__(THREADS) selective_scan_kernel(
    const T* __restrict__ dt, const T* __restrict__ x,
    const T* __restrict__ Bm, const T* __restrict__ Cm,
    const float* __restrict__ A, const float* __restrict__ h0,
    T* __restrict__ y, float* __restrict__ hT, int L, int dI, int N) {
  __shared__ float sB[T_TILE][NMAX];
  __shared__ float sC[T_TILE][NMAX];
  const int b = blockIdx.y;
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const bool live = d < dI;
  const size_t state = ((size_t)b * dI + (live ? d : 0)) * N;

  float a[NMAX], h[NMAX];
#pragma unroll
  for (int n = 0; n < NMAX; ++n) {
    const bool on = live && n < N;
    a[n] = on ? A[(size_t)(live ? d : 0) * N + n] : 0.f;
    h[n] = on ? h0[state + n] : 0.f;
  }

  const size_t row0 = (size_t)b * L;
  for (int t0 = 0; t0 < L; t0 += T_TILE) {
    const int tn = min(T_TILE, L - t0);
    __syncthreads();   // the previous tile is consumed
    for (int i = threadIdx.x; i < tn * N; i += THREADS) {
      const int tt = i / N;
      const int n = i - tt * N;
      const size_t src = (row0 + t0 + tt) * N + n;
      sB[tt][n] = to_f(Bm[src]);
      sC[tt][n] = to_f(Cm[src]);
    }
    __syncthreads();
    if (live) {
#pragma unroll 4
      for (int tt = 0; tt < tn; ++tt) {
        const size_t off = (row0 + t0 + tt) * dI + d;
        const float dtv = to_f(dt[off]);
        const float dx = dtv * to_f(x[off]);
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < NMAX; ++n) {
          if (n < N) {
            h[n] = expf(dtv * a[n]) * h[n] + dx * sB[tt][n];
            acc += h[n] * sC[tt][n];
          }
        }
        store(y + off, acc);
      }
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < NMAX; ++n)
      if (n < N) hT[state + n] = h[n];
  }
}

template <typename T>
void launch(const void* dt, const void* x, const void* Bm, const void* Cm,
            const void* A, const void* h0, void* y, void* hT, int B, int L,
            int dI, int N, cudaStream_t stream) {
  const dim3 grid((dI + THREADS - 1) / THREADS, B);
  const T* dt_ = (const T*)dt;
  const T* x_ = (const T*)x;
  const T* b_ = (const T*)Bm;
  const T* c_ = (const T*)Cm;
  const float* a_ = (const float*)A;
  const float* h_ = (const float*)h0;
  T* y_ = (T*)y;
  float* hT_ = (float*)hT;
  if (N <= 8)
    selective_scan_kernel<T, 8><<<grid, THREADS, 0, stream>>>(
        dt_, x_, b_, c_, a_, h_, y_, hT_, L, dI, N);
  else if (N <= 16)
    selective_scan_kernel<T, 16><<<grid, THREADS, 0, stream>>>(
        dt_, x_, b_, c_, a_, h_, y_, hT_, L, dI, N);
  else if (N <= 32)
    selective_scan_kernel<T, 32><<<grid, THREADS, 0, stream>>>(
        dt_, x_, b_, c_, a_, h_, y_, hT_, L, dI, N);
  else
    selective_scan_kernel<T, 64><<<grid, THREADS, 0, stream>>>(
        dt_, x_, b_, c_, a_, h_, y_, hT_, L, dI, N);
}

}  // namespace

// bf16 != 0: dt, x, Bm, Cm and y are bf16, else float32.  1 <= N <= 64.
extern "C" int selective_scan_launch(const void* dt, const void* x,
                                     const void* Bm, const void* Cm,
                                     const void* A, const void* h0, void* y,
                                     void* hT, int B, int L, int dI, int N,
                                     int bf16, void* stream) {
  if (N < 1 || N > 64) return (int)cudaErrorInvalidValue;
  if (bf16)
    launch<__nv_bfloat16>(dt, x, Bm, Cm, A, h0, y, hT, B, L, dI, N,
                          (cudaStream_t)stream);
  else
    launch<float>(dt, x, Bm, Cm, A, h0, y, hT, B, L, dI, N,
                  (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
