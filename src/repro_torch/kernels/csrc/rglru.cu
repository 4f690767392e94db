// RG-LRU linear recurrence for Hopper (sm_90a), CUDA cores, f32 state.
//
// Replaces the Pallas TPU kernel `repro/kernels/rglru.py::rglru_linear_scan`
// (`_rglru_kernel`):
//   h_t = a_t * h_{t-1} + x_t   over   a [B, S, W] f32, x [B, S, W] (bf16 or
//   f32), h0 [B, W] f32,
// returning ys [B, S, W] in x's type and h_final [B, W] in f32. The step is
// one f32 multiply and one f32 add, each rounded on its own (__fmul_rn,
// __fadd_rn: no contraction into a fused multiply-add), as the plain version
// computes it.
//
// What bounds it on this card: bytes. Each element of a and x is read once
// and each of ys written once, against two flops: at B 1, S 6000, W 2560 in
// f32 that is 184 MB, 0.055 ms at 3.35 TB/s.
//
// Design: one thread per (b, w) lane, a loop over S that carries h in a
// register; all W lanes of a row advance in parallel (the Pallas kernel's
// VPU shape). The loads of a_t and x_t do not depend on h, so the loop runs
// over chunks of CHUNK steps and issues the next chunk's loads (into
// registers) before it computes the current one: about 2 * CHUNK loads per
// thread stay in flight while the dependent chain of the current chunk runs.
// 32 threads a block (one warp of consecutive w, 128-byte coalesced rows), so
// a B 1, W 2560 scan spreads over 80 SMs. Any S and W: the ragged ends of
// both axes are masked (the Pallas wrapper asserts that its blocks divide
// them). The sequence axis stays sequential within a thread: the two-pass
// chunked scan that would use the whole card is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 32;
constexpr int CHUNK = 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ void load_chunk(const float* a, const T* x, int t0,
                                           int S, int64_t W, float* ca,
                                           float* cx) {
#pragma unroll
  for (int u = 0; u < CHUNK; ++u) {
    const int t = t0 + u;
    if (t < S) {
      ca[u] = a[t * W];
      cx[u] = to_f32(x[t * W]);
    } else {
      ca[u] = 0.0f;
      cx[u] = 0.0f;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rglru_scan(const float* __restrict__ a, const T* __restrict__ x,
           const float* __restrict__ h0, T* __restrict__ ys,
           float* __restrict__ h_out, int S, int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (w >= W) return;
  const int64_t base = (int64_t)b * S * W + w;
  const float* ap = a + base;
  const T* xp = x + base;
  T* yp = ys + base;
  float h = h0[(int64_t)b * W + w];

  float ca[CHUNK], cx[CHUNK], na[CHUNK], nx[CHUNK];
  load_chunk(ap, xp, 0, S, W, ca, cx);
  for (int t0 = 0; t0 < S; t0 += CHUNK) {
    if (t0 + CHUNK < S) load_chunk(ap, xp, t0 + CHUNK, S, W, na, nx);
#pragma unroll
    for (int u = 0; u < CHUNK; ++u) {
      if (t0 + u < S) {
        h = __fadd_rn(__fmul_rn(ca[u], h), cx[u]);
        store(yp + (int64_t)(t0 + u) * W, h);
      }
    }
#pragma unroll
    for (int u = 0; u < CHUNK; ++u) {
      ca[u] = na[u];
      cx[u] = nx[u];
    }
  }
  h_out[(int64_t)b * W + w] = h;
}

template <typename T>
int launch(const void* a, const void* x, const void* h0, void* ys, void* h_out,
           int B, int S, int W, cudaStream_t stream) {
  const dim3 grid((W + THREADS - 1) / THREADS, B);
  rglru_scan<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(a), static_cast<const T*>(x),
      static_cast<const float*>(h0), static_cast<T*>(ys),
      static_cast<float*>(h_out), S, W);
  return (int)cudaGetLastError();
}

}  // namespace

// a [B, S, W] f32, x and ys [B, S, W] of one type (is_bf16: bf16, else f32),
// h0 and h_out [B, W] f32, all contiguous; S >= 0, B and W > 0.
// Returns the CUDA error of the launch (0 when it was accepted).
extern "C" int rglru_linear_scan_launch(const void* a, const void* x,
                                        const void* h0, void* ys, void* h_out,
                                        int is_bf16, int B, int S, int W,
                                        void* stream) {
  if (B <= 0 || W <= 0 || S < 0 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(a, x, h0, ys, h_out, B, S, W, s);
  return launch<float>(a, x, h0, ys, h_out, B, S, W, s);
}
