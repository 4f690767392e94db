// WKV6 recurrence for Hopper (sm_90a), CUDA cores, f32 state.
//
// Replaces the Pallas TPU kernel `repro/kernels/rwkv6.py::wkv6`
// (`_wkv6_kernel`): over r, k [B, S, H, K], v [B, S, H, V] (bf16 or f32,
// one type), w [B, S, H, K] f32, u [H, K] f32 and s0 [B, H, K, V] f32,
//   y_t = r_t^T (S + (u . k_t) v_t^T),   then   S <- w_t . S + k_t v_t^T,
// returning y [B, S, H, V] in v's type and S_final [B, H, K, V] in f32.
//
// What bounds it on this card: operations. Every step does 7 f32 flops on
// each of the K x V state entries of every (b, h) against one read of the
// step's r, k, v, w rows: at B 1, S 6000, H 40, K = V = 64 in f32 that is
// 6.9 GFLOP (0.103 ms at 67 TFLOP/s) against 307 MB (0.092 ms at
// 3.35 TB/s).
//
// Design, one block of 64 threads per (h, b):
// * Column S[:, v] evolves on its own (it needs k, w, u and v_t[v]), and
//   y_t[v] is a sum over K of that column. So thread v holds its column of
//   K f32 values in registers for the whole sequence, and the K-sum needs no
//   shuffles; the state never leaves the SM between steps (the Pallas
//   kernel's VMEM scratch).
// * The step's r, k and w rows (K values each) are shared by all V threads:
//   they are staged in shared memory in chunks of TS steps, read back as
//   broadcast float4 loads. Two buffers: while the block computes chunk c
//   out of one buffer, each thread's loads of chunk c + 1 are in flight into
//   registers, and go to the other buffer afterwards (one __syncthreads per
//   chunk).
// * Any K and V up to 64, K != V allowed: K is padded to KT (16, 32, 48 or
//   64, a template argument, so the column lives in registers) with zero
//   r, k, w, u and s0 rows, which leave the padded state rows at 0 and add
//   nothing to y; threads v >= V only help with the loads.
// * Any S: the last chunk is masked (the Pallas wrapper asserts that its
//   block divides S).
// * The sequence stays sequential (the data-dependent decay w_t forbids a
//   plain matrix form); the chunkwise-parallel form on the tensor cores is
//   later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 64;     // threads per block; V <= NT
constexpr int TS = 16;     // steps per staged chunk
constexpr int VMAX = 64;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int KT>
struct Chunk {
  static constexpr int NK = TS * KT / NT;    // r, k, w values per thread
  static constexpr int NV = TS * VMAX / NT;  // v values per thread
  float r[NK], k[NK], w[NK], v[NV];

  // Load the rows of steps t0 .. t0 + TS - 1 (zero past S, K or V).
  __device__ __forceinline__ void fetch(const T* rp, const T* kp, const T* vp,
                                        const float* wp, int t0, int S, int H,
                                        int K, int V) {
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const int i = j * NT + threadIdx.x;
      const int t = t0 + i / KT;
      const int c = i % KT;
      const bool ok = t < S && c < K;
      const int64_t off = (int64_t)t * H * K + c;
      r[j] = ok ? to_f32(rp[off]) : 0.0f;
      k[j] = ok ? to_f32(kp[off]) : 0.0f;
      w[j] = ok ? wp[off] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = j * NT + threadIdx.x;
      const int t = t0 + i / VMAX;
      const int c = i % VMAX;
      v[j] = (t < S && c < V) ? to_f32(vp[(int64_t)t * H * V + c]) : 0.0f;
    }
  }

  __device__ __forceinline__ void commit(float (*rs)[KT], float (*ks)[KT],
                                         float (*ws)[KT],
                                         float (*vs)[VMAX]) const {
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const int i = j * NT + threadIdx.x;
      rs[i / KT][i % KT] = r[j];
      ks[i / KT][i % KT] = k[j];
      ws[i / KT][i % KT] = w[j];
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = j * NT + threadIdx.x;
      vs[i / VMAX][i % VMAX] = v[j];
    }
  }
};

template <typename T, int KT>
__global__ void __launch_bounds__(NT)
wkv6_fwd(const T* __restrict__ r, const T* __restrict__ k,
         const T* __restrict__ v, const float* __restrict__ w,
         const float* __restrict__ u, const float* __restrict__ s0,
         T* __restrict__ y, float* __restrict__ s_out, int S, int H, int K,
         int V) {
  __shared__ __align__(16) float rs[2][TS][KT];
  __shared__ __align__(16) float ks[2][TS][KT];
  __shared__ __align__(16) float ws[2][TS][KT];
  __shared__ __align__(16) float vs[2][TS][VMAX];
  __shared__ __align__(16) float us[KT];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int col = threadIdx.x;
  const bool live = col < V;

  // row (b, t = 0, h) of r, k, w and of v, y
  const int64_t rk0 = ((int64_t)b * S * H + h) * K;
  const int64_t v0 = ((int64_t)b * S * H + h) * V;
  const int64_t st0 = ((int64_t)b * H + h) * K * V;

  for (int i = col; i < KT; i += NT) us[i] = i < K ? u[h * K + i] : 0.0f;

  float state[KT];
#pragma unroll
  for (int i = 0; i < KT; ++i)
    state[i] = (live && i < K) ? s0[st0 + (int64_t)i * V + col] : 0.0f;

  Chunk<T, KT> next;
  next.fetch(r + rk0, k + rk0, v + v0, w + rk0, 0, S, H, K, V);
  next.commit(rs[0], ks[0], ws[0], vs[0]);
  __syncthreads();

  for (int t0 = 0, buf = 0; t0 < S; t0 += TS, buf ^= 1) {
    const bool more = t0 + TS < S;
    if (more) next.fetch(r + rk0, k + rk0, v + v0, w + rk0, t0 + TS, S, H, K, V);
    if (live) {
      const int steps = min(TS, S - t0);
      for (int tt = 0; tt < steps; ++tt) {
        const float vv = vs[buf][tt][col];
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int i = 0; i < KT; i += 4) {
          const float4 r4 = *reinterpret_cast<const float4*>(&rs[buf][tt][i]);
          const float4 k4 = *reinterpret_cast<const float4*>(&ks[buf][tt][i]);
          const float4 w4 = *reinterpret_cast<const float4*>(&ws[buf][tt][i]);
          const float4 u4 = *reinterpret_cast<const float4*>(&us[i]);
          const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
          const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
          const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
          const float uu[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float kv = kk[j] * vv;
            acc[j] += rr[j] * (state[i + j] + uu[j] * kv);
            state[i + j] = ww[j] * state[i + j] + kv;
          }
        }
        store(y + v0 + (int64_t)(t0 + tt) * H * V + col,
              (acc[0] + acc[1]) + (acc[2] + acc[3]));
      }
    }
    if (more) next.commit(rs[buf ^ 1], ks[buf ^ 1], ws[buf ^ 1], vs[buf ^ 1]);
    __syncthreads();
  }

  if (live) {
#pragma unroll
    for (int i = 0; i < KT; ++i)
      if (i < K) s_out[st0 + (int64_t)i * V + col] = state[i];
  }
}

template <typename T, int KT>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* y, void* s_out, int B, int S,
           int H, int K, int V, cudaStream_t stream) {
  const dim3 grid(H, B);
  wkv6_fwd<T, KT><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(y), static_cast<float*>(s_out), S, H, K, V);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_k(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* s0, void* y, void* s_out, int B,
             int S, int H, int K, int V, cudaStream_t stream) {
  if (K <= 16) return launch<T, 16>(r, k, v, w, u, s0, y, s_out, B, S, H, K, V, stream);
  if (K <= 32) return launch<T, 32>(r, k, v, w, u, s0, y, s_out, B, S, H, K, V, stream);
  if (K <= 48) return launch<T, 48>(r, k, v, w, u, s0, y, s_out, B, S, H, K, V, stream);
  return launch<T, 64>(r, k, v, w, u, s0, y, s_out, B, S, H, K, V, stream);
}

}  // namespace

// r, k, w [B, S, H, K]; v and y [B, S, H, V]; u [H, K]; s0 and s_out
// [B, H, K, V]; all contiguous. r, k, v, y of one type (is_bf16: bf16, else
// f32), w, u, s0, s_out f32. 1 <= K, V <= 64; S >= 0.
// Returns the CUDA error of the launch (0 when it was accepted).
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* s0,
                           void* y, void* s_out, int is_bf16, int B, int S,
                           int H, int K, int V, void* stream) {
  if (B <= 0 || H <= 0 || S < 0 || K <= 0 || V <= 0 || K > 64 || V > VMAX ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_k<__nv_bfloat16>(r, k, v, w, u, s0, y, s_out, B, S, H, K, V, s);
  return launch_k<float>(r, k, v, w, u, s0, y, s_out, B, S, H, K, V, s);
}
