// Neighborhood search and IDM acceleration for Hopper (sm_90a).
//
// Two kernels behind a plain C interface (loaded with ctypes by
// repro_torch/kernels/idm.py). Each C entry launches on the caller's stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError().
//
// Built without --use_fast_math: the neighbor contract is bit-exact, and
// its arithmetic is one f32 subtraction plus comparisons per pair.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;      // egos per block = other-vehicle tile width
constexpr float kInf = 1e9f;     // INF of the reference

// ---------------------------------------------------------------------------
// neighbor_mq: replaces repro/kernels/idm.py::neighbor_kernel
// (_neighbor_mq_kernel, the Pallas multi-query lead+follower search).
//
// For every (instance b, query row q, ego i): the argmin over active
// vehicles j with lane[b,j] == query_lanes[b,q,i] strictly ahead and
// strictly behind; bumper-to-bumper gaps; lowest j wins ties; absent
// neighbours give (0, INF - veh_len, false); inactive egos have none.
//
// Bound on an H100 SXM: B*Q*N^2 pair tests. Per pair that shares the query
// lane it does one f32 subtraction and two compares (67 TFLOP/s f32 peak);
// it must read pos/lane/active [B,N] and query_lanes [B,Q,N] once and write
// 18 bytes per (b,q,i) at 3.35 TB/s. At the sweep's shapes (N = 128) the
// bytes bound it.
//
// Design (first, simple form): one thread per (b, q, i); grid
// (ceil(N/128), Q, B). Each block stages instance b's pos/lane/active in
// shared memory one 128-wide tile at a time; the running (gap, idx) minima
// of both directions stay in registers. j is walked in increasing order
// with a strict < update, so the lowest index wins ties exactly as the
// reference's first-argmin does. The ragged edge is masked, no padding.
// Later work: stage the whole instance once per block and share it across
// the Q rows, warp-level early exits per lane, several egos per thread.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kBlock)
neighbor_mq_kernel(const float* __restrict__ pos, const int32_t* __restrict__ lane,
                   const uint8_t* __restrict__ active,
                   const int32_t* __restrict__ query_lanes, int Q, int N,
                   float veh_len, int32_t* __restrict__ lead_idx,
                   float* __restrict__ lead_gap, uint8_t* __restrict__ has_lead,
                   int32_t* __restrict__ foll_idx, float* __restrict__ foll_gap,
                   uint8_t* __restrict__ has_foll) {
  __shared__ float s_pos[kBlock];
  __shared__ int32_t s_lane[kBlock];
  __shared__ uint8_t s_act[kBlock];

  const int b = blockIdx.z;
  const int q = blockIdx.y;
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool valid = i < N;
  const size_t row = static_cast<size_t>(b) * N;
  const size_t out = (static_cast<size_t>(b) * Q + q) * N + i;

  const float my_pos = valid ? pos[row + i] : 0.f;
  const bool my_act = valid && active[row + i] != 0;
  const int32_t my_q = valid ? query_lanes[out] : 0;

  float lg = kInf, fg = kInf;
  int32_t li = 0, fi = 0;
  for (int j0 = 0; j0 < N; j0 += kBlock) {
    const int j = j0 + threadIdx.x;
    if (j < N) {
      s_pos[threadIdx.x] = pos[row + j];
      s_lane[threadIdx.x] = lane[row + j];
      s_act[threadIdx.x] = active[row + j];
    }
    __syncthreads();
    const int jn = min(kBlock, N - j0);
    if (my_act) {
      for (int t = 0; t < jn; ++t) {
        if (s_act[t] && s_lane[t] == my_q) {
          const float d = s_pos[t] - my_pos;
          if (d > 0.f) {
            if (d < lg) { lg = d; li = j0 + t; }
          } else if (d < 0.f) {
            const float nd = -d;
            if (nd < fg) { fg = nd; fi = j0 + t; }
          }
        }
      }
    }
    __syncthreads();
  }
  if (valid) {
    const bool hl = lg < 0.5f * kInf;
    const bool hf = fg < 0.5f * kInf;
    lead_idx[out] = hl ? li : 0;
    lead_gap[out] = __fsub_rn(lg, veh_len);
    has_lead[out] = hl;
    foll_idx[out] = hf ? fi : 0;
    foll_gap[out] = __fsub_rn(fg, veh_len);
    has_foll[out] = hf;
  }
}

// ---------------------------------------------------------------------------
// idm_accel: replaces repro/kernels/idm.py::idm_accel_kernel (_idm_kernel).
//
// The same-lane lead search of neighbor_mq (lead only, query lane = own
// lane) carrying the lead's velocity, fused with the IDM epilogue of
// repro/kernels/idm.py:74-92. Bound on an H100 SXM: B*N^2 pair tests, and
// nine [B,N] inputs read once plus one f32 [B,N] output at 3.35 TB/s.
// The epilogue uses the _rn intrinsics so that nvcc does not contract it
// into fused multiply-adds: each operation rounds as the plain PyTorch
// version's separate element-wise operations do. First, simple form, with
// the same shared-memory tiling as neighbor_mq.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kBlock)
idm_accel_kernel(const float* __restrict__ pos, const float* __restrict__ vel,
                 const int32_t* __restrict__ lane, const uint8_t* __restrict__ active,
                 const float* __restrict__ v0, const float* __restrict__ T,
                 const float* __restrict__ a_max, const float* __restrict__ b_comf,
                 const float* __restrict__ s0, int N, float veh_len,
                 float* __restrict__ acc) {
  __shared__ float s_pos[kBlock];
  __shared__ float s_vel[kBlock];
  __shared__ int32_t s_lane[kBlock];
  __shared__ uint8_t s_act[kBlock];

  const int b = blockIdx.y;
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool valid = i < N;
  const size_t row = static_cast<size_t>(b) * N;

  const float my_pos = valid ? pos[row + i] : 0.f;
  const bool my_act = valid && active[row + i] != 0;
  const int32_t my_lane = valid ? lane[row + i] : 0;

  float lg = kInf, vlead = 0.f;
  for (int j0 = 0; j0 < N; j0 += kBlock) {
    const int j = j0 + threadIdx.x;
    if (j < N) {
      s_pos[threadIdx.x] = pos[row + j];
      s_vel[threadIdx.x] = vel[row + j];
      s_lane[threadIdx.x] = lane[row + j];
      s_act[threadIdx.x] = active[row + j];
    }
    __syncthreads();
    const int jn = min(kBlock, N - j0);
    if (my_act) {
      for (int t = 0; t < jn; ++t) {
        if (s_act[t] && s_lane[t] == my_lane) {
          const float d = s_pos[t] - my_pos;
          if (d > 0.f && d < lg) { lg = d; vlead = s_vel[t]; }
        }
      }
    }
    __syncthreads();
  }
  if (!valid) return;
  const float v = vel[row + i];
  const float am = a_max[row + i];
  const bool has = lg < 0.5f * kInf;
  const float gap = fmaxf(has ? __fsub_rn(lg, veh_len) : kInf, 0.1f);
  const float dv = has ? __fsub_rn(v, vlead) : 0.f;
  const float denom = __fmul_rn(2.0f, __fsqrt_rn(__fmul_rn(am, b_comf[row + i])));
  const float push = __fadd_rn(__fmul_rn(v, T[row + i]),
                               __fdiv_rn(__fmul_rn(v, dv), denom));
  const float s_star = __fadd_rn(s0[row + i], fmaxf(0.f, push));
  const float r = __fdiv_rn(v, fmaxf(v0[row + i], 0.1f));
  const float r2 = __fmul_rn(r, r);
  const float g = __fdiv_rn(s_star, gap);
  acc[row + i] = __fmul_rn(am, __fsub_rn(__fsub_rn(1.0f, __fmul_rn(r2, r2)),
                                         __fmul_rn(g, g)));
}

}  // namespace

extern "C" {

int neighbor_mq_launch(const void* pos, const void* lane, const void* active,
                       const void* query_lanes, int B, int Q, int N,
                       float veh_len, void* lead_idx, void* lead_gap,
                       void* has_lead, void* foll_idx, void* foll_gap,
                       void* has_foll, void* stream) {
  if (B == 0 || Q == 0 || N == 0) return 0;
  const dim3 grid((N + kBlock - 1) / kBlock, Q, B);
  neighbor_mq_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), static_cast<const int32_t*>(lane),
      static_cast<const uint8_t*>(active),
      static_cast<const int32_t*>(query_lanes), Q, N, veh_len,
      static_cast<int32_t*>(lead_idx), static_cast<float*>(lead_gap),
      static_cast<uint8_t*>(has_lead), static_cast<int32_t*>(foll_idx),
      static_cast<float*>(foll_gap), static_cast<uint8_t*>(has_foll));
  return static_cast<int>(cudaGetLastError());
}

int idm_accel_launch(const void* pos, const void* vel, const void* lane,
                     const void* active, const void* v0, const void* T,
                     const void* a_max, const void* b_comf, const void* s0,
                     int B, int N, float veh_len, void* acc, void* stream) {
  if (B == 0 || N == 0) return 0;
  const dim3 grid((N + kBlock - 1) / kBlock, B);
  idm_accel_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), static_cast<const float*>(vel),
      static_cast<const int32_t*>(lane), static_cast<const uint8_t*>(active),
      static_cast<const float*>(v0), static_cast<const float*>(T),
      static_cast<const float*>(a_max), static_cast<const float*>(b_comf),
      static_cast<const float*>(s0), N, veh_len, static_cast<float*>(acc));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
