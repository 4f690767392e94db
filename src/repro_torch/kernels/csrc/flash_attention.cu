// Flash attention forward for Hopper (sm_90a), CUDA cores, f32 arithmetic.
//
// Replaces the Pallas TPU kernel `repro/kernels/flash_attention.py::
// flash_attention` (`_flash_kernel`): online-softmax attention over
//   q [B, Sq, H, D], k and v [B, Sk, K, D] (contiguous, bf16 or f32)
// with GQA (query head h reads kv head h / (H / K)), causal masking aligned
// to the end (query i sits at position i + Sk - Sq), a sliding window
// (q_pos - k_pos < window), the Gemma-2 logit softcap cap * tanh(s / cap),
// and the finite mask value -2^30. Scores, the running max m, the running
// sum l, p, v and the accumulator are f32, as in the Pallas kernel; the
// output is acc / max(l, 1e-30) in q's type. Key tiles that are fully
// masked for every query row of a block are never visited, so a local
// layer costs O(Sq * window), not O(Sq * Sk).
//
// What bounds it on this card: at the serving shapes it is operation-bound
// (4 * D flops per live (query, key) pair per head against bytes that are
// read once), and this first version does its products on the CUDA cores
// in f32 out of shared memory, so it sits far below the tensor-core bound.
// A wgmma/TMA redesign is later work.
//
// Design, one block per (64 query rows, head, batch row), 256 threads:
// * Four threads own one query row. Each computes 8 of the 32 scores of a
//   key tile for that row, so the row max and row sum of the online
//   softmax are two xor-shuffles inside the four-lane group, and p is
//   handed to the P.V product by shuffles too: no score tile in shared
//   memory.
// * The f32 accumulator of a 64 x D tile is split over the four threads of
//   a row: D / 4 floats each (64 at D = 256), in registers.
// * q (64 x D), k and v (32 x D each) tiles live in dynamic shared memory
//   in the input type, each row padded by 16 bytes against bank conflicts:
//   at D = 256 that is 67,584 bytes in bf16 and 133,120 bytes in f32,
//   above the 48 KB static limit, hence cudaFuncSetAttribute.
// * Ragged edges are masked, not padded: rows past Sq are computed and
//   never stored, keys past Sk get the mask value (their k and v are
//   zero-filled), so any Sq and Sk work (the Pallas wrapper asserts
//   divisibility by its block sizes).
// * No fast-math: expf and tanhf are the accurate library functions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;                     // query rows per block
constexpr int BK = 32;                     // keys per tile
constexpr int THREADS = 256;               // four threads per query row
constexpr int SPT = BK / 4;                // scores per thread per tile
constexpr float NEG_INF = -1073741824.0f;  // -2^30, as the Pallas kernel
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) =
      __halves2bfloat162(__float2bfloat16_rn(a), __float2bfloat16_rn(b));
}

// Copy `rows` rows of D elements (global row stride `gstride` elements)
// into shared memory with row stride LD; rows at or past `nvalid` are
// zero-filled. 16-byte vector accesses: D * sizeof(T) is a multiple of 16.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int rows,
                                          int nvalid, int64_t gstride) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = D / VEC;
  constexpr int LD = D + VEC;
  for (int i = threadIdx.x; i < rows * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < nvalid) val = *reinterpret_cast<const uint4*>(src + r * gstride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk, int H,
          int KH, int causal, int window, float softcap, float scale) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int LD = D + VEC;
  constexpr int PAIRS = D / 8;  // accumulator column pairs per thread
  extern __shared__ uint4 smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + BQ * LD;
  T* Vs = Ks + BK * LD;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row = tid >> 2;  // query row of this thread in the tile
  const int sub = tid & 3;   // its quarter of the row's scores and columns
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int offset = Sk - Sq;
  const int nq = min(BQ, Sq - q0);
  const int64_t q_stride = (int64_t)H * D;
  const int64_t kv_stride = (int64_t)KH * D;

  load_tile<T, D>(Qs, q + (((int64_t)b * Sq + q0) * H + h) * D, BQ, nq,
                  q_stride);

  // keys that any row of this block may see; tiles outside are skipped
  const int first_q = q0 + offset;
  const int last_q = q0 + nq - 1 + offset;
  const int k_end = causal ? min(Sk, last_q + 1) : Sk;
  const int k_begin = window > 0 ? max(0, first_q - window + 1) : 0;
  const int qpos = q0 + row + offset;

  float m_run = NEG_INF;
  float l_run = 0.f;
  float acc[2 * PAIRS];
#pragma unroll
  for (int i = 0; i < 2 * PAIRS; ++i) acc[i] = 0.f;

  const T* k_base = k + ((int64_t)b * Sk * KH + kh) * D;
  const T* v_base = v + ((int64_t)b * Sk * KH + kh) * D;
  for (int k0 = k_begin / BK * BK; k0 < k_end; k0 += BK) {
    const int nk = min(BK, Sk - k0);
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(Ks, k_base + k0 * kv_stride, BK, nk, kv_stride);
    load_tile<T, D>(Vs, v_base + k0 * kv_stride, BK, nk, kv_stride);
    __syncthreads();

    // s = q . k for keys sub, sub + 4, ..., sub + 28 of the tile
    float s[SPT];
#pragma unroll
    for (int j = 0; j < SPT; ++j) s[j] = 0.f;
    const T* qrow = Qs + row * LD;
#pragma unroll 4
    for (int d = 0; d < D; d += 2) {
      const float2 qv = load2(qrow + d);
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const float2 kv = load2(Ks + (sub + 4 * j) * LD + d);
        s[j] = fmaf(qv.x, kv.x, s[j]);
        s[j] = fmaf(qv.y, kv.y, s[j]);
      }
    }

    // scale, softcap, mask; the tile's row max over the four lanes
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      float x = s[j] * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      const int kpos = k0 + sub + 4 * j;
      bool ok = kpos < Sk;
      if (causal) ok = ok && qpos >= kpos;
      if (window > 0) ok = ok && qpos - kpos < window;
      s[j] = ok ? x : NEG_INF;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    psum += __shfl_xor_sync(FULL, psum, 1);
    psum += __shfl_xor_sync(FULL, psum, 2);
    l_run = l_run * alpha + psum;
    m_run = m_new;

    // acc = acc * alpha + p . v over this thread's column pairs
    // (columns 8 i + 2 sub and 8 i + 2 sub + 1)
#pragma unroll
    for (int i = 0; i < 2 * PAIRS; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
#pragma unroll
      for (int src = 0; src < 4; ++src) {
        const float p = __shfl_sync(FULL, s[j], (lane & ~3) | src);
        const T* vrow = Vs + (src + 4 * j) * LD + 2 * sub;
#pragma unroll
        for (int i = 0; i < PAIRS; ++i) {
          const float2 vv = load2(vrow + 8 * i);
          acc[2 * i] = fmaf(p, vv.x, acc[2 * i]);
          acc[2 * i + 1] = fmaf(p, vv.y, acc[2 * i + 1]);
        }
      }
    }
  }

  // normalise into the q tile's shared memory, then store whole rows
  __syncthreads();
  const float l_safe = fmaxf(l_run, 1e-30f);
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) {
    store2(Qs + row * LD + 8 * i + 2 * sub, acc[2 * i] / l_safe,
           acc[2 * i + 1] / l_safe);
  }
  __syncthreads();
  constexpr int PER_ROW = D / VEC;
  T* ob = o + (((int64_t)b * Sq + q0) * H + h) * D;
  for (int i = tid; i < nq * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * VEC;
    *reinterpret_cast<uint4*>(ob + r * q_stride + c) =
        *reinterpret_cast<const uint4*>(Qs + r * LD + c);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int KH, int causal, int window,
           float softcap, float scale, cudaStream_t stream) {
  constexpr int LD = D + 16 / sizeof(T);
  const int smem = (BQ + 2 * BK) * LD * (int)sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, KH, causal,
      window, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* o,
             int B, int Sq, int Sk, int H, int KH, int causal, int window,
             float softcap, float scale, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Sk, H, KH, causal, window, softcap, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Sk, H, KH, causal, window, softcap, scale, stream);
    case 256: return launch<T, 256>(q, k, v, o, B, Sq, Sk, H, KH, causal, window, softcap, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, Sq, H, D], k/v [B, Sk, KH, D], o [B, Sq, H, D], all contiguous and
// of one type (is_bf16: bf16, else f32); D in {64, 128, 256}, the head
// dims of the Pallas kernel's block table.
// Returns the CUDA error of the launch (0 when it was accepted).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int is_bf16,
                                      int B, int Sq, int Sk, int H, int KH,
                                      int D, int causal, int window,
                                      float softcap, float scale,
                                      void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KH <= 0 || H % KH != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_d<__nv_bfloat16>(D, q, k, v, o, B, Sq, Sk, H, KH, causal,
                                   window, softcap, scale, s);
  return launch_d<float>(D, q, k, v, o, B, Sq, Sk, H, KH, causal, window,
                         softcap, scale, s);
}
