// RG-LRU linear recurrence for Hopper (sm_90a): a chunked scan whose chunks
// pass their states on by a decoupled look-back, in one launch.
//
// Replaces the Pallas TPU kernel `repro/kernels/rglru.py::rglru_linear_scan`
// (`_rglru_kernel`):
//   h_t = a_t * h_{t-1} + x_t   over   a [B, S, W] f32, x [B, S, W] (bf16 or
//   f32), h0 [B, W] f32,
// returning ys [B, S, W] in x's type and h_final [B, W] in f32, for any
// S >= 0, B, W > 0 and any a (0 and 1 included).
//
// What bounds it on this card: bytes. Each element of a and x is read once
// and each of ys written once, against two flops: at B 1, S 6000, W 2560 in
// f32 that is 184 MB, 0.055 ms at 3.35 TB/s. A thread that walks all of S
// for one lane keeps too few bytes in flight (the card holds only B W such
// chains); so the sequence is cut into chunks that run side by side.
//
// Design: a block of 128 threads takes T steps (one chunk) x 128 lanes, one
// lane a thread. The tile of a and x goes to shared memory first, by
// 16-byte cp.async copies where the rows are aligned and the lane tile
// whole (else value by value); past S, a is 1 and x is 0, which leaves
// every product and sum unchanged. Blocks take their tiles from a counter
// in launch order (chunk-major: all lane tiles of chunk c before chunk
// c + 1), so every tile a block waits for belongs to a block that started
// earlier and the waits end. Per lane, with every product and sum rounded
// on its own (__fmul_rn, __fadd_rn: no fused multiply-add):
//   1. from a zero state, the chunk's aggregate: P = prod a_t and L, the
//      state the chunk reaches from 0 (L <- a_t L + x_t); published at once;
//   2. the carry (the state before the chunk) by a look-back over the
//      chunks before it, newest first: acc <- acc + ap L_j, ap <- ap P_j,
//      until a chunk whose inclusive state H_j is published (or h0 before
//      chunk 0); carry = acc + ap H_j. Then H_c = P carry + L is published.
//      Lane r of a warp reads the flag of the r-th chunk back, so one trip
//      covers 32 chunks, and a ballot finds the first inclusive one;
//   3. the chunk again from the carry, h <- a_t h + x_t, writing ys; the
//      last chunk writes its h as h_final.
// T is 64 (the wrapper's rglru.CHUNK): at the main shape 16, 32 and 128
// were slower (PERF.md), and 256 steps of tile exceed a block's shared
// memory. A trial build that kept the tile in registers needed 255
// registers at T 64 (two blocks an SM, with spills) and was slower.
// Products only (no log, no division): a = 0 gives the exact 0 of the
// recurrence and a = 1 the exact sum. The carries are composed, so ys are
// not bit-equal to the sequential recurrence (within f32's 1e-5).
// Flags (0, AGG, INCL; lookback.cuh) are per (b, chunk, 32-lane warp
// tile), written by lane 0 after the warp's values and a __threadfence.
// Scratch, from the wrapper: 3 f32 per (b, chunk, lane) (P, L, H), one int
// flag per (b, chunk, warp tile) and the counter: at B 1, S 6000, W 2560,
// T 64 that is 94 x 2560 x 3 f32 + 94 x 80 + 1 ints, 2.9 MB; the C entry
// zeroes the flags and the counter with rglru_chunk_clear, then launches
// rglru_chunk. Shared memory a block: T x 128 x (4 + sizeof(x)) bytes,
// 64 KB in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lookback.cuh"  // the flags and the clear

namespace {

constexpr int THREADS = 128;  // lanes a block
constexpr int T = 64;         // steps a block (one chunk)
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct Scratch {
  float* agg_p;  // [B, NC, W]
  float* agg_l;  // [B, NC, W]
  float* incl;   // [B, NC, W]
  int* flag;     // [B, NC, ceil(W / 32)]
  int* ticket;
};

// The carry into chunk c of lane w: the look-back over the chunks before
// it, newest first, 32 a round: lane r of the warp reads the flag of chunk
// j - r, the warp waits until every chunk before the first inclusive one
// has published its aggregate, then each lane folds those aggregates of its
// own w (acc <- acc + ap L_j, ap <- ap P_j; their loads 8 at a time) and
// ends at the inclusive state H (or h0 before chunk 0):
// carry = acc + ap H.
__device__ __forceinline__ float look_back(const Scratch& sc,
                                          const int* flags, int nwt,
                                          const float* __restrict__ h0,
                                          int64_t b, int NC, int W, int w,
                                          bool valid, int c, int lane) {
  float acc = 0.0f, ap = 1.0f;
  for (int j = c - 1;; j -= 32) {
    const int jr = j - lane;
    const int* fp = flags + static_cast<int64_t>(max(jr, 0)) * nwt;
    int f = jr < 0 ? INCL : ld_flag(fp);
    unsigned incl;
    for (unsigned spins = 0;; ++spins) {
      incl = __ballot_sync(FULL, f == INCL);
      const unsigned need = incl ? (incl & (0u - incl)) - 1u : FULL;
      if (!__any_sync(FULL, f == 0 && ((need >> lane) & 1u))) break;
      if (spins == kMaxSpins) __trap();  // never: a lost chunk
      if (f == 0) {
        __nanosleep(64);
        f = ld_flag(fp);
      }
    }
    __threadfence();  // what the flags published is read after them
    const int r_end = incl ? __ffs(incl) - 1 : 32;  // the inclusive one
    const int jb = j - r_end;
    float base = 0.0f;
    if (r_end < 32 && valid)
      base = jb < 0 ? h0[b * W + w] : __ldcg(&sc.incl[(b * NC + jb) * W + w]);
    for (int r0 = 0; r0 < r_end; r0 += 8) {
      float vp[8], vl[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        vp[u] = 1.0f;
        vl[u] = 0.0f;
        if (valid && r0 + u < r_end) {
          const int64_t sj = (b * NC + j - r0 - u) * W + w;
          vp[u] = __ldcg(&sc.agg_p[sj]);
          vl[u] = __ldcg(&sc.agg_l[sj]);
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (r0 + u < r_end) {
          acc = __fadd_rn(acc, __fmul_rn(ap, vl[u]));
          ap = __fmul_rn(ap, vp[u]);
        }
      }
    }
    if (r_end < 32) return __fadd_rn(acc, __fmul_rn(ap, base));
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// Clears the flags and the counter of one call.
__global__ void rglru_chunk_clear(int* __restrict__ flag, int64_t n) {
  clear_flags(flag, n);
}

template <typename X>
__global__ void __launch_bounds__(THREADS)
rglru_chunk(const float* __restrict__ a, const X* __restrict__ x,
            const float* __restrict__ h0, X* __restrict__ ys,
            float* __restrict__ h_out, Scratch sc, int S, int W, int NC,
            int NLT, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_a = reinterpret_cast<float*>(smem);           // [T][THREADS]
  X* s_x = reinterpret_cast<X*>(s_a + T * THREADS);      // [T][THREADS]
  __shared__ int s_ticket;
  const int tid = threadIdx.x;
  if (tid == 0) s_ticket = atomicAdd(sc.ticket, 1);
  __syncthreads();
  const int ticket = s_ticket;
  const int lt = ticket % NLT;
  const int64_t bc = ticket / NLT;  // b * NC + c
  const int c = static_cast<int>(bc % NC);
  const int64_t b = bc / NC;
  const int lane = tid % 32;
  const int w0 = lt * THREADS;
  const int w = w0 + tid;
  const bool valid = w < W;
  const int nwt = (W + 31) / 32;
  const int c0 = c * T;
  const int rows = max(0, min(T, S - c0));
  const int64_t base = (b * S + c0) * W;  // row 0 of the tile, lane 0

  // the tile into shared memory: 16-byte copies where the rows allow
  // them, else element by element; past S, a is 1 and x is 0
  if (vec && w0 + THREADS <= W) {
    constexpr int VA = THREADS / 4, VX = THREADS * sizeof(X) / 16;
    for (int v = tid; v < rows * VA; v += THREADS) {
      const int t = v / VA, col = (v % VA) * 4;
      cp_async16(&s_a[t * THREADS + col], a + base + (int64_t)t * W + w0 + col);
    }
    for (int v = tid; v < rows * VX; v += THREADS) {
      const int t = v / VX, col = (v % VX) * (16 / sizeof(X));
      cp_async16(&s_x[t * THREADS + col], x + base + (int64_t)t * W + w0 + col);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  } else if (valid) {
    for (int t = 0; t < rows; ++t) {
      s_a[t * THREADS + tid] = a[base + (int64_t)t * W + w];
      s_x[t * THREADS + tid] = x[base + (int64_t)t * W + w];
    }
  }
  for (int t = rows; t < T; ++t) {
    s_a[t * THREADS + tid] = 1.0f;
    s_x[t * THREADS + tid] = X(0.0f);
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  if (w - lane >= W) return;  // the whole warp lies past W

  // 1. the aggregate, published at once
  float P = 1.0f, L = 0.0f;
#pragma unroll 16
  for (int t = 0; t < T; ++t) {
    const float at = s_a[t * THREADS + tid];
    P = __fmul_rn(at, P);
    L = __fadd_rn(__fmul_rn(at, L), to_f32(s_x[t * THREADS + tid]));
  }
  const int64_t slot = bc * W + w;
  const int* flags = sc.flag + b * NC * nwt + w / 32;  // chunk j: [j * nwt]
  int* own_flag = sc.flag + bc * nwt + w / 32;
  if (c < NC - 1) {
    if (valid) {
      __stcg(&sc.agg_p[slot], P);
      __stcg(&sc.agg_l[slot], L);
    }
    __threadfence();
    __syncwarp();
    if (lane == 0) set_flag(own_flag, AGG);
  }

  // 2. the carry, by the look-back; then the inclusive state
  const float carry =
      look_back(sc, flags, nwt, h0, b, NC, W, w, valid, c, lane);
  if (c < NC - 1) {
    if (valid) __stcg(&sc.incl[slot], __fadd_rn(__fmul_rn(P, carry), L));
    __threadfence();
    __syncwarp();
    if (lane == 0) set_flag(own_flag, INCL);
  }

  // 3. the chunk again from the carry
  float h = carry;
  X* yp = ys + base + w;
#pragma unroll 16
  for (int t = 0; t < T; ++t) {
    h = __fadd_rn(__fmul_rn(s_a[t * THREADS + tid], h),
                  to_f32(s_x[t * THREADS + tid]));
    if (valid && t < rows) store(yp + (int64_t)t * W, h);
  }
  if (c == NC - 1 && valid) h_out[b * W + w] = h;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename X>
int launch(const void* a, const void* x, const void* h0, void* ys, void* h_out,
           void* scratch, int B, int S, int W, cudaStream_t stream) {
  const int NC = S > 0 ? (S + T - 1) / T : 1;  // S 0: one empty chunk
  const int NLT = (W + THREADS - 1) / THREADS;
  const int64_t blocks = static_cast<int64_t>(B) * NC * NLT;
  const int64_t n = static_cast<int64_t>(B) * NC * W;
  const int64_t n_flags = static_cast<int64_t>(B) * NC * ((W + 31) / 32);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  float* f = static_cast<float*>(scratch);
  int* flags = reinterpret_cast<int*>(f + 3 * n);
  const Scratch sc{f, f + n, f + 2 * n, flags, flags + n_flags};
  // 16-byte copies: every row of a and x starts on a 16-byte boundary
  const int vec = W % (16 / sizeof(X)) == 0 && W % 4 == 0 && aligned16(a) &&
                  aligned16(x);
  const size_t smem = static_cast<size_t>(T) * THREADS * (4 + sizeof(X));
  rglru_chunk_clear<<<clear_blocks(n_flags, THREADS), THREADS, 0, stream>>>(
      flags, n_flags);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess && smem > 32 * 1024)  // with the static ticket
    err = cudaFuncSetAttribute(rglru_chunk<X>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  rglru_chunk<X><<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      static_cast<const float*>(a), static_cast<const X*>(x),
      static_cast<const float*>(h0), static_cast<X*>(ys),
      static_cast<float*>(h_out), sc, S, W, NC, NLT, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a [B, S, W] f32, x and ys [B, S, W] of one type (is_bf16: bf16, else f32),
// h0 and h_out [B, W] f32, all contiguous; S >= 0, B and W > 0. scratch:
// f32 from the caller, 3 B NC W + B NC ceil(W / 32) + 1 values,
// NC = max(1, ceil(S / 64)). Launches rglru_chunk_clear and rglru_chunk on
// the stream. Returns the CUDA error of the first one refused (0 when both
// were accepted).
extern "C" int rglru_linear_scan_launch(const void* a, const void* x,
                                        const void* h0, void* ys, void* h_out,
                                        void* scratch, int is_bf16, int B,
                                        int S, int W, void* stream) {
  if (B <= 0 || W <= 0 || S < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(a, x, h0, ys, h_out, scratch, B, S, W, s);
  return launch<float>(a, x, h0, ys, h_out, scratch, B, S, W, s);
}
