// WKV6 recurrence for Hopper (sm_90a): chunkwise-parallel, with the chunk
// products on the tensor cores in 3xTF32.
//
// Replaces the Pallas TPU kernel `repro/kernels/rwkv6.py::wkv6`
// (`_wkv6_kernel`): over r, k [B, S, H, K], v [B, S, H, V] (bf16 or f32,
// one type), w [B, S, H, K] f32, u [H, K] f32 and s0 [B, H, K, V] f32,
//   y_t = r_t^T (S + (u . k_t) v_t^T),   then   S <- w_t . S + k_t v_t^T,
// returning y [B, S, H, V] in v's type and S_final [B, H, K, V] in f32,
// for any S >= 0, 1 <= K, V <= 64 and any w in [0, 1].
//
// What bounds it on this card: bytes. chip_smoke.py counts the function's
// work as r, k, w, v read once and y written once (plus u, s0 and S_final),
// against 5 f32 operations per state entry per step (the read-out r.S 2, the
// update w.S + k.v 3) and the bonus (sum_k r_k u_k k_k) v: at B 1, S 6000,
// H 40, K = V = 64 in f32 that is 308 MB (0.0921 ms at 3.35 TB/s) against
// 5.0 GFLOP (0.0745 ms at 67 TFLOP/s). The chunked form's extra products
// (four 64 x 64 x 64 products a chunk, each three TF32 products) and its
// scratch traffic are this kernel's cost, not the function's.
//
// Design: the sequence is cut into chunks of C = 64 steps (sub-chunks of
// 16), one block of 256 threads per (chunk, h, b): n_chunks x H x B blocks,
// 3,760 at B 1, S 6000, H 40, so that a B 1 call fills the card. A block
// takes its chunk from a counter (wkv6_fwd_clear zeroes it and the flags
// first), so chunks start in launch order. With P_t the product of w from
// the chunk's start to t (exclusive),
//   y_t = (r_t . P_t)^T S_c + sum_{s <= t in chunk} A[t][s] v_s,
//   A[t][s] = sum_k r_t[k] k_s[k] prod_{s<j<t} w_j[k]   (s < t),
//   A[t][t] = sum_k r_t[k] u[k] k_t[k]                  (the bonus),
//   S_{c+1} = P_c . S_c + dS_c,  dS_c = sum_s (k_s . bwd_s)^T v_s,
// bwd_s the product of w over the chunk's steps after s. The block computes
// its aggregate (dS_c, P_c) and publishes it at once; later it finds S_c by
// a decoupled look-back: back from chunk c - 1, folding in each published
// aggregate (S_c = dS_{c-1} + P_{c-1} . (dS_{c-2} + ...)) until a chunk whose
// inclusive state S_{j+1} is published, or s0, and publishes S_{c+1}. A
// chunk with neither yet is waited for; its block took an earlier ticket, so
// it is running and publishes its aggregate without waiting on anything.
// Numerics:
// * Every decay factor is a running product of w inside one chunk: forward
//   from the start of the chunk or sub-chunk (r's side), backward from the
//   end of the chunk or sub-chunk (k's side). No log, no division, no
//   difference of prefix sums: every factor is <= 1, so nothing overflows,
//   and w = 0 (reached when the model's exp(-exp(x)) underflows) gives the
//   exact 0 that the recurrence gives.
// * A[t][s] for t and s in sub-chunks T > S' factors as
//   (r_t . fwd_t)(k_s . bwd_s . M)^T, fwd from the start of T, bwd to the end
//   of S', M the whole sub-chunks between: a product on the tensor cores.
//   In the 16 x 16 diagonal blocks the same holds across the edge between
//   their 8 x 8 halves, so the lower-left quarter is a product too; the two
//   8 x 8 diagonal blocks are computed directly on the CUDA cores (each lane
//   two keys, a running product over t, then a transposing butterfly that
//   sums 8 values over 32 lanes in 9 shuffles).
// * The products of a chunk (k~^T V, the off-diagonal A, r~ S_c, A V)
//   run as mma.sync.m16n8k8 in TF32 with the 3xTF32 split
//   a b ~ a_hi b_hi + (a_hi b_lo + a_lo b_hi), a_hi = a rounded to TF32,
//   a_lo = a - a_hi (truncated to TF32 by the tensor core); the cross terms
//   accumulate apart from the main term, so the main accumulator takes one
//   rounding per k-step. Plain TF32 does not hold f32's 1e-4.
// * bf16 inputs are converted to f32 on load and take the same path.
// Data movement: a block stages its r, k, w and v tiles in shared memory in
// f32 (with f32 inputs whose rows are 16-byte aligned through cp.async);
// A takes w's place once the decay products are taken. Rows are padded to
// 68 or 72 floats so that the fragment loads avoid bank conflicts. Past S,
// k, r and v are zero and w is one; K and V below 64 are zero-padded, so
// the scratch states are always 64 x 64. The scratch (aggregates, inclusive
// states, flags) is read back from L2 by the chunks just after.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "lookback.cuh"  // the flags, the wait, the clear

namespace {

constexpr int D = 64;          // K and V are padded to D
constexpr int C = 64;          // steps per chunk
constexpr int SUB = 16;        // steps per sub-chunk
constexpr int HALF = SUB / 2;  // steps per half sub-chunk
constexpr int NSUB = C / SUB;
constexpr int NT = 256;        // threads per block: 8 warps
constexpr int NW = NT / 32;
constexpr int LA = D + 4;      // row stride of tiles read row-by-lane-group
constexpr int LB = D + 8;      // row stride of tiles read row-by-lane-in-group
constexpr unsigned FULL = 0xffffffffu;

static_assert(NT == D * NSUB, "the scans give one thread to each (key, sub-chunk)");
static_assert(C == D, "the y tiling pairs sub-chunks and the tile loader takes C = D rows");
static_assert(HALF == 8, "the diagonal blocks' butterfly sums 8 values");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// D rows of D columns into shared memory (row stride ld): element (i, j) is
// g[i * stride + j] for i < rows and j < cols, else fill. With vec (16-byte
// aligned rows, cols a multiple of 16 bytes' worth) f32 goes through
// cp.async, which the caller commits and waits for, and bf16 in 16-byte
// loads converted to f32; else by plain loads, converted to f32.
template <typename T>
__device__ __forceinline__ void load_tile(float* sm, int ld, const T* g,
                                          int64_t stride, int rows, int cols,
                                          bool vec, float fill) {
  const float4 fill4 = make_float4(fill, fill, fill, fill);
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {
      for (int i = threadIdx.x; i < D * (D / 4); i += NT) {
        const int row = i / (D / 4), col = (i % (D / 4)) * 4;
        float* dst = sm + row * ld + col;
        if (row < rows && col < cols)
          cp_async16(dst, g + row * stride + col);
        else
          *reinterpret_cast<float4*>(dst) = fill4;
      }
      return;
    }
  } else {
    if (vec) {
      constexpr int PER = D * (D / 8) / NT;  // 16-byte loads a thread
      uint4 raw[PER];
#pragma unroll
      for (int m = 0; m < PER; ++m) {
        const int i = threadIdx.x + m * NT, row = i / (D / 8);
        const int col = (i % (D / 8)) * 8;
        if (row < rows && col < cols)
          raw[m] = *reinterpret_cast<const uint4*>(g + row * stride + col);
      }
#pragma unroll
      for (int m = 0; m < PER; ++m) {
        const int i = threadIdx.x + m * NT, row = i / (D / 8);
        const int col = (i % (D / 8)) * 8;
        float4 lo = fill4, hi = fill4;
        if (row < rows && col < cols) {
          const __nv_bfloat162* p =
              reinterpret_cast<const __nv_bfloat162*>(&raw[m]);
          const float2 a = __bfloat1622float2(p[0]), b = __bfloat1622float2(p[1]);
          const float2 c = __bfloat1622float2(p[2]), d = __bfloat1622float2(p[3]);
          lo = make_float4(a.x, a.y, b.x, b.y);
          hi = make_float4(c.x, c.y, d.x, d.y);
        }
        float* dst = sm + row * ld + col;
        *reinterpret_cast<float4*>(dst) = lo;
        *reinterpret_cast<float4*>(dst + 4) = hi;
      }
      return;
    }
  }
  for (int i = threadIdx.x; i < D * D; i += NT) {
    const int row = i / D, col = i % D;
    sm[row * ld + col] =
        (row < rows && col < cols) ? to_f32(g[row * stride + col]) : fill;
  }
}

// 3xTF32 operands of one mma.sync.m16n8k8: each value as tf32 hi + lo
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// hi: x rounded to TF32's 10 mantissa bits, to nearest with ties away from
// zero (what cvt.rna.tf32.f32 gives, in two integer operations); lo: the
// remainder x - hi, exact in f32, which the tensor core reads truncated to
// TF32 (it ignores an operand's 13 low mantissa bits).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
// A fragment: a0 (row g, col t), a1 (row g + 8, col t), a2 (row g,
// col t + 4), a3 (row g + 8, col t + 4), g = lane / 4, t = lane % 4
__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2,
                                        float a3) {
  FragA f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}
// B fragment: b0 (row t, col g), b1 (row t + 4, col g)
__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  split(b0, f.hi[0], f.lo[0]);
  split(b1, f.hi[1], f.lo[1]);
  return f;
}
__device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// acc + cor += a b in 3xTF32; C/D fragment: d0 (row g, col 2t), d1 (row g,
// col 2t + 1), d2 (row g + 8, col 2t), d3 (row g + 8, col 2t + 1)
__device__ __forceinline__ void mma3(float* acc, float* cor, const FragA& a,
                                     const FragB& b) {
  mma(cor, a.lo, b.hi);
  mma(cor, a.hi, b.lo);
  mma(acc, a.hi, b.hi);
}

// One butterfly round: lanes with bit `off` set keep the upper half of
// p[0 .. 2n) and send the lower, the others the reverse; p[0 .. n) becomes
// the pair's sums of the half kept.
template <int N>
__device__ __forceinline__ void fold(float (&p)[HALF], int lane, int off) {
  const bool up = lane & off;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float send = up ? p[i] : p[i + N];
    const float keep = up ? p[i + N] : p[i];
    p[i] = keep + __shfl_xor_sync(FULL, send, off);
  }
}
// The sum over the warp's 32 lanes of p[l / 4], returned to lane l: three
// folds and two plain shuffles, 9 shuffles for 8 sums.
__device__ __forceinline__ float transpose_sum8(float (&p)[HALF], int lane) {
  fold<4>(p, lane, 16);
  fold<2>(p, lane, 8);
  fold<1>(p, lane, 4);
  const float x = p[0] + __shfl_xor_sync(FULL, p[0], 2);
  return x + __shfl_xor_sync(FULL, x, 1);
}

// The scratch that the wrapper allocates, in one f32 buffer: per (b, h,
// chunk) the chunk's aggregate (its state increment dS_c, D x D, and total
// decay P_c, D), its inclusive state S_{c+1} (D x D) and a flag (int: 0,
// then AGG once the aggregate is published, then INCL once S_{c+1} is); and
// the counter that hands out the blocks' chunks in launch order.
struct Scratch {
  float* agg;
  float* incl;
  float* decay;
  int* flag;
  int* ticket;
};

struct Smem {
  float r[C][LA];       // r, then r . (decay from the start of its sub-chunk)
  float k[C][LB];       // k, then k . (decay to the end of its sub-chunk)
  float w[C][LA];       // w; once the sub-chunk products are taken, A
  float v[C][LB];
  union {
    float s[D][LB];     // the chunk's start state, from phase 5 on
    struct {            // before: the operands of the diagonal blocks'
      float rf8[NSUB][HALF][LA];  // lower-left 8 x 8 quarters
      float kb8[NSUB][HALF][LA];
    } q8;
  };
  float u[D];
  float wsub[NSUB][D];  // each sub-chunk's total decay
  float wpre[NSUB][D];  // the product of the sub-chunks before it
  int chunk;            // this block's place in launch order
};

// Half HB of the diagonal 16 x 16 block of sub-chunk q. Its 8 x 8 diagonal
// block directly: lane l takes keys l and l + 32 along the running decay
// product over t > s, then the butterfly sums the keys; res[s] is
// A[q * SUB + HB * HALF + l / 4][q * SUB + HB * HALF + s]. And the operands
// of the 8 x 8 block below it (rows HALF.., columns ..HALF), which factors
// as (r_t . fwd_t)(k_s . bwd_s)^T across the half's edge: half 1 gives r_t
// times the decay from the edge to t, half 0 k_s times the decay from s to
// the edge.
template <int HB>
__device__ __forceinline__ void diag_half(Smem& sm, int q, int lane,
                                          float (&res)[HALF]) {
  const int t0 = q * SUB + HB * HALF;
  float r0[HALF], r1[HALF], w0[HALF], w1[HALF];
#pragma unroll
  for (int t = 0; t < HALF; ++t) {
    r0[t] = sm.r[t0 + t][lane];
    r1[t] = sm.r[t0 + t][lane + 32];
    w0[t] = sm.w[t0 + t][lane];
    w1[t] = sm.w[t0 + t][lane + 32];
  }
  const float u0 = sm.u[lane], u1 = sm.u[lane + 32];
#pragma unroll
  for (int s = 0; s < HALF; ++s) {
    const float k0 = sm.k[t0 + s][lane], k1 = sm.k[t0 + s][lane + 32];
    float p[HALF];
#pragma unroll
    for (int t = 0; t < HALF; ++t) p[t] = 0.0f;
    p[s] = r0[s] * (u0 * k0) + r1[s] * (u1 * k1);
    float kd0 = k0, kd1 = k1;  // k_s . prod_{s<j<t} w_j
#pragma unroll
    for (int t = s + 1; t < HALF; ++t) {
      p[t] = r0[t] * kd0 + r1[t] * kd1;
      kd0 *= w0[t];
      kd1 *= w1[t];
    }
    res[s] = transpose_sum8(p, lane);
  }
  float e0 = 1.0f, e1 = 1.0f;
  if (HB == 1) {
#pragma unroll
    for (int t = 0; t < HALF; ++t) {
      sm.q8.rf8[q][t][lane] = r0[t] * e0;
      sm.q8.rf8[q][t][lane + 32] = r1[t] * e1;
      e0 *= w0[t];
      e1 *= w1[t];
    }
  } else {
#pragma unroll
    for (int t = HALF - 1; t >= 0; --t) {
      sm.q8.kb8[q][t][lane] = sm.k[t0 + t][lane] * e0;
      sm.q8.kb8[q][t][lane + 32] = sm.k[t0 + t][lane + 32] * e1;
      e0 *= w0[t];
      e1 *= w1[t];
    }
  }
}

// This thread's 16 entries of a D x D state in the aggregate's fragment
// layout: keys k0 and k0 + 8, values n0 + 8 x + 2 t4 and the next one.
__device__ __forceinline__ void ld_frag(float (&d)[4][4], const float* m,
                                        int k0, int n0, int t4) {
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int col = n0 + x * 8 + 2 * t4;
    const float2 lo = __ldcg(reinterpret_cast<const float2*>(&m[k0 * D + col]));
    const float2 hi =
        __ldcg(reinterpret_cast<const float2*>(&m[(k0 + 8) * D + col]));
    d[x][0] = lo.x;
    d[x][1] = lo.y;
    d[x][2] = hi.x;
    d[x][3] = hi.y;
  }
}
// The same entries of s0 [K, V], zero past K and V.
__device__ __forceinline__ void ld_frag_s0(float (&d)[4][4], const float* s0,
                                           int k0, int n0, int t4, int K,
                                           int V) {
#pragma unroll
  for (int x = 0; x < 4; ++x) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kk = k0 + 8 * (e / 2), vv = n0 + x * 8 + 2 * t4 + e % 2;
      d[x][e] = (kk < K && vv < V) ? s0[kk * V + vv] : 0.0f;
    }
  }
}
__device__ __forceinline__ void copy16(float (&d)[4][4],
                                       const float (&x)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[i][e] = x[i][e];
}
// acc += ap . d, ap0 for key k0, ap1 for k0 + 8
__device__ __forceinline__ void fold16(float (&acc)[4][4], float ap0,
                                       float ap1, const float (&d)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[i][0] = fmaf(ap0, d[i][0], acc[i][0]);
    acc[i][1] = fmaf(ap0, d[i][1], acc[i][1]);
    acc[i][2] = fmaf(ap1, d[i][2], acc[i][2]);
    acc[i][3] = fmaf(ap1, d[i][3], acc[i][3]);
  }
}

// Clears the flags and the counter of one call.
__global__ void wkv6_fwd_clear(int* __restrict__ flag, int64_t n) {
  clear_flags(flag, n);
}

// One chunk of one (b, h): its aggregate, published at once; its start state
// by a decoupled look-back over the chunks before it; then y.
template <typename T>
__global__ void __launch_bounds__(NT, 2)
wkv6_fwd_chunk(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, const float* __restrict__ s0,
               Scratch sc, T* __restrict__ y, float* __restrict__ s_out,
               int S, int H, int K, int V, int NC, int vec) {
  extern __shared__ __align__(16) float smem[];
  Smem& sm = *reinterpret_cast<Smem*>(smem);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  // Chunks go out in launch order, so every chunk this block waits for
  // belongs to a block that started before it: the waits always end.
  if (tid == 0) sm.chunk = atomicAdd(sc.ticket, 1);
  __syncthreads();
  const int ticket = sm.chunk;
  const int b = ticket / (NC * H), c = ticket / H % NC, h = ticket % H;
  const int c0 = c * C, rows = min(C, S - c0);
  const int64_t rk = ((int64_t)b * S + c0) * H * K + (int64_t)h * K;
  const int64_t rv = ((int64_t)b * S + c0) * H * V + (int64_t)h * V;
  const int64_t bh = (int64_t)b * H + h, slot = bh * NC + c;
  load_tile(&sm.r[0][0], LA, r + rk, (int64_t)H * K, rows, K, vec, 0.0f);
  load_tile(&sm.k[0][0], LB, k + rk, (int64_t)H * K, rows, K, vec, 0.0f);
  load_tile(&sm.w[0][0], LA, w + rk, (int64_t)H * K, rows, K, vec, 1.0f);
  load_tile(&sm.v[0][0], LB, v + rv, (int64_t)H * V, rows, V, vec, 0.0f);
  cp_async_commit();
  if (tid < D) sm.u[tid] = tid < K ? u[h * K + tid] : 0.0f;
  cp_async_wait_all();
  __syncthreads();

  // 1. the diagonal blocks of A: warps 2q and 2q + 1 take sub-chunk q's
  // halves
  float res[HALF];
  const int qd = warp / 2, hd = warp % 2;
  if (hd)
    diag_half<1>(sm, qd, lane, res);
  else
    diag_half<0>(sm, qd, lane, res);
  __syncthreads();

  // 2. running products inside each sub-chunk: r . fwd, k . bwd, the total
  {
    const int kk = tid % D, q = tid / D;
    float f = 1.0f, bw = 1.0f;
#pragma unroll
    for (int i = 0; i < SUB; ++i) {
      const int t = q * SUB + i;
      const float wt = sm.w[t][kk];
      sm.r[t][kk] *= f;
      f *= wt;
    }
    sm.wsub[q][kk] = f;
#pragma unroll
    for (int i = SUB - 1; i >= 0; --i) {
      const int t = q * SUB + i;
      sm.k[t][kk] *= bw;
      bw *= sm.w[t][kk];
    }
  }
  __syncthreads();

  // 3. the aggregate dS_c [key, value] = k~^T [key, s] . V [s, value], with
  // k~_s = k_s . (decay to the chunk's end), and P_c, published at once for
  // the chunks after this one; a warp takes 16 keys x 32 values, so thread
  // (g, t4) holds keys m0 + g, m0 + g + 8 at values n0 + 8 j + 2 t4 (+1)
  const int m0 = (warp % 4) * 16, n0 = (warp / 4) * 32;
  if (tid < D) {
    float p = 1.0f;
#pragma unroll
    for (int q = 0; q < NSUB; ++q) p *= sm.wsub[q][tid];
    sc.decay[slot * D + tid] = p;
  }
  float own[4][4];
  {
    float acc[4][4] = {}, cor[4][4] = {};
#pragma unroll
    for (int ks = 0; ks < C / 8; ++ks) {
      const int s0 = ks * 8 + t4, s1 = s0 + 4, q = ks * 8 / SUB;
      float p0 = 1.0f, p1 = 1.0f;  // the sub-chunks after s's
#pragma unroll
      for (int x = q + 1; x < NSUB; ++x) {
        p0 *= sm.wsub[x][m0 + g];
        p1 *= sm.wsub[x][m0 + g + 8];
      }
      const FragA fa = frag_a(sm.k[s0][m0 + g] * p0, sm.k[s0][m0 + g + 8] * p1,
                              sm.k[s1][m0 + g] * p0, sm.k[s1][m0 + g + 8] * p1);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + j * 8 + g;
        mma3(acc[j], cor[j], fa, frag_b(sm.v[s0][col], sm.v[s1][col]));
      }
    }
    float* out = sc.agg + slot * D * D;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int x = 0; x < 4; ++x) own[j][x] = acc[j][x] + cor[j][x];
      const int col = n0 + j * 8 + 2 * t4;
      __stcg(reinterpret_cast<float2*>(&out[(m0 + g) * D + col]),
             make_float2(own[j][0], own[j][1]));
      __stcg(reinterpret_cast<float2*>(&out[(m0 + g + 8) * D + col]),
             make_float2(own[j][2], own[j][3]));
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) set_flag(&sc.flag[slot], AGG);

  // 4. A into w's place: the diagonal blocks from phase 1, the off-diagonal
  // 16 x 16 blocks (sub-chunks T > S') as tensor-core products, one a warp;
  // the last two warps take the table of decays before each sub-chunk
  float (*a)[LA] = sm.w;
  {
    const int t0 = qd * SUB + hd * HALF;
    if ((lane & 3) == 0) {
#pragma unroll
      for (int j = 0; j < HALF; ++j) a[t0 + lane / 4][t0 + j] = res[j];
    }
    if (hd == 0) {  // the upper-right quarter: s after t
      a[t0 + lane / 8][t0 + HALF + lane % 8] = 0.0f;
      a[t0 + 4 + lane / 8][t0 + HALF + lane % 8] = 0.0f;
    }
  }
  constexpr int NPAIR = NSUB * (NSUB - 1) / 2;  // 6 blocks for 8 warps
  if (tid >= NT - D) {
    const int kk = tid - (NT - D);
    float p = 1.0f;
#pragma unroll
    for (int q = 0; q < NSUB; ++q) {
      sm.wpre[q][kk] = p;
      p *= sm.wsub[q][kk];
    }
  }
  if (warp >= NPAIR) {  // the lower-left quarters, two a warp
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = (warp - NPAIR) * 2 + i, m0 = q * SUB + HALF, n0 = q * SUB;
      float acc[4] = {}, cor[4] = {};
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) {
        const int kk0 = ks * 8 + t4, kk1 = kk0 + 4;
        mma3(acc, cor,
             frag_a(sm.q8.rf8[q][g][kk0], 0.0f, sm.q8.rf8[q][g][kk1], 0.0f),
             frag_b(sm.q8.kb8[q][g][kk0], sm.q8.kb8[q][g][kk1]));
      }
      a[m0 + g][n0 + 2 * t4] = acc[0] + cor[0];
      a[m0 + g][n0 + 2 * t4 + 1] = acc[1] + cor[1];
    }
  }
  for (int pr = warp; pr < NPAIR; pr += NW) {
    int sp = pr, tq = 1;
    while (sp >= tq) sp -= tq++;
    const int m0 = tq * SUB, n0 = sp * SUB;
    float acc[2][4] = {}, cor[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
      const int kk0 = ks * 8 + t4, kk1 = kk0 + 4;
      float m_0 = 1.0f, m_1 = 1.0f;  // the whole sub-chunks between
      for (int q = sp + 1; q < tq; ++q) {
        m_0 *= sm.wsub[q][kk0];
        m_1 *= sm.wsub[q][kk1];
      }
      const FragA fa = frag_a(sm.r[m0 + g][kk0], sm.r[m0 + g + 8][kk0],
                              sm.r[m0 + g][kk1], sm.r[m0 + g + 8][kk1]);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        mma3(acc[j], cor[j], fa,
             frag_b(sm.k[n0 + j * 8 + g][kk0] * m_0,
                    sm.k[n0 + j * 8 + g][kk1] * m_1));
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n0 + j * 8 + 2 * t4;
      a[m0 + g][col] = acc[j][0] + cor[j][0];
      a[m0 + g][col + 1] = acc[j][1] + cor[j][1];
      a[m0 + g + 8][col] = acc[j][2] + cor[j][2];
      a[m0 + g + 8][col + 1] = acc[j][3] + cor[j][3];
    }
  }
  __syncthreads();

  // 5. the start state: back from chunk c - 1, folding in each aggregate
  // (S_c = dS_{c-1} + P_{c-1} . (dS_{c-2} + ...)) until a chunk with its
  // inclusive state published, or s0; a chunk with neither yet is waited
  // for (its block has started: see the ticket above). Then S_{c+1} =
  // P_c . S_c + dS_c is published.
  {
    const int k0 = m0 + g, k1 = k0 + 8;
    float sacc[4][4] = {}, base[4][4];
    float ap0 = 1.0f, ap1 = 1.0f;
    const int* flag = sc.flag + bh * NC;
    const float* s0b = s0 + bh * K * V;
    // two chunks a round: their flags in one trip, their states in another
    for (int j = c - 1;; j -= 2) {
      int f0 = j < 0 ? INCL : ld_flag(&flag[j]);  // before chunk 0: s0
      int f1 = j < 1 ? INCL : ld_flag(&flag[j - 1]);
      f0 = wait_flag(&flag[j], f0);
      if (f0 == AGG) f1 = wait_flag(&flag[j - 1], f1);
      __threadfence();  // what the flags published is read after them
      float d0[4][4], d1[4][4], p0 = 0.0f, p1 = 0.0f, q0 = 0.0f, q1 = 0.0f;
      if (j < 0)
        ld_frag_s0(d0, s0b, k0, n0, t4, K, V);
      else
        ld_frag(d0, (f0 == INCL ? sc.incl : sc.agg) + (bh * NC + j) * D * D,
                k0, n0, t4);
      if (f0 == AGG) {
        p0 = __ldcg(&sc.decay[(bh * NC + j) * D + k0]);
        p1 = __ldcg(&sc.decay[(bh * NC + j) * D + k1]);
        if (j < 1) {
          ld_frag_s0(d1, s0b, k0, n0, t4, K, V);
        } else {
          ld_frag(d1,
                  (f1 == INCL ? sc.incl : sc.agg) + (bh * NC + j - 1) * D * D,
                  k0, n0, t4);
          if (f1 == AGG) {
            q0 = __ldcg(&sc.decay[(bh * NC + j - 1) * D + k0]);
            q1 = __ldcg(&sc.decay[(bh * NC + j - 1) * D + k1]);
          }
        }
      }
      if (f0 == INCL) {
        copy16(base, d0);
        break;
      }
      fold16(sacc, ap0, ap1, d0);
      ap0 *= p0;
      ap1 *= p1;
      if (f1 == INCL) {
        copy16(base, d1);
        break;
      }
      fold16(sacc, ap0, ap1, d1);
      ap0 *= q0;
      ap1 *= q1;
    }
    const float pc0 = sc.decay[slot * D + k0];  // this block's own writes
    const float pc1 = sc.decay[slot * D + k1];
    float* incl = sc.incl + slot * D * D;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int col = n0 + x * 8 + 2 * t4;
      float st[4], nx[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        st[e] = fmaf(e < 2 ? ap0 : ap1, base[x][e], sacc[x][e]);
        nx[e] = fmaf(e < 2 ? pc0 : pc1, st[e], own[x][e]);
      }
      *reinterpret_cast<float2*>(&sm.s[k0][col]) = make_float2(st[0], st[1]);
      *reinterpret_cast<float2*>(&sm.s[k1][col]) = make_float2(st[2], st[3]);
      __stcg(reinterpret_cast<float2*>(&incl[k0 * D + col]), make_float2(nx[0], nx[1]));
      __stcg(reinterpret_cast<float2*>(&incl[k1 * D + col]), make_float2(nx[2], nx[3]));
      if (c == NC - 1) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kk = e < 2 ? k0 : k1, vv = col + e % 2;
          if (kk < K && vv < V) s_out[bh * K * V + kk * V + vv] = nx[e];
        }
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) set_flag(&sc.flag[slot], INCL);

  // 6. y = (r . P) S_c + A V; a warp takes sub-chunks {p, NSUB - 1 - p} (so
  // every warp does the same share of the triangle) x 16 values, the two
  // row tiles sharing each B fragment
  const int y0 = (warp / 2) * 16;
  const int mt[2] = {warp % 2, NSUB - 1 - warp % 2};
  float acc[2][2][4] = {}, cor[2][2][4] = {};
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    const int kk0 = ks * 8 + t4, kk1 = kk0 + 4;
    FragB bf[2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
      bf[j] = frag_b(sm.s[kk0][y0 + j * 8 + g], sm.s[kk1][y0 + j * 8 + g]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r0 = mt[i] * SUB;
      const float p0 = sm.wpre[mt[i]][kk0], p1 = sm.wpre[mt[i]][kk1];
      const FragA fa = frag_a(sm.r[r0 + g][kk0] * p0, sm.r[r0 + g + 8][kk0] * p0,
                              sm.r[r0 + g][kk1] * p1,
                              sm.r[r0 + g + 8][kk1] * p1);
#pragma unroll
      for (int j = 0; j < 2; ++j) mma3(acc[i][j], cor[i][j], fa, bf[j]);
    }
  }
  // A V over s up to the end of each row tile's sub-chunk
  for (int ks = 0; ks < (mt[1] + 1) * SUB / 8; ++ks) {
    const int s0 = ks * 8 + t4, s1 = s0 + 4;
    FragB bf[2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
      bf[j] = frag_b(sm.v[s0][y0 + j * 8 + g], sm.v[s1][y0 + j * 8 + g]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (ks >= (mt[i] + 1) * SUB / 8) continue;
      const int r0 = mt[i] * SUB;
      const FragA fa = frag_a(a[r0 + g][s0], a[r0 + g + 8][s0], a[r0 + g][s1],
                              a[r0 + g + 8][s1]);
#pragma unroll
      for (int j = 0; j < 2; ++j) mma3(acc[i][j], cor[i][j], fa, bf[j]);
    }
  }
  const int64_t yrow = (int64_t)H * V;
  T* yb = y + rv;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = y0 + j * 8 + 2 * t4;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = mt[i] * SUB + g + 8 * hr;
        if (row >= rows) continue;
        if constexpr (std::is_same<T, float>::value) {
          if (vec) {  // V a multiple of 4: col + 1 < V when col < V
            if (col < V)
              *reinterpret_cast<float2*>(yb + row * yrow + col) =
                  make_float2(acc[i][j][2 * hr] + cor[i][j][2 * hr],
                              acc[i][j][2 * hr + 1] + cor[i][j][2 * hr + 1]);
            continue;
          }
        }
        if (col < V)
          store(yb + row * yrow + col, acc[i][j][2 * hr] + cor[i][j][2 * hr]);
        if (col + 1 < V)
          store(yb + row * yrow + col + 1,
                acc[i][j][2 * hr + 1] + cor[i][j][2 * hr + 1]);
      }
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* y, void* s_out, void* scratch,
           int B, int S, int H, int K, int V, cudaStream_t stream) {
  const int NC = S > 0 ? (S + C - 1) / C : 1;  // S 0: one empty chunk
  const int64_t n = (int64_t)B * H * NC;
  float* f = static_cast<float*>(scratch);
  int* flags = reinterpret_cast<int*>(f + 2 * n * D * D + n * D);
  const Scratch sc{f, f + n * D * D, f + 2 * n * D * D, flags, flags + n};
  constexpr int E = 16 / sizeof(T);  // values in 16 bytes
  const int vec = K % E == 0 && V % E == 0 && aligned16(r) && aligned16(k) &&
                  aligned16(v) && aligned16(w) && aligned16(y);
  wkv6_fwd_clear<<<clear_blocks(n, NT), NT, 0, stream>>>(flags, n);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wkv6_fwd_chunk<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sizeof(Smem));
  if (err != cudaSuccess) return (int)err;
  wkv6_fwd_chunk<T><<<(int)n, NT, sizeof(Smem), stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0), sc,
      static_cast<T*>(y), static_cast<float*>(s_out), S, H, K, V, NC, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, w [B, S, H, K]; v and y [B, S, H, V]; u [H, K]; s0 and s_out
// [B, H, K, V]; all contiguous. r, k, v, y of one type (is_bf16: bf16, else
// f32), w, u, s0, s_out f32. 1 <= K, V <= 64; S >= 0. scratch: f32 from the
// caller, B * H * max(1, ceil(S / 64)) * (2 * 64 * 64 + 64 + 1) + 1 values.
// Launches two kernels on the stream. Returns the CUDA error of the first
// launch refused (0 when both were accepted).
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* s0,
                           void* y, void* s_out, void* scratch, int is_bf16,
                           int B, int S, int H, int K, int V, void* stream) {
  if (B <= 0 || H <= 0 || S < 0 || K <= 0 || V <= 0 || K > D || V > D ||
      (int64_t)B * H * ((S + C - 1) / C + 1) >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(r, k, v, w, u, s0, y, s_out, scratch, B, S,
                                 H, K, V, s);
  return launch<float>(r, k, v, w, u, s0, y, s_out, scratch, B, S, H, K, V, s);
}
