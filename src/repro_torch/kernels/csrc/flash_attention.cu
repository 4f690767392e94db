// Flash attention forward for Hopper (sm_90a): bf16 on the tensor cores
// (wgmma, TMA, an mbarrier ring), f32 on the CUDA cores.
//
// Replaces the Pallas TPU kernel `src/repro/kernels/flash_attention.py:135`
// (`flash_attention`, whose tile body is `_flash_kernel`): online-softmax
// attention over
//   q [B, Sq, H, D], k and v [B, Sk, K, D] (contiguous, bf16 or f32)
// with GQA (query head h reads kv head h / (H / K)), causal masking aligned
// to the end (query i sits at position i + Sk - Sq), a sliding window
// (q_pos - k_pos < window), the Gemma-2 logit softcap cap * tanh(s / cap),
// and the finite mask value -2^30. The output is acc / max(l, 1e-30) in
// q's type. Key tiles that are fully masked for every query row of a block
// are never visited, so a local layer costs O(Sq * window), not O(Sq * Sk).
//
// What bounds it on this card: operations. At the serving shapes (gemma2-2b
// global, S 6000: 4 * D flops per live (query, key) pair per head, 147.5
// GFLOP against 74 MB read once and written once) the bf16 work takes
// 0.149 ms at the 989 TFLOP/s bf16 tensor-core peak and the bytes 0.022 ms
// at 3.35 TB/s. Only wgmma reaches that peak.
//
// bf16 design (flash_fwd_wgmma), FA3's shape:
// 1. A CTA owns 128 query rows of one (head, batch row): one producer
//    warpgroup (one thread issues every TMA load; setmaxnreg 24) and two
//    consumer warpgroups of 64 rows each (setmaxnreg 240), 384 threads,
//    one CTA per SM. Keys come in tiles of BK = 64. O (64 x 256 f32 at D
//    256) is 128 registers a thread and S 32 more: the consumers need up
//    to 238 of their 240.
// 2. S = Q K^T: wgmma m64n64k16, Q and K both K-major in swizzled shared
//    memory. A swizzled row is min(2 D, 128) bytes: 64 bf16 columns under
//    the 128-byte swizzle at D >= 64, and one whole row of 16 or 32
//    columns under the 32- or 64-byte swizzle at D 16 and 32 (the reduced
//    configs' and the Pallas kernel's tests' head dims). Every tile arrives
//    as D / columns slabs (one TMA box each), the TMA maps and the wgmma
//    descriptors (layout type 1, 2 or 3) use the same swizzle, and the
//    descriptors step 32 bytes per k-step inside a slab, a slab at a time
//    across D (D 16: a single k-step).
// 3. The softmax runs on the accumulator fragment in registers: a row lies
//    on the four threads of a quad (max by two xor-shuffles; the row sum is
//    kept per thread and summed once at the end). log2(e) is folded into
//    the scale and p = ex2.approx(t - m). The softcap is
//    cap * (1 - 2 / (2^(2 y log2 e) + 1)), y = s * scale / cap: not
//    tanh.approx, whose 2^-11 error times cap 50 would move p by ~2.5 %.
//    The element mask runs only on tiles that straddle the causal diagonal
//    or the window edge or hold keys past Sk (TMA zero-fills those: a
//    score of 0, so they must still get -2^30).
// 4. O += P V with p at about f32 precision, as the Pallas kernel forms
//    P V from p in f32: p is split into p_hi = bf16(p) and p_lo =
//    bf16(p - p_hi) (p - p_hi is exact in f32; p_hi + p_lo is within
//    2^-17 of p) and both go through the tensor cores against the same V
//    tile, into the same f32 accumulator: two register-A wgmma per k-step
//    (the f32 fragment of S, packed in pairs, is the A fragment), V as an
//    MN-major B operand (the transpose bit, 16-bit types only) and N = D
//    (m64n16k16 up to m64n256k16); O is
//    scaled by alpha each tile. The second product doubles P V's tensor
//    work (half of the kernel's) and costs no extra registers at the peak:
//    the two packed halves take the 32 registers the f32 scores held.
//    Rounding p once to bf16 before the product, as the first build did,
//    made 2 of 64 large-score draws cross the bf16 tolerance against
//    ref_attention, which rounds the normalised p instead (PERF.md).
// 5. TMA: 4-D tensor maps over (D, heads, S, B), encoded on the host with
//    cuTensorMapEncodeTiled from cudaGetDriverEntryPoint (no -lcuda), passed
//    as __grid_constant__. A ragged last tile is zero-filled by the
//    hardware and never reads the next batch row. The output goes through
//    the warpgroup's own rows of Q's buffer to masked 16-byte stores.
// 6. Query blocks run longest causal rows first (the grid walks them in
//    reverse, all heads of a block side by side).
// 7. K and V land on their own "full" mbarriers in a ring of 2 stages at
//    D 256 (Q 64 KB + 2 x 64 KB) and 3 below it; the consumers
//    release a stage on its "empty" mbarrier. The two consumer warpgroups
//    overlap each other's softmax and products only as the scheduler
//    interleaves them: no explicit ping-pong, and no intra-warpgroup
//    overlap (the next tile's Q K^T issued before this tile's softmax),
//    which a trial build found slower at D 256 (PERF.md).
// 8. A bf16 input the kernel cannot take is refused by the wrapper; the
//    launch allocates nothing, runs on the caller's stream and returns
//    cudaGetLastError().
//
// f32 design (flash_fwd, CUDA cores): wgmma has no f32 input, only TF32,
// and TF32's 10-bit mantissa would not hold the f32 tolerance (rtol 2e-3,
// atol 2e-4), so f32 keeps the first port's kernel: one block per (64
// query rows, head, batch row), 256 threads, f32 FMAs out of shared memory.
// * Four threads own one query row. Each computes 8 of the 32 scores of a
//   key tile for that row, so the row max and row sum of the online
//   softmax are two xor-shuffles inside the four-lane group, and p is
//   handed to the P.V product by shuffles too: no score tile in shared
//   memory.
// * The f32 accumulator of a 64 x D tile is split over the four threads of
//   a row: D / 4 floats each (64 at D = 256), in registers.
// * q (64 x D), k and v (32 x D each) tiles live in dynamic shared memory,
//   each row padded by 16 bytes against bank conflicts: 133,120 bytes at
//   D = 256, above the 48 KB static limit, hence cudaFuncSetAttribute.
// * Ragged edges are masked, not padded: rows past Sq are computed and
//   never stored, keys past Sk get the mask value (their k and v are
//   zero-filled), so any Sq and Sk work (the Pallas wrapper asserts
//   divisibility by its block sizes).
// * No fast-math: expf and tanhf are the accurate library functions.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1073741824.0f;  // -2^30, as the Pallas kernel
constexpr unsigned FULL = 0xffffffffu;

// ------------------------------------------------------------ f32: CUDA cores
namespace cuda_core {

constexpr int BQ = 64;                     // query rows per block
constexpr int BK = 32;                     // keys per tile
constexpr int THREADS = 256;               // four threads per query row
constexpr int SPT = BK / 4;                // scores per thread per tile

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
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
    case 16: return launch<T, 16>(q, k, v, o, B, Sq, Sk, H, KH, causal, window, softcap, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, Sq, Sk, H, KH, causal, window, softcap, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Sk, H, KH, causal, window, softcap, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Sk, H, KH, causal, window, softcap, scale, stream);
    case 256: return launch<T, 256>(q, k, v, o, B, Sq, Sk, H, KH, causal, window, softcap, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace cuda_core

// ------------------------------------------------- bf16: wgmma, TMA, mbarriers
namespace hopper {

constexpr int BQ = 128;        // query rows per CTA: two consumer warpgroups
constexpr int BK = 64;         // keys per tile
constexpr int THREADS = 384;   // producer warpgroup + two consumer warpgroups
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Cfg {
  // bytes of a swizzled row (the swizzle's width) and its bf16 columns:
  // 128 bytes (64 columns) at D >= 64, the whole row at D 16 and 32
  static constexpr int ROW = 2 * D < 128 ? 2 * D : 128;
  static constexpr int COLS = ROW / 2;
  static constexpr int SLABS = D / COLS;            // column slabs of a row
  // the wgmma descriptor's layout type: 1 = 128-, 2 = 64-, 3 = 32-byte swizzle
  static constexpr uint64_t LAYOUT = ROW == 128 ? 1 : ROW == 64 ? 2 : 3;
  static constexpr int STAGES = D == 256 ? 2 : 3;   // depth of the K/V ring
  static constexpr int Q_SLAB = BQ * ROW;           // bytes of one q slab
  static constexpr int KV_SLAB = BK * ROW;          // bytes of one k or v slab
  static constexpr int Q_BYTES = SLABS * Q_SLAB;    // BQ * D * 2
  static constexpr int KV_BYTES = SLABS * KV_SLAB;  // BK * D * 2
  static constexpr int BARS = 1 + 3 * STAGES;       // q, full k/v, empty
  // 1024 bytes of slack to align the buffers to the swizzle atom
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * BARS;
  static_assert(D % 16 == 0 && ROW % 32 == 0, "a row holds whole k-steps");
};

// the ROW-byte swizzle (TMA's and wgmma's) of byte offset `off` from a
// 1024-byte-aligned buffer: the 16-byte chunk bits [4, 4 + log2(ROW / 16))
// XOR the bits above the 128-byte line, [7, 7 + log2(ROW / 16))
template <int ROW>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  return off ^ (((off >> 7) & (ROW / 16 - 1)) << 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

// one arrival that also announces `bytes` of TMA traffic
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// wait until the phase of parity `parity` has completed. No spin limit
// and no trap: a trap path in the consumer branch makes ptxas drop the
// setmaxnreg budget, and D 256 then spills.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// TMA: the box at coordinates (c0, c1, c2, c3) of `map` into shared memory
// at `dst`, completing its bytes on mbarrier `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma descriptor of a swizzled operand at shared address `addr`: leading
// and stride byte offsets in 16-byte units, and the layout type of D's
// swizzle (Cfg<D>::LAYOUT)
template <int D>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (Cfg<D>::LAYOUT << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// keep the compiler from moving accumulator accesses across a wgmma
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// d[32] (+)= A . B^T, m64n64k16; A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[32] += A . B, m64n64k16; A (bf16 pairs) in registers, B MN-major
// (transposed) in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[8] += A . B, m64n16k16; A (bf16 pairs) in registers, B MN-major
// (transposed) in shared memory
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[16] += A . B, m64n32k16; A (bf16 pairs) in registers, B MN-major
// (transposed) in shared memory
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[64] += A . B, m64n128k16; A (bf16 pairs) in registers, B MN-major
// (transposed) in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[128] += A . B, m64n256k16; A (bf16 pairs) in registers, B MN-major
// (transposed) in shared memory
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&acc)[D / 2],
                                         const uint32_t (&a)[4], uint64_t dv) {
  if constexpr (D == 256) wgmma_rs_n256(acc, a, dv);
  else if constexpr (D == 128) wgmma_rs_n128(acc, a, dv);
  else if constexpr (D == 64) wgmma_rs_n64(acc, a, dv);
  else if constexpr (D == 32) wgmma_rs_n32(acc, a, dv);
  else wgmma_rs_n16(acc, a, dv);
}

// wait for every wgmma this thread's warpgroup has committed
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// S = Q K^T for one key tile, issued: D / 16 k-steps, slab by slab (a
// slab row holds ROW / 32 k-steps of 32 bytes)
template <int D>
__device__ __forceinline__ void issue_s(float (&sc)[BK / 2], uint64_t dq,
                                        uint64_t dk) {
  using C = Cfg<D>;
  constexpr int KPR = C::ROW / 32;  // k-steps per swizzled row
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
  pin(sc);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(sc, dq + ((kk / KPR * C::Q_SLAB + kk % KPR * 32) >> 4),
                 dk + ((kk / KPR * C::KV_SLAB + kk % KPR * 32) >> 4), kk > 0);
  wg_commit();
}

// O += P V for one key tile, issued: BK / 16 k-steps, each the product of
// p_hi and then of p_lo with the same V rows, p from registers
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&p_hi)[BK / 16][4],
                                         const uint32_t (&p_lo)[BK / 16][4],
                                         uint64_t dv) {
  pin(acc);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t d = dv + ((kk * 16 * Cfg<D>::ROW) >> 4);
    wgmma_pv<D>(acc, p_hi[kk], d);
    wgmma_pv<D>(acc, p_lo[kk], d);
  }
  wg_commit();
}

// Online softmax of one tile in place: raw scores in, f32 p out, in log2
// units (t = s * scale * log2 e, or with the softcap t = cap * log2 e *
// tanh(s * scale / cap)). Masks only when `edge`. Updates the running max
// m and this thread's share of the row sums l; alpha is the factor the
// accumulator rows take before this tile's P V.
template <bool CAP>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[BK / 2], float (&m)[2], float (&l)[2], float (&alpha)[2],
    float c_score, float c_cap, bool edge, int k0, int col, int qpos, int Sk,
    int causal, int window) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[4 * i + e];
      if (CAP)
        x = c_cap * (1.f - __fdividef(2.f, ex2(x * c_score) + 1.f));
      else
        x *= c_score;
      if (edge) {
        const int kpos = k0 + 8 * i + col + (e & 1);
        const int qp = qpos + 8 * (e >> 1);
        bool ok = kpos < Sk;
        if (causal) ok = ok && qp >= kpos;
        if (window > 0) ok = ok && qp - kpos < window;
        x = ok ? x : NEG_INF;
      }
      sc[4 * i + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
    alpha[r] = ex2(m[r] - mx[r]);
    m[r] = mx[r];
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const float p = ex2(sc[i] - m[(i >> 1) & 1]);
    sc[i] = p;
    l[(i >> 1) & 1] += p;
  }
}

// p as p_hi + p_lo, both bf16: the S fragment of keys 16 kk .. 16 kk + 15
// is the A fragment of k-step kk of P V
__device__ __forceinline__ void pack_p(uint32_t (&p_hi)[BK / 16][4],
                                       uint32_t (&p_lo)[BK / 16][4],
                                       const float (&sc)[BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float a = sc[8 * kk + 2 * j], b = sc[8 * kk + 2 * j + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(a, b);
      p_hi[kk][j] = *reinterpret_cast<const uint32_t*>(&hi);
      p_lo[kk][j] = pack_bf16(a - __low2float(hi), b - __high2float(hi));
    }
}

template <int D>
__device__ __forceinline__ void rescale(float (&acc)[D / 2],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
}

// the mbarriers after q_full: full k and full v of each stage, then empty
template <int D>
__device__ __forceinline__ uint32_t full_k(uint32_t q_full, int s) {
  return q_full + 8u * (1 + s);
}
template <int D>
__device__ __forceinline__ uint32_t full_v(uint32_t q_full, int s) {
  return q_full + 8u * (1 + Cfg<D>::STAGES + s);
}
template <int D>
__device__ __forceinline__ uint32_t empty_bar(uint32_t q_full, int s) {
  return q_full + 8u * (1 + 2 * Cfg<D>::STAGES + s);
}
// the parity of tile t's round through the ring
template <int D>
__device__ __forceinline__ uint32_t tile_parity(int t) {
  return (uint32_t)((t / Cfg<D>::STAGES) & 1);
}
template <int D>
__device__ __forceinline__ uint64_t k_desc(uint32_t sK, int t) {
  return make_desc<D>(sK + t % Cfg<D>::STAGES * Cfg<D>::KV_BYTES, 16,
                      8 * Cfg<D>::ROW);
}
template <int D>
__device__ __forceinline__ uint64_t v_desc(uint32_t sV, int t) {
  return make_desc<D>(sV + t % Cfg<D>::STAGES * Cfg<D>::KV_BYTES,
                      Cfg<D>::KV_SLAB, 8 * Cfg<D>::ROW);
}
// whether the key tile at k0 holds a key that a row of the warpgroup
// (positions wg_first .. wg_last) sees
__device__ __forceinline__ bool tile_live(int k0, int causal, int window,
                                          int wg_first, int wg_last) {
  return (!causal || k0 <= wg_last) &&
         (window <= 0 || wg_first - (k0 + BK - 1) < window);
}
// whether it needs the element mask: it straddles the causal diagonal or
// the window edge of those rows, or holds keys past Sk
__device__ __forceinline__ bool tile_edge(int k0, int Sk, int causal,
                                          int window, int wg_first,
                                          int wg_last) {
  return k0 + BK > Sk || (causal && k0 + BK - 1 > wg_first) ||
         (window > 0 && wg_last - k0 >= window);
}
// a tile the warpgroup does not need: wait for it all the same, so that
// its release cannot count toward the stage's previous round
template <int D>
__device__ __forceinline__ void skip_tile(uint32_t q_full, int t) {
  const int s = t % Cfg<D>::STAGES;
  mbar_wait(full_k<D>(q_full, s), tile_parity<D>(t));
  mbar_wait(full_v<D>(q_full, s), tile_parity<D>(t));
  mbar_arrive(empty_bar<D>(q_full, s));
}

template <int D, bool CAP>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ o, int Sq, int Sk, int H, int KH,
                int n_qblocks, int causal, int window, float softcap,
                float scale) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  uint8_t* smem = smem_raw + pad;  // aligned to the 1024-byte swizzle atom
  const uint32_t sQ = raw + pad;
  const uint32_t sK = sQ + C::Q_BYTES;  // stage s at sK + s * KV_BYTES
  const uint32_t sV = sK + C::STAGES * C::KV_BYTES;
  const uint32_t q_full = sV + C::STAGES * C::KV_BYTES;

  const int h = blockIdx.x % H;
  const int qb = n_qblocks - 1 - (int)(blockIdx.x / H);  // longest rows first
  const int b = blockIdx.y;
  const int kh = h / (H / KH);
  const int q0 = qb * BQ;
  const int nq = min(BQ, Sq - q0);
  // keys that any row of this block may see; tiles outside are skipped
  const int first_q = q0 + Sk - Sq;
  const int last_q = first_q + nq - 1;
  const int k_end = causal ? min(Sk, last_q + 1) : Sk;
  const int k_lo = (window > 0 ? max(0, first_q - window + 1) : 0) / BK * BK;
  const int n_tiles = k_end > k_lo ? (k_end - k_lo + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full_k<D>(q_full, s), 1);
      mbar_init(full_v<D>(q_full, s), 1);
      mbar_init(empty_bar<D>(q_full, s), 2 * 128);  // each consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the role as a warp-uniform value (a shuffle from lane 0): without it
  // ptxas budgets the consumers at the launch's 168 registers, not the 240
  // that setmaxnreg gives them, and D 256 spills
  const int role = __shfl_sync(FULL, (int)threadIdx.x / 128, 0);
  if (role == 0) {
    // producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
      for (int j = 0; j < C::SLABS; ++j)
        tma_load(sQ + j * C::Q_SLAB, &tq, q_full, C::COLS * j, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % C::STAGES;
        mbar_wait(empty_bar<D>(q_full, s), tile_parity<D>(t) ^ 1);
        const int k0 = k_lo + t * BK;
        const uint32_t off = s * C::KV_BYTES;
        const uint32_t fk = full_k<D>(q_full, s), fv = full_v<D>(q_full, s);
        mbar_expect_tx(fk, C::KV_BYTES);
        for (int j = 0; j < C::SLABS; ++j)
          tma_load(sK + off + j * C::KV_SLAB, &tk, fk, C::COLS * j, kh, k0, b);
        mbar_expect_tx(fv, C::KV_BYTES);
        for (int j = 0; j < C::SLABS; ++j)
          tma_load(sV + off + j * C::KV_SLAB, &tv, fv, C::COLS * j, kh, k0, b);
      }
    }
  } else {
    // consumer warpgroup cw owns query rows 64 cw .. 64 cw + 63 of the block
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int ct = threadIdx.x - 128;
    const int cw = __shfl_sync(FULL, ct / 128, 0);  // warp-uniform, as role
    const int lane = ct & 31;
    // this thread's accumulator rows r0 and r0 + 8, columns col, col + 1
    // of every 8-column group (the wgmma fragment layout)
    const int r0 = cw * 64 + ((ct & 127) / 32) * 16 + lane / 4;
    const int col = 2 * (lane & 3);
    const int qpos = first_q + r0;
    const int wg_first = first_q + cw * 64;
    const int wg_last = wg_first + 63;
    // scores in log2 units: t = s * scale * log2(e), or with the softcap
    // t = cap * log2(e) * tanh(s * scale / cap)
    const float c_score = CAP ? 2.f * LOG2E * scale / softcap : LOG2E * scale;
    const float c_cap = softcap * LOG2E;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF};
    float l[2] = {0.f, 0.f};  // this thread's share of the row sums

    const uint64_t dq = make_desc<D>(sQ + cw * 64 * C::ROW, 16, 8 * C::ROW);
    // the tiles this warpgroup needs form one run [t0, t1): the causal
    // bound can cut its end, the window its start
    int t0 = 0;
    while (t0 < n_tiles &&
           !tile_live(k_lo + t0 * BK, causal, window, wg_first, wg_last))
      ++t0;
    int t1 = t0;
    while (t1 < n_tiles &&
           tile_live(k_lo + t1 * BK, causal, window, wg_first, wg_last))
      ++t1;

    float sc[BK / 2];
    uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
    float alpha[2];
    mbar_wait(q_full, 0);
    for (int t = 0; t < t0; ++t) skip_tile<D>(q_full, t);
    for (int t = t0; t < t1; ++t) {
      const int s = t % C::STAGES;
      const int k0 = k_lo + t * BK;
      mbar_wait(full_k<D>(q_full, s), tile_parity<D>(t));
      issue_s<D>(sc, dq, k_desc<D>(sK, t));
      wg_wait();
      pin(sc);
      softmax_tile<CAP>(
          sc, m, l, alpha, c_score, c_cap,
          tile_edge(k0, Sk, causal, window, wg_first, wg_last), k0, col, qpos,
          Sk, causal, window);
      rescale<D>(acc, alpha);
      pack_p(p_hi, p_lo, sc);
      mbar_wait(full_v<D>(q_full, s), tile_parity<D>(t));
      issue_pv<D>(acc, p_hi, p_lo, v_desc<D>(sV, t));
      wg_wait();
      pin(acc);
      mbar_arrive(empty_bar<D>(q_full, s));
    }
    for (int t = t1; t < n_tiles; ++t) skip_tile<D>(q_full, t);

    // normalise into this warpgroup's rows of Q's buffer (same swizzle),
    // then masked 16-byte stores of whole rows
    constexpr int CPR = C::ROW / 16;  // 16-byte chunks of a swizzled row
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(FULL, l[r], 1);
      l[r] += __shfl_xor_sync(FULL, l[r], 2);
      inv[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
    named_sync(1 + cw);
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        const uint32_t off =
            (i / CPR) * C::Q_SLAB +
            swizzle<C::ROW>(row * C::ROW + (i % CPR) * 16) + col * 2;
        *reinterpret_cast<uint32_t*>(smem + off) =
            pack_bf16(acc[4 * i + 2 * r] * inv[r],
                      acc[4 * i + 2 * r + 1] * inv[r]);
      }
    }
    named_sync(1 + cw);
    constexpr int CHUNKS = D / 8;  // 16-byte chunks of a row
    for (int idx = ct & 127; idx < 64 * CHUNKS; idx += 128) {
      const int row = cw * 64 + idx / CHUNKS;
      const int c = idx % CHUNKS;
      if (q0 + row < Sq) {
        const uint32_t off = (c / CPR) * C::Q_SLAB +
                             swizzle<C::ROW>(row * C::ROW + (c % CPR) * 16);
        *reinterpret_cast<uint4*>(
            o + (((int64_t)b * Sq + q0 + row) * H + h) * D + c * 8) =
            *reinterpret_cast<const uint4*>(smem + off);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links no libcuda of its own
EncodeTiled encode_tiled() {
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

// 4-D map over a contiguous bf16 [B, S, heads, D] tensor, dims innermost
// first (D, heads, S, B); boxes of `cols` columns x 1 head x `rows` x 1,
// swizzled over 2 * cols bytes (32, 64 or 128); out-of-bounds elements
// read as zero
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
              int D, int cols, int rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                              : CU_TENSOR_MAP_SWIZZLE_32B;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool CAP>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int KH, int causal, int window,
           float softcap, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  constexpr int cols = Cfg<D>::COLS;
  if (!make_map(&tq, q, B, Sq, H, D, cols, BQ) ||
      !make_map(&tk, k, B, Sk, KH, D, cols, BK) ||
      !make_map(&tv, v, B, Sk, KH, D, cols, BK))
    return (int)cudaErrorInvalidValue;
  const int n_qblocks = (Sq + BQ - 1) / BQ;
  if ((int64_t)n_qblocks * H > 0x7fffffff) return (int)cudaErrorInvalidValue;
  constexpr int smem = Cfg<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<D, CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_qblocks * H, B);
  flash_fwd_wgmma<D, CAP><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), Sq, Sk, H, KH, n_qblocks,
      causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

int launch_d(int D, const void* q, const void* k, const void* v, void* o,
             int B, int Sq, int Sk, int H, int KH, int causal, int window,
             float softcap, float scale, cudaStream_t stream) {
  const bool cap = softcap > 0.f;
  switch (D) {
    case 16:
      return cap ? launch<16, true>(q, k, v, o, B, Sq, Sk, H, KH, causal, window, softcap, scale, stream)
                 : launch<16, false>(q, k, v, o, B, Sq, Sk, H, KH, causal, window, softcap, scale, stream);
    case 32:
      return cap ? launch<32, true>(q, k, v, o, B, Sq, Sk, H, KH, causal, window, softcap, scale, stream)
                 : launch<32, false>(q, k, v, o, B, Sq, Sk, H, KH, causal, window, softcap, scale, stream);
    case 64:
      return cap ? launch<64, true>(q, k, v, o, B, Sq, Sk, H, KH, causal, window, softcap, scale, stream)
                 : launch<64, false>(q, k, v, o, B, Sq, Sk, H, KH, causal, window, softcap, scale, stream);
    case 128:
      return cap ? launch<128, true>(q, k, v, o, B, Sq, Sk, H, KH, causal, window, softcap, scale, stream)
                 : launch<128, false>(q, k, v, o, B, Sq, Sk, H, KH, causal, window, softcap, scale, stream);
    case 256:
      return cap ? launch<256, true>(q, k, v, o, B, Sq, Sk, H, KH, causal, window, softcap, scale, stream)
                 : launch<256, false>(q, k, v, o, B, Sq, Sk, H, KH, causal, window, softcap, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace hopper

}  // namespace

// q [B, Sq, H, D], k/v [B, Sk, KH, D], o [B, Sq, H, D], all contiguous,
// 16-byte aligned and of one type (is_bf16: bf16, on the Hopper kernel;
// else f32, on the CUDA-core kernel); D in {16, 32, 64, 128, 256}: the
// reduced configs' 16, the Pallas kernel's tests' 32 and the published
// configs' widths.
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
    return hopper::launch_d(D, q, k, v, o, B, Sq, Sk, H, KH, causal, window,
                            softcap, scale, s);
  return cuda_core::launch_d<float>(D, q, k, v, o, B, Sq, Sk, H, KH, causal,
                                    window, softcap, scale, s);
}
