// Neighborhood search and IDM acceleration for Hopper (sm_90a).
//
// Two searches behind a plain C interface (loaded with ctypes by
// repro_torch/kernels/idm.py), each a sort form up to 8192 slots and an
// all-pairs form past it. Each C entry launches on the caller's stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError().
//
// Built without --use_fast_math: the neighbor contract is bit-exact, and
// its arithmetic is one f32 subtraction plus comparisons per pair.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;      // all-pairs kernels: egos a block = tile
constexpr float kInf = 1e9f;     // INF of the reference
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSlots = 8192;  // the sorted instance fits shared memory
constexpr int kMaxThreads = 1024;
constexpr int kRows = 4;         // query rows searched side by side

// ---------------------------------------------------------------------------
// neighbor_mq: replaces repro/kernels/idm.py::neighbor_kernel
// (_neighbor_mq_kernel, the Pallas multi-query lead+follower search).
//
// For every (instance b, query row q, ego i): the argmin of the f32 gap over
// active vehicles j with lane[b,j] == the row's query lane strictly ahead
// and strictly behind; lowest j wins ties; absent neighbours give
// (0, INF - veh_len, false); inactive egos have none. The row's query lane
// is query_lanes[b,q,i], or q itself when query_lanes is null (a table
// build: row q asks every ego for its neighbours in lane q).
//
// Bound on an H100 SXM: bytes. It must read pos/lane/active [B,N] (and
// query_lanes [B,Q,N] when given) once and write 18 bytes per (b,q,i) at
// 3.35 TB/s: at the sweep's B 256, N 128, Q 4 that is 0.6 MB, under a
// microsecond, below what one launch takes.
//
// Design, for N <= kMaxSlots (neighbor_mq_wide below takes larger N): one
// block per instance (B on gridDim.x, so any B up to 2^31 - 1), which
// stages the instance once and answers all Q rows from it:
//   1. the active vehicles' keys: the lane's bits with the sign flipped,
//      above the position's bits made order-preserving (-0 folded into +0),
//      one unsigned 64-bit integer (unsigned order = (lane, pos) order);
//      inactive slots and the padding to P = the next power of two >=
//      max(N, 32) carry the largest key;
//   2. a bitonic sort of the keys, each with its slot, compared by key
//      alone: equal keys (one lane, one position) may end in any slot
//      order, since step 3 takes the lowest slot of a tie group itself.
//      T = min(P, 1024) threads, E = P / T keys a thread: strides below E
//      swap in registers, below 32 E between lanes by shuffles, longer ones
//      through shared memory. Up to 128 keys each warp sorts its 32 and the
//      runs are merged by rank (a key's place: its place in its run plus,
//      in each other run, the keys below it, or at or below it in the runs
//      before its own), which takes 13 dependent stages off the network;
//   3. per (row, ego), four rows side by side: a branchless binary search
//      for the row's key (query lane, pos_i) among the sorted keys; the
//      lead is the first entry past pos_i's tie group, the follower the
//      entry before it, each in the query lane; from each, every further
//      entry of the lane whose f32 gap equals the first one's (the tie
//      group of its position, and positions a rounded subtraction cannot
//      tell apart) is walked, keeping the lowest slot. That is exactly the
//      first-index argmin of the f32 gaps that the all-pairs scan computes.
// Work per instance: O(P log^2 P) for the sort and O(Q N log N) for the
// searches, against Q N^2 pair tests. At the sweep's shape one block's
// critical path (the loads, the sort, the searches) and the launch set the
// time (PERF.md). Trial builds that were slower there: one thread per
// (row, ego); one warp sorting four keys a lane; four runs sorted apart
// and each searched; runs of 16 merged; the rows one after another, each
// searching only its lane's run or starting from the ego's own place; the
// keys around each search result loaded before the walks.
// ---------------------------------------------------------------------------

// The sort key of an active vehicle: lane, then position, as one unsigned
// 64-bit integer (unsigned order = (lane, pos) order for non-NaN pos).
__device__ __forceinline__ uint64_t sort_key(int32_t lane, float pos) {
  uint32_t bits = __float_as_uint(pos);
  if (bits == 0x80000000u) bits = 0u;  // -0 == +0: one position
  const uint32_t ord = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  return (static_cast<uint64_t>(static_cast<uint32_t>(lane) ^ 0x80000000u)
          << 32) | ord;
}
__device__ __forceinline__ float key_pos(uint64_t key) {
  const uint32_t ord = static_cast<uint32_t>(key);
  return __uint_as_float((ord & 0x80000000u) ? (ord ^ 0x80000000u) : ~ord);
}
__device__ __forceinline__ uint32_t key_lane(uint64_t key) {
  return static_cast<uint32_t>(key >> 32);
}
// One compare-exchange of the bitonic sort, seen from element p, whose
// partner p ^ j holds (ko, so): the pair sorts ascending where p & k is 0,
// and the lower index keeps the smaller key of an ascending pair. Keys only:
// equal keys (one lane, one position) may end in any slot order, since the
// search below takes the lowest slot of a whole tie group itself.
__device__ __forceinline__ void exchange(uint64_t& key, int& slot,
                                         uint64_t ko, int so, int p, int j,
                                         int k) {
  const bool up = (p & k) == 0, low = (p & j) == 0;
  if (low == up ? ko < key : key < ko) {
    key = ko;
    slot = so;
  }
}

// The lowest slot among the entries from c on (step +1 or -1, inside
// [0, m)) in lane lane_b whose f32 gap to pos_i (step +1: ahead, -1:
// behind) equals entry c's; returns that gap in d.
__device__ __forceinline__ int lowest_slot(const uint64_t* __restrict__ s_key,
                                           const int32_t* __restrict__ s_slot,
                                           int c, int step, int m,
                                           uint32_t lane_b, float pos_i,
                                           float& d) {
  const float pc = key_pos(s_key[c]);
  d = step > 0 ? __fsub_rn(pc, pos_i) : __fsub_rn(pos_i, pc);
  int best = s_slot[c];
  for (c += step; c >= 0 && c < m; c += step) {
    const uint64_t kc = s_key[c];
    if (key_lane(kc) != lane_b) break;
    const float pn = key_pos(kc);
    if ((step > 0 ? __fsub_rn(pn, pos_i) : __fsub_rn(pos_i, pn)) != d) break;
    best = min(best, s_slot[c]);
  }
  return best;
}

// Every row of ego i (position pos_i, active act_i) against the sorted
// keys; with kPre, ql0 holds the query lanes of rows 0 .. kRows - 1.
template <bool kPre>
__device__ __forceinline__ void answer_rows(
    const uint64_t* __restrict__ s_key, const int32_t* __restrict__ s_slot,
    int P, int m, const int32_t* __restrict__ query_lanes,
    const int32_t (&ql0)[kRows], int64_t b, int Q, int N, int i, float pos_i,
    bool act_i, float veh_len, int32_t* __restrict__ lead_idx,
    float* __restrict__ lead_gap, uint8_t* __restrict__ has_lead,
    int32_t* __restrict__ foll_idx, float* __restrict__ foll_gap,
    uint8_t* __restrict__ has_foll) {
  for (int q0 = 0; q0 < Q; q0 += kRows) {
    uint64_t tk[kRows];
    int lo[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int q = min(q0 + r, Q - 1);
      int32_t ql = q;
      if (query_lanes)
        ql = kPre && q0 == 0 ? ql0[r] : query_lanes[(b * Q + q) * N + i];
      tk[r] = sort_key(ql, pos_i);
      lo[r] = 0;
    }
    // lo = the number of keys below tk (the padding's keys are the
    // largest, so searching all P keys finds the same count as m)
    for (int s = P >> 1; s > 0; s >>= 1) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (s_key[lo[r] + s - 1] < tk[r]) lo[r] += s;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int q = q0 + r;
      if (q >= Q) break;
      const int lo_r = min(lo[r] + (s_key[lo[r]] < tk[r] ? 1 : 0), m);
      const uint32_t lane_b = key_lane(tk[r]);
      float lg = kInf, fg = kInf;
      int li = 0, fi = 0;
      bool hl = false, hf = false;
      if (act_i) {
        int c = lo_r;
        while (c < m && s_key[c] == tk[r]) ++c;  // pos_i's tie group
        if (c < m && key_lane(s_key[c]) == lane_b) {
          hl = true;
          li = lowest_slot(s_key, s_slot, c, 1, m, lane_b, pos_i, lg);
        }
        c = lo_r - 1;
        if (c >= 0 && key_lane(s_key[c]) == lane_b) {
          hf = true;
          fi = lowest_slot(s_key, s_slot, c, -1, m, lane_b, pos_i, fg);
        }
      }
      const int64_t out = (b * Q + q) * N + i;
      lead_idx[out] = li;
      lead_gap[out] = __fsub_rn(lg, veh_len);
      has_lead[out] = hl;
      foll_idx[out] = fi;
      foll_gap[out] = __fsub_rn(fg, veh_len);
      has_foll[out] = hf;
    }
  }
}

// Stages 1-2 of both sort kernels (neighbor_mq_kernel, idm_accel_sort):
// instance pb/lb/ab of N slots, P entries, this thread t holding E of them.
//   1. this thread's E vehicles, p = t E .. t E + E - 1: keys for the sort,
//      and, kept for the search, their positions, flags and lanes; then
//      pre() (a kernel's own loads, issued before the sort so that their
//      latency hides under it);
//   2. the bitonic sort of the P entries, ascending; up to 128 entries,
//      each warp sorts its 32 and the runs are merged by rank.
// Leaves the sorted keys and their slots in s_key, s_slot (after a
// __syncthreads) and returns m, the active vehicles: the sorted keys'
// length.
template <int E, class Pre>
__device__ __forceinline__ int sort_instance(
    const float* __restrict__ pb, const int32_t* __restrict__ lb,
    const uint8_t* __restrict__ ab, int N, int P, int t,
    uint64_t* __restrict__ s_key, int32_t* __restrict__ s_slot,
    float (&pos_r)[E], bool (&act_r)[E], int32_t (&lane_r)[E], Pre pre) {
  uint64_t key[E];
  int slot[E];
  int m = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int p = t * E + e;
    pos_r[e] = p < N ? pb[p] : 0.0f;
    act_r[e] = p < N && ab[p] != 0;
    lane_r[e] = act_r[e] ? lb[p] : 0;
    key[e] = act_r[e] ? sort_key(lane_r[e], pos_r[e]) : ~0ull;
    slot[e] = p;
  }
  pre();
#pragma unroll
  for (int e = 0; e < E; ++e) m += __syncthreads_count(act_r[e]);

  const bool merge = P <= 4 * 32 && E == 1;
  const int sorted = merge ? 32 : P;  // the network sorts runs this long
  for (int k = 2; k <= sorted; k <<= 1) {
    const int dir = k == sorted ? P : k;  // p & dir == 0: sort up
    for (int j = k >> 1; j >= E; j >>= 1) {
      if (j >= 32 * E) {  // partner in another warp
#pragma unroll
        for (int e = 0; e < E; ++e) {
          s_key[t * E + e] = key[e];
          s_slot[t * E + e] = slot[e];
        }
        __syncthreads();
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int p = t * E + e;
          exchange(key[e], slot[e], s_key[p ^ j], s_slot[p ^ j], p, j, dir);
        }
        __syncthreads();
      } else {  // partner in this warp, same register
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const uint64_t ko = __shfl_xor_sync(kFull, key[e], j / E);
          const int so = __shfl_xor_sync(kFull, slot[e], j / E);
          exchange(key[e], slot[e], ko, so, t * E + e, j, dir);
        }
      }
    }
#pragma unroll
    for (int j = E >> 1; j >= 1; j >>= 1) {  // partner in this thread
      if (j < k) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if (e & j) continue;
          const int f = e | j;  // the pair (e, f), f the upper index
          const bool up = ((t * E + e) & dir) == 0;
          if (up ? key[f] < key[e] : key[e] < key[f]) {
            const uint64_t kk = key[e];
            const int ss = slot[e];
            key[e] = key[f];
            slot[e] = slot[f];
            key[f] = kk;
            slot[f] = ss;
          }
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    s_key[t * E + e] = key[e];
    s_slot[t * E + e] = slot[e];
  }
  __syncthreads();
  // 2b. the merge of up to four sorted runs of 32: each key's place is its
  // place in its run plus, in each other run, the keys below it (at or
  // below it in the runs before its own, so that equal keys keep the runs'
  // order and every place is taken once)
  if (merge && P > 32) {
    const int run = t / 32;
    int place = t % 32;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (u == run || u >= P / 32) continue;
      const uint64_t* r = s_key + u * 32;
      int lo = 0;
      if (u < run) {
        for (int w = 16; w > 0; w >>= 1)
          if (r[lo + w - 1] <= key[0]) lo += w;
        place += lo + (r[lo] <= key[0] ? 1 : 0);
      } else {
        for (int w = 16; w > 0; w >>= 1)
          if (r[lo + w - 1] < key[0]) lo += w;
        place += lo + (r[lo] < key[0] ? 1 : 0);
      }
    }
    __syncthreads();
    s_key[place] = key[0];
    s_slot[place] = slot[0];
    __syncthreads();
  }
  return m;
}

template <int E>
__global__ void __launch_bounds__(kMaxThreads)
neighbor_mq_kernel(const float* __restrict__ pos,
                   const int32_t* __restrict__ lane,
                   const uint8_t* __restrict__ active,
                   const int32_t* __restrict__ query_lanes, int Q, int N,
                   int P, float veh_len, int32_t* __restrict__ lead_idx,
                   float* __restrict__ lead_gap, uint8_t* __restrict__ has_lead,
                   int32_t* __restrict__ foll_idx, float* __restrict__ foll_gap,
                   uint8_t* __restrict__ has_foll) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* s_key = reinterpret_cast<uint64_t*>(smem);
  int32_t* s_slot = reinterpret_cast<int32_t*>(s_key + P);

  const int t = threadIdx.x;  // blockDim.x = P / E
  const int64_t b = blockIdx.x;

  // 1-2: the sorted instance; with one vehicle a thread, its first rows'
  // query lanes are loaded before the sort
  float pos_r[E];
  bool act_r[E];
  int32_t lane_r[E];
  int32_t ql0[kRows] = {};
  const int m = sort_instance<E>(
      pos + b * N, lane + b * N, active + b * N, N, P, t, s_key, s_slot,
      pos_r, act_r, lane_r, [&] {
        if (E == 1 && query_lanes && t < N) {
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            ql0[r] = query_lanes[(b * Q + min(r, Q - 1)) * N + t];
        }
      });

  // 3. every (row, ego) of this thread's vehicles: search, then the lowest
  // slot at the nearest gap
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = t * E + e;
    if (i < N)
      answer_rows<E == 1>(s_key, s_slot, P, m, query_lanes, ql0, b, Q, N, i,
                  pos_r[e], act_r[e], veh_len, lead_idx, lead_gap, has_lead,
                  foll_idx, foll_gap, has_foll);
  }
}

template <int E>
int neighbor_mq_run(int B, int P, size_t smem, cudaStream_t stream,
                    const float* pos, const int32_t* lane,
                    const uint8_t* active, const int32_t* query_lanes, int Q,
                    int N, float veh_len, int32_t* li, float* lg, uint8_t* lh,
                    int32_t* fi, float* fg, uint8_t* fh) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        neighbor_mq_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  neighbor_mq_kernel<E><<<B, P / E, smem, stream>>>(
      pos, lane, active, query_lanes, Q, N, P, veh_len, li, lg, lh, fi, fg,
      fh);
  return static_cast<int>(cudaGetLastError());
}

// neighbor_mq_wide: the same contract for N > kMaxSlots, whose sort keys do
// not fit one block's shared memory. The all-pairs form: one thread per
// (b, q, i), the (instance, row, ego tile) triples along gridDim.x; each
// block stages instance b one 128-wide tile at a time in shared memory and
// keeps the running (gap, idx) minima of both directions in registers. j is
// walked in increasing order with a strict < update, so the lowest slot
// wins ties as in the reference's first argmin. Q N^2 pair tests an
// instance: off the sweep's shapes (N 128), so left simple.
__global__ void __launch_bounds__(kBlock)
neighbor_mq_wide(const float* __restrict__ pos,
                 const int32_t* __restrict__ lane,
                 const uint8_t* __restrict__ active,
                 const int32_t* __restrict__ query_lanes, int Q, int N,
                 float veh_len, int32_t* __restrict__ lead_idx,
                 float* __restrict__ lead_gap, uint8_t* __restrict__ has_lead,
                 int32_t* __restrict__ foll_idx, float* __restrict__ foll_gap,
                 uint8_t* __restrict__ has_foll) {
  __shared__ float s_pos[kBlock];
  __shared__ int32_t s_lane[kBlock];
  __shared__ uint8_t s_act[kBlock];

  const int tiles = (N + kBlock - 1) / kBlock;
  const int64_t bq = blockIdx.x / tiles;  // b * Q + q
  const int q = static_cast<int>(bq % Q);
  const int64_t b = bq / Q;
  const int i = (blockIdx.x % tiles) * kBlock + threadIdx.x;
  const bool valid = i < N;
  const int64_t row = b * N;
  const int64_t out = bq * N + i;

  const float my_pos = valid ? pos[row + i] : 0.f;
  const bool my_act = valid && active[row + i] != 0;
  const int32_t my_q = !valid ? 0 : query_lanes ? query_lanes[out] : q;

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
          const float d = __fsub_rn(s_pos[t], my_pos);
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
// repro/kernels/idm.py:74-92. Bound on an H100 SXM: bytes, nine [B,N]
// inputs read once plus one f32 [B,N] output at 3.35 TB/s.
//
// Design, for N <= kMaxSlots (idm_accel_sort): one block per instance (B on
// gridDim.x), which sorts the instance's (lane, position) keys with their
// slots as neighbor_mq_kernel does (sort_instance), the velocities staged
// in shared memory by slot beside them. Each ego then makes one search,
// for its own key sort_key(lane_i, pos_i): the lead is the first entry
// past pos_i's tie group, if it lies in the ego's lane; from it, every
// further entry of the lane whose f32 gap equals the first one's is
// walked, keeping the lowest slot (lowest_slot), and that slot's velocity
// is the lead's. So where two vehicles share a position, or their gaps
// round to one f32 value while the nearer position is not the lowest
// slot, the lead is the lowest slot and its velocity goes into dv: exactly
// the first-index argmin of the all-pairs scan and of the Pallas kernel
// (argmin inside a tile, strict < across tiles). An inactive ego has no
// lead and still gets the epilogue. Work per instance: O(P log^2 P) for
// the sort and O(N log N) for the searches, against N^2 pair tests.
//
// Past kMaxSlots (the keys would not fit shared memory) the same C entry
// launches the all-pairs form, idm_accel_wide: one thread per ego walks
// the instance one 128-wide shared-memory tile at a time in slot order
// with a strict < update; the (instance, ego tile) pairs run along
// gridDim.x. idm_accel_wide_launch exports it at any N, as the oracle that
// the sort form equals bit for bit.
//
// Both forms end in idm_epilogue, whose _rn intrinsics keep nvcc from
// contracting it into fused multiply-adds: each operation rounds as the
// plain PyTorch version's separate element-wise operations do, and the two
// forms differ only if their leads do.
// ---------------------------------------------------------------------------

struct IdmArgs {
  const float* __restrict__ pos;
  const float* __restrict__ vel;
  const int32_t* __restrict__ lane;
  const uint8_t* __restrict__ active;
  const float* __restrict__ v0;
  const float* __restrict__ T;
  const float* __restrict__ a_max;
  const float* __restrict__ b_comf;
  const float* __restrict__ s0;
  int N;
  float veh_len;
  float* __restrict__ acc;
};

// The ego's own inputs to the epilogue, element k of the [B, N] arrays.
struct IdmEgo {
  float v, v0, T, am, bc, s0;
};
__device__ __forceinline__ IdmEgo idm_ego(const IdmArgs& a, int64_t k) {
  return {a.vel[k], a.v0[k], a.T[k], a.a_max[k], a.b_comf[k], a.s0[k]};
}

// IDM for ego g with lead gap lg (kInf: no lead) and lead velocity vlead.
__device__ __forceinline__ float idm_epilogue(const IdmEgo& g, float lg,
                                              float vlead, float veh_len) {
  const bool has = lg < 0.5f * kInf;
  const float gap = fmaxf(has ? __fsub_rn(lg, veh_len) : kInf, 0.1f);
  const float dv = has ? __fsub_rn(g.v, vlead) : 0.f;
  const float denom = __fmul_rn(2.0f, __fsqrt_rn(__fmul_rn(g.am, g.bc)));
  const float push = __fadd_rn(__fmul_rn(g.v, g.T),
                               __fdiv_rn(__fmul_rn(g.v, dv), denom));
  const float s_star = __fadd_rn(g.s0, fmaxf(0.f, push));
  const float r = __fdiv_rn(g.v, fmaxf(g.v0, 0.1f));
  const float r2 = __fmul_rn(r, r);
  const float q = __fdiv_rn(s_star, gap);
  return __fmul_rn(g.am, __fsub_rn(__fsub_rn(1.0f, __fmul_rn(r2, r2)),
                                   __fmul_rn(q, q)));
}

template <int E>
__global__ void __launch_bounds__(kMaxThreads) idm_accel_sort(IdmArgs a,
                                                              int P) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* s_key = reinterpret_cast<uint64_t*>(smem);
  int32_t* s_slot = reinterpret_cast<int32_t*>(s_key + P);
  float* s_vel = reinterpret_cast<float*>(s_slot + P);

  const int t = threadIdx.x;  // blockDim.x = P / E
  const int N = a.N;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * N;

  // 1-2: the sorted instance; before the sort, the velocities go to shared
  // memory by slot and, with one vehicle a thread, its own epilogue inputs
  // into registers
  float pos_r[E];
  bool act_r[E];
  int32_t lane_r[E];
  IdmEgo ego{};
  const int m = sort_instance<E>(
      a.pos + row, a.lane + row, a.active + row, N, P, t, s_key, s_slot,
      pos_r, act_r, lane_r, [&] {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int p = t * E + e;
          if (p < N) s_vel[p] = a.vel[row + p];
        }
        if (E == 1 && t < N) ego = idm_ego(a, row + t);
      });

  // 3. every ego of this thread: its own key's search, the lowest slot at
  // the nearest gap ahead, its velocity, the epilogue
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = t * E + e;
    if (i >= N) break;
    float lg = kInf, vlead = 0.f;
    if (act_r[e]) {
      const uint64_t tk = sort_key(lane_r[e], pos_r[e]);
      int lo = 0;  // the number of keys below tk, as in answer_rows
      for (int s = P >> 1; s > 0; s >>= 1)
        if (s_key[lo + s - 1] < tk) lo += s;
      int c = min(lo + (s_key[lo] < tk ? 1 : 0), m);
      while (c < m && s_key[c] == tk) ++c;  // pos_i's tie group
      const uint32_t lane_b = key_lane(tk);
      if (c < m && key_lane(s_key[c]) == lane_b)
        vlead = s_vel[lowest_slot(s_key, s_slot, c, 1, m, lane_b, pos_r[e],
                                  lg)];
    }
    a.acc[row + i] = idm_epilogue(E == 1 ? ego : idm_ego(a, row + i), lg,
                                  vlead, a.veh_len);
  }
}

template <int E>
int idm_accel_sort_run(const IdmArgs& a, int B, int P, cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(P) * (sizeof(uint64_t) + sizeof(int32_t) +
                                sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        idm_accel_sort<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  idm_accel_sort<E><<<B, P / E, smem, stream>>>(a, P);
  return static_cast<int>(cudaGetLastError());
}

__global__ void __launch_bounds__(kBlock) idm_accel_wide(IdmArgs a) {
  __shared__ float s_pos[kBlock];
  __shared__ float s_vel[kBlock];
  __shared__ int32_t s_lane[kBlock];
  __shared__ uint8_t s_act[kBlock];

  const int N = a.N;
  const int tiles = (N + kBlock - 1) / kBlock;
  const int64_t b = blockIdx.x / tiles;
  const int i = (blockIdx.x % tiles) * kBlock + threadIdx.x;
  const bool valid = i < N;
  const int64_t row = b * N;

  const float my_pos = valid ? a.pos[row + i] : 0.f;
  const bool my_act = valid && a.active[row + i] != 0;
  const int32_t my_lane = valid ? a.lane[row + i] : 0;

  float lg = kInf, vlead = 0.f;
  for (int j0 = 0; j0 < N; j0 += kBlock) {
    const int j = j0 + threadIdx.x;
    if (j < N) {
      s_pos[threadIdx.x] = a.pos[row + j];
      s_vel[threadIdx.x] = a.vel[row + j];
      s_lane[threadIdx.x] = a.lane[row + j];
      s_act[threadIdx.x] = a.active[row + j];
    }
    __syncthreads();
    const int jn = min(kBlock, N - j0);
    if (my_act) {
      for (int t = 0; t < jn; ++t) {
        if (s_act[t] && s_lane[t] == my_lane) {
          const float d = __fsub_rn(s_pos[t], my_pos);
          if (d > 0.f && d < lg) { lg = d; vlead = s_vel[t]; }
        }
      }
    }
    __syncthreads();
  }
  if (valid)
    a.acc[row + i] = idm_epilogue(idm_ego(a, row + i), lg, vlead, a.veh_len);
}

int idm_accel_wide_run(const IdmArgs& a, int B, cudaStream_t stream) {
  const int64_t blocks =
      static_cast<int64_t>(B) * ((a.N + kBlock - 1) / kBlock);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  idm_accel_wide<<<static_cast<unsigned>(blocks), kBlock, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

IdmArgs idm_args(const void* pos, const void* vel, const void* lane,
                 const void* active, const void* v0, const void* T,
                 const void* a_max, const void* b_comf, const void* s0, int N,
                 float veh_len, void* acc) {
  return {static_cast<const float*>(pos),    static_cast<const float*>(vel),
          static_cast<const int32_t*>(lane), static_cast<const uint8_t*>(active),
          static_cast<const float*>(v0),     static_cast<const float*>(T),
          static_cast<const float*>(a_max),  static_cast<const float*>(b_comf),
          static_cast<const float*>(s0),     N,
          veh_len,                           static_cast<float*>(acc)};
}

}  // namespace

extern "C" {

// pos f32, lane i32, active bool [B, N]; query_lanes i32 [B, Q, N] or null
// (row q queries lane q); the six outputs [B, Q, N]; all contiguous.
// Returns the CUDA error of the launch (0 when it was accepted).
int neighbor_mq_launch(const void* pos, const void* lane, const void* active,
                       const void* query_lanes, int B, int Q, int N,
                       float veh_len, void* lead_idx, void* lead_gap,
                       void* has_lead, void* foll_idx, void* foll_gap,
                       void* has_foll, void* stream) {
  if (B < 0 || Q < 0 || N < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Q == 0 || N == 0) return 0;
  if (N > kMaxSlots) {
    const int64_t blocks =
        static_cast<int64_t>(B) * Q * ((N + kBlock - 1) / kBlock);
    if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    neighbor_mq_wide<<<static_cast<unsigned>(blocks), kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pos), static_cast<const int32_t*>(lane),
        static_cast<const uint8_t*>(active),
        static_cast<const int32_t*>(query_lanes), Q, N, veh_len,
        static_cast<int32_t*>(lead_idx), static_cast<float*>(lead_gap),
        static_cast<uint8_t*>(has_lead), static_cast<int32_t*>(foll_idx),
        static_cast<float*>(foll_gap), static_cast<uint8_t*>(has_foll));
    return static_cast<int>(cudaGetLastError());
  }
  int P = 32;
  while (P < N) P <<= 1;
  const size_t smem = static_cast<size_t>(P) * (sizeof(uint64_t) + 4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const float*>(pos);
  const auto* l = static_cast<const int32_t*>(lane);
  const auto* a = static_cast<const uint8_t*>(active);
  const auto* q = static_cast<const int32_t*>(query_lanes);
  auto* li = static_cast<int32_t*>(lead_idx);
  auto* lg = static_cast<float*>(lead_gap);
  auto* lh = static_cast<uint8_t*>(has_lead);
  auto* fi = static_cast<int32_t*>(foll_idx);
  auto* fg = static_cast<float*>(foll_gap);
  auto* fh = static_cast<uint8_t*>(has_foll);
  switch (P / kMaxThreads) {  // E = P / T keys a thread
    case 0:
    case 1:
      return neighbor_mq_run<1>(B, P, smem, s, p, l, a, q, Q, N, veh_len, li,
                                lg, lh, fi, fg, fh);
    case 2:
      return neighbor_mq_run<2>(B, P, smem, s, p, l, a, q, Q, N, veh_len, li,
                                lg, lh, fi, fg, fh);
    case 4:
      return neighbor_mq_run<4>(B, P, smem, s, p, l, a, q, Q, N, veh_len, li,
                                lg, lh, fi, fg, fh);
    default:
      return neighbor_mq_run<8>(B, P, smem, s, p, l, a, q, Q, N, veh_len, li,
                                lg, lh, fi, fg, fh);
  }
}

// The nine [B, N] inputs (f32; lane i32, active bool) and acc f32 [B, N],
// all contiguous: the sort form up to kMaxSlots slots, the all-pairs form
// past it. Returns the CUDA error of the launch.
int idm_accel_launch(const void* pos, const void* vel, const void* lane,
                     const void* active, const void* v0, const void* T,
                     const void* a_max, const void* b_comf, const void* s0,
                     int B, int N, float veh_len, void* acc, void* stream) {
  if (B < 0 || N < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return 0;
  const IdmArgs a = idm_args(pos, vel, lane, active, v0, T, a_max, b_comf,
                             s0, N, veh_len, acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N > kMaxSlots) return idm_accel_wide_run(a, B, s);
  int P = 32;
  while (P < N) P <<= 1;
  switch (P / kMaxThreads) {  // E = P / T keys a thread
    case 0:
    case 1:
      return idm_accel_sort_run<1>(a, B, P, s);
    case 2:
      return idm_accel_sort_run<2>(a, B, P, s);
    case 4:
      return idm_accel_sort_run<4>(a, B, P, s);
    default:
      return idm_accel_sort_run<8>(a, B, P, s);
  }
}

// The same arguments; the all-pairs form at any N (the sort form's oracle).
int idm_accel_wide_launch(const void* pos, const void* vel, const void* lane,
                          const void* active, const void* v0, const void* T,
                          const void* a_max, const void* b_comf,
                          const void* s0, int B, int N, float veh_len,
                          void* acc, void* stream) {
  if (B < 0 || N < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return 0;
  return idm_accel_wide_run(
      idm_args(pos, vel, lane, active, v0, T, a_max, b_comf, s0, N, veh_len,
               acc),
      B, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
