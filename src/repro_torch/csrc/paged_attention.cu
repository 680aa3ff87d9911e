// Paged decode attention for Hopper (sm_90a), plain C interface: the
// port's kernels 3 (bf16 KV) and 3b (int8 KV).
//
// Replaces the Pallas TPU kernel paged_attention_kernel
// (src/repro/kernels/paged_attention/paged_attention.py:109, body _kernel
// :49; its int8-KV branch :49-56, :77-78, :92-94).  q [B, Hq, 1, D] and
// page pools [P, page, Hkv, D] (f32 or bf16 in q's dtype, or int8 with
// bf16 scale pools [P, page, Hkv, 1]; page 0 = the null page), block table
// int32 [B, pps], pos / start int32 [B] -> out f32 [B, Hq, 1, D].  Column
// j = table order * page + offset attends iff start[b] <= j <= pos[b] and
// its page id is non-zero.  As in the plain version (paged_attention_ref),
// the scores are (q . k) * scale, then times the column's K scale (int8);
// l sums the unscaled f32 probabilities; the column's V scale is folded
// into its probability, which is rounded to q's dtype before the value
// product.  An all-null slot gives exact zeros.
//
// What bounds it on the H100.  A decode step reads each live K/V row once
// for the G = Hq / Hkv q rows of its kv head, ~2 G flops a byte, far below
// the card's balance: at long context HBM bytes bound it (8 slots x 4096
// tokens, 16 / 2 heads, D 128: 33.5 MB of bf16 pages, 10 us at 3.35 TB/s).
// At the serving tick (8 slots of <= 576 tokens, under 2 MB) the bytes take
// under a microsecond, and the launch's latency and the DRAM round trips
// (the table, then the pages it names) bound it.
//
// Design: a split-KV flash-decode in one launch.
// - Grid (splits, Hkv, B).  The wrapper's split_plan cuts each table row
//   into runs of `pp` pages, enough that B Hkv splits >= 2 SMs where the
//   table allows (the tick's 8 slots x 2 kv heads x 36 pages: 18 runs of 2
//   pages, 288 blocks), and of at most 64 pages (the wrapper's
//   MAX_RUN_PAGES), since a block holds its run's table entries and, with
//   int8 pools, its rows' K and V scales in shared memory.  The plan comes
//   from shapes only: the host reads nothing of pos, start or the table.
// - A block serves the G q rows of one kv head over its run, so each K/V
//   byte is read once per kv head.  It reads its run's table entries once,
//   clipped to [start, pos], then copies the rows' K and V with 16-byte
//   cp.async (row stride Hkv D; rows of null pages are zero-filled, no
//   read) into a ring of NST stages of CH = 32 rows.  A run of up to NST
//   stages (the tick's two pages) is all in flight before the first wait:
//   one DRAM round trip.  A run wholly past pos, before start or on null
//   pages exits early with an empty partial (m = -inf, l = 0).
// - bf16 q (kernels 3 and 3b): both products on the tensor cores with
//   mma.sync, bf16 -> f32.  The G <= 16 q rows pad to 16 (wgmma needs 64
//   rows; decode has at most 16 a kv head).  Warp w takes columns 8 w ..
//   8 w + 7 of each 32-row stage: S = Q K^T by m16n8k16 (the k steps in
//   two chains), its own online softmax in registers, and O += P V over
//   all of D by m16n8k8, P being the bf16 probabilities in the score
//   accumulator's own layout (k = the warp's 8 columns).  After the run
//   the four warps' (m, l, O) merge in shared memory, in warp order, into
//   the block's partial.  The operands are the plain version's: q and k in
//   bf16, int8 codes converted to bf16 as the fragments load (exact:
//   |c| <= 127 needs 7 significant bits), p rounded to bf16.  Only the
//   order of the f32 sums moves.  float32 q keeps the CUDA cores (lane j
//   scores column j of a page, the run's pages walked in series), with the
//   same split and combine.
// - The combine is in the same launch.  Each block writes its partial (m,
//   l, acc [G, D]) in f32 to the workspace; its thread 0 fences and takes a
//   ticket for the (slot, kv head).  The last block to arrive combines the
//   partials in split order 0 .. S-1, out = sum_s e^(m_s - M) acc_s /
//   sum_s e^(m_s - M) l_s, and resets its ticket to 0 (the pattern of
//   int8_stream.cuh).  No float atomic, no second launch, no memset: the
//   result repeats bit for bit.  With one split the block writes out
//   itself.
//
// Rounding.  Each warp rounds its probabilities against its own running
// max (over its columns of the split's stages so far), as an online
// softmax does tile by tile; the plain version rounds against the row's
// final max.  A bf16 rounding moves p = e^(s - m) by at most 2^-8 of
// itself whatever m is, and the rescales by e^(m_w - M) (warps, then
// splits) are f32, so column j's weight differs from the plain version's
// by at most ~2^-7 of itself (one rounding on each side) and the output by
// at most 2^-7 att|v|: inside TOL_BF16 = 2^-6 att|v| of chip_smoke.py.
// float32 q rounds nothing; the sides differ only in the order of their
// f32 sums (TOL_F32).
//
// The ring form (RING = true; C entry ring_decode_attention): the decode
// read of a sliding-window ring (models/kv_cache.py RingCache), which the
// reference sends to its jnp core with an explicit mask
// (src/repro/models/attention.py:179, 203; kv_cache.py:377-385): it
// reaches no Pallas kernel, and this form takes the place of kernel 2's
// ring form.  The pools are the ring's as stored, [B, W, Hkv, D] (int8
// with bf16 scale pools [B, W, Hkv, 1]), read in place: row j of slot b,
// kv head h at ((b W + j) Hkv + h) D, the row stride Hkv D as a page's.
// There is no table.  A split is a run of `pp` rows (a multiple of CH,
// the wrapper's ring_split_plan: B Hkv splits >= 2 SMs where W allows,
// the tick's 8 slots x 4 kv heads x 4096 rows in 10 runs of 448 rows, 320
// blocks; at most 2048 rows, for the int8 rows' scales in shared memory).
// Each block computes the seam r = pos mod W once; a row's live flag is
// ring_attends (ring.cuh: its position pos - ((pos - j) mod W) written, in
// [start, pos] and in the window).  The live rows are one or two runs
// around the seam, so a split's liveness and its stages' range come from
// the flags of its rows (first and last live row), not from a column
// range; a split with none exits with the empty partial, and dead rows
// inside the range are zero-filled without a read, as null pages are.
// The rest is kernel 3's: the G rows on the tensor cores, the cp.async
// ring, each warp's online softmax, the ticket combine in split order.
// Its rounding is kernel 3's (above), bound and all.  What bounds it on
// the H100 is the live rows' bytes: at the starcoder2-15b tick (8 slots,
// 48 / 4 heads, D 128, a 4096-row ring) 51 MB of bf16 K/V, 15 us at 3.35
// TB/s; each live row is read once per kv head, not once per q head.
//
// `fault` is a check hook, 0 on every path of the port: 1 makes the
// combine drop the last live split, 2 (ring form) reads rows as if row j
// held position j (the ring unrotated); planted faults of chip_smoke.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

#include "online_softmax.cuh"
#include "ring.cuh"
#include "sm90.cuh"

namespace {

using namespace ent_attn;

constexpr int NWARPS = 4;
constexpr int NT = NWARPS * 32;
constexpr int MAXG = 16;            // q rows per kv head: one m16 tile
constexpr int RPW = MAXG / NWARPS;  // CUDA-core kernel: q rows a warp, at most
constexpr int MAXPAGE = 32;         // CUDA-core kernel: one lane per page column
constexpr int CH = 32;              // tensor-core kernel: rows (S columns) a stage
constexpr int NST = 3;              // its ring of stages
constexpr size_t MAX_SMEM = 232448; // a block's shared memory on the H100

// Whether row j of a slot's ring attends a read at pos p_b (seam r):
// ring_attends, or with fault 2 the ring read unrotated (row j as position
// j).
__device__ __forceinline__ bool ring_row_live(int j, int p_b, int r, int W, int s_b, int window,
                                              int fault) {
  return fault == 2 ? pos_attends(j, p_b, s_b, window) : ring_attends(j, p_b, r, W, s_b, window);
}

// The split's columns that can attend: [c_lo, c_hi] (empty if c_lo > c_hi).
__device__ __forceinline__ void split_cols(int s, int pp, int pps, int page, int p_b,
                                           int s_b, int& c_lo, int& c_hi) {
  const int pg0 = s * pp, pg1 = min(pg0 + pp, pps);
  c_lo = max(pg0 * page, s_b);
  c_hi = min(pg1 * page - 1, p_b);
}

// Split workspace of one (slot, kv head): partial sums [S, G, D] and (m, l)
// pairs [S, G, 2].  The launch's workspace holds every (slot, kv head)'s
// sums, then every one's pairs: [B, Hkv, S, G, D] + [B, Hkv, S, G, 2].
struct Partials {
  float* acc;
  float* ml;
  __device__ Partials(float* ws, int B, int Hkv, int bh, int S, int G, int D)
      : acc(ws + static_cast<size_t>(bh) * S * G * D),
        ml(ws + static_cast<size_t>(B) * Hkv * S * G * D + static_cast<size_t>(bh) * S * G * 2) {}
};

// a += w v unless w = 0 (a split that attended nothing, or was dropped:
// its words are not read into the sum).
__device__ __forceinline__ void fma4(float4& a, float w, const float4& v) {
  if (w != 0.0f) {
    a.x = fmaf(w, v.x, a.x);
    a.y = fmaf(w, v.y, a.y);
    a.z = fmaf(w, v.z, a.z);
    a.w = fmaf(w, v.w, a.w);
  }
}

// Called by every thread of a block after its partial is written: the last
// block of the (slot, kv head) to arrive combines the S partials in split
// order into out (row g at out + g D) and resets the ticket.  `sm` holds
// 2 G S floats.  A split with l = 0 attended nothing and weighs 0: its
// words are not read.  Thread 0 fences for the block (after the barrier,
// the fence is cumulative over the block's writes), and the code of this
// tail, which one block in S runs, is kept short.
template <int D>
__device__ void combine(const Partials& pt, int* ticket, float* __restrict__ out, int G,
                        int S, int fault, float* sm) {
  __shared__ int last;
  __syncthreads();   // the block's partial is written
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1) == S - 1;
    if (last) __threadfence();
  }
  __syncthreads();
  if (!last) return;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  float* sw = sm;          // [G][S]: m, then each split's weight
  float* sl = sm + G * S;  // [G][S]: l
  for (int i = tid; i < G * S; i += NT) {   // i = s G + g
    const float2 v = __ldcg(reinterpret_cast<const float2*>(pt.ml) + i);
    sw[(i % G) * S + i / G] = v.x;
    sl[(i % G) * S + i / G] = v.y;
  }
  __syncthreads();
  for (int g = warp; g < G; g += NWARPS) {   // a warp a row: M, the last live split, weights
    float* w = sw + g * S;
    const float* l = sl + g * S;
    float M = NEG_INF;
    int live = -1;
    for (int s = lane; s < S; s += 32)
      if (l[s] > 0.0f) {
        M = fmaxf(M, w[s]);
        live = s;
      }
    M = warp_max(M);
    const int drop = fault == 1 ? __reduce_max_sync(FULL, live) : -1;
    for (int s = lane; s < S; s += 32) w[s] = l[s] > 0.0f && s != drop ? expf(w[s] - M) : 0.0f;
  }
  __syncthreads();
  // acc [S][G][D] as float4, split s, element e at s n4 + e: each element's
  // sum and denominator in split order, eight live splits' loads in flight
  constexpr int D4 = D / 4;
  const int n4 = G * D4;
  const float4* acc4 = reinterpret_cast<const float4*>(pt.acc);
  for (int e = tid; e < n4; e += NT) {
    const float* w = sw + e / D4 * S;
    const float* l = sl + e / D4 * S;
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float L = 0.0f;
    for (int s0 = 0; s0 < S; s0 += 8) {
      float4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (s0 + u < S && w[s0 + u] != 0.0f)
          v[u] = __ldcg(acc4 + static_cast<size_t>(s0 + u) * n4 + e);
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (s0 + u < S && w[s0 + u] != 0.0f) {
          fma4(a, w[s0 + u], v[u]);
          L = fmaf(w[s0 + u], l[s0 + u], L);
        }
    }
    const float den = fmaxf(L, 1e-30f);
    reinterpret_cast<float4*>(out)[e] = make_float4(a.x / den, a.y / den, a.z / den, a.w / den);
  }
  if (tid == 0) *ticket = 0;
}

// An empty split's partial: m = -inf, l = 0 for each row (one split: out
// zeros), then the combine.
template <int D>
__device__ void empty_split(float* ws, int* tickets, float* out, int B, int Hkv, int bh,
                            int s, int G, int S, int fault, float* sm) {
  if (S == 1) {
    for (int i = threadIdx.x; i < G * D; i += NT) out[i] = 0.0f;
    return;
  }
  const Partials pt(ws, B, Hkv, bh, S, G, D);
  for (int g = threadIdx.x; g < G; g += NT)
    reinterpret_cast<float2*>(pt.ml)[s * G + g] = make_float2(NEG_INF, 0.0f);
  combine<D>(pt, tickets + bh, out, G, S, fault, sm);
}

// ------------------------------------------ bf16 q: tensor cores (3, 3b)

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sm90::smem_u32(dst)),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d += a b, m16n8k16, bf16 operands, f32 accumulators (not volatile: the
// compiler may interleave independent products).
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b, m16n8k8, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma1688(float (&d)[4], const uint32_t (&a)[2], uint32_t b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// Elements at + 0 and at + 1 of a staged row as a bf16x2 register (low:
// the first); int8 codes convert exactly.
__device__ __forceinline__ uint32_t pair(const __nv_bfloat16* t, int at) {
  return *reinterpret_cast<const uint32_t*>(t + at);
}
__device__ __forceinline__ uint32_t pair(const int8_t* t, int at) {
  return sm90::pack_bf16(static_cast<float>(t[at]), static_cast<float>(t[at + 1]));
}
// Elements at and at + stride (one column of two rows) as a bf16x2 register.
__device__ __forceinline__ uint32_t pair_t(const __nv_bfloat16* t, int at, int stride) {
  const uint32_t lo = *reinterpret_cast<const uint16_t*>(t + at);
  const uint32_t hi = *reinterpret_cast<const uint16_t*>(t + at + stride);
  return lo | (hi << 16);
}
__device__ __forceinline__ uint32_t pair_t(const int8_t* t, int at, int stride) {
  return sm90::pack_bf16(static_cast<float>(t[at]), static_cast<float>(t[at + stride]));
}

// A stage: CH K rows then CH V rows of the pool's type, each padded by 16
// bytes (conflict-free fragment reads).
template <typename KV, int D>
struct Stage {
  static constexpr int EP = 16 / static_cast<int>(sizeof(KV));  // elements a 16-byte piece
  static constexpr int RS = D + EP;                              // row stride, elements
  static constexpr int PIECES = D / EP;                          // pieces a row
  static constexpr int ELEMS = 2 * CH * RS;
  static constexpr size_t BYTES = static_cast<size_t>(ELEMS) * sizeof(KV);
};

// Dynamic shared memory of the tensor-core kernel: the ring, a live flag
// per staged row, the run's table entries (none in the ring form, whose
// run is pp rows: page 1) and (int8) its rows' K / V scales; the warps'
// merge and the combine reuse it.  The launcher refuses a plan past
// MAX_SMEM (split_plan's runs of <= 64 pages stay far below, as
// ring_split_plan's of <= 2048 rows).
template <typename KV, bool SCALED, int D, bool RING>
size_t tc_smem(int pp, int page, int G, int S) {
  const size_t ring = NST * (Stage<KV, D>::BYTES + CH) +
                      (RING ? 0 : 4 * static_cast<size_t>(pp)) +
                      (SCALED ? 4 * static_cast<size_t>(pp) * page : 0);
  const size_t merge = 4 * static_cast<size_t>(NWARPS) * G * (D + 2);
  const size_t comb = S > 1 ? 8 * static_cast<size_t>(G) * S : 0;
  return std::max(std::max(ring, merge), comb);
}

// Paged (RING = false): pps table pages of `page` rows, runs of pp pages.
// Ring (RING = true): no table, pps = W rows a slot, page = 1, runs of pp
// rows, `window` the ring's attention window.
template <typename KV, bool SCALED, int D, bool RING>
__global__ void __launch_bounds__(NT)
paged_decode_tc(const __nv_bfloat16* __restrict__ q, const KV* __restrict__ kpool,
                const KV* __restrict__ vpool, const __nv_bfloat16* __restrict__ kscale,
                const __nv_bfloat16* __restrict__ vscale, const int* __restrict__ table,
                const int* __restrict__ pos, const int* __restrict__ start,
                float* __restrict__ out, float* __restrict__ ws, int* __restrict__ tickets,
                int Hq, int Hkv, int pps, int page, int pp, int S, int window, float scale,
                int fault) {
  using St = Stage<KV, D>;
  constexpr int KS = D / 16;            // k steps of S = Q K^T
  constexpr int NTD = D / 8;            // O's 8-column tiles
  extern __shared__ __align__(16) unsigned char smem[];
  KV* ring = reinterpret_cast<KV*>(smem);
  unsigned char* flags = smem + NST * St::BYTES;   // [NST][CH]: the staged row attends
  int* spid = reinterpret_cast<int*>(flags + NST * CH);   // the run's table entries
  __nv_bfloat16* kss = reinterpret_cast<__nv_bfloat16*>(spid + (RING ? 0 : pp));
  __nv_bfloat16* vss = kss + pp * page;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int B = gridDim.z, G = Hq / Hkv, bh = b * Hkv + h;
  float* ob = out + static_cast<size_t>(b * Hq + h * G) * D;
  // pos, start, the run's table entries and q's G rows, all in flight at
  // once; the ticket's line into L2 for the combine
  const int p_b = pos[b], s_b = start[b];
  const int pg0 = s * pp, npg = min(pg0 + pp, pps) - pg0;
  const int seam = RING ? (p_b % pps + pps) % pps : 0;   // the ring form: rows r | r + 1
  if (!RING)
    for (int i = tid; i < npg; i += NT) spid[i] = table[static_cast<size_t>(b) * pps + pg0 + i];
  if (S > 1 && tid == 0) asm volatile("prefetch.global.L2 [%0];\n" ::"l"(tickets + bh));
  // q as A fragments, rows >= G zero: rows lane / 4 (+ 8), columns
  // 16 ks + 2 (lane % 4) (+ 8)
  const int r0 = lane / 4, cq = 2 * (lane % 4);
  const __nv_bfloat16* qb = q + static_cast<size_t>(b * Hq + h * G) * D;
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 8 * (i & 1), k = 16 * ks + cq + 8 * (i >> 1);
      qa[ks][i] = r < G ? __ldg(reinterpret_cast<const unsigned int*>(qb + r * D + k)) : 0u;
    }
  }
  int c_lo, c_hi;
  if constexpr (RING) {   // the split's first and last live rows, from the rows' flags
    __shared__ int live_lo, live_hi;
    if (tid == 0) live_lo = INT_MAX, live_hi = -1;
    __syncthreads();
    int lo = INT_MAX, hi = -1;
    for (int i = tid; i < npg; i += NT)
      if (ring_row_live(pg0 + i, p_b, seam, pps, s_b, window, fault)) {
        lo = min(lo, i);
        hi = i;
      }
    lo = __reduce_min_sync(FULL, lo);
    hi = __reduce_max_sync(FULL, hi);
    if (lane == 0 && hi >= 0) {
      atomicMin(&live_lo, lo);
      atomicMax(&live_hi, hi);
    }
    __syncthreads();
    c_lo = pg0 + live_lo;
    c_hi = pg0 + live_hi;
    if (live_hi < 0) {
      empty_split<D>(ws, tickets, ob, B, Hkv, bh, s, G, S, fault, reinterpret_cast<float*>(smem));
      return;
    }
  } else {
    split_cols(s, pp, pps, page, p_b, s_b, c_lo, c_hi);
    int live = 0;   // a non-null page meeting [c_lo, c_hi]
    for (int i = tid; i < npg; i += NT) {
      const int c0 = (pg0 + i) * page;
      live |= spid[i] != 0 && c_lo <= c_hi && c0 <= c_hi && c0 + page - 1 >= c_lo;
    }
    if (!__syncthreads_or(live)) {
      empty_split<D>(ws, tickets, ob, B, Hkv, bh, s, G, S, fault,
                     reinterpret_cast<float*>(smem));
      return;
    }
  }

  const int nrows = c_hi - c_lo + 1;
  const int nch = (nrows + CH - 1) / CH;
  const size_t rstride = static_cast<size_t>(Hkv) * D;
  // row `row` of [c_lo, c_hi]: whether it attends, and its row index `at`
  // in the pools (its K / V elements at at Hkv D + h D, its scale at at Hkv
  // + h)
  auto locate = [&](int row, size_t& at) {
    const int j = c_lo + row;
    if constexpr (RING) {
      at = static_cast<size_t>(b) * pps + j;
      return row < nrows && ring_row_live(j, p_b, seam, pps, s_b, window, fault);
    } else {
      const int id = row < nrows ? spid[j / page - pg0] : 0;
      at = static_cast<size_t>(id) * page + j % page;
      return id != 0;
    }
  };
  // chunk c (rows 32 c .. of [c_lo, c_hi]) into stage c % NST, with its
  // rows' live flags; one cp.async group a call.  A dead row is zero-filled
  // without a read.
  auto load_stage = [&](int c) {
    if (c < nch) {
      const int st = c % NST;
      KV* kt = ring + st * St::ELEMS;
      KV* vt = kt + CH * St::RS;
      for (int i = tid; i < CH * St::PIECES; i += NT) {
        const int r = i / St::PIECES, e = i % St::PIECES * St::EP;
        size_t at;
        const bool ok = locate(c * CH + r, at);
        at = ok ? at * rstride + static_cast<size_t>(h) * D + e : 0;
        cp_async16(kt + r * St::RS + e, kpool + at, ok);
        cp_async16(vt + r * St::RS + e, vpool + at, ok);
        if (e == 0) flags[st * CH + r] = ok;
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < NST; ++c) load_stage(c);
  if (SCALED) {   // the run's row scales, while the first stages are in flight
    const __nv_bfloat16 zero = __float2bfloat16(0.0f);
    for (int row = tid; row < nrows; row += NT) {
      size_t at;
      const bool ok = locate(row, at);
      at = at * Hkv + h;
      kss[row] = ok ? kscale[at] : zero;
      vss[row] = ok ? vscale[at] : zero;
    }
  }

  // warp w takes columns 8 w .. 8 w + 7 of every stage: its own online
  // softmax over them (rows r0 and r0 + 8: m, l) and O over all of D
  const int cw = 8 * warp;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
  float o[NTD][4];
#pragma unroll
  for (int t = 0; t < NTD; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.0f;
  for (int c = 0; c < nch; ++c) {
    cp_async_wait<NST - 1>();
    __syncthreads();
    const int st = c % NST;
    const KV* kt = ring + st * St::ELEMS;
    const KV* vt = kt + CH * St::RS;
    // S = Q K^T over the warp's 8 columns (B: K row cw + lane / 4), the k
    // steps in two chains: sc[2 i + e] is row r0 + 8 i, column cw + cq + e
    float sc[4] = {0.0f, 0.0f, 0.0f, 0.0f}, sd[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const KV* kr = kt + (cw + r0) * St::RS + cq;
#pragma unroll
    for (int ks = 0; ks < KS; ks += 2) {
      mma16816(sc, qa[ks], pair(kr, 16 * ks), pair(kr, 16 * ks + 8));
      mma16816(sd, qa[ks + 1], pair(kr, 16 * ks + 16), pair(kr, 16 * ks + 24));
    }
    // masks, scales, online softmax; the four lanes of a row share it
    bool ok[2];
    float vcol[2], mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = cw + cq + e, row = c * CH + col;
      ok[e] = flags[st * CH + col] != 0;
      const float kcol = SCALED && ok[e] ? __bfloat162float(kss[row]) : 1.0f;
      vcol[e] = SCALED && ok[e] ? __bfloat162float(vss[row]) : 1.0f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float v = (sc[2 * i + e] + sd[2 * i + e]) * scale;
        if (SCALED) v = v * kcol;   // K scale after the dot
        v = ok[e] ? v : NEG_INF;
        sc[2 * i + e] = v;
        mx[i] = fmaxf(mx[i], v);
      }
    }
    float pv[4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
      const float mn = fmaxf(m[i], mx[i]);
      const float alpha = expf(m[i] - mn);
      m[i] = mn;
      float ps = 0.0f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p = expf(sc[2 * i + e] - mn);
        p = ok[e] ? p : 0.0f;
        ps += p;
        pv[2 * i + e] = p * vcol[e];   // the V scale, after l has the probability
      }
      ps += __shfl_xor_sync(FULL, ps, 1);
      ps += __shfl_xor_sync(FULL, ps, 2);
      l[i] = alpha * l[i] + ps;
#pragma unroll
      for (int t = 0; t < NTD; ++t) {
        o[t][2 * i] *= alpha;
        o[t][2 * i + 1] *= alpha;
      }
    }
    // O += P V: P [16 x 8] rounded to bf16 as the A operand (the
    // accumulator's layout), B: V rows cw + cq, + 1, column 8 t + lane / 4
    const uint32_t pf[2] = {sm90::pack_bf16(pv[0], pv[1]), sm90::pack_bf16(pv[2], pv[3])};
    const KV* vr = vt + (cw + cq) * St::RS + r0;
#pragma unroll
    for (int t = 0; t < NTD; ++t) mma1688(o[t], pf, pair_t(vr, 8 * t, St::RS));
    __syncthreads();   // the stage is consumed: refill it
    load_stage(c + NST);
  }

  // the four warps' (m, l, O) into the block's, in warp order: O_b =
  // sum_w e^(m_w - M) O_w, l_b = sum_w e^(m_w - M) l_w (the ring is free)
  float* wo = reinterpret_cast<float*>(smem);   // [NWARPS][G][D]
  float* wml = wo + NWARPS * G * D;              // [NWARPS][G]: (m, l)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= G) continue;
#pragma unroll
    for (int t = 0; t < NTD; ++t)
      *reinterpret_cast<float2*>(wo + (warp * G + r) * D + 8 * t + cq) =
          make_float2(o[t][2 * i], o[t][2 * i + 1]);
    if (cq == 0) reinterpret_cast<float2*>(wml)[warp * G + r] = make_float2(m[i], l[i]);
  }
  __syncthreads();
  const Partials pt(ws, B, Hkv, bh, S, G, D);
  constexpr int D4 = D / 4;
  for (int e = tid; e < G * D4; e += NT) {
    const int g = e / D4;
    float2 ml[NWARPS];
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      ml[w] = reinterpret_cast<const float2*>(wml)[w * G + g];
      M = fmaxf(M, ml[w].x);
    }
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float L = 0.0f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float f = expf(ml[w].x - M);
      const float4 v = reinterpret_cast<const float4*>(wo)[w * G * D4 + e];
      a = make_float4(fmaf(f, v.x, a.x), fmaf(f, v.y, a.y), fmaf(f, v.z, a.z), fmaf(f, v.w, a.w));
      L = fmaf(f, ml[w].y, L);
    }
    if (S == 1) {
      const float den = fmaxf(L, 1e-30f);
      reinterpret_cast<float4*>(ob)[e] = make_float4(a.x / den, a.y / den, a.z / den, a.w / den);
    } else {
      reinterpret_cast<float4*>(pt.acc)[static_cast<size_t>(s) * G * D4 + e] = a;
      if (e % D4 == 0) reinterpret_cast<float2*>(pt.ml)[s * G + g] = make_float2(M, L);
    }
  }
  if (S == 1) return;
  combine<D>(pt, tickets + bh, ob, G, S, fault, reinterpret_cast<float*>(smem));
}

// ------------------------------------------- float32 q: CUDA cores

// One block per (split, kv head, slot) walks its run page by page (the
// ring form: tile by tile of up to 32 rows): each live tile's K and V rows
// are staged in shared memory as f32; lane j scores column j of the tile
// for each of its warp's q rows, the row max and sum are warp shuffles,
// and each lane owns D/32 output columns.  Null pages, pages outside
// [start, pos] and ring tiles without a live row cost no loads.
template <typename KV, bool SCALED, int D, bool RING>
__global__ void __launch_bounds__(NT)
paged_decode_f32(const float* __restrict__ q, const KV* __restrict__ kpool,
                 const KV* __restrict__ vpool, const __nv_bfloat16* __restrict__ kscale,
                 const __nv_bfloat16* __restrict__ vscale, const int* __restrict__ table,
                 const int* __restrict__ pos, const int* __restrict__ start,
                 float* __restrict__ out, float* __restrict__ ws, int* __restrict__ tickets,
                 int Hq, int Hkv, int pps, int page, int pp, int S, int window, float scale,
                 int fault) {
  constexpr int DT = D / 32;
  __shared__ float qs[MAXG][D];
  __shared__ float ks[MAXPAGE][D + 1];
  __shared__ float vs[MAXPAGE][D];
  __shared__ float kss[MAXPAGE], vss[MAXPAGE];   // the page's row scales
  extern __shared__ float comb[];                // the combine's 2 G S
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int B = gridDim.z, G = Hq / Hkv, bh = b * Hkv + h;
  const int p_b = pos[b], s_b = start[b];
  const int pg0 = s * pp, pg1 = min(pg0 + pp, pps);
  float* ob = out + static_cast<size_t>(b * Hq + h * G) * D;

  for (int i = tid; i < G * D; i += NT)
    qs[i / D][i % D] = q[static_cast<size_t>(b * Hq + h * G) * D + i];

  float m[RPW], l[RPW], acc[RPW][DT];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    m[rr] = NEG_INF;
    l[rr] = 0.0f;
#pragma unroll
    for (int t = 0; t < DT; ++t) acc[rr][t] = 0.0f;
  }

  // one staged tile of n rows from row `at` of the pool (stride Hkv D):
  // lane j's column attends iff `valid`
  auto tile = [&](size_t at, int n, bool valid) {
    for (int i = tid; i < n * D; i += NT) {
      const int o = i / D, d = i % D;
      const size_t e = (at + o) * Hkv * D + static_cast<size_t>(h) * D + d;
      ks[o][d] = to_f32(kpool[e]);
      vs[o][d] = to_f32(vpool[e]);
    }
    if (SCALED && tid < n) {
      kss[tid] = to_f32(kscale[(at + tid) * Hkv + h]);
      vss[tid] = to_f32(vscale[(at + tid) * Hkv + h]);
    }
    __syncthreads();
    // lanes past the tile hold no scale; their probability is 0 anyway
    const float kcol = SCALED && lane < n ? kss[lane] : 1.0f;
    const float vcol = SCALED && lane < n ? vss[lane] : 1.0f;
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp + NWARPS * rr;
      if (r >= G) break;                       // warp-uniform
      float sv = 0.0f;
      if (lane < n) {
#pragma unroll 16
        for (int d = 0; d < D; ++d) sv = fmaf(qs[r][d], ks[lane][d], sv);
      }
      sv = sv * scale;
      if (SCALED) sv = sv * kcol;              // K scale after the dot
      online_softmax_update<float, D>(sv, valid, n, &vs[0][0], m[rr], l[rr], acc[rr], lane,
                                      vcol);
    }
  };
  if constexpr (RING) {   // rows [pg0, pg1) of the slot's ring, 32 a tile
    const int seam = (p_b % pps + pps) % pps;
    for (int c0 = pg0; c0 < pg1; c0 += MAXPAGE) {
      const int n = min(MAXPAGE, pg1 - c0);
      // (the barrier: the previous tile consumed, and qs written)
      if (!__syncthreads_or(tid < n && ring_row_live(c0 + tid, p_b, seam, pps, s_b, window,
                                                     fault)))
        continue;
      tile(static_cast<size_t>(b) * pps + c0, n,
           lane < n && ring_row_live(c0 + lane, p_b, seam, pps, s_b, window, fault));
    }
  } else {
    for (int pp_ = pg0; pp_ < pg1; ++pp_) {
      const int c0 = pp_ * page;
      if (c0 > p_b) break;                       // table order = position order
      if (c0 + page - 1 < s_b) continue;         // wholly left padding
      const int pid = table[static_cast<size_t>(b) * pps + pp_];
      if (pid == 0) continue;                    // null page: no loads
      __syncthreads();   // previous page consumed (and qs written)
      const int col = c0 + lane;
      tile(static_cast<size_t>(pid) * page, page, lane < page && col >= s_b && col <= p_b);
    }
  }

  if (S == 1) {
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp + NWARPS * rr;
      if (r >= G) break;
      store_row(ob + r * D, acc[rr], l[rr], lane);
    }
    return;
  }
  const Partials pt(ws, B, Hkv, bh, S, G, D);
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = warp + NWARPS * rr;
    if (r >= G) break;
    float* row = pt.acc + static_cast<size_t>(s * G + r) * D;
#pragma unroll
    for (int t = 0; t < DT; ++t) row[lane + 32 * t] = acc[rr][t];
    if (lane == 0) reinterpret_cast<float2*>(pt.ml)[s * G + r] = make_float2(m[rr], l[rr]);
  }
  combine<D>(pt, tickets + bh, ob, G, S, fault, comb);
}

// ------------------------------------------------------------- launch

struct Args {
  const void *q, *k, *v, *k_s, *v_s;
  const int *table, *pos, *start;
  float* out;
  float* ws;
  int* tickets;
  int B, Hq, Hkv, pps, page, pp, S, window, fault;
  float scale;
};

// Opt a kernel into `bytes` of dynamic shared memory (once per size).
template <typename K>
int opt_in(K kernel, size_t bytes, size_t& opted) {
  if (bytes <= opted) return 0;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  opted = bytes;
  return 0;
}

template <typename KV, bool SCALED, int D, bool RING>
int launch_tc(const Args& a, cudaStream_t st) {
  static size_t opted = 0;
  const size_t smem = tc_smem<KV, SCALED, D, RING>(a.pp, a.page, a.Hq / a.Hkv, a.S);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = paged_decode_tc<KV, SCALED, D, RING>;
  if (const int e = opt_in(kernel, smem, opted)) return e;
  kernel<<<dim3(a.S, a.Hkv, a.B), NT, smem, st>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), static_cast<const __nv_bfloat16*>(a.k_s),
      static_cast<const __nv_bfloat16*>(a.v_s), a.table, a.pos, a.start, a.out, a.ws,
      a.tickets, a.Hq, a.Hkv, a.pps, a.page, a.pp, a.S, a.window, a.scale, a.fault);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of the float32 kernel: the combine's.
size_t f32_smem(int G, int S) { return S > 1 ? 8 * static_cast<size_t>(G) * S : 0; }

template <typename KV, bool SCALED, int D, bool RING>
int launch_f32(const Args& a, cudaStream_t st) {
  static size_t opted = 0;
  const size_t smem = f32_smem(a.Hq / a.Hkv, a.S);
  auto kernel = paged_decode_f32<KV, SCALED, D, RING>;
  if (const int e = opt_in(kernel, smem, opted)) return e;
  kernel<<<dim3(a.S, a.Hkv, a.B), NT, smem, st>>>(
      static_cast<const float*>(a.q), static_cast<const KV*>(a.k), static_cast<const KV*>(a.v),
      static_cast<const __nv_bfloat16*>(a.k_s), static_cast<const __nv_bfloat16*>(a.v_s),
      a.table, a.pos, a.start, a.out, a.ws, a.tickets, a.Hq, a.Hkv, a.pps, a.page, a.pp, a.S,
      a.window, a.scale, a.fault);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool RING>
int launch_d(const Args& a, int is_bf16, int kv_int8, cudaStream_t st) {
  if (is_bf16)
    return kv_int8 ? launch_tc<int8_t, true, D, RING>(a, st)
                   : launch_tc<__nv_bfloat16, false, D, RING>(a, st);
  return kv_int8 ? launch_f32<int8_t, true, D, RING>(a, st)
                 : launch_f32<float, false, D, RING>(a, st);
}

template <bool RING>
int launch(const Args& a, int D, int is_bf16, int kv_int8, cudaStream_t st) {
  if (D == 128) return launch_d<128, RING>(a, is_bf16, kv_int8, st);
  if (D == 64) return launch_d<64, RING>(a, is_bf16, kv_int8, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The split workspace and the scale pools a launch needs.
bool operands_fit(int B, int Hq, int Hkv, int D, int splits, const float* ws, long long ws_len,
                  const int* tickets, int n_tickets, int kv_int8, const void* k_s,
                  const void* v_s) {
  if (splits > 1 &&
      (ws == nullptr || tickets == nullptr || n_tickets < B * Hkv ||
       ws_len < static_cast<long long>(B) * Hkv * splits * (Hq / Hkv) * (D + 2)))
    return false;
  return !kv_int8 || (k_s != nullptr && v_s != nullptr);
}

template <bool RING>
int smem_of(int is_bf16, int kv_int8, int D, int pp, int page, int G, int S) {
  if (!is_bf16) return static_cast<int>(f32_smem(G, S));
  if (D == 128)
    return static_cast<int>(kv_int8 ? tc_smem<int8_t, true, 128, RING>(pp, page, G, S)
                                    : tc_smem<__nv_bfloat16, false, 128, RING>(pp, page, G, S));
  return static_cast<int>(kv_int8 ? tc_smem<int8_t, true, 64, RING>(pp, page, G, S)
                                  : tc_smem<__nv_bfloat16, false, 64, RING>(pp, page, G, S));
}

}  // namespace

// k_s / v_s: the bf16 scale pools of int8 pools (kv_int8 = 1), else null.
// pp pages a split and `splits` splits (the wrapper's split_plan) must
// cover the table; with splits > 1, ws is a float workspace of ws_len >=
// B Hkv splits G (D + 2) floats and tickets n_tickets >= B Hkv zeroed
// ints, which every call leaves zero.  fault: 0, or 1 to drop the last
// live split in the combine.  Returns a cudaError_t.
extern "C" int paged_attention(const void* q, const void* k, const void* v, const void* k_s,
                               const void* v_s, const int* table, const int* pos,
                               const int* start, float* out, float* ws, long long ws_len,
                               int* tickets, int n_tickets, int is_bf16, int kv_int8, int B,
                               int Hq, int Hkv, int pps, int page, int D, int pp, int splits,
                               float scale, int fault, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (B < 1 || Hkv < 1 || Hq % Hkv || Hq / Hkv > MAXG || page < 1 || page > MAXPAGE ||
      pps < 0 || pp < 1 || splits < 1 || static_cast<long long>(splits) * pp < pps ||
      static_cast<long long>(splits - 1) * pp >= (pps > 0 ? pps : 1) || fault < 0 || fault > 1)
    return bad;
  if (!operands_fit(B, Hq, Hkv, D, splits, ws, ws_len, tickets, n_tickets, kv_int8, k_s, v_s))
    return bad;
  const Args a{q, k, v, k_s, v_s, table, pos, start, out, ws, tickets,
               B, Hq, Hkv, pps, page, pp, splits, 0, fault, scale};
  return launch<false>(a, D, is_bf16, kv_int8, static_cast<cudaStream_t>(stream));
}

// The ring form: pools [B, W, Hkv, D] (k_s / v_s [B, W, Hkv, 1] with int8
// pools, else null), pos / start int32 [B], window (0: none) -> out f32
// [B, Hq, 1, D].  `rows` rows a split (a multiple of 32) and `splits`
// splits (the wrapper's ring_split_plan) must cover the W rows; ws and
// tickets as paged_attention's.  fault: 0, 1 to drop the last live split
// in the combine, or 2 to read rows as if row j held position j.
extern "C" int ring_decode_attention(const void* q, const void* k, const void* v,
                                     const void* k_s, const void* v_s, const int* pos,
                                     const int* start, float* out, float* ws, long long ws_len,
                                     int* tickets, int n_tickets, int is_bf16, int kv_int8, int B,
                                     int Hq, int Hkv, int W, int D, int rows, int splits,
                                     int window, float scale, int fault, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (B < 1 || Hkv < 1 || Hq % Hkv || Hq / Hkv > MAXG || W < 1 || rows < CH || rows % CH ||
      splits < 1 || static_cast<long long>(splits) * rows < W ||
      static_cast<long long>(splits - 1) * rows >= W || fault < 0 || fault > 2)
    return bad;
  if (!operands_fit(B, Hq, Hkv, D, splits, ws, ws_len, tickets, n_tickets, kv_int8, k_s, v_s))
    return bad;
  const Args a{q, k, v, k_s, v_s, nullptr, pos, start, out, ws, tickets,
               B, Hq, Hkv, W, 1, rows, splits, window, fault, scale};
  return launch<true>(a, D, is_bf16, kv_int8, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of one launch (chip_smoke.py's build report); the
// ring form's with pp = rows a split and page = 1.
extern "C" int paged_attention_smem(int is_bf16, int kv_int8, int D, int pp, int page, int G,
                                    int S) {
  return smem_of<false>(is_bf16, kv_int8, D, pp, page, G, S);
}

extern "C" int ring_decode_smem(int is_bf16, int kv_int8, int D, int rows, int G, int S) {
  return smem_of<true>(is_bf16, kv_int8, D, rows, 1, G, S);
}
