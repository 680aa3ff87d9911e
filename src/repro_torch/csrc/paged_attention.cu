// In-place paged decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel paged_attention_kernel
// (src/repro/kernels/paged_attention/paged_attention.py:109, body _kernel
// :49).  q [B, Hq, 1, D] and page pools [P, page, Hkv, D] (f32 or bf16
// in q's dtype, or int8 with bf16 scale pools [P, page, Hkv, 1]; page 0 =
// the null page), block table int32 [B, pps], pos/start int32 [B] -> out
// f32 [B, Hq, 1, D].  Column j = table order * page + offset attends iff
// start[b] <= j <= pos[b] and its page id is non-zero.  Online softmax in
// f32; an all-null slot gives exact zeros.  As in the plain version,
// scores are (q . k) * scale and the probabilities are rounded to q's
// dtype before the value product.
//
// The int8-KV branch (Pallas :49-56, :77-78, :92-94) reads one byte per
// pool element and dequantizes in the kernel: int8 codes convert to f32
// exactly, the score is multiplied by the column's K scale after the
// q.k dot, the running denominator l sums the UNSCALED probabilities,
// and only then is the column's V scale folded into the probability
// that weights its V row (online_softmax_update's vscale).
//
// What bounds it on the H100: a decode tick reads each live K/V page
// once for G = Hq/Hkv query rows (8 on qwen2.5-3b) — about 2*G flops per
// byte, far below the card's balance, so HBM bytes bound it.  Design
// (simple first): one block per (kv head, slot) loads the slot's [G, D]
// q rows once and walks its table row page by page, the TPU's
// sequential kv grid axis as a loop.  Null pages, pages wholly before
// start and pages past pos cost no loads at all.  Each live page's K and
// V rows are staged in shared memory as f32; lane j scores column j of
// the page for each of its warp's q rows, the row max and sum are warp
// shuffles, and each lane owns D/32 output columns.  With 8 slots and 2
// kv heads only 16 blocks run; splitting a slot's pages over blocks
// (flash-decoding) to fill the 132 SMs is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "online_softmax.cuh"

namespace {

using namespace ent_attn;

constexpr int NWARPS = 4;
constexpr int MAXG = 16;           // q heads per kv head
constexpr int RPW = MAXG / NWARPS; // q rows per warp, at most
constexpr int MAXPAGE = 32;

// T: q's dtype (and the probabilities' rounding); KV: the pools' type,
// T or int8_t; SCALED: the int8-KV branch, with per-row scale pools.
template <typename T, typename KV, bool SCALED, int D>
__global__ void __launch_bounds__(NWARPS * 32)
paged_decode_kernel(const T* __restrict__ q, const KV* __restrict__ kpool,
                    const KV* __restrict__ vpool,
                    const __nv_bfloat16* __restrict__ kscale,
                    const __nv_bfloat16* __restrict__ vscale,
                    const int* __restrict__ table,
                    const int* __restrict__ pos, const int* __restrict__ start,
                    float* __restrict__ out, int Hq, int Hkv, int pps, int page,
                    float scale) {
  constexpr int DT = D / 32;
  __shared__ float qs[MAXG][D];
  __shared__ float ks[MAXPAGE][D + 1];
  __shared__ float vs[MAXPAGE][D];
  __shared__ float kss[MAXPAGE], vss[MAXPAGE];   // the page's row scales
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = Hq / Hkv;
  const int p_b = pos[b], s_b = start[b];

  for (int i = tid; i < G * D; i += NWARPS * 32) {
    const int g = i / D, d = i % D;
    qs[g][d] = to_f32(q[static_cast<size_t>(b * Hq + h * G + g) * D + d]);
  }

  float m[RPW], l[RPW], acc[RPW][DT];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    m[rr] = NEG_INF;
    l[rr] = 0.0f;
#pragma unroll
    for (int t = 0; t < DT; ++t) acc[rr][t] = 0.0f;
  }

  for (int pp = 0; pp < pps; ++pp) {
    const int c0 = pp * page;
    if (c0 > p_b) break;                       // table order = position order
    if (c0 + page - 1 < s_b) continue;         // wholly left padding
    const int pid = table[static_cast<size_t>(b) * pps + pp];
    if (pid == 0) continue;                    // null page: no loads
    __syncthreads();   // previous page consumed (and qs written)
    for (int i = tid; i < page * D; i += NWARPS * 32) {
      const int o = i / D, d = i % D;
      const size_t at = (static_cast<size_t>(pid) * page + o) * Hkv * D +
                        static_cast<size_t>(h) * D + d;
      ks[o][d] = to_f32(kpool[at]);
      vs[o][d] = to_f32(vpool[at]);
    }
    if (SCALED && tid < page) {
      const size_t at = (static_cast<size_t>(pid) * page + tid) * Hkv + h;
      kss[tid] = to_f32(kscale[at]);
      vss[tid] = to_f32(vscale[at]);
    }
    __syncthreads();
    const int col = c0 + lane;
    const bool valid = lane < page && col >= s_b && col <= p_b;
    // lanes past the page hold no scale; their probability is 0 anyway
    const float kcol = SCALED && lane < page ? kss[lane] : 1.0f;
    const float vcol = SCALED && lane < page ? vss[lane] : 1.0f;
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp + NWARPS * rr;
      if (r >= G) break;                       // warp-uniform
      float s = 0.0f;
      if (lane < page) {
#pragma unroll 16
        for (int d = 0; d < D; ++d) s = fmaf(qs[r][d], ks[lane][d], s);
      }
      s = s * scale;
      if (SCALED) s = s * kcol;                // K scale after the dot
      online_softmax_update<T, D>(s, valid, page, &vs[0][0], m[rr], l[rr],
                                  acc[rr], lane, vcol);
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = warp + NWARPS * rr;
    if (r >= G) break;
    store_row(out + static_cast<size_t>(b * Hq + h * G + r) * D, acc[rr], l[rr], lane);
  }
}

template <typename T, typename KV, bool SCALED>
int launch(const void* q, const void* k, const void* v, const void* k_s,
           const void* v_s, const int* table, const int* pos, const int* start,
           float* out, int B, int Hq, int Hkv, int pps, int page, int D,
           float scale, cudaStream_t st) {
  if (Hq / Hkv > MAXG || page > MAXPAGE) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(Hkv, B);
  const T* qq = static_cast<const T*>(q);
  const KV* kk = static_cast<const KV*>(k);
  const KV* vv = static_cast<const KV*>(v);
  const __nv_bfloat16* ks = static_cast<const __nv_bfloat16*>(k_s);
  const __nv_bfloat16* vs = static_cast<const __nv_bfloat16*>(v_s);
  if (D == 128) {
    paged_decode_kernel<T, KV, SCALED, 128><<<grid, NWARPS * 32, 0, st>>>(
        qq, kk, vv, ks, vs, table, pos, start, out, Hq, Hkv, pps, page, scale);
  } else if (D == 64) {
    paged_decode_kernel<T, KV, SCALED, 64><<<grid, NWARPS * 32, 0, st>>>(
        qq, kk, vv, ks, vs, table, pos, start, out, Hq, Hkv, pps, page, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_kv(int kv_int8, const void* q, const void* k, const void* v,
              const void* k_s, const void* v_s, const int* table, const int* pos,
              const int* start, float* out, int B, int Hq, int Hkv, int pps,
              int page, int D, float scale, cudaStream_t st) {
  if (kv_int8)
    return launch<T, int8_t, true>(q, k, v, k_s, v_s, table, pos, start, out, B,
                                   Hq, Hkv, pps, page, D, scale, st);
  return launch<T, T, false>(q, k, v, k_s, v_s, table, pos, start, out, B, Hq,
                             Hkv, pps, page, D, scale, st);
}

}  // namespace

// k_s / v_s: the bf16 scale pools of int8 pools (kv_int8 = 1), else null
extern "C" int paged_attention(const void* q, const void* k, const void* v,
                               const void* k_s, const void* v_s,
                               const int* table, const int* pos,
                               const int* start, float* out, int is_bf16,
                               int kv_int8, int B, int Hq, int Hkv, int pps,
                               int page, int D, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_kv<__nv_bfloat16>(kv_int8, q, k, v, k_s, v_s, table, pos, start,
                                    out, B, Hq, Hkv, pps, page, D, scale, st);
  return launch_kv<float>(kv_int8, q, k, v, k_s, v_s, table, pos, start, out, B,
                          Hq, Hkv, pps, page, D, scale, st);
}
