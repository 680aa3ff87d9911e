// In-place paged decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel paged_attention_kernel
// (src/repro/kernels/paged_attention/paged_attention.py:109, body _kernel
// :49).  q [B, Hq, 1, D] and page pools [P, page, Hkv, D] (f32 or bf16,
// page 0 = the null page), block table int32 [B, pps], pos/start int32
// [B] -> out f32 [B, Hq, 1, D].  Column j = table order * page + offset
// attends iff start[b] <= j <= pos[b] and its page id is non-zero.
// Online softmax in f32; an all-null slot gives exact zeros.  As in the
// plain version, scores are (q . k) * scale and the probabilities are
// rounded to the value dtype before the value product.
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

template <typename T, int D>
__global__ void __launch_bounds__(NWARPS * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                    const T* __restrict__ vpool, const int* __restrict__ table,
                    const int* __restrict__ pos, const int* __restrict__ start,
                    float* __restrict__ out, int Hq, int Hkv, int pps, int page,
                    float scale) {
  constexpr int DT = D / 32;
  __shared__ float qs[MAXG][D];
  __shared__ float ks[MAXPAGE][D + 1];
  __shared__ float vs[MAXPAGE][D];
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
    __syncthreads();
    const int col = c0 + lane;
    const bool valid = lane < page && col >= s_b && col <= p_b;
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp + NWARPS * rr;
      if (r >= G) break;                       // warp-uniform
      float s = 0.0f;
      if (lane < page) {
#pragma unroll 16
        for (int d = 0; d < D; ++d) s = fmaf(qs[r][d], ks[lane][d], s);
      }
      online_softmax_update<T, D>(s * scale, valid, page, &vs[0][0], m[rr], l[rr],
                                  acc[rr], lane);
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = warp + NWARPS * rr;
    if (r >= G) break;
    store_row(out + static_cast<size_t>(b * Hq + h * G + r) * D, acc[rr], l[rr], lane);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* table,
           const int* pos, const int* start, float* out, int B, int Hq,
           int Hkv, int pps, int page, int D, float scale, cudaStream_t st) {
  if (Hq / Hkv > MAXG || page > MAXPAGE) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(Hkv, B);
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  if (D == 128) {
    paged_decode_kernel<T, 128><<<grid, NWARPS * 32, 0, st>>>(
        qq, kk, vv, table, pos, start, out, Hq, Hkv, pps, page, scale);
  } else if (D == 64) {
    paged_decode_kernel<T, 64><<<grid, NWARPS * 32, 0, st>>>(
        qq, kk, vv, table, pos, start, out, Hq, Hkv, pps, page, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int paged_attention(const void* q, const void* k, const void* v,
                               const int* table, const int* pos,
                               const int* start, float* out, int is_bf16,
                               int B, int Hq, int Hkv, int pps, int page,
                               int D, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, table, pos, start, out, B, Hq, Hkv,
                                 pps, page, D, scale, st);
  return launch<float>(q, k, v, table, pos, start, out, B, Hq, Hkv, pps, page,
                       D, scale, st);
}
