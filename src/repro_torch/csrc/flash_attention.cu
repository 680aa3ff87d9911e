// Masked flash attention (serving prefill) for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel flash_attention_masked
// (src/repro/kernels/flash_attention/flash_attention.py:145, body _kernel
// :32).  q [B, Hq, Sq, D], k/v [B, Hkv, Skv, D] (f32 or bf16), start
// int32 [B] -> out [B, Hq, Sq, D] in q's dtype, as the Pallas kernel
// writes it.  Query row t sits at kv position q_offset + t; kv column j
// attends iff j <= q_offset + t (causal), j > q_offset + t - window
// (window > 0) and j >= start[b].  GQA reads kv head q_head / (Hq / Hkv).
// Online softmax in f32; fully masked rows
// give exact zeros.  As in the plain version (masked_attention_ref),
// scores are (q . k) * scale and the probabilities are rounded to the
// value dtype before the value product.
//
// What bounds it on the H100: at prefill lengths 256..512 with D = 128,
// 16 q heads and 2 kv heads, the ~4*S^2*D/2 flops per q head and the
// bytes of q, K/V and the output (each once) give bounds of about the
// same size (~1.1 and ~1.4 us at S = 512): neither dominates, and the
// simple kernel below is far from both.  Design (simple first):
// the TPU's sequential kv grid axis becomes a loop inside the block; one
// block per (q tile of 16 rows, q head, batch), 4 warps, 4 query rows
// per warp.  Per 32-column kv tile the block stages K and V in shared
// memory as f32; lane j scores column j for each of its warp's rows
// (q rows broadcast from shared memory, K rows padded against bank
// conflicts), the row max and sum are warp shuffles, and each lane owns
// D/32 output columns of the accumulator.  Tiles wholly outside the
// causal / window / start band are skipped (exact: a fully masked tile
// leaves m, l and acc unchanged), and ragged q and kv edges are masked
// in-kernel.  Tensor-core (mma/wgmma) scores are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "online_softmax.cuh"

namespace {

using namespace ent_attn;

constexpr int BQ = 16;
constexpr int BKV = 32;
constexpr int NWARPS = 4;
constexpr int RPW = BQ / NWARPS;   // query rows per warp

template <typename T, int D>
__global__ void __launch_bounds__(NWARPS * 32)
masked_flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ start,
                    T* __restrict__ out, int Hq, int Hkv, int Sq, int Skv,
                    int q_offset, int causal, int window, float scale) {
  constexpr int DT = D / 32;
  __shared__ float qs[BQ][D];
  __shared__ float ks[BKV][D + 1];
  __shared__ float vs[BKV][D];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int b = blockIdx.z, hq = blockIdx.y, q0 = blockIdx.x * BQ;
  const int hk = hq / (Hq / Hkv);
  const T* qp = q + static_cast<size_t>(b * Hq + hq) * Sq * D;
  const T* kp = k + static_cast<size_t>(b * Hkv + hk) * Skv * D;
  const T* vp = v + static_cast<size_t>(b * Hkv + hk) * Skv * D;
  const int st = start[b];

  for (int i = tid; i < BQ * D; i += NWARPS * 32) {
    const int r = i / D, d = i % D;
    qs[r][d] = (q0 + r < Sq) ? to_f32(qp[static_cast<size_t>(q0 + r) * D + d]) : 0.0f;
  }

  float m[RPW], l[RPW], acc[RPW][DT];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    m[rr] = NEG_INF;
    l[rr] = 0.0f;
#pragma unroll
    for (int t = 0; t < DT; ++t) acc[rr][t] = 0.0f;
  }

  // columns any row of this tile can attend to
  const int qpos_lo = q_offset + q0;
  const int qpos_hi = q_offset + min(q0 + BQ, Sq) - 1;
  int kv_lo = max(st, 0);
  if (window > 0) kv_lo = max(kv_lo, qpos_lo - window + 1);
  const int kv_hi = causal ? min(Skv - 1, qpos_hi) : Skv - 1;

  for (int j0 = (kv_lo / BKV) * BKV; j0 <= kv_hi; j0 += BKV) {
    __syncthreads();   // previous tile consumed (and qs written)
    for (int i = tid; i < BKV * D; i += NWARPS * 32) {
      const int c = i / D, d = i % D, col = j0 + c;
      const bool in = col < Skv;
      ks[c][d] = in ? to_f32(kp[static_cast<size_t>(col) * D + d]) : 0.0f;
      vs[c][d] = in ? to_f32(vp[static_cast<size_t>(col) * D + d]) : 0.0f;
    }
    __syncthreads();
    const int col = j0 + lane;
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp * RPW + rr;
      const int qrow = q0 + r;
      const int qpos = q_offset + qrow;
      float s = 0.0f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s = fmaf(qs[r][d], ks[lane][d], s);
      const bool valid = qrow < Sq && col < Skv && col >= st &&
                         (!causal || col <= qpos) &&
                         (window <= 0 || col > qpos - window);
      online_softmax_update<T, D>(s * scale, valid, BKV, &vs[0][0], m[rr], l[rr],
                                  acc[rr], lane);
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int qrow = q0 + warp * RPW + rr;
    if (qrow >= Sq) continue;
    store_row(out + (static_cast<size_t>(b * Hq + hq) * Sq + qrow) * D, acc[rr],
              l[rr], lane);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* start,
           void* out, int B, int Hq, int Hkv, int Sq, int Skv, int D,
           int q_offset, int causal, int window, float scale,
           cudaStream_t st) {
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(out);
  if (D == 128) {
    masked_flash_kernel<T, 128><<<grid, NWARPS * 32, 0, st>>>(
        qq, kk, vv, start, oo, Hq, Hkv, Sq, Skv, q_offset, causal, window, scale);
  } else if (D == 64) {
    masked_flash_kernel<T, 64><<<grid, NWARPS * 32, 0, st>>>(
        qq, kk, vv, start, oo, Hq, Hkv, Sq, Skv, q_offset, causal, window, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_masked(const void* q, const void* k,
                                      const void* v, const int* start,
                                      void* out, int is_bf16, int B, int Hq,
                                      int Hkv, int Sq, int Skv, int D,
                                      int q_offset, int causal, int window,
                                      float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, start, out, B, Hq, Hkv, Sq, Skv, D,
                                 q_offset, causal, window, scale, st);
  return launch<float>(q, k, v, start, out, B, Hq, Hkv, Sq, Skv, D, q_offset,
                       causal, window, scale, st);
}
