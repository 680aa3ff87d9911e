// Flash attention for Hopper (sm_90a), plain C interface: the masked
// serving prefill (kernel 2), the unmasked training forward (kernel 7) and
// its backward (kernels 7b and 7c).
//
// Kernel 2 replaces the Pallas TPU kernel flash_attention_masked
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
//
// Kernel 7 (flash_attention_fwd) replaces the Pallas TPU kernel
// flash_attention (flash_attention.py:92, the same body _kernel :32 with
// has_start=False): the same kernel as 2, instantiated with TRAIN = true,
// which reads no start vector (every column from 0 attends), keeps the
// probabilities in f32 for the value product (as attention_ref and the
// Pallas body do; kernel 2's instantiation keeps its rounding) and writes
// the row's log-sum-exp lse = m + log(l) f32 [B, Hq, Sq] for the
// backward (+inf for a fully masked row, which has no gradient).  The
// Pallas body multiplies q by scale before the dot (:48); this kernel
// follows the plain version, attention_ref, and scales the dot: s =
// (q . k) * scale.  The training caller passes q_offset = Skv - Sq.
// Bound at the training shape (B=1, H=36, S=4096, D=64, causal):
// ~7.7e10 flops against ~76 MB of bytes, so operations bound it (~78 us
// at the bf16 dense tensor-core peak); this CUDA-core kernel is far from
// that, as kernel 2 is.
//
// Kernels 7b and 7c are the backward.  The JAX package has no backward
// kernel (no custom_vjp around flash_attention): the reference
// differentiates the plain jnp attention.  They stand in for that
// autograd backward with the flash-attention-2 recurrence from the saved
// lse: P = exp(s - lse) on the band, D_i = rowsum(dO_i * O_i),
// dS = P * (dP - D), dP = dO V^T, dV = P^T dO, dK = scale dS^T Q,
// dQ = scale dS K, all in f32 registers, each written once in the
// input's dtype (two kernels rather than atomics on dQ: runs repeat bit
// for bit).  Both recompute the scores from q and K and compute D_i for
// their own rows.  Bound at the training shape: ~1.5e11 flops for 7b and
// ~1.2e11 for 7c (each recomputes the scores), operation-bound (~0.16
// and ~0.12 ms at the bf16 dense peak).
//   7b (flash_attention_bwd_dkdv): one block per (32-row kv tile, kv
//   head, batch).  K and V tiles stay in shared memory; the block walks
//   the group's q heads and, for each, the 16-row q tiles inside the
//   causal / window band.  Lane j scores kv row j against its warp's 4 q
//   rows; P and dS go to shared memory; then thread (lane j, warp w)
//   accumulates dK and dV of kv row j over the columns w*D/4 .. + D/4.
//   7c (flash_attention_bwd_dq): one block per (16-row q tile, q head,
//   batch), looping over the kv tiles inside the band as kernel 7 does;
//   lane j scores column j, and dS is broadcast by shuffles into each
//   lane's D/32 dQ columns.
// Simple first, as kernel 2: CUDA cores, f32 arithmetic; mma/wgmma, TMA
// and a fused single-pass backward are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "online_softmax.cuh"

namespace {

using namespace ent_attn;

constexpr int BQ = 16;
constexpr int BKV = 32;
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int RPW = BQ / NWARPS;   // query rows per warp

__device__ __forceinline__ bool attends(int col, int qpos, int Skv, int causal,
                                        int window) {
  return col < Skv && (!causal || col <= qpos) && (window <= 0 || col > qpos - window);
}

// Kernels 2 (TRAIN = false) and 7 (TRAIN = true).
template <typename T, int D, bool TRAIN>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ start,
                 T* __restrict__ out, float* __restrict__ lse, int Hq, int Hkv,
                 int Sq, int Skv, int q_offset, int causal, int window,
                 float scale) {
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
  const int st = TRAIN ? 0 : start[b];

  for (int i = tid; i < BQ * D; i += NTHREADS) {
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
    for (int i = tid; i < BKV * D; i += NTHREADS) {
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
      online_softmax_update<T, D, DT, !TRAIN>(s * scale, valid, BKV, &vs[0][0],
                                              m[rr], l[rr], acc[rr], lane);
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int qrow = q0 + warp * RPW + rr;
    if (qrow >= Sq) continue;
    const size_t row = static_cast<size_t>(b * Hq + hq) * Sq + qrow;
    store_row(out + row * D, acc[rr], l[rr], lane);
    if (TRAIN && lane == 0) lse[row] = l[rr] > 0.0f ? m[rr] + logf(l[rr]) : INFINITY;
  }
}

// Kernel 7b: dK and dV of one 32-row kv tile, summed over the group's q heads.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ o,
                      const float* __restrict__ lse, const T* __restrict__ dout,
                      T* __restrict__ dk, T* __restrict__ dv, int Hq, int Hkv,
                      int Sq, int Skv, int q_offset, int causal, int window,
                      float scale) {
  constexpr int DQ = D / NWARPS;   // accumulator columns per thread
  constexpr int KS = D + 1;        // padded K / V row stride
  extern __shared__ float smem[];
  float* ks = smem;                // [BKV][KS]
  float* vs = ks + BKV * KS;       // [BKV][KS]
  float* qs = vs + BKV * KS;       // [BQ][D]
  float* dos = qs + BQ * D;        // [BQ][D]
  float* ps = dos + BQ * D;        // [BQ][BKV]
  float* dss = ps + BQ * BKV;      // [BQ][BKV]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int b = blockIdx.z, hk = blockIdx.y, j0 = blockIdx.x * BKV;
  const int group = Hq / Hkv;
  const size_t kvbase = static_cast<size_t>(b * Hkv + hk) * Skv;

  for (int i = tid; i < BKV * D; i += NTHREADS) {
    const int c = i / D, d = i % D, col = j0 + c;
    const bool in = col < Skv;
    ks[c * KS + d] = in ? to_f32(k[(kvbase + col) * D + d]) : 0.0f;
    vs[c * KS + d] = in ? to_f32(v[(kvbase + col) * D + d]) : 0.0f;
  }
  float dka[DQ], dva[DQ];
#pragma unroll
  for (int c = 0; c < DQ; ++c) dka[c] = dva[c] = 0.0f;

  // q rows whose band meets this kv tile
  const int j_hi = min(j0 + BKV, Skv) - 1;
  const int t_lo = causal ? max(0, j0 - q_offset) : 0;
  int t_hi = Sq - 1;
  if (window > 0) t_hi = min(t_hi, j_hi + window - 1 - q_offset);
  const int col = j0 + lane;

  for (int g = 0; g < group; ++g) {
    const size_t qbase = static_cast<size_t>(b * Hq + hk * group + g) * Sq;
    for (int t0 = (t_lo / BQ) * BQ; t0 <= t_hi; t0 += BQ) {
      __syncthreads();   // previous q tile consumed (and K / V staged)
      for (int i = tid; i < BQ * D; i += NTHREADS) {
        const int row = t0 + i / D;
        const bool in = row < Sq;
        const size_t at = (qbase + row) * D + i % D;
        qs[i] = in ? to_f32(q[at]) : 0.0f;
        dos[i] = in ? to_f32(dout[at]) : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const int r = warp * RPW + rr, row = t0 + r;
        float di = 0.0f, s = 0.0f, dp = 0.0f;
        if (row < Sq) {
          for (int d = lane; d < D; d += 32)
            di = fmaf(dos[r * D + d], to_f32(o[(qbase + row) * D + d]), di);
        }
        di = warp_sum(di);   // D_i = rowsum(dO_i * O_i)
#pragma unroll 16
        for (int d = 0; d < D; ++d) {
          s = fmaf(qs[r * D + d], ks[lane * KS + d], s);
          dp = fmaf(dos[r * D + d], vs[lane * KS + d], dp);
        }
        const bool valid = row < Sq && attends(col, q_offset + row, Skv, causal, window);
        const float p = valid ? expf(s * scale - lse[qbase + row]) : 0.0f;
        ps[r * BKV + lane] = p;
        dss[r * BKV + lane] = p * (dp - di);
      }
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < BQ; ++i) {
        const float p = ps[i * BKV + lane], ds = dss[i * BKV + lane];
#pragma unroll
        for (int c = 0; c < DQ; ++c) {
          dva[c] = fmaf(p, dos[i * D + warp * DQ + c], dva[c]);
          dka[c] = fmaf(ds, qs[i * D + warp * DQ + c], dka[c]);
        }
      }
    }
  }
  if (col < Skv) {
#pragma unroll
    for (int c = 0; c < DQ; ++c) {
      const size_t at = (kvbase + col) * D + warp * DQ + c;
      dk[at] = from_f32<T>(dka[c] * scale);
      dv[at] = from_f32<T>(dva[c]);
    }
  }
}

// Kernel 7c: dQ of one 16-row q tile of one q head.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const float* __restrict__ lse, const T* __restrict__ dout,
                    T* __restrict__ dq, int Hq, int Hkv, int Sq, int Skv,
                    int q_offset, int causal, int window, float scale) {
  constexpr int DT = D / 32;
  constexpr int KS = D + 1;
  extern __shared__ float smem[];
  float* qs = smem;                // [BQ][D]
  float* dos = qs + BQ * D;        // [BQ][D]
  float* ks = dos + BQ * D;        // [BKV][KS]
  float* vs = ks + BKV * KS;       // [BKV][KS]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int b = blockIdx.z, hq = blockIdx.y, q0 = blockIdx.x * BQ;
  const int hk = hq / (Hq / Hkv);
  const size_t qbase = static_cast<size_t>(b * Hq + hq) * Sq;
  const size_t kvbase = static_cast<size_t>(b * Hkv + hk) * Skv;

  for (int i = tid; i < BQ * D; i += NTHREADS) {
    const int row = q0 + i / D;
    const bool in = row < Sq;
    const size_t at = (qbase + row) * D + i % D;
    qs[i] = in ? to_f32(q[at]) : 0.0f;
    dos[i] = in ? to_f32(dout[at]) : 0.0f;
  }
  __syncthreads();
  float di[RPW], lrow[RPW], acc[RPW][DT];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = warp * RPW + rr, row = q0 + r;
    float x = 0.0f;
    if (row < Sq) {
      for (int d = lane; d < D; d += 32)
        x = fmaf(dos[r * D + d], to_f32(o[(qbase + row) * D + d]), x);
    }
    di[rr] = warp_sum(x);   // D_i = rowsum(dO_i * O_i)
    lrow[rr] = row < Sq ? lse[qbase + row] : 0.0f;
#pragma unroll
    for (int t = 0; t < DT; ++t) acc[rr][t] = 0.0f;
  }

  // columns any row of this tile attends to
  const int qpos_lo = q_offset + q0;
  const int qpos_hi = q_offset + min(q0 + BQ, Sq) - 1;
  const int kv_lo = window > 0 ? max(0, qpos_lo - window + 1) : 0;
  const int kv_hi = causal ? min(Skv - 1, qpos_hi) : Skv - 1;

  for (int j0 = (kv_lo / BKV) * BKV; j0 <= kv_hi; j0 += BKV) {
    __syncthreads();   // previous kv tile consumed
    for (int i = tid; i < BKV * D; i += NTHREADS) {
      const int c = i / D, d = i % D, col = j0 + c;
      const bool in = col < Skv;
      ks[c * KS + d] = in ? to_f32(k[(kvbase + col) * D + d]) : 0.0f;
      vs[c * KS + d] = in ? to_f32(v[(kvbase + col) * D + d]) : 0.0f;
    }
    __syncthreads();
    const int col = j0 + lane;
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp * RPW + rr, row = q0 + r;
      float s = 0.0f, dp = 0.0f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) {
        s = fmaf(qs[r * D + d], ks[lane * KS + d], s);
        dp = fmaf(dos[r * D + d], vs[lane * KS + d], dp);
      }
      const bool valid = row < Sq && attends(col, q_offset + row, Skv, causal, window);
      const float p = valid ? expf(s * scale - lrow[rr]) : 0.0f;
      const float ds = p * (dp - di[rr]);
#pragma unroll 8
      for (int jj = 0; jj < BKV; ++jj) {
        const float dsj = __shfl_sync(FULL, ds, jj);
#pragma unroll
        for (int t = 0; t < DT; ++t)
          acc[rr][t] = fmaf(dsj, ks[jj * KS + lane + 32 * t], acc[rr][t]);
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int row = q0 + warp * RPW + rr;
    if (row >= Sq) continue;
#pragma unroll
    for (int t = 0; t < DT; ++t)
      dq[(qbase + row) * D + lane + 32 * t] = from_f32<T>(acc[rr][t] * scale);
  }
}

template <typename T, bool TRAIN>
int launch_fwd(const void* q, const void* k, const void* v, const int* start,
               void* out, float* lse, int B, int Hq, int Hkv, int Sq, int Skv,
               int D, int q_offset, int causal, int window, float scale,
               cudaStream_t st) {
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(out);
  if (D == 128) {
    flash_fwd_kernel<T, 128, TRAIN><<<grid, NTHREADS, 0, st>>>(
        qq, kk, vv, start, oo, lse, Hq, Hkv, Sq, Skv, q_offset, causal, window, scale);
  } else if (D == 64) {
    flash_fwd_kernel<T, 64, TRAIN><<<grid, NTHREADS, 0, st>>>(
        qq, kk, vv, start, oo, lse, Hq, Hkv, Sq, Skv, q_offset, causal, window, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch a backward kernel with `smem` bytes of dynamic shared memory (over
// the 48 KB default at D = 128, so the limit is raised first).
template <typename Kernel, typename... Args>
int launch_dyn(Kernel kernel, dim3 grid, size_t smem, cudaStream_t st, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, NTHREADS, smem, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_bwd(bool dkdv, const T* q, const T* k, const T* v, const T* o,
               const float* lse, const T* dout, T* a, T* b_out, int B, int Hq,
               int Hkv, int Sq, int Skv, int q_offset, int causal, int window,
               float scale, cudaStream_t st) {
  if (dkdv) {
    const size_t smem = sizeof(float) * (2 * BKV * (D + 1) + 2 * BQ * D + 2 * BQ * BKV);
    return launch_dyn(flash_bwd_dkdv_kernel<T, D>, dim3((Skv + BKV - 1) / BKV, Hkv, B),
                      smem, st, q, k, v, o, lse, dout, a, b_out, Hq, Hkv, Sq, Skv,
                      q_offset, causal, window, scale);
  }
  const size_t smem = sizeof(float) * (2 * BQ * D + 2 * BKV * (D + 1));
  return launch_dyn(flash_bwd_dq_kernel<T, D>, dim3((Sq + BQ - 1) / BQ, Hq, B), smem,
                    st, q, k, v, o, lse, dout, a, Hq, Hkv, Sq, Skv, q_offset, causal,
                    window, scale);
}

template <typename T>
int launch_bwd_d(bool dkdv, const void* q, const void* k, const void* v,
                 const void* o, const float* lse, const void* dout, void* a,
                 void* b_out, int B, int Hq, int Hkv, int Sq, int Skv, int D,
                 int q_offset, int causal, int window, float scale, cudaStream_t st) {
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const T* oo = static_cast<const T*>(o);
  const T* dd = static_cast<const T*>(dout);
  T* aa = static_cast<T*>(a);
  T* bb = static_cast<T*>(b_out);
  if (D == 128)
    return launch_bwd<T, 128>(dkdv, qq, kk, vv, oo, lse, dd, aa, bb, B, Hq, Hkv, Sq,
                              Skv, q_offset, causal, window, scale, st);
  if (D == 64)
    return launch_bwd<T, 64>(dkdv, qq, kk, vv, oo, lse, dd, aa, bb, B, Hq, Hkv, Sq,
                             Skv, q_offset, causal, window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
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
    return launch_fwd<__nv_bfloat16, false>(q, k, v, start, out, nullptr, B, Hq, Hkv,
                                            Sq, Skv, D, q_offset, causal, window,
                                            scale, st);
  return launch_fwd<float, false>(q, k, v, start, out, nullptr, B, Hq, Hkv, Sq, Skv,
                                  D, q_offset, causal, window, scale, st);
}

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, float* lse, int is_bf16, int B,
                                   int Hq, int Hkv, int Sq, int Skv, int D,
                                   int q_offset, int causal, int window,
                                   float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_fwd<__nv_bfloat16, true>(q, k, v, nullptr, out, lse, B, Hq, Hkv, Sq,
                                           Skv, D, q_offset, causal, window, scale, st);
  return launch_fwd<float, true>(q, k, v, nullptr, out, lse, B, Hq, Hkv, Sq, Skv, D,
                                 q_offset, causal, window, scale, st);
}

extern "C" int flash_attention_bwd_dkdv(const void* q, const void* k,
                                        const void* v, const void* o,
                                        const float* lse, const void* dout,
                                        void* dk, void* dv, int is_bf16, int B,
                                        int Hq, int Hkv, int Sq, int Skv, int D,
                                        int q_offset, int causal, int window,
                                        float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_bwd_d<__nv_bfloat16>(true, q, k, v, o, lse, dout, dk, dv, B, Hq, Hkv,
                                       Sq, Skv, D, q_offset, causal, window, scale, st);
  return launch_bwd_d<float>(true, q, k, v, o, lse, dout, dk, dv, B, Hq, Hkv, Sq, Skv,
                             D, q_offset, causal, window, scale, st);
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const float* lse, const void* dout,
                                      void* dq, int is_bf16, int B, int Hq,
                                      int Hkv, int Sq, int Skv, int D,
                                      int q_offset, int causal, int window,
                                      float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_bwd_d<__nv_bfloat16>(false, q, k, v, o, lse, dout, dq, nullptr, B, Hq,
                                       Hkv, Sq, Skv, D, q_offset, causal, window, scale,
                                       st);
  return launch_bwd_d<float>(false, q, k, v, o, lse, dout, dq, nullptr, B, Hq, Hkv, Sq,
                             Skv, D, q_offset, causal, window, scale, st);
}
