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
// Online softmax in f32; fully masked rows give exact zeros.  As in the
// plain version (masked_attention_ref), scores are (q . k) * scale and the
// probabilities are rounded to the value dtype before the value product.
//
// What bounds it on the H100: at prefill lengths 256..512 with D = 128,
// 16 q heads and 2 kv heads, the ~4*S^2*D/2 flops per q head and the
// bytes of q, K/V and the output (each once) give bounds of about the
// same size (~1.1 and ~1.4 us at S = 512): neither dominates.  Kernel 2
// has two routes by dtype, like kernel 7 (see Routes below): bf16, what
// serving runs, takes kernel 7's tensor-core body (flash_fwd_masked_tc,
// below); float32 the CUDA-core kernel, whose design (simple first): the
// TPU's sequential kv grid axis becomes a loop inside the block; one
// block per (q tile of 16 rows, q head, batch), 4 warps, 4 query rows
// per warp.  Per 32-column kv tile the block stages K and V in shared
// memory as f32; lane j scores column j for each of its warp's rows
// (q rows broadcast from shared memory, K rows padded against bank
// conflicts), the row max and sum are warp shuffles, and each lane owns
// D/32 output columns of the accumulator.  Tiles wholly outside the
// causal / window / start band are skipped (exact: a fully masked tile
// leaves m, l and acc unchanged), and ragged q and kv edges are masked
// in-kernel.
//
// Kernel 7 (flash_attention_fwd) replaces the Pallas TPU kernel
// flash_attention (flash_attention.py:92, the same body _kernel :32 with
// has_start=False): no start vector (every column from 0 attends), the
// row's log-sum-exp lse = m + log(l) f32 [B, Hq, Sq] written for the
// backward (+inf for a fully masked row, which has no gradient).  The
// Pallas body multiplies q by scale before the dot (:48); this kernel
// follows the plain version, attention_ref, and scales the dot: s =
// (q . k) * scale, in f32.  The training caller passes q_offset = Skv - Sq.
//
// Kernels 7b and 7c are the backward.  The JAX package has no backward
// kernel (no custom_vjp around flash_attention): the reference
// differentiates the plain jnp attention.  They stand in for that
// autograd backward with the flash-attention-2 recurrence from the saved
// lse: P = exp(s - lse) on the band, D_i = rowsum(dO_i * O_i),
// dS = P * (dP - D), dP = dO V^T, dV = P^T dO, dK = scale dS^T Q,
// dQ = scale dS K, accumulated in f32, each gradient written once in the
// input's dtype (two kernels rather than atomics on dQ: runs repeat bit
// for bit).
//
// Routes.  Kernels 2, 7, 7b and 7c take one of two routes by the operands'
// dtype, with no fallback between them:
// * bfloat16 operands (what training runs), D = 64 or 128: the
//   tensor-core kernels flash_fwd_tc, flash_bwd_dkdv_tc and
//   flash_bwd_dq_tc below (wgmma, TMA, mbarriers; helpers in sm90.cuh).
//   They round P (and in 7b and 7c dS) to bf16 as the register operand of
//   the value and gradient products, as a TPU's MXU takes bf16 operands
//   from the Pallas body's f32 dot_generals at default precision: one
//   rounding of 2^-8 relative, inside the limits of chip_smoke.py
//   (TOL_BF16, bwd_units).
//   Kernel 2 (flash_fwd_masked_tc) rounds P the same way, before P V.
// * float32 operands: the CUDA-core kernels flash_fwd_kernel<float, D,
//   TRAIN> (kernel 2: TRAIN = false; 7: true), flash_bwd_dkdv_kernel<float,
//   D> and flash_bwd_dq_kernel<float, D>, unchanged.  The float32 parity
//   checks (TOL_F32 and the float32 training comparison) need f32
//   products, which TF32 tensor cores would not give; nothing on the
//   serving or training path is float32.
//
// What bounds them on the H100 at the training shape (B=1, H=36, S=4096,
// D=64, causal, bf16): kernel 7 does 4 S^2/2 H D = 7.7e10 flops on ~76 MB
// (each input read once, output and lse written once), 7b 1.5e11 flops
// (S and dP recomputed, dV and dK), 7c 1.2e11: operation-bound, 0.078,
// 0.156 and 0.117 ms at the bf16 dense tensor-core peak (989 TFLOP/s).
//
// Kernel 7, tensor-core design (flash_fwd_tc): one block of 384 threads
// per (128-row q tile, q head, batch), heaviest q tiles first under
// causal masking; two consumer warpgroups own 64 q rows each, and one
// thread of the producer warpgroup issues TMA loads: Q once, then K and V
// tiles of 128 rows into a ring of 4 stages (D = 64; 3 at D = 128) of
// 128-byte-swizzled shared memory, completion on mbarriers (full: bytes
// arrived; empty: one arrival per consumer warp).  setmaxnreg gives the
// consumers 232 registers and the producer 40.  Per kv tile a consumer
// issues S = Q K^T as wgmma m64n128k16 (both operands in shared memory),
// then the online softmax in registers over the 4 threads sharing a row:
// the mask only on tiles that cross the causal diagonal, the window edge
// or Skv (tiles wholly outside the band are not loaded), the max over the
// raw scores, p = 2^(s c - m c) with c = scale log2(e) in one FFMA,
// l summing the f32 p; then O += P V as wgmma m64n64k16 per 64 columns of
// D, P as the bf16 register A operand (the accumulator layout is the A
// fragment's: no shuffle) and V MN-major from shared memory.  Epilogue:
// O / l to bf16 into the warpgroup's consumed Q rows (swizzled), one TMA
// store per 64 columns (rows past Sq are not written); lse from the
// threads holding each row.  Shared memory 148,552 bytes at D = 64 and
// 230,456 at D = 128 (FwdTC::SMEM); -Xptxas -v reports 168 registers at
// entry (384 threads) with no spill at D = 64 (chip_smoke.py prints the
// build's figures).
//
// Kernel 2, tensor-core design (flash_fwd_masked_tc): kernel 7's body
// (fwd_tc_body) with MASKED set.  Each block reads start[b] and begins its
// kv loop at the tile holding max(start, the window edge); an edge tile
// (one that crosses the diagonal, the window edge, start or Skv) sets the
// masked scores to -inf in the same branch-free select, whole tiles skip
// it; no lse is written.  A row with no attended column keeps l = 0 and
// stores 0, and a block with no kv tile at all (every row a pad query)
// stores zeros through the same TMA store, without loading Q.  Its own
// tiles: 64-column kv tiles, so a consumer's live set (O: 64 floats at
// D = 128, S: 32) fits ptxas's 168 registers without spill, in a 4-stage
// ring; q tiles of 64 rows (one consumer warpgroup, 256 threads, no
// setmaxnreg: 128 blocks at S = 512, Hq = 16, B = 1, against 64 with
// 128-row tiles, which timed slower on the card; PERF.md).  q_offset > 0
// (a chunked prefill) is kernel 7's band logic unchanged.
//
// Kernel 7b, tensor-core design (flash_bwd_dkdv_tc): one block of 384
// threads per (128-row kv tile, kv head, batch); two consumer warpgroups
// own 64 kv rows each, and K and V stay resident (one TMA load each).  The
// block walks the group's q heads and, for each, the q tiles (64 rows at
// D = 64, 32 at D = 128) inside the causal / window band; the producer
// warp brings each tile's Q and dO by TMA and its lse log2(e) and D_i by
// plain loads into a 4-stage ring.  D_i = rowsum(dO_i * O_i) arrives
// precomputed (f32 [B, Hq, Sq], written by kernel 7c, which runs first:
// O and dO are read once per call instead of once per kv tile).  Per q tile: S^T = K Q^T and
// dP^T = V dO^T by wgmma from shared memory; P^T = 2^(S^T c - lse log2 e)
// and dS^T = P^T (dP^T - D), the mask selecting 0 only on tiles that cross
// the band's edges; dV += P^T dO and dK += dS^T Q by wgmma m64n64k16 with
// P^T and dS^T as bf16 register A operands and dO and Q MN-major.  dK
// scale and dV are written once in bf16 through the consumed K / V rows
// and TMA stores.  The group's q heads are summed in registers: no
// atomics.  Shared memory 101,448 bytes at D = 64 and 133,192 at D =
// 128 (BwdTC::SMEM); 168 registers at entry, 4 bytes of spill at D = 64.
//
// Kernel 7c, tensor-core design (flash_bwd_dq_tc): one block of 384
// threads per (128-row q tile, q head, batch), heaviest q tiles first
// under causal masking; two consumer warpgroups own 64 q rows each.  Q and
// dO stay resident (one TMA load each); K and V of the GQA group's kv head
// come through a ring of 64-row tiles (6 stages at D = 64, 4 at D = 128)
// over the causal / window band of the block's rows.  Before the kv loop
// each consumer thread computes D_i = rowsum(dO_i * O_i) in f32 for its
// two rows (the row's 4 threads split D; O and dO by 16-byte loads, O is
// read once and needs no shared memory) and writes it once, f32 [B, Hq,
// Sq], for kernel 7b.  Per kv tile: S = Q K^T and dP = dO V^T by wgmma
// m64n64k16 from shared memory (K-major B); P = 2^(S c - lse log2(e))
// with c = scale log2(e) in one FFMA, branch-free per element (only tiles
// that cross the band's edges set masked scores to -inf); dS = P (dP -
// D_i); dQ += dS K by wgmma m64n64k16 with dS rounded to bf16 as the
// register A operand and K MN-major.  A 64-column kv tile keeps the
// consumer's live set (dQ, S, dP: 96 floats at D = 64, 128 at D = 128) under
// ptxas's 168 registers at entry.  Each block owns its q rows and all their
// kv tiles: dQ scale is written once in bf16 through the consumed Q rows
// and TMA stores, with no atomics (runs repeat bit for bit).
//
// The CUDA-core kernels (simple first): 7 is kernel 2's template with
// TRAIN = true (probabilities kept in f32); 7b is one block per (32-row kv
// tile, kv head, batch) whose lanes score kv rows against 16-row q tiles,
// with P and dS through shared memory, computing D_i itself; 7c (float32
// route) is one block per (16-row q tile, q head, batch), looping over the
// band's kv tiles as kernel 7 does, lane j scoring column j and dS
// broadcast by shuffles into each lane's D/32 dQ columns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "online_softmax.cuh"
#include "sm90.cuh"

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

// Kernels 2 (TRAIN = false) and 7 on its float32 route (TRAIN = true).
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

// Kernel 7b on its float32 route: dK and dV of one 32-row kv tile, summed over
// the group's q heads.
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

// Kernel 7c on its float32 route: dQ of one 16-row q tile of one q head.
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

// ---------------------------------------------------------------------------
// Tensor-core route (bf16 operands): kernels 7 and 7b for Hopper.  Layout,
// descriptors and fragment conventions: sm90.cuh.

constexpr int WG = 128;                    // threads of a warpgroup
constexpr int TC_CONSUMERS = 2;            // consumer warpgroups
constexpr int TC_THREADS = (TC_CONSUMERS + 1) * WG;   // + the producer warpgroup
// registers a thread: 65536 / 384 = 168 at launch, then the producer
// warpgroup drops to 40 and the consumers rise to 232 (128 x 40 + 256 x 232
// = 64512)
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

// Kernels 7 and 2 (tensor-core route) shared memory: Q [NSUB][BQ][64] |
// K, V [STAGES][NSUB][BKV][64] | mbarriers; NSUB = D / 64 column tiles,
// each 128-byte swizzled; one consumer warpgroup per 64 q rows.
template <int D, int BQ_, int BKV_, int STAGES_>
struct FwdTile {
  static constexpr int BQ = BQ_, BKV = BKV_, NSUB = D / 64, STAGES = STAGES_;
  static constexpr int CONSUMERS = BQ / 64, THREADS = (CONSUMERS + 1) * 128;
  static constexpr int Q_BYTES = BQ * D * 2, KV_BYTES = BKV * D * 2;
  static constexpr int K_OFF = Q_BYTES, V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;   // + alignment slack
};
// kernel 7: 128-row q and kv tiles
template <int D>
using FwdTC = FwdTile<D, 128, 128, D == 64 ? 4 : 3>;
// kernel 2: 64-column kv tiles (a consumer's live set without spill at
// D = 128), 64-row q tiles (one consumer warpgroup)
template <int D>
using MaskedTC = FwdTile<D, 64, 64, 4>;

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (sm90::smem_u32(p) & 1023)) & 1023);
}

// The tensor-core forward of kernels 7 (MASKED = false: lse written, every
// column from 0 attends) and 2 (MASKED: columns before start[b] masked, no
// lse): one block per (L::BQ-row q tile, q head, batch); warpgroup w owns
// q rows 64 w .. 64 w + 63 of the tile.
template <typename L, bool MASKED>
__device__ __forceinline__ void fwd_tc_body(const CUtensorMap* qmap, const CUtensorMap* kmap,
                                            const CUtensorMap* vmap, const CUtensorMap* omap,
                                            float* __restrict__ lse,
                                            const int* __restrict__ start, int Hq, int Hkv,
                                            int Sq, int Skv, int q_offset, int causal,
                                            int window, float scale) {
  using namespace sm90;
  constexpr int BQ = L::BQ, BKV = L::BKV, NSUB = L::NSUB, STAGES = L::STAGES;
  constexpr int CONS = L::CONSUMERS, D = 64 * NSUB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* qs = smem;
  uint8_t* ks = smem + L::K_OFF;
  uint8_t* vs = smem + L::V_OFF;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  // under causal masking the last q tiles see the most kv tiles: start them first
  const int q0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * BQ;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int qplane = b * Hq + hq, kvplane = b * Hkv + hq / (Hq / Hkv);
  const int st = MASKED ? start[b] : 0;   // kernel 2: columns before it never attend
  // kv tiles any row of this block attends to
  const int qpos_lo = q_offset + q0, qpos_hi = q_offset + min(q0 + BQ, Sq) - 1;
  int kv_lo = window > 0 ? max(0, qpos_lo - window + 1) : 0;
  if (MASKED) kv_lo = max(kv_lo, st);
  const int kv_hi = causal ? min(Skv - 1, qpos_hi) : Skv - 1;
  const int j_first = (kv_lo / BKV) * BKV;
  const int ntiles = kv_hi >= j_first ? (kv_hi - j_first) / BKV + 1 : 0;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONS * WG / 32);   // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= CONS * WG) {   // producer warpgroup: one thread issues every TMA load
    if constexpr (CONS == TC_CONSUMERS) reg_dealloc<PRODUCER_REGS>();
    if (tid == CONS * WG && ntiles > 0) {
      mbar_arrive_expect_tx(q_full, L::Q_BYTES);
      for (int s = 0; s < NSUB; ++s) tma_load(qs + s * BQ * 128, qmap, q_full, 64 * s, q0, qplane);
      for (int i = 0; i < ntiles; ++i) {
        const int stg = i % STAGES, j0 = j_first + i * BKV;
        mbar_wait(&empty[stg], ((i / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[stg], 2 * L::KV_BYTES);
        for (int s = 0; s < NSUB; ++s) {
          const int at = stg * L::KV_BYTES + s * BKV * 128;
          tma_load(ks + at, kmap, &full[stg], 64 * s, j0, kvplane);
          tma_load(vs + at, vmap, &full[stg], 64 * s, j0, kvplane);
        }
      }
    }
  } else {
    if constexpr (CONS == TC_CONSUMERS) reg_alloc<CONSUMER_REGS>();
    const int wg = tid / WG, warp = (tid % WG) / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int wq = q_offset + q0 + 64 * wg;   // position of the warpgroup's first row
    uint8_t* qa = qs + 64 * wg * 128;         // its rows of each Q column tile
    float o[NSUB][32];
#pragma unroll
    for (int s = 0; s < NSUB; ++s)
#pragma unroll
      for (int x = 0; x < 32; ++x) o[s][x] = 0.0f;
    // m: running row max of the raw scores; l: this thread's columns' sum
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
    const float c = scale * 1.44269504088896341f;   // scale log2(e)

    if (ntiles > 0) mbar_wait(q_full, 0);
    for (int i = 0; i < ntiles; ++i) {
      const int stg = i % STAGES, j0 = j_first + i * BKV;
      const uint8_t* kt = ks + stg * L::KV_BYTES;
      const uint8_t* vt = vs + stg * L::KV_BYTES;
      mbar_wait(&full[stg], (i / STAGES) & 1);

      float s[BKV / 2];   // S = Q K^T, rows 16 warp + g (+ 8), columns 8 j + 2 t (+ 1)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {   // column tile kk / 4, 16-column step kk % 4
        const int at = (kk % 4) * 32;
        wgmma_ss<BKV>(s, desc(qa + (kk / 4) * BQ * 128 + at),
                      desc(kt + (kk / 4) * BKV * 128 + at), kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);

      // online softmax in f32 over the raw scores (scale > 0 commutes with
      // the max), branch-free per element: only tiles that cross the causal
      // diagonal, the window edge, start (kernel 2) or Skv evaluate the mask,
      // which sets a masked score to -inf; p = 2^(s c - m c) with c = scale
      // log2(e) folded into one FFMA (a row with no column yet exponentiates
      // against 0, so a fully masked row keeps p = 0, l = 0 and O = 0)
      const bool whole = j0 + BKV <= Skv && (!causal || j0 + BKV - 1 <= wq) &&
                         (window <= 0 || j0 > wq + 63 - window) && (!MASKED || j0 >= st);
      if (!whole) {
#pragma unroll
        for (int x = 0; x < BKV / 2; ++x) {
          const int col = j0 + 8 * (x / 4) + 2 * t + x % 2;
          const int qpos = wq + 16 * warp + g + 8 * ((x / 2) % 2);
          s[x] = attends(col, qpos, Skv, causal, window) && (!MASKED || col >= st) ? s[x]
                                                                                   : -INFINITY;
        }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int x = 0; x < BKV / 2; ++x) mx[(x / 2) % 2] = fmaxf(mx[(x / 2) % 2], s[x]);
      float alpha[2], nb[2];
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        mx[i2] = fmaxf(mx[i2], __shfl_xor_sync(FULL, mx[i2], 1));
        mx[i2] = fmaxf(mx[i2], __shfl_xor_sync(FULL, mx[i2], 2));
        const float base = mx[i2] == -INFINITY ? 0.0f : mx[i2];
        alpha[i2] = exp2f((m[i2] - base) * c);
        nb[i2] = -base * c;
        l[i2] *= alpha[i2];
        m[i2] = mx[i2];
      }
#pragma unroll
      for (int x = 0; x < BKV / 2; ++x) {
        s[x] = exp2f(fmaf(s[x], c, nb[(x / 2) % 2]));
        l[(x / 2) % 2] += s[x];
      }
#pragma unroll
      for (int sb = 0; sb < NSUB; ++sb)
#pragma unroll
        for (int x = 0; x < 32; ++x) o[sb][x] *= alpha[(x / 2) % 2];

      // O += P V: P rounded to bf16 as the register A operand, V MN-major
      uint32_t a[BKV / 16][4];
#pragma unroll
      for (int kb = 0; kb < BKV / 16; ++kb) a_frag(s, kb, a[kb]);
      wgmma_fence();
#pragma unroll
      for (int sb = 0; sb < NSUB; ++sb) fence_regs(o[sb]);
#pragma unroll
      for (int kb = 0; kb < BKV / 16; ++kb)
#pragma unroll
        for (int sb = 0; sb < NSUB; ++sb)
          wgmma_rs_n64(o[sb], a[kb], desc(vt + sb * BKV * 128 + kb * 16 * 128));
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int sb = 0; sb < NSUB; ++sb) fence_regs(o[sb]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stg]);
    }

    // epilogue: O / l in bf16 into this warpgroup's (consumed) Q rows, then
    // one TMA store per column tile (rows past Sq are not written); a row
    // with l = 0 stores 0 * (1 / 1e-30) = 0, and a block with no kv tile
    // stores zeros without having loaded Q
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      l[i2] += __shfl_xor_sync(FULL, l[i2], 1);
      l[i2] += __shfl_xor_sync(FULL, l[i2], 2);
    }
    named_bar_sync(1 + wg, WG);
    const float inv[2] = {1.0f / fmaxf(l[0], 1e-30f), 1.0f / fmaxf(l[1], 1e-30f)};
#pragma unroll
    for (int sb = 0; sb < NSUB; ++sb)
#pragma unroll
      for (int x = 0; x < 32; x += 2) {
        const int i2 = (x / 2) % 2, row = 16 * warp + g + 8 * i2;
        *reinterpret_cast<uint32_t*>(qa + sb * BQ * 128 + sw128(row, x / 4) + 4 * t) =
            pack_bf16(o[sb][x] * inv[i2], o[sb][x + 1] * inv[i2]);
      }
    fence_proxy_async();
    named_bar_sync(1 + wg, WG);
    if (tid % WG == 0) {
      for (int sb = 0; sb < NSUB; ++sb)
        tma_store(omap, qa + sb * BQ * 128, 64 * sb, q0 + 64 * wg, qplane);
      tma_store_wait();
    }
    if (!MASKED && t == 0) {
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        const int row = q0 + 64 * wg + 16 * warp + g + 8 * i2;
        if (row < Sq)
          lse[static_cast<size_t>(qplane) * Sq + row] =
              l[i2] > 0.0f ? m[i2] * scale + logf(l[i2]) : INFINITY;
      }
    }
  }
}

// Kernel 7, tensor-core route.
template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_fwd_tc(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap,
             float* __restrict__ lse, int Hq, int Hkv, int Sq, int Skv, int q_offset,
             int causal, int window, float scale) {
  fwd_tc_body<FwdTC<D>, false>(&qmap, &kmap, &vmap, &omap, lse, nullptr, Hq, Hkv, Sq, Skv,
                               q_offset, causal, window, scale);
}

// Kernel 2, tensor-core route (bf16 operands).
template <int D>
__global__ void __launch_bounds__(MaskedTC<D>::THREADS, 1)
flash_fwd_masked_tc(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap omap, const int* __restrict__ start,
                    int Hq, int Hkv, int Sq, int Skv, int q_offset, int causal, int window,
                    float scale) {
  fwd_tc_body<MaskedTC<D>, true>(&qmap, &kmap, &vmap, &omap, nullptr, start, Hq, Hkv, Sq, Skv,
                                 q_offset, causal, window, scale);
}

// Kernel 7b shared memory: K, V [NSUB][BKV][64] | Q, dO [STAGES][NSUB][BQ][64]
// | lse log2(e), D_i [STAGES][BQ] f32 | mbarriers.
template <int D>
struct BwdTC {
  static constexpr int BKV = 128, BQ = D == 64 ? 64 : 32, NSUB = D / 64, STAGES = 4;
  static constexpr int KV_BYTES = BKV * D * 2, QT_BYTES = BQ * D * 2;
  static constexpr int V_OFF = KV_BYTES, Q_OFF = 2 * KV_BYTES;
  static constexpr int DO_OFF = Q_OFF + STAGES * QT_BYTES;
  static constexpr int LSE_OFF = DO_OFF + STAGES * QT_BYTES;
  static constexpr int DEL_OFF = LSE_OFF + STAGES * BQ * 4;
  static constexpr int BAR_OFF = DEL_OFF + STAGES * BQ * 4;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};

// Kernel 7b, tensor-core route: one block per (128-row kv tile, kv head,
// batch); warpgroup w owns kv rows 64 w .. 64 w + 63 and accumulates their
// dK and dV over the group's q heads and the q tiles of the band.
template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_bwd_dkdv_tc(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const __grid_constant__ CUtensorMap domap,
                  const __grid_constant__ CUtensorMap dkmap,
                  const __grid_constant__ CUtensorMap dvmap, const float* __restrict__ lse,
                  const float* __restrict__ delta, int Hq, int Hkv, int Sq, int Skv,
                  int q_offset, int causal, int window, float scale) {
  using L = BwdTC<D>;
  using namespace sm90;
  constexpr int BQ = L::BQ, BKV = L::BKV, NSUB = L::NSUB, STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* ks = smem;
  uint8_t* vs = smem + L::V_OFF;
  uint8_t* qs = smem + L::Q_OFF;
  uint8_t* dos = smem + L::DO_OFF;
  float* lse_s = reinterpret_cast<float*>(smem + L::LSE_OFF);
  float* del_s = reinterpret_cast<float*>(smem + L::DEL_OFF);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, lane = tid % 32;
  const int j0 = blockIdx.x * BKV, hk = blockIdx.y, b = blockIdx.z;
  const int group = Hq / Hkv, kvplane = b * Hkv + hk;
  // q rows whose band meets this kv tile
  const int j_hi = min(j0 + BKV, Skv) - 1;
  const int t_lo = causal ? max(0, j0 - q_offset) : 0;
  int t_hi = Sq - 1;
  if (window > 0) t_hi = min(t_hi, j_hi + window - 1 - q_offset);
  const int t_first = (t_lo / BQ) * BQ;
  const int ntq = t_hi >= t_first ? (t_hi - t_first) / BQ + 1 : 0;
  const int n = group * ntq;   // (q head, q tile) steps

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], TC_CONSUMERS * WG / 32);   // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= TC_CONSUMERS * WG) {   // producer warpgroup: its first warp loads
    reg_dealloc<PRODUCER_REGS>();
    if (tid < TC_CONSUMERS * WG + 32 && n > 0) {
      if (lane == 0) {
        mbar_arrive_expect_tx(kv_full, 2 * L::KV_BYTES);
        for (int s = 0; s < NSUB; ++s) {
          tma_load(ks + s * BKV * 128, &kmap, kv_full, 64 * s, j0, kvplane);
          tma_load(vs + s * BKV * 128, &vmap, kv_full, 64 * s, j0, kvplane);
        }
      }
      for (int it = 0; it < n; ++it) {
        const int st = it % STAGES;
        const int t0 = t_first + (it % ntq) * BQ, qplane = b * Hq + hk * group + it / ntq;
        mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
        // the tile's lse log2(e) and D_i by plain loads; each lane arrives
        // after its writes
        for (int r = lane; r < BQ; r += 32) {
          const bool in = t0 + r < Sq;
          const size_t at = static_cast<size_t>(qplane) * Sq + t0 + r;
          lse_s[st * BQ + r] = in ? lse[at] * 1.44269504088896341f : 0.0f;
          del_s[st * BQ + r] = in ? delta[at] : 0.0f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[st], 2 * L::QT_BYTES);
          for (int s = 0; s < NSUB; ++s) {
            const int at = st * L::QT_BYTES + s * BQ * 128;
            tma_load(qs + at, &qmap, &full[st], 64 * s, t0, qplane);
            tma_load(dos + at, &domap, &full[st], 64 * s, t0, qplane);
          }
        } else {
          mbar_arrive(&full[st]);
        }
      }
    }
  } else {
    reg_alloc<CONSUMER_REGS>();
    const int wg = tid / WG, warp = (tid % WG) / 32;
    const int g = lane / 4, t = lane % 4;
    const int kr = j0 + 64 * wg;   // the warpgroup's first kv row
    uint8_t* ka = ks + 64 * wg * 128;
    uint8_t* va = vs + 64 * wg * 128;
    float dk[NSUB][32], dv[NSUB][32];
#pragma unroll
    for (int s = 0; s < NSUB; ++s)
#pragma unroll
      for (int x = 0; x < 32; ++x) dk[s][x] = dv[s][x] = 0.0f;

    const float c = scale * 1.44269504088896341f;   // scale log2(e)
    if (n > 0) mbar_wait(kv_full, 0);
    for (int it = 0; it < n; ++it) {
      const int st = it % STAGES, t0 = t_first + (it % ntq) * BQ;
      const uint8_t* qt = qs + st * L::QT_BYTES;
      const uint8_t* dot = dos + st * L::QT_BYTES;
      mbar_wait(&full[st], (it / STAGES) & 1);

      // S^T = K Q^T and dP^T = V dO^T: rows are kv rows, columns q rows
      float s[BQ / 2], dp[BQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int a_at = (kk / 4) * BKV * 128 + (kk % 4) * 32;
        const int b_at = (kk / 4) * BQ * 128 + (kk % 4) * 32;
        wgmma_ss<BQ>(s, desc(ka + a_at), desc(qt + b_at), kk > 0);
        wgmma_ss<BQ>(dp, desc(va + a_at), desc(dot + b_at), kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);
      fence_regs(dp);

      // P^T = exp(S^T scale - lse) = 2^(S^T c - lse log2(e)) with c = scale
      // log2(e) (one FFMA) on the band, dS^T = P^T (dP^T - D), branch-free
      // per element: the mask (only on tiles that cross the band's edges or
      // Sq / Skv) selects 0 after the exp
      const bool whole = t0 + BQ <= Sq && kr + 63 < Skv &&
                         (!causal || kr + 63 <= q_offset + t0) &&
                         (window <= 0 || kr > q_offset + t0 + BQ - 1 - window);
#pragma unroll
      for (int x = 0; x < BQ / 2; ++x)
        s[x] = exp2f(fmaf(s[x], c, -lse_s[st * BQ + 8 * (x / 4) + 2 * t + x % 2]));
      if (!whole) {
#pragma unroll
        for (int x = 0; x < BQ / 2; ++x) {
          const int col = t0 + 8 * (x / 4) + 2 * t + x % 2;
          const int row = kr + 16 * warp + g + 8 * ((x / 2) % 2);
          s[x] = (col < Sq && attends(row, q_offset + col, Skv, causal, window)) ? s[x] : 0.0f;
        }
      }
#pragma unroll
      for (int x = 0; x < BQ / 2; ++x)
        dp[x] = s[x] * (dp[x] - del_s[st * BQ + 8 * (x / 4) + 2 * t + x % 2]);

      // dV += P^T dO and dK += dS^T Q: P^T, dS^T rounded to bf16 as register
      // A operands; dO, Q MN-major
      uint32_t ap[BQ / 16][4], ad[BQ / 16][4];
#pragma unroll
      for (int kb = 0; kb < BQ / 16; ++kb) {
        a_frag(s, kb, ap[kb]);
        a_frag(dp, kb, ad[kb]);
      }
      wgmma_fence();
#pragma unroll
      for (int sb = 0; sb < NSUB; ++sb) {
        fence_regs(dv[sb]);
        fence_regs(dk[sb]);
      }
#pragma unroll
      for (int kb = 0; kb < BQ / 16; ++kb)
#pragma unroll
        for (int sb = 0; sb < NSUB; ++sb) {
          const int at = sb * BQ * 128 + kb * 16 * 128;
          wgmma_rs_n64(dv[sb], ap[kb], desc(dot + at));
          wgmma_rs_n64(dk[sb], ad[kb], desc(qt + at));
        }
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int sb = 0; sb < NSUB; ++sb) {
        fence_regs(dv[sb]);
        fence_regs(dk[sb]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    // epilogue: dK scale and dV in bf16 into this warpgroup's (consumed) K
    // and V rows, then TMA stores (rows past Skv are not written)
    named_bar_sync(1 + wg, WG);
#pragma unroll
    for (int sb = 0; sb < NSUB; ++sb)
#pragma unroll
      for (int x = 0; x < 32; x += 2) {
        const int row = 16 * warp + g + 8 * ((x / 2) % 2);
        const uint32_t at = sb * BKV * 128 + sw128(row, x / 4) + 4 * t;
        *reinterpret_cast<uint32_t*>(ka + at) = pack_bf16(dk[sb][x] * scale, dk[sb][x + 1] * scale);
        *reinterpret_cast<uint32_t*>(va + at) = pack_bf16(dv[sb][x], dv[sb][x + 1]);
      }
    fence_proxy_async();
    named_bar_sync(1 + wg, WG);
    if (tid % WG == 0) {
      for (int sb = 0; sb < NSUB; ++sb) {
        tma_store(&dkmap, ka + sb * BKV * 128, 64 * sb, kr, kvplane);
        tma_store(&dvmap, va + sb * BKV * 128, 64 * sb, kr, kvplane);
      }
      tma_store_wait();
    }
  }
}

// Kernel 7c shared memory: Q, dO [NSUB][BQ][64] | K, V [STAGES][NSUB][BKV][64]
// | mbarriers.
template <int D>
struct DqTC {
  static constexpr int BQ = 128, BKV = 64, NSUB = D / 64, STAGES = D == 64 ? 6 : 4;
  static constexpr int Q_BYTES = BQ * D * 2, KV_BYTES = BKV * D * 2;
  static constexpr int DO_OFF = Q_BYTES, K_OFF = 2 * Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};

// Kernel 7c, tensor-core route: one block per (128-row q tile, q head,
// batch); warpgroup w owns q rows 64 w .. 64 w + 63, computes their D_i and
// accumulates their dQ over the kv tiles of the band.
template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_bwd_dq_tc(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const __grid_constant__ CUtensorMap domap,
                const __grid_constant__ CUtensorMap dqmap, const __nv_bfloat16* __restrict__ o,
                const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                float* __restrict__ delta, int Hq, int Hkv, int Sq, int Skv, int q_offset,
                int causal, int window, float scale) {
  using L = DqTC<D>;
  using namespace sm90;
  constexpr int BQ = L::BQ, BKV = L::BKV, NSUB = L::NSUB, STAGES = L::STAGES;
  constexpr float LOG2E = 1.44269504088896341f;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* qs = smem;
  uint8_t* dos = smem + L::DO_OFF;
  uint8_t* ks = smem + L::K_OFF;
  uint8_t* vs = smem + L::V_OFF;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  // under causal masking the last q tiles see the most kv tiles: start them first
  const int q0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * BQ;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int qplane = b * Hq + hq, kvplane = b * Hkv + hq / (Hq / Hkv);
  // kv tiles any row of this block attends to
  const int qpos_lo = q_offset + q0, qpos_hi = q_offset + min(q0 + BQ, Sq) - 1;
  const int kv_lo = window > 0 ? max(0, qpos_lo - window + 1) : 0;
  const int kv_hi = causal ? min(Skv - 1, qpos_hi) : Skv - 1;
  const int j_first = (kv_lo / BKV) * BKV;
  const int ntiles = kv_hi >= j_first ? (kv_hi - j_first) / BKV + 1 : 0;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], TC_CONSUMERS * WG / 32);   // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= TC_CONSUMERS * WG) {   // producer warpgroup: one thread issues every TMA load
    reg_dealloc<PRODUCER_REGS>();
    if (tid == TC_CONSUMERS * WG && ntiles > 0) {
      mbar_arrive_expect_tx(q_full, 2 * L::Q_BYTES);
      for (int s = 0; s < NSUB; ++s) {
        tma_load(qs + s * BQ * 128, &qmap, q_full, 64 * s, q0, qplane);
        tma_load(dos + s * BQ * 128, &domap, q_full, 64 * s, q0, qplane);
      }
      for (int i = 0; i < ntiles; ++i) {
        const int st = i % STAGES, j0 = j_first + i * BKV;
        mbar_wait(&empty[st], ((i / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], 2 * L::KV_BYTES);
        for (int s = 0; s < NSUB; ++s) {
          const int at = st * L::KV_BYTES + s * BKV * 128;
          tma_load(ks + at, &kmap, &full[st], 64 * s, j0, kvplane);
          tma_load(vs + at, &vmap, &full[st], 64 * s, j0, kvplane);
        }
      }
    }
  } else {
    reg_alloc<CONSUMER_REGS>();
    const int wg = tid / WG, warp = (tid % WG) / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = q0 + 64 * wg;          // the warpgroup's first q row
    const int wq = q_offset + r0;         // and its kv position
    uint8_t* qa = qs + 64 * wg * 128;     // its rows of each Q / dO column tile
    const uint8_t* doa = dos + 64 * wg * 128;
    const float c = scale * LOG2E;        // scale log2(e)

    // this thread's rows 16 warp + g + 8 i: lse log2(e) (+inf past Sq, so
    // P = 0 there) and D_i = rowsum(dO_i * O_i) in f32, the row's 4 threads
    // (t) each summing D / 4 columns; written once for kernel 7b
    float lse2[2], di[2];
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      const int row = r0 + 16 * warp + g + 8 * i2;
      const bool in = row < Sq;
      const size_t at = static_cast<size_t>(qplane) * Sq + row;
      lse2[i2] = in ? lse[at] * LOG2E : INFINITY;
      float x = 0.0f;
      if (in) {
        const uint4* op = reinterpret_cast<const uint4*>(o + at * D) + t * (D / 32);
        const uint4* dp = reinterpret_cast<const uint4*>(dout + at * D) + t * (D / 32);
#pragma unroll
        for (int u = 0; u < D / 32; ++u) {
          const uint4 ov = __ldg(op + u), dv = __ldg(dp + u);
          const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
          const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 fo = __bfloat1622float2(o2[e]), fd = __bfloat1622float2(d2[e]);
            x = fmaf(fd.x, fo.x, x);
            x = fmaf(fd.y, fo.y, x);
          }
        }
      }
      x += __shfl_xor_sync(FULL, x, 1);
      x += __shfl_xor_sync(FULL, x, 2);
      di[i2] = x;
      if (in && t == 0) delta[at] = x;
    }

    float dq[NSUB][32];
#pragma unroll
    for (int s = 0; s < NSUB; ++s)
#pragma unroll
      for (int x = 0; x < 32; ++x) dq[s][x] = 0.0f;

    if (ntiles > 0) mbar_wait(q_full, 0);
    for (int i = 0; i < ntiles; ++i) {
      const int st = i % STAGES, j0 = j_first + i * BKV;
      const uint8_t* kt = ks + st * L::KV_BYTES;
      const uint8_t* vt = vs + st * L::KV_BYTES;
      mbar_wait(&full[st], (i / STAGES) & 1);

      // S = Q K^T and dP = dO V^T: rows 16 warp + g (+ 8), columns 8 j + 2 t (+ 1)
      float s[BKV / 2], dp[BKV / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int a_at = (kk / 4) * BQ * 128 + (kk % 4) * 32;   // column tile, 16-column step
        const int b_at = (kk / 4) * BKV * 128 + (kk % 4) * 32;
        wgmma_ss<BKV>(s, desc(qa + a_at), desc(kt + b_at), kk > 0);
        wgmma_ss<BKV>(dp, desc(doa + a_at), desc(vt + b_at), kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);
      fence_regs(dp);

      // P = exp(S scale - lse) = 2^(S c - lse log2(e)) and dS = P (dP - D_i),
      // branch-free per element: only tiles that cross the causal diagonal,
      // the window edge or Skv evaluate the mask, which sets a masked score
      // to -inf (exp gives it an exact 0)
      const bool whole = j0 + BKV <= Skv && (!causal || j0 + BKV - 1 <= wq) &&
                         (window <= 0 || j0 > wq + 63 - window);
      if (!whole) {
#pragma unroll
        for (int x = 0; x < BKV / 2; ++x) {
          const int col = j0 + 8 * (x / 4) + 2 * t + x % 2;
          const int qpos = wq + 16 * warp + g + 8 * ((x / 2) % 2);
          s[x] = attends(col, qpos, Skv, causal, window) ? s[x] : -INFINITY;
        }
      }
#pragma unroll
      for (int x = 0; x < BKV / 2; ++x) {
        const int i2 = (x / 2) % 2;
        s[x] = exp2f(fmaf(s[x], c, -lse2[i2])) * (dp[x] - di[i2]);
      }

      // dQ += dS K: dS rounded to bf16 as the register A operand, K MN-major
      uint32_t a[BKV / 16][4];
#pragma unroll
      for (int kb = 0; kb < BKV / 16; ++kb) a_frag(s, kb, a[kb]);
      wgmma_fence();
#pragma unroll
      for (int sb = 0; sb < NSUB; ++sb) fence_regs(dq[sb]);
#pragma unroll
      for (int kb = 0; kb < BKV / 16; ++kb)
#pragma unroll
        for (int sb = 0; sb < NSUB; ++sb)
          wgmma_rs_n64(dq[sb], a[kb], desc(kt + sb * BKV * 128 + kb * 16 * 128));
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int sb = 0; sb < NSUB; ++sb) fence_regs(dq[sb]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    // epilogue: dQ scale in bf16 into this warpgroup's (consumed) Q rows,
    // then one TMA store per column tile (rows past Sq are not written)
    named_bar_sync(1 + wg, WG);
#pragma unroll
    for (int sb = 0; sb < NSUB; ++sb)
#pragma unroll
      for (int x = 0; x < 32; x += 2) {
        const int row = 16 * warp + g + 8 * ((x / 2) % 2);
        *reinterpret_cast<uint32_t*>(qa + sb * BQ * 128 + sw128(row, x / 4) + 4 * t) =
            pack_bf16(dq[sb][x] * scale, dq[sb][x + 1] * scale);
      }
    fence_proxy_async();
    named_bar_sync(1 + wg, WG);
    if (tid % WG == 0) {
      for (int sb = 0; sb < NSUB; ++sb)
        tma_store(&dqmap, qa + sb * BQ * 128, 64 * sb, r0, qplane);
      tma_store_wait();
    }
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <int D>
int launch_fwd_tc(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                  int Hq, int Hkv, int Sq, int Skv, int q_offset, int causal, int window,
                  float scale, cudaStream_t st) {
  using L = FwdTC<D>;
  CUtensorMap qm, km, vm, om;
  int e;
  if ((e = sm90::bf16_map(&qm, q, B * Hq, Sq, D, L::BQ)) ||
      (e = sm90::bf16_map(&km, k, B * Hkv, Skv, D, L::BKV)) ||
      (e = sm90::bf16_map(&vm, v, B * Hkv, Skv, D, L::BKV)) ||
      (e = sm90::bf16_map(&om, out, B * Hq, Sq, D, 64)) ||
      (e = set_smem(flash_fwd_tc<D>, L::SMEM)))
    return e;
  const dim3 grid((Sq + L::BQ - 1) / L::BQ, Hq, B);
  flash_fwd_tc<D><<<grid, TC_THREADS, L::SMEM, st>>>(qm, km, vm, om, lse, Hq, Hkv, Sq, Skv,
                                                      q_offset, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_masked_tc(const void* q, const void* k, const void* v, const int* start, void* out,
                     int B, int Hq, int Hkv, int Sq, int Skv, int q_offset, int causal,
                     int window, float scale, cudaStream_t st) {
  using L = MaskedTC<D>;
  CUtensorMap qm, km, vm, om;
  int e;
  if ((e = sm90::bf16_map(&qm, q, B * Hq, Sq, D, L::BQ)) ||
      (e = sm90::bf16_map(&km, k, B * Hkv, Skv, D, L::BKV)) ||
      (e = sm90::bf16_map(&vm, v, B * Hkv, Skv, D, L::BKV)) ||
      (e = sm90::bf16_map(&om, out, B * Hq, Sq, D, 64)) ||
      (e = set_smem(flash_fwd_masked_tc<D>, L::SMEM)))
    return e;
  const dim3 grid((Sq + L::BQ - 1) / L::BQ, Hq, B);
  flash_fwd_masked_tc<D><<<grid, L::THREADS, L::SMEM, st>>>(
      qm, km, vm, om, start, Hq, Hkv, Sq, Skv, q_offset, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkdv_tc(const void* q, const void* k, const void* v, const float* lse,
                   const float* delta, const void* dout, void* dk, void* dv, int B, int Hq,
                   int Hkv, int Sq, int Skv, int q_offset, int causal, int window, float scale,
                   cudaStream_t st) {
  using L = BwdTC<D>;
  CUtensorMap qm, km, vm, dom, dkm, dvm;
  int e;
  if ((e = sm90::bf16_map(&qm, q, B * Hq, Sq, D, L::BQ)) ||
      (e = sm90::bf16_map(&dom, dout, B * Hq, Sq, D, L::BQ)) ||
      (e = sm90::bf16_map(&km, k, B * Hkv, Skv, D, L::BKV)) ||
      (e = sm90::bf16_map(&vm, v, B * Hkv, Skv, D, L::BKV)) ||
      (e = sm90::bf16_map(&dkm, dk, B * Hkv, Skv, D, 64)) ||
      (e = sm90::bf16_map(&dvm, dv, B * Hkv, Skv, D, 64)) ||
      (e = set_smem(flash_bwd_dkdv_tc<D>, L::SMEM)))
    return e;
  const dim3 grid((Skv + L::BKV - 1) / L::BKV, Hkv, B);
  flash_bwd_dkdv_tc<D><<<grid, TC_THREADS, L::SMEM, st>>>(
      qm, km, vm, dom, dkm, dvm, lse, delta, Hq, Hkv, Sq, Skv, q_offset, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq_tc(const void* q, const void* k, const void* v, const void* o, const float* lse,
                 const void* dout, void* dq, float* delta, int B, int Hq, int Hkv, int Sq,
                 int Skv, int q_offset, int causal, int window, float scale, cudaStream_t st) {
  using L = DqTC<D>;
  CUtensorMap qm, km, vm, dom, dqm;
  int e;
  if ((e = sm90::bf16_map(&qm, q, B * Hq, Sq, D, L::BQ)) ||
      (e = sm90::bf16_map(&dom, dout, B * Hq, Sq, D, L::BQ)) ||
      (e = sm90::bf16_map(&km, k, B * Hkv, Skv, D, L::BKV)) ||
      (e = sm90::bf16_map(&vm, v, B * Hkv, Skv, D, L::BKV)) ||
      (e = sm90::bf16_map(&dqm, dq, B * Hq, Sq, D, 64)) ||
      (e = set_smem(flash_bwd_dq_tc<D>, L::SMEM)))
    return e;
  const dim3 grid((Sq + L::BQ - 1) / L::BQ, Hq, B);
  flash_bwd_dq_tc<D><<<grid, TC_THREADS, L::SMEM, st>>>(
      qm, km, vm, dom, dqm, static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, delta, Hq, Hkv, Sq, Skv, q_offset, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
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

template <typename T, int D, bool DKDV>
int launch_bwd(const T* q, const T* k, const T* v, const T* o, const float* lse,
               const T* dout, T* a, T* b_out, int B, int Hq, int Hkv, int Sq, int Skv,
               int q_offset, int causal, int window, float scale, cudaStream_t st) {
  if constexpr (DKDV) {
    const size_t smem = sizeof(float) * (2 * BKV * (D + 1) + 2 * BQ * D + 2 * BQ * BKV);
    return launch_dyn(flash_bwd_dkdv_kernel<T, D>, dim3((Skv + BKV - 1) / BKV, Hkv, B),
                      smem, st, q, k, v, o, lse, dout, a, b_out, Hq, Hkv, Sq, Skv,
                      q_offset, causal, window, scale);
  } else {
    const size_t smem = sizeof(float) * (2 * BQ * D + 2 * BKV * (D + 1));
    return launch_dyn(flash_bwd_dq_kernel<T, D>, dim3((Sq + BQ - 1) / BQ, Hq, B), smem,
                      st, q, k, v, o, lse, dout, a, Hq, Hkv, Sq, Skv, q_offset, causal,
                      window, scale);
  }
}

// The CUDA-core backward kernels: the float32 route of 7b and 7c.
template <bool DKDV>
int launch_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                   const float* lse, const void* dout, void* a, void* b_out, int B, int Hq,
                   int Hkv, int Sq, int Skv, int D, int q_offset, int causal, int window,
                   float scale, cudaStream_t st) {
  using T = float;
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const T* oo = static_cast<const T*>(o);
  const T* dd = static_cast<const T*>(dout);
  T* aa = static_cast<T*>(a);
  T* bb = static_cast<T*>(b_out);
  if (D == 128)
    return launch_bwd<T, 128, DKDV>(qq, kk, vv, oo, lse, dd, aa, bb, B, Hq, Hkv, Sq, Skv,
                                    q_offset, causal, window, scale, st);
  if (D == 64)
    return launch_bwd<T, 64, DKDV>(qq, kk, vv, oo, lse, dd, aa, bb, B, Hq, Hkv, Sq, Skv,
                                   q_offset, causal, window, scale, st);
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
  if (!is_bf16)
    return launch_fwd<float, false>(q, k, v, start, out, nullptr, B, Hq, Hkv, Sq, Skv, D,
                                    q_offset, causal, window, scale, st);
  if (D == 64)
    return launch_masked_tc<64>(q, k, v, start, out, B, Hq, Hkv, Sq, Skv, q_offset, causal,
                                window, scale, st);
  if (D == 128)
    return launch_masked_tc<128>(q, k, v, start, out, B, Hq, Hkv, Sq, Skv, q_offset, causal,
                                 window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, float* lse, int is_bf16, int B,
                                   int Hq, int Hkv, int Sq, int Skv, int D,
                                   int q_offset, int causal, int window,
                                   float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return launch_fwd<float, true>(q, k, v, nullptr, out, lse, B, Hq, Hkv, Sq, Skv, D,
                                   q_offset, causal, window, scale, st);
  if (D == 64)
    return launch_fwd_tc<64>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, q_offset, causal,
                             window, scale, st);
  if (D == 128)
    return launch_fwd_tc<128>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, q_offset, causal,
                              window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// delta: D_i = rowsum(dO_i * O_i), f32 [B, Hq, Sq], read by the bf16
// (tensor-core) route; the float32 route computes its own from o.
extern "C" int flash_attention_bwd_dkdv(const void* q, const void* k,
                                        const void* v, const void* o,
                                        const float* lse, const float* delta,
                                        const void* dout, void* dk, void* dv,
                                        int is_bf16, int B, int Hq, int Hkv, int Sq,
                                        int Skv, int D, int q_offset, int causal,
                                        int window, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return launch_bwd_f32<true>(q, k, v, o, lse, dout, dk, dv, B, Hq, Hkv, Sq, Skv, D,
                                 q_offset, causal, window, scale, st);
  if (delta == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (D == 64)
    return launch_dkdv_tc<64>(q, k, v, lse, delta, dout, dk, dv, B, Hq, Hkv, Sq, Skv,
                              q_offset, causal, window, scale, st);
  if (D == 128)
    return launch_dkdv_tc<128>(q, k, v, lse, delta, dout, dk, dv, B, Hq, Hkv, Sq, Skv,
                               q_offset, causal, window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// delta: D_i = rowsum(dO_i * O_i), f32 [B, Hq, Sq], written by the bf16
// (tensor-core) route for kernel 7b; the float32 route ignores it.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const float* lse, const void* dout,
                                      void* dq, float* delta, int is_bf16, int B,
                                      int Hq, int Hkv, int Sq, int Skv, int D,
                                      int q_offset, int causal, int window,
                                      float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return launch_bwd_f32<false>(q, k, v, o, lse, dout, dq, nullptr, B, Hq, Hkv, Sq, Skv,
                                  D, q_offset, causal, window, scale, st);
  if (delta == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (D == 64)
    return launch_dq_tc<64>(q, k, v, o, lse, dout, dq, delta, B, Hq, Hkv, Sq, Skv, q_offset,
                            causal, window, scale, st);
  if (D == 128)
    return launch_dq_tc<128>(q, k, v, o, lse, dout, dq, delta, B, Hq, Hkv, Sq, Skv, q_offset,
                             causal, window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of the tensor-core kernels in bytes (kind 0: kernel
// 7, 1: 7b, 2: 7c, 3: kernel 2), for chip_smoke.py's build report; -1 for
// another kind or D.
extern "C" int flash_attention_tc_smem(int kind, int D) {
  if (D != 64 && D != 128) return -1;
  const bool d64 = D == 64;
  switch (kind) {
    case 0: return d64 ? FwdTC<64>::SMEM : FwdTC<128>::SMEM;
    case 1: return d64 ? BwdTC<64>::SMEM : BwdTC<128>::SMEM;
    case 2: return d64 ? DqTC<64>::SMEM : DqTC<128>::SMEM;
    case 3: return d64 ? MaskedTC<64>::SMEM : MaskedTC<128>::SMEM;
    default: return -1;
  }
}
