// Mamba-2 SSD chunked scan for Hopper (sm_90a), plain C interface: the
// forward (kernel 8) and its backward (kernels 8b and 8c).
//
// Shapes (float32 only, as ssm.apply passes them): x [B, L, H, P], dt
// [B, L, H] (post-softplus), a [H] (< 0), b / c [B, L, G, N], head h reads
// group h / (H / G); chunks of Q <= 128 steps, L % Q == 0; P = 64 and
// N = 128 (mamba2-370m and jamba).  Per chunk, with cum the inclusive
// in-chunk cumsum of dt a (summed sequentially in f32, as the reference):
//   intra  y_i  = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//   inter  y_i += exp(cum_i) h0 C_i
//   state  h    = exp(cum_Q) h0 + sum_j exp(cum_Q - cum_j) dt_j x_j B_j^T
// exp is only ever taken of cum_i - cum_j with j <= i (and of cum_i,
// cum_Q - cum_j), all <= 0: cum reaches ~-400 over a chunk at init, so the
// masked upper triangle is never exponentiated (exp(+400) * 0 is NaN).
//
// Kernel 8 (ssd_scan_fwd) replaces the Pallas TPU kernel ssd_scan
// (src/repro/kernels/ssd_scan/ssd_scan.py:72, body _kernel :33).  The TPU
// grid (batch, head, chunk) marks the chunk axis "arbitrary" and carries
// the [P, N] state in VMEM scratch; here one block per (head, batch)
// walks its chunks in order with the state in shared memory.  Per chunk
// the block stages B, C (64 KB each), x (32 KB) and dt, computes the
// causal score rows in blocks of 16 (C_i . B_j, decay, dt_j; an 8 KB
// tile, so the [Q, Q] matrix is never resident), the 16 output rows
// from them and from the state, and then the state update.  With
// save_states it writes each chunk's entering state h0s [B, H, nc, P, N]
// for the backward, as kernel 7 writes lse.  207.7 KB of dynamic shared
// memory, one 256-thread block per SM: B*H = 128 blocks on 132 SMs at
// the training shape (one wave, 8 warps per SM).
// Bound at the training shape (B=4, L=4096, H=32, G=1, Q=128): ~3.0e10
// f32 flops on the causal half of the chunk products against ~0.42 GB
// (x, y, h0s 134 MB each; B, C, dt), so operations bound it: ~0.45 ms at
// the 67 TFLOP/s f32 CUDA-core peak.
//
// Kernels 8b and 8c are the backward.  The JAX package has no backward
// kernel (no custom_vjp around ssd_scan): the reference differentiates
// its jnp chunk algorithm (ssd_scan_chunked, ref.py:56).  They stand in
// for that autograd backward with the explicit formulas of
// ssd_scan_bwd_ref (repro_torch/kernels/ssd_scan/ref.py).
//   8b (ssd_scan_bwd_state): one block per (head, batch) walks the
//   chunks in reverse, carrying dh, the gradient of the state leaving a
//   chunk, in registers (32 floats a thread):
//   dh_{c-1} = exp(cum_Q) dh_c + sum_i exp(cum_i) dy_i C_i^T, written at
//   each chunk boundary as dhs [B, H, nc, P, N] (zeros for the last).
//   Bound at the training shape: ~8.3e9 flops, ~0.28 GB; ~0.12 ms.
//   100.4 KB of dynamic shared memory.
//   8c (ssd_scan_bwd_chunk): one block per (chunk, head, batch), parallel
//   over chunks (4096 blocks at the training shape).  From h0s[c] and
//   dhs[c] it recomputes the chunk: W = (dy x^T) * decay and S = C B^T on
//   the causal half, two [Q, Q] tiles in shared memory (S in two halves
//   of N), then dx, dC, dB, ddt and d(dt a), whose in-chunk reverse
//   cumsum gives ddt and the chunk's partial of da.  dB and dC are
//   written per head and summed over the group's heads by the wrapper
//   (a fixed-order .sum): summing them in the block would need the whole
//   [Q, N] dB and dC of every head resident at once (128 KB beside the
//   two 64 KB tiles).  da is written per (batch, chunk, head) and summed
//   the same way.  Row sums of the block are warp-shuffle trees and
//   fixed-order loops: no atomics, so runs repeat bit for bit.  206.1 KB
//   of dynamic shared memory, one block per SM.  Bound at the training
//   shape: ~6.0e10 flops, ~0.71 GB; ~0.90 ms.
// Simple first: CUDA cores, f32 throughout, no fast math; tensor cores
// (TF32 or split-bf16 mma / wgmma) and TMA are later work.
//
// `fault` (kernels 8 and 8b) is a check hook, 0 on every path of the
// port: chip_smoke.py plants 1 (8: the carried state not decayed), 2 (8:
// the intra-chunk mask off by one, j < i) and 3 (8b: dh not carried
// across chunks) to show that its limits reject them.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int P = 64;
constexpr int N = 128;
constexpr int QM = 128;        // largest chunk
constexpr int NT = 256;        // threads per block
constexpr int RB = 16;         // score rows per tile (kernel 8)
constexpr int PS = P + 1;      // padded row strides (bank-conflict free)
constexpr int NS = N + 1;
constexpr int QS = QM + 1;
constexpr unsigned FULL = 0xffffffffu;
static_assert(N == 2 * P, "8c stages half rows of B / C in [QM][P + 1] tiles");
static_assert(NT == 2 * N && NT == 4 * P, "thread mappings");

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Rows [l0, l0 + rows) of a [B, L, R, W] tensor's slice r into a shared
// [rows][stride] tile (columns col0 .. col0 + width).
__device__ __forceinline__ void stage(float* dst, int stride, const float* src, int b,
                                      int L, int R, int r, int W, int l0, int rows,
                                      int col0, int width) {
  for (int i = threadIdx.x; i < rows * width; i += NT) {
    const int row = i / width, col = i % width;
    dst[row * stride + col] =
        src[((static_cast<size_t>(b) * L + l0 + row) * R + r) * W + col0 + col];
  }
}

// dt of the chunk into dts, and (after a barrier) cum = the inclusive
// cumsum of dt a, summed sequentially by one thread.
__device__ __forceinline__ void chunk_cum(float* dts, float* cum, const float* dt,
                                          float av, int b, int L, int H, int h,
                                          int l0, int Q) {
  if (threadIdx.x < Q)
    dts[threadIdx.x] = dt[(static_cast<size_t>(b) * L + l0 + threadIdx.x) * H + h];
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int i = 0; i < Q; ++i) {
      s += dts[i] * av;
      cum[i] = s;
    }
  }
}

__device__ __forceinline__ size_t state_at(int b, int h, int c, int H, int nc) {
  return ((static_cast<size_t>(b) * H + h) * nc + c) * P * N;
}

// Kernel 8.
__global__ void __launch_bounds__(NT, 1)
ssd_fwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const float* __restrict__ bm,
               const float* __restrict__ cm, float* __restrict__ y,
               float* __restrict__ h0s, int L, int H, int G, int Q, int fault) {
  extern __shared__ float smem[];
  float* bs = smem;               // [QM][NS]
  float* cs = bs + QM * NS;       // [QM][NS]
  float* xs = cs + QM * NS;       // [QM][PS]
  float* hs = xs + QM * PS;       // [P][NS]   the carried state
  float* ss = hs + P * NS;        // [RB][QS]  one tile of score rows
  float* cum = ss + RB * QS;      // [QM]
  float* dts = cum + QM;          // [QM]
  const int tid = threadIdx.x, h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G), nc = L / Q;
  const float av = a[h];
  for (int i = tid; i < P * NS; i += NT) hs[i] = 0.0f;

  for (int c = 0; c < nc; ++c) {
    const int l0 = c * Q;
    __syncthreads();   // the previous chunk's readers are done
    stage(bs, NS, bm, b, L, G, g, N, l0, Q, 0, N);
    stage(cs, NS, cm, b, L, G, g, N, l0, Q, 0, N);
    stage(xs, PS, x, b, L, H, h, P, l0, Q, 0, P);
    chunk_cum(dts, cum, dt, av, b, L, H, h, l0, Q);
    if (h0s != nullptr) {
      float* out = h0s + state_at(b, h, c, H, nc);
      for (int i = tid; i < P * N; i += NT) out[i] = hs[(i / N) * NS + i % N];
    }
    __syncthreads();

    for (int r0 = 0; r0 < Q; r0 += RB) {
      const int jmax = min(r0 + RB, Q) - 1;
      {  // score rows r0 .. r0 + 15: thread (column j, 8 rows)
        const int j = tid % QM, rg = tid / QM;
        if (j <= jmax) {
          float s[RB / 2];
#pragma unroll
          for (int k = 0; k < RB / 2; ++k) s[k] = 0.0f;
#pragma unroll 4
          for (int n = 0; n < N; ++n) {
            const float bv = bs[j * NS + n];
#pragma unroll
            for (int k = 0; k < RB / 2; ++k)
              s[k] = fmaf(cs[(r0 + rg * (RB / 2) + k) * NS + n], bv, s[k]);
          }
#pragma unroll
          for (int k = 0; k < RB / 2; ++k) {
            const int i = r0 + rg * (RB / 2) + k;
            ss[(rg * (RB / 2) + k) * QS + j] =
                (i < Q && (fault == 2 ? j < i : j <= i))
                    ? s[k] * expf(cum[i] - cum[j]) * dts[j] : 0.0f;
          }
        }
      }
      __syncthreads();
      {  // output rows: thread (column p, 4 rows)
        const int p = tid % P, rr = tid / P;
        float acc[4], inter[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] = inter[k] = 0.0f;
        for (int j = 0; j <= jmax; ++j) {
          const float xv = xs[j * PS + p];
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[k] = fmaf(ss[(rr * 4 + k) * QS + j], xv, acc[k]);
        }
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          const float hv = hs[p * NS + n];
#pragma unroll
          for (int k = 0; k < 4; ++k) inter[k] = fmaf(cs[(r0 + rr * 4 + k) * NS + n], hv, inter[k]);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int i = r0 + rr * 4 + k;
          if (i < Q)
            y[((static_cast<size_t>(b) * L + l0 + i) * H + h) * P + p] =
                acc[k] + inter[k] * expf(cum[i]);
        }
      }
      __syncthreads();
    }

    {  // state update: thread (column n, 32 rows of P)
      const int n = tid % N, p0 = (tid / N) * 32;
      const float cl = cum[Q - 1], dec = fault == 1 ? 1.0f : expf(cl);
      float acc[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) acc[k] = hs[(p0 + k) * NS + n] * dec;
      for (int j = 0; j < Q; ++j) {
        const float w = expf(cl - cum[j]) * dts[j];
        const float bv = bs[j * NS + n];
#pragma unroll
        for (int k = 0; k < 32; ++k) acc[k] = fmaf(xs[j * PS + p0 + k] * w, bv, acc[k]);
      }
#pragma unroll
      for (int k = 0; k < 32; ++k) hs[(p0 + k) * NS + n] = acc[k];
    }
  }
}

// Kernel 8b.
__global__ void __launch_bounds__(NT, 1)
ssd_bwd_state_kernel(const float* __restrict__ dt, const float* __restrict__ a,
                     const float* __restrict__ cm, const float* __restrict__ dy,
                     float* __restrict__ dhs, int L, int H, int G, int Q, int fault) {
  extern __shared__ float smem[];
  float* cs = smem;               // [QM][NS]
  float* ds = cs + QM * NS;       // [QM][PS]
  float* cum = ds + QM * PS;      // [QM]
  float* dts = cum + QM;          // [QM]
  const int tid = threadIdx.x, h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G), nc = L / Q;
  const float av = a[h];
  const int n = tid % N, p0 = (tid / N) * 32;
  float dh[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) dh[k] = 0.0f;

  for (int c = nc - 1;; --c) {
    float* out = dhs + state_at(b, h, c, H, nc);
#pragma unroll
    for (int k = 0; k < 32; ++k) out[(p0 + k) * N + n] = dh[k];
    if (c == 0) break;
    const int l0 = c * Q;
    __syncthreads();   // the previous chunk's readers are done
    stage(cs, NS, cm, b, L, G, g, N, l0, Q, 0, N);
    stage(ds, PS, dy, b, L, H, h, P, l0, Q, 0, P);
    chunk_cum(dts, cum, dt, av, b, L, H, h, l0, Q);
    __syncthreads();
    const float dec = fault == 3 ? 0.0f : expf(cum[Q - 1]);
#pragma unroll
    for (int k = 0; k < 32; ++k) dh[k] *= dec;
    for (int i = 0; i < Q; ++i) {
      const float cv = cs[i * NS + n] * expf(cum[i]);
#pragma unroll
      for (int k = 0; k < 32; ++k) dh[k] = fmaf(ds[i * PS + p0 + k], cv, dh[k]);
    }
  }
}

// Shared-memory layout of kernel 8c (floats).
constexpr int TILE = QM * QS;                  // one [QM][QM] tile
constexpr int R2 = (P * NS + QM * PS) > TILE ? (P * NS + QM * PS) : TILE;
constexpr int R3 = (2 * QM * PS) > (QM * NS) ? (2 * QM * PS) : (QM * NS);
constexpr int CHUNK_SMEM = TILE + R2 + R3 + 4 * QM + 2 * 4 * QM + NT;

// One [Q, Q] tile of kernel 8c: entry (i, j) for j <= i is
// f(i, j, dot over `width` columns of rows i of `rows_i` and j of
// `rows_j`); entries above the diagonal are zero.  Thread (column j,
// 8 rows per 16-row block).
template <typename F>
__device__ __forceinline__ void causal_tile(float* out, bool accumulate,
                                            const float* rows_i, const float* rows_j,
                                            int width, int Q, F f) {
  const int j = threadIdx.x % QM, rg = threadIdx.x / QM;
  for (int r0 = 0; r0 < Q; r0 += RB) {
    const int jmax = min(r0 + RB, Q) - 1;
    float s[RB / 2];
#pragma unroll
    for (int k = 0; k < RB / 2; ++k) s[k] = 0.0f;
    if (j <= jmax) {
      for (int d = 0; d < width; ++d) {
        const float v = rows_j[j * PS + d];
#pragma unroll
        for (int k = 0; k < RB / 2; ++k)
          s[k] = fmaf(rows_i[(r0 + rg * (RB / 2) + k) * PS + d], v, s[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < RB / 2; ++k) {
      const int i = r0 + rg * (RB / 2) + k;
      const float val = (i < Q && j <= i) ? f(i, j, s[k]) : 0.0f;
      float* at = out + i * QS + j;
      *at = accumulate ? *at + val : val;
    }
  }
}

// Kernel 8c.
__global__ void __launch_bounds__(NT, 1)
ssd_bwd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a, const float* __restrict__ bm,
                     const float* __restrict__ cm, const float* __restrict__ h0s,
                     const float* __restrict__ dhs, const float* __restrict__ dy,
                     float* __restrict__ dx, float* __restrict__ ddt,
                     float* __restrict__ da_part, float* __restrict__ db_part,
                     float* __restrict__ dc_part, int L, int H, int G, int Q) {
  extern __shared__ float smem[];
  float* wm = smem;               // [QM][QS]  W = (dy x^T) decay, then W dt_j
  float* r2 = wm + TILE;          // [QM][QS]  S = C B^T, then S decay dt_j;
                                  //   later a [P][NS] state + a [QM][PS] tile
  float* r3 = r2 + R2;            // staging: two [QM][PS] or one [QM][NS]
  float* cum = r3 + R3;           // [QM]
  float* dts = cum + QM;          // [QM]
  float* dcum = dts + QM;         // [QM]
  float* ddtv = dcum + QM;        // [QM]
  float* cpart = ddtv + QM;       // [QM][4]  row sums of C . dC_state per warp
  float* bpart = cpart + 4 * QM;  // [QM][4]  row sums of B . v per warp
  float* red = bpart + 4 * QM;    // [NT]
  const int tid = threadIdx.x, c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G), nc = L / Q, l0 = c * Q;
  const float av = a[h];
  const float* h0 = h0s + state_at(b, h, c, H, nc);
  const float* dh = dhs + state_at(b, h, c, H, nc);
  const int lane = tid % 32, wq = (tid % N) / 32;

  // W
  float* xs = r3;
  float* ds = r3 + QM * PS;
  stage(xs, PS, x, b, L, H, h, P, l0, Q, 0, P);
  stage(ds, PS, dy, b, L, H, h, P, l0, Q, 0, P);
  chunk_cum(dts, cum, dt, av, b, L, H, h, l0, Q);
  __syncthreads();
  causal_tile(wm, false, ds, xs, P, Q,
              [&](int i, int j, float s) { return s * expf(cum[i] - cum[j]); });
  // S, over two halves of N
  float* sm = r2;
  for (int half = 0; half < 2; ++half) {
    __syncthreads();
    stage(r3, PS, cm, b, L, G, g, N, l0, Q, half * P, P);
    stage(r3 + QM * PS, PS, bm, b, L, G, g, N, l0, Q, half * P, P);
    __syncthreads();
    causal_tile(sm, half == 1, r3, r3 + QM * PS, P, Q,
                [](int, int, float s) { return s; });
  }
  __syncthreads();
  // ddt (intra) and dcum (intra) per position k, then W <- W dt_j and
  // S <- S decay dt_j
  if (tid < Q) {
    const int k = tid;
    float row = 0.0f, col = 0.0f, dd = 0.0f;
    for (int j = 0; j < Q; ++j) row += wm[k * QS + j] * sm[k * QS + j] * dts[j];
    for (int i = 0; i < Q; ++i) {
      const float ws = wm[i * QS + k] * sm[i * QS + k];
      dd += ws;
      col += ws * dts[k];
    }
    dcum[k] = row - col;
    ddtv[k] = dd;
  }
  __syncthreads();
  for (int idx = tid; idx < Q * QM; idx += NT) {
    const int i = idx / QM, j = idx % QM;
    if (j <= i) {
      sm[i * QS + j] = sm[i * QS + j] * expf(cum[i] - cum[j]) * dts[j];
      wm[i * QS + j] *= dts[j];
    }
  }
  __syncthreads();

  // dx (intra): thread (column p, rows j0 .. j0 + 31), written now and
  // completed by the same thread below
  stage(ds, PS, dy, b, L, H, h, P, l0, Q, 0, P);
  __syncthreads();
  {
    const int p = tid % P, j0 = (tid / P) * 32;
    float acc[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) acc[k] = 0.0f;
    for (int i = j0; i < Q; ++i) {
      const float d = ds[i * PS + p];
#pragma unroll
      for (int k = 0; k < 32; ++k) acc[k] = fmaf(sm[i * QS + j0 + k], d, acc[k]);
    }
#pragma unroll
    for (int k = 0; k < 32; ++k)
      if (j0 + k < Q) dx[((static_cast<size_t>(b) * L + l0 + j0 + k) * H + h) * P + p] = acc[k];
  }
  __syncthreads();

  // dC = W dt B + exp(cum_i) h0^T dy_i; C . dC_state into cpart
  float* st = r2;                 // [P][NS]
  float* rows = r2 + P * NS;      // [QM][PS]
  float* full = r3;               // [QM][NS]
  stage(full, NS, bm, b, L, G, g, N, l0, Q, 0, N);
  for (int i = tid; i < P * N; i += NT) st[(i / N) * NS + i % N] = h0[i];
  stage(rows, PS, dy, b, L, H, h, P, l0, Q, 0, P);
  __syncthreads();
  for (int pass = 0; pass < 2; ++pass) {
    const int n = tid % N, i0 = pass * 64 + (tid / N) * 32;
    float acc[32], sv[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) acc[k] = sv[k] = 0.0f;
    const int jend = min(i0 + 32, Q);
    for (int j = 0; j < jend; ++j) {
      const float bv = full[j * NS + n];
#pragma unroll
      for (int k = 0; k < 32; ++k) acc[k] = fmaf(wm[(i0 + k) * QS + j], bv, acc[k]);
    }
#pragma unroll 4
    for (int p = 0; p < P; ++p) {
      const float hv = st[p * NS + n];
#pragma unroll
      for (int k = 0; k < 32; ++k) sv[k] = fmaf(hv, rows[(i0 + k) * PS + p], sv[k]);
    }
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const int i = i0 + k;
      float part = 0.0f;
      if (i < Q) {
        const size_t at = (static_cast<size_t>(b) * L + l0 + i);
        const float dcs = sv[k] * expf(cum[i]);
        dc_part[(at * H + h) * N + n] = acc[k] + dcs;
        part = cm[(at * G + g) * N + n] * dcs;
      }
      part = warp_sum(part);
      if (lane == 0) cpart[i * 4 + wq] = part;
    }
  }
  __syncthreads();

  // dB = (W dt)^T C + dt_j v_j, v_j = exp(cum_Q - cum_j) dh^T x_j; B . v
  // into bpart
  const float cl = cum[Q - 1];
  stage(full, NS, cm, b, L, G, g, N, l0, Q, 0, N);
  for (int i = tid; i < P * N; i += NT) st[(i / N) * NS + i % N] = dh[i];
  stage(rows, PS, x, b, L, H, h, P, l0, Q, 0, P);
  __syncthreads();
  for (int pass = 0; pass < 2; ++pass) {
    const int n = tid % N, j0 = pass * 64 + (tid / N) * 32;
    float acc[32], v[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) acc[k] = v[k] = 0.0f;
    for (int i = j0; i < Q; ++i) {
      const float cv = full[i * NS + n];
#pragma unroll
      for (int k = 0; k < 32; ++k) acc[k] = fmaf(wm[i * QS + j0 + k], cv, acc[k]);
    }
#pragma unroll 4
    for (int p = 0; p < P; ++p) {
      const float hv = st[p * NS + n];
#pragma unroll
      for (int k = 0; k < 32; ++k) v[k] = fmaf(hv, rows[(j0 + k) * PS + p], v[k]);
    }
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const int j = j0 + k;
      float part = 0.0f;
      if (j < Q) {
        const size_t at = (static_cast<size_t>(b) * L + l0 + j);
        const float vv = v[k] * expf(cl - cum[j]);
        db_part[(at * H + h) * N + n] = acc[k] + vv * dts[j];
        part = bm[(at * G + g) * N + n] * vv;
      }
      part = warp_sum(part);
      if (lane == 0) bpart[j * 4 + wq] = part;
    }
  }
  __syncthreads();

  // dx += dt_j exp(cum_Q - cum_j) dh B_j (dh stays in st); <h0, dh>
  stage(full, NS, bm, b, L, G, g, N, l0, Q, 0, N);
  __syncthreads();
  {
    const int p = tid % P, j0 = (tid / P) * 32;
    for (int k = 0; k < 32; ++k) {
      const int j = j0 + k;
      if (j >= Q) break;
      float t = 0.0f;
#pragma unroll 8
      for (int n = 0; n < N; ++n) t = fmaf(st[p * NS + n], full[j * NS + n], t);
      float* at = dx + ((static_cast<size_t>(b) * L + l0 + j) * H + h) * P + p;
      *at += t * (expf(cl - cum[j]) * dts[j]);
    }
  }
  {
    float s = 0.0f;
    for (int i = tid; i < P * N; i += NT) s = fmaf(h0[i], st[(i / N) * NS + i % N], s);
    red[tid] = s;
  }
  __syncthreads();

  // d(dt a): the state terms, then the in-chunk reverse cumsum -> ddt, da
  if (tid == 0) {
    float hd = 0.0f, usum = 0.0f;
    for (int t = 0; t < NT; ++t) hd += red[t];
    for (int k = 0; k < Q; ++k) {
      const float dcs = cpart[k * 4] + cpart[k * 4 + 1] + cpart[k * 4 + 2] + cpart[k * 4 + 3];
      const float dds = bpart[k * 4] + bpart[k * 4 + 1] + bpart[k * 4 + 2] + bpart[k * 4 + 3];
      const float u = dts[k] * dds;
      dcum[k] += dcs - u;
      usum += u;
      ddtv[k] += dds;
    }
    dcum[Q - 1] += expf(cl) * hd + usum;
    float acc = 0.0f, dap = 0.0f;
    for (int k = Q - 1; k >= 0; --k) {
      acc += dcum[k];
      ddt[(static_cast<size_t>(b) * L + l0 + k) * H + h] = ddtv[k] + av * acc;
      dap += dts[k] * acc;
    }
    da_part[(static_cast<size_t>(b) * nc + c) * H + h] = dap;
  }
}

template <typename Kernel, typename... Args>
int launch_dyn(Kernel kernel, dim3 grid, size_t smem, cudaStream_t st, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, NT, smem, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int B, int L, int H, int G, int p, int n, int Q) {
  return p != P || n != N || Q <= 0 || Q > QM || L % Q != 0 || G <= 0 || H % G != 0 ||
         B <= 0 || H <= 0;
}

}  // namespace

extern "C" int ssd_scan_fwd(const float* x, const float* dt, const float* a,
                            const float* b, const float* c, float* y, float* h0s,
                            int B, int L, int H, int G, int p, int n, int Q,
                            int fault, void* stream) {
  if (bad_shape(B, L, H, G, p, n, Q)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (2 * QM * NS + QM * PS + P * NS + RB * QS + 2 * QM);
  return launch_dyn(ssd_fwd_kernel, dim3(H, B), smem, static_cast<cudaStream_t>(stream),
                    x, dt, a, b, c, y, h0s, L, H, G, Q, fault);
}

extern "C" int ssd_scan_bwd_state(const float* dt, const float* a, const float* c,
                                  const float* dy, float* dhs, int B, int L, int H,
                                  int G, int p, int n, int Q, int fault, void* stream) {
  if (bad_shape(B, L, H, G, p, n, Q)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (QM * NS + QM * PS + 2 * QM);
  return launch_dyn(ssd_bwd_state_kernel, dim3(H, B), smem,
                    static_cast<cudaStream_t>(stream), dt, a, c, dy, dhs, L, H, G, Q,
                    fault);
}

extern "C" int ssd_scan_bwd_chunk(const float* x, const float* dt, const float* a,
                                  const float* b, const float* c, const float* h0s,
                                  const float* dhs, const float* dy, float* dx,
                                  float* ddt, float* da_part, float* db_part,
                                  float* dc_part, int B, int L, int H, int G, int p,
                                  int n, int Q, void* stream) {
  if (bad_shape(B, L, H, G, p, n, Q)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * CHUNK_SMEM;
  return launch_dyn(ssd_bwd_chunk_kernel, dim3(L / Q, H, B), smem,
                    static_cast<cudaStream_t>(stream), x, dt, a, b, c, h0s, dhs, dy, dx,
                    ddt, da_part, db_part, dc_part, L, H, G, Q);
}
