// Mamba-2 SSD chunked scan for Hopper (sm_90a), plain C interface: the
// forward (kernel 8, three launches) and its backward (kernels 8b and 8c).
//
// Shapes (float32 only, as ssm.apply passes them): x [B, L, H, P], dt
// [B, L, H] (post-softplus), a [H] (< 0), b / c [B, L, G, N], head h reads
// group h / (H / G); chunks of Q <= 128 steps, L % Q == 0; P = 64 and
// N = 128 (mamba2-370m and jamba).  Per chunk, with cum the inclusive
// in-chunk cumsum of dt a:
//   intra  y_i  = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//   inter  y_i += exp(cum_i) h0 C_i
//   state  h    = exp(cum_Q) h0 + sum_j exp(cum_Q - cum_j) dt_j x_j B_j^T
// exp is only ever taken of cum_i - cum_j with j <= i (and of cum_i,
// cum_Q - cum_j), all <= 0: cum reaches ~-400 over a chunk at init, so the
// masked upper triangle is never exponentiated (exp(+400) * 0 is NaN).
// Each decay factor exp(cum_i - cum_j) is computed once per (i, j) and
// block.  cum is a warp scan (chunk_cum), the same code in every kernel
// here, so kernels 8, 8b and 8c see the same bits.
//
// The chunk products run on the tensor cores (wgmma m64nNk16, bf16 in,
// f32 accumulate) in split-bf16 three-pass form: every operand a is split
// once, a = hi + lo with hi = bf16(a) and lo = bf16(a - hi), and a b is
// taken as hi hi + hi lo + lo hi.  Error budget: bf16 keeps 8 significant
// bits (unit roundoff 2^-8), so |lo| <= 2^-8 |a| and the residual |a - hi
// - lo| <= 2^-16 |a|; the dropped lo lo and the two residual terms are
// each <= 2^-16 |a| |b|, so a product term is off by <= 3 2^-16 (~4.6e-5)
// of |a| |b|, plus the f32 accumulation.  A result split again for a
// second product (the masked scores, W, M) carries that into it: <= ~1e-4
// of the unit for two stages.  chip_smoke.py holds the SSD kernels to
// (TOL_F32 + E) units with TOL_F32 = 2^-11 (~4.9e-4), of which f32 order
// differences take <= 2.7e-4 at nc = 32, Q = 128 (ssd_units): the ~2.2e-4
// left covers the worst case twice over, and rounding errors of both
// signs make the typical error far smaller (the CPU emulation,
// tests/test_torch_ssd_split.py, reads <= 0.015 of the limit).  One bf16
// pass (2^-8 a product) reads 2-7x the limit there, so every operand is
// split and no pass is skipped.
// Operands are staged once a block from float32 device memory (16-byte
// loads, many in flight a thread), split in registers and stored as
// 128-byte-swizzled [rows x 64] bf16 tiles (sm90.cuh), hi and lo side by
// side, then fence.proxy.async.  A tile is a K-major or an MN-major
// operand as the product needs (wgmma's transpose bits); a chunk shorter
// than 128 steps is zero-padded to 128 rows and masked.
//
// Kernel 8 (ssd_scan_fwd) replaces the Pallas TPU kernel ssd_scan
// (src/repro/kernels/ssd_scan/ssd_scan.py:72, body _kernel :33), whose
// grid (batch, head, chunk) carries the [P, N] state across chunks in
// VMEM.  Here the chunk algorithm of ssd_scan_fwd_ref, chunk-parallel, in
// three launches:
//   states, ssd_states_kernel<false>, one block per (chunk, head, batch)
//      (chunks 0 .. nc - 2): the chunk's own state s_c = (x w)^T B, w_j =
//      exp(cum_Q - cum_j) dt_j ([P, Q] . [Q, N], both operands MN-major,
//      one warpgroup per half of N), written into h0s[c + 1], and cum_Q
//      into a [B, H, nc] scratch.  96 KB of shared memory, 2 blocks an SM.
//   carry, ssd_carry_kernel forward, one block per (1024 floats of the
//      state, head, batch): walks the chunks in order, h <- h exp(cum_Q) +
//      s_c (multiply then add, as the plain version), in place in h0s,
//      which then holds each chunk's entering state (h0s[0] = 0).  Bytes
//      only.
//   out, ssd_fwd_out_kernel, one block per (chunk, head, batch), one
//      warpgroup per 64 rows i: Y = C h0^T ([Q, N] . [N, P]) scaled by
//      exp(cum_i), S = C B^T ([Q, N] . [N, Q], only the causal columns),
//      the masked decayed scores S L dt_j split into register A operands,
//      Y += scores X ([Q, Q] . [Q, P], X MN-major).  192 KB of shared memory.
// Bound at the training shape (B=4, L=4096, H=32, G=1, Q=128): ~0.42 GB
// (x, y, h0s 134 MB each) against ~3.0e10 flops, 9.1e10 as three bf16
// passes: bytes bound it (0.126 ms at 3.35 TB/s; 0.092 ms of tensor-core
// time at 989 TFLOP/s).  The three launches move ~0.94 GB: h0s is written
// twice and read twice.
//
// Kernels 8b and 8c are the backward.  The JAX package has no backward
// kernel (no custom_vjp around ssd_scan): the reference differentiates
// its jnp chunk algorithm (ssd_scan_chunked, ref.py:56).  They stand in
// for that autograd backward with the explicit formulas of
// ssd_scan_bwd_ref (repro_torch/kernels/ssd_scan/ref.py).
//   8b (ssd_scan_bwd_state): dhs [B, H, nc, P, N], dh_{c-1} = exp(cum_Q^c)
//   dh_c + own_c with own_c = sum_i exp(cum_i) dy_i C_i^T and dh_{nc-1} =
//   0, in kernel 8's form, two launches:
//     own, ssd_states_kernel<true>: one block per (chunk c >= 1, head,
//       batch), own_c = (dy e)^T C with e_i = exp(cum_i): the states
//       kernel's product with dy for x, C for B and exp(cum_i) for its row
//       weight, written into dhs[c - 1], and cum_Q^c into the scratch;
//     carry, ssd_carry_kernel in reverse: dhs[c] <- dhs[c + 1]
//       exp(cum_Q^{c+1}) + dhs[c] from c = nc - 2 down to 0 (multiply
//       then add, as the plain version), and dhs[nc - 1] = 0.
//   Bound at the training shape: ~0.28 GB (dy and dhs 134 MB each)
//   against ~8.3e9 flops, 2.5e10 as three bf16 passes: bytes, 0.083 ms
//   (0.025 ms of tensor-core time).  The two launches move ~0.55 GB: dhs
//   is written twice and read once.
//   8c (ssd_scan_bwd_chunk): one block per (chunk, head, batch), two
//   warpgroups, each owning 64 rows (of i where a product's rows are i,
//   of j where they are j).  With W = (dy x^T) L, S = C B^T, L_ij =
//   exp(cum_i - cum_j) on j <= i, h0 = h0s[c], dh = dhs[c]:
//     G = dy x^T, then W = G L into a causal [Q, Q] tile (three 64 x 64
//       blocks, hi / lo), L kept in registers;
//     per half of N (B, C, h0, dh staged once each, a half at a time):
//       S += C B^T (rows i, registers),
//       dC = exp(cum_i) dy h0 + (W dt) B (rows i; W dt the register A
//         operand, read back from the tile and split again),
//       dB = dt_j (exp(cum_Q - cum_j) x dh + W^T C) (rows j; W^T is the
//         tile read MN-major),
//       B dh^T (rows j), the first half's parked in dx itself (each
//         thread reads back its own stores), so that no accumulator
//         beyond S lives across the halves;
//     then T = W S dt_j (row sums, and column sums of W S by warp
//     shuffles and a fixed-order pass over the warps), M = S L dt_j into
//     the tile in W's place, dx = exp(cum_Q - cum_j) dt_j (B dh^T) +
//     M^T dy (rows j, M^T MN-major), and a one-warp tail: d(dt a) from
//     its state terms, its in-chunk reverse cumsum (warp scan) -> ddt and
//     the chunk's partial of da.
//   Both warpgroups run every product alike: warpgroup 0 (rows 0 .. 63)
//   takes the n128 products and the [Q, Q] tile's block above the
//   diagonal as a tile of zeros where it has no columns: ptxas serializes
//   every wgmma of a kernel in which one sits under a branch that differs
//   between warpgroups ("wgmma.mma_async instructions are serialized").
//   dB and dC are written per head and summed over the group's heads by
//   the wrapper (a fixed-order .sum), da per (batch, chunk, head) and
//   summed the same way.  No atomics: runs repeat bit for bit.  ~225 KB
//   of shared memory (X, dy 32 KB each; the [Q, Q] tile 48 KB and the zero
//   block 8 KB; a half of B, C 32 KB each and of h0, dh 16 KB each), one
//   block an SM.  Bound at the training shape: ~0.71 GB against ~6.0e10
//   flops (1.8e11 as three bf16 passes): bytes, 0.212 ms (0.183 ms of
//   tensor-core time).  The per-head dB / dC it writes (268 MB each) are
//   what it moves most.
//
// `fault` is a check hook, 0 on every path of the port: chip_smoke.py
// plants 1 (8, the carry kernel: the state not decayed), 2 (8, the output
// kernel: the intra-chunk mask off by one, j < i), 3 (8b, the carry
// kernel: dh not carried across chunks) and 4 (8b, the own kernel: row i
// weighted by exp(cum_{i+1})) to show that its limits reject them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int P = 64;
constexpr int N = 128;
constexpr int QM = 128;        // largest chunk; every tile has QM rows
constexpr int NT = 256;        // threads per block: two warpgroups
constexpr unsigned FULL = 0xffffffffu;
constexpr int T128 = QM * 128;   // bytes of a [128 x 64] bf16 tile
constexpr int T64 = 64 * 128;    // bytes of a [64 x 64] bf16 tile
constexpr int KSTEP = 16 * 128;  // bytes of 16 tile rows: an MN-major k16 step
static_assert(QM == 4 * 32, "chunk_cum: four positions a lane");

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ size_t state_at(int b, int h, int c, int H, int nc) {
  return ((static_cast<size_t>(b) * H + h) * nc + c) * P * N;
}

// ------------------------------------------------------ split-bf16 pieces

// a0, a1 -> (hi, lo) bf16 pairs, hi = bf16(a), lo = bf16(a - hi) (a - hi
// is exact in f32).
__device__ __forceinline__ void split2(float a0, float a1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a0, a1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a0 - hf.x, a1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// hi + lo of the pair at byte `off` of a hi tile whose lo tile is `lo_at`
// bytes further (exact in f32).
__device__ __forceinline__ float2 read2(const uint8_t* tile, int lo_at, uint32_t off) {
  const uint32_t h = *reinterpret_cast<const uint32_t*>(tile + off);
  const uint32_t l = *reinterpret_cast<const uint32_t*>(tile + lo_at + off);
  const float2 hf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&h));
  const float2 lf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&l));
  return make_float2(hf.x + lf.x, hf.y + lf.y);
}

// byte offset of element (row, col) of a [rows x 64] swizzled bf16 tile
__device__ __forceinline__ uint32_t at(int row, int col) {
  return sw128(row, col / 8) + (col % 8) * 2;
}

// Rows 0 .. R - 1 of a float32 slab (row r at src + r ld, 64 floats) into
// the hi tile and the lo tile `lo_at` bytes further; rows `valid` .. R - 1
// are zeros; row r is multiplied by scale[r] first when scale is given.
// All the block's threads; each issues its R / 16 16-byte loads before it
// converts.
template <int R>
__device__ __forceinline__ void stage(uint8_t* hi, int lo_at, const float* __restrict__ src,
                                      size_t ld, int valid, const float* scale = nullptr) {
  constexpr int ITER = R * 16 / NT;
  float4 v[ITER];
#pragma unroll
  for (int k = 0; k < ITER; ++k) {
    const int idx = threadIdx.x + k * NT, r = idx / 16;
    v[k] = r < valid ? __ldg(reinterpret_cast<const float4*>(src + r * ld) + idx % 16)
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
#pragma unroll
  for (int k = 0; k < ITER; ++k) {
    const int idx = threadIdx.x + k * NT, r = idx / 16, c4 = idx % 16;
    float4 e = v[k];
    if (scale != nullptr) {
      const float s = scale[r];
      e = make_float4(e.x * s, e.y * s, e.z * s, e.w * s);
    }
    uint2 h, l;
    split2(e.x, e.y, h.x, l.x);
    split2(e.z, e.w, h.y, l.y);
    const uint32_t off = at(r, 4 * c4);
    *reinterpret_cast<uint2*>(hi + off) = h;
    *reinterpret_cast<uint2*>(hi + lo_at + off) = l;
  }
}

// Two [64 x 64] float32 slabs (h0 and dh halves, row stride N) into their
// tiles; returns this thread's part of their inner product.
__device__ __forceinline__ float stage_pair(uint8_t* ta, uint8_t* tb, const float* __restrict__ a,
                                            const float* __restrict__ b) {
  constexpr int ITER = 64 * 16 / NT;
  float4 va[ITER], vb[ITER];
#pragma unroll
  for (int k = 0; k < ITER; ++k) {
    const int idx = threadIdx.x + k * NT;
    va[k] = __ldg(reinterpret_cast<const float4*>(a + (idx / 16) * N) + idx % 16);
    vb[k] = __ldg(reinterpret_cast<const float4*>(b + (idx / 16) * N) + idx % 16);
  }
  float dot = 0.0f;
#pragma unroll
  for (int k = 0; k < ITER; ++k) {
    const int idx = threadIdx.x + k * NT;
    const uint32_t off = at(idx / 16, 4 * (idx % 16));
    const float4 e = va[k], f = vb[k];
    dot = fmaf(e.x, f.x, dot);
    dot = fmaf(e.y, f.y, dot);
    dot = fmaf(e.z, f.z, dot);
    dot = fmaf(e.w, f.w, dot);
    uint2 h, l;
    split2(e.x, e.y, h.x, l.x);
    split2(e.z, e.w, h.y, l.y);
    *reinterpret_cast<uint2*>(ta + off) = h;
    *reinterpret_cast<uint2*>(ta + T64 + off) = l;
    split2(f.x, f.y, h.x, l.x);
    split2(f.z, f.w, h.y, l.y);
    *reinterpret_cast<uint2*>(tb + off) = h;
    *reinterpret_cast<uint2*>(tb + T64 + off) = l;
  }
  return dot;
}

// D (+)= A B in three passes, hi hi + hi lo + lo hi; a / b point at the hi
// tiles' k16 step, whose lo tiles are a_lo / b_lo bytes further.
template <int NN, int TA, int TB>
__device__ __forceinline__ void mma3(float (&d)[NN / 2], const uint8_t* a, int a_lo,
                                     const uint8_t* b, int b_lo, int scale_d) {
  if constexpr (NN == 64) {
    wgmma_ss_n64_t<TA, TB>(d, desc(a), desc(b), scale_d);
    wgmma_ss_n64_t<TA, TB>(d, desc(a), desc(b + b_lo), 1);
    wgmma_ss_n64_t<TA, TB>(d, desc(a + a_lo), desc(b), 1);
  } else {
    static_assert(TA == 0 && TB == 0, "n128: K-major operands only");
    wgmma_ss<NN>(d, desc(a), desc(b), scale_d);
    wgmma_ss<NN>(d, desc(a), desc(b + b_lo), 1);
    wgmma_ss<NN>(d, desc(a + a_lo), desc(b), 1);
  }
}

// The first 32 accumulators of a 64 (an m64n64 view of an m64n128 one).
__device__ __forceinline__ float (&lo32(float (&d)[64]))[32] {
  return *reinterpret_cast<float(*)[32]>(&d[0]);
}

// The accumulator position of element x of an m64nN accumulator: row
// 16 w + g + 8 ((x / 2) % 2), column 8 (x / 4) + 2 t + x % 2.
struct Frag {
  int w, g, t;
  __device__ __forceinline__ Frag() {
    const int lane = threadIdx.x % 32;
    w = (threadIdx.x % 128) / 32;
    g = lane / 4;
    t = lane % 4;
  }
  __device__ __forceinline__ int row(int x) const { return 16 * w + g + 8 * ((x / 2) % 2); }
  __device__ __forceinline__ int col(int x) const { return 8 * (x / 4) + 2 * t + x % 2; }
};

// cum = the inclusive cumsum of dt a over the chunk (warp 0; a lane sums
// four positions in order, then a warp scan of the lanes' sums), dt into
// dts; positions Q .. QM - 1 take dt = 0.  The caller syncs.
__device__ __forceinline__ void chunk_cum(float* dts, float* cum, const float* __restrict__ dt,
                                          float av, size_t row0, int H, int Q) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  float d[4], pre[4], run = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = 4 * lane + k;
    d[k] = i < Q ? dt[(row0 + i) * H] : 0.0f;
    run = __fadd_rn(run, __fmul_rn(d[k], av));
    pre[k] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl = __fadd_rn(incl, y);
  }
  float excl = __shfl_up_sync(FULL, incl, 1);
  if (lane == 0) excl = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    dts[4 * lane + k] = d[k];
    cum[4 * lane + k] = __fadd_rn(excl, pre[k]);
  }
}

// ------------------------------------------------------------- kernel 8

constexpr int STATES_SMEM = 6 * T128 + 3 * QM * 4 + 1024;

// A chunk's own state, one block per (chunk, head, batch):
//   s[p, n] = sum_j w_j v[j, p] k[j, n]
// forward (REV false; kernel 8's states): chunk c = blockIdx.x of 0 ..
// nc - 2, v x, k B, w_j = exp(cum_Q - cum_j) dt_j, into h0s[c + 1];
// backward (REV true; 8b's own): chunk c = blockIdx.x + 1 of 1 .. nc - 1,
// v dy, k C, w_i = exp(cum_i) (fault 4: exp(cum_{i+1})), into dhs[c - 1].
// cum_Q of chunk c into cumq[c].
template <bool REV>
__global__ void __launch_bounds__(NT, 2)
ssd_states_kernel(const float* __restrict__ v, const float* __restrict__ dt,
                  const float* __restrict__ a, const float* __restrict__ km,
                  float* __restrict__ states, float* __restrict__ cumq, int L, int H, int G,
                  int Q, int fault) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* vw = align1024(smem_raw);        // v w: hi, lo (+T128)
  uint8_t* kt = vw + 2 * T128;              // k, tile t (columns 64 t ..) at 2 t T128
  float* cum = reinterpret_cast<float*>(kt + 4 * T128);
  float* dts = cum + QM;
  float* wv = dts + QM;
  const int tid = threadIdx.x, c = blockIdx.x + REV, h = blockIdx.y, b = blockIdx.z;
  const int nc = L / Q;
  // the last chunk's own state enters no chunk; the first's gradient leaves none
  if (REV ? c >= nc : c >= nc - 1) return;
  const int g = h / (H / G);
  const size_t row0 = static_cast<size_t>(b) * L + c * Q;
  chunk_cum(dts, cum, dt + h, a[h], row0, H, Q);
  for (int t = 0; t < 2; ++t)
    stage<QM>(kt + 2 * t * T128, T128, km + (row0 * G + g) * N + 64 * t,
              static_cast<size_t>(G) * N, Q);
  __syncthreads();
  const float cl = cum[Q - 1];
  if (tid < QM) {
    float w = 0.0f;
    if (tid < Q) {
      if constexpr (REV) w = expf(cum[fault == 4 ? min(tid + 1, Q - 1) : tid]);
      else w = __fmul_rn(expf(cl - cum[tid]), dts[tid]);
    }
    wv[tid] = w;
  }
  if (tid == 0) cumq[(static_cast<size_t>(b) * H + h) * nc + c] = cl;
  __syncthreads();
  stage<QM>(vw, T128, v + (row0 * H + h) * P, static_cast<size_t>(H) * P, Q, wv);
  fence_proxy_async();
  __syncthreads();

  // s[p, n] = sum_j (v w)[j, p] k[j, n]: A = (v w)^T, B = the warpgroup's
  // half of k, both MN-major; k16 steps of 16 rows j
  const int wg = tid / 128;
  const uint8_t* kw = kt + 2 * wg * T128;
  float acc[32];
  wgmma_fence();
  for (int s = 0; s < (Q + 15) / 16; ++s)
    mma3<64, 1, 1>(acc, vw + s * KSTEP, T128, kw + s * KSTEP, T128, s > 0);
  wgmma_commit();
  wgmma_wait();
  fence_regs(acc);
  const Frag f;
  float* out = states + state_at(b, h, REV ? c - 1 : c + 1, H, nc) + 64 * wg;
#pragma unroll
  for (int x2 = 0; x2 < 32; x2 += 2)
    *reinterpret_cast<float2*>(out + f.row(x2) * N + f.col(x2)) =
        make_float2(acc[x2], acc[x2 + 1]);
}

// The carry, in place over the states of one (batch, head), each slot
// holding a chunk's own state: forward (rev 0), h0s[0] = 0 and for c = 1
// .. nc - 1 h0s[c] <- h0s[c - 1] exp(cumq[c - 1]) + h0s[c]; in reverse
// (rev 1), dhs[nc - 1] = 0 and for c = nc - 2 .. 0 dhs[c] <- dhs[c + 1]
// exp(cumq[c + 1]) + dhs[c].  Fault 1: no decay; fault 3: nothing carried.
// Thread: four consecutive floats of every state.
__global__ void __launch_bounds__(NT)
ssd_carry_kernel(const float* __restrict__ cumq, float* states, int nc, int rev, int fault) {
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  float4* st = reinterpret_cast<float4*>(states + state_at(b, h, 0, H, nc)) +
               blockIdx.x * NT + threadIdx.x;
  const float* cq = cumq + (static_cast<size_t>(b) * H + h) * nc;
  constexpr int STRIDE = P * N / 4;   // float4s a state
  const int step = rev ? -1 : 1, first = rev ? nc - 1 : 0;
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 next = nc > 1 ? st[(first + step) * STRIDE] : s;
  st[first * STRIDE] = s;
  for (int k = 1; k < nc; ++k) {
    const int c = first + step * k;
    const float4 own = next;
    if (k + 1 < nc) next = st[(c + step) * STRIDE];
    const float d = fault == 1 ? 1.0f : fault == 3 ? 0.0f : expf(cq[c - step]);
    s.x = __fadd_rn(__fmul_rn(s.x, d), own.x);
    s.y = __fadd_rn(__fmul_rn(s.y, d), own.y);
    s.z = __fadd_rn(__fmul_rn(s.z, d), own.z);
    s.w = __fadd_rn(__fmul_rn(s.w, d), own.w);
    st[c * STRIDE] = s;
  }
}

// Shared memory of the output kernel (bytes from the aligned base).
constexpr int OUT_C = 0;                 // C: tile t hi at OUT_C + 2 t T128, lo + T128
constexpr int OUT_B = OUT_C + 4 * T128;  // B: the same
constexpr int OUT_X = OUT_B + 4 * T128;  // x: hi, lo (+T128)
constexpr int OUT_H = OUT_X + 2 * T128;  // h0 [P x N]: tile t hi at OUT_H + 2 t T64, lo + T64
constexpr int OUT_F = OUT_H + 4 * T64;   // cum, dts, exp(cum)
constexpr int OUT_SMEM = OUT_F + 3 * QM * 4 + 1024;

// out: y for the warpgroup's 64 rows i (r0 ..); NARROW: rows 0 .. 63, whose
// causal columns are 0 .. 63.
template <bool NARROW>
__device__ __forceinline__ void out_rows(const uint8_t* sm, const float* cum, const float* dts,
                                         const float* ecum, float* __restrict__ y,
                                         size_t y_ld, int r0, int Q, int fault) {
  constexpr int NX = NARROW ? 32 : 64;   // score accumulators in use
  const Frag f;
  float yacc[32], s[64];
  wgmma_fence();
  for (int kk = 0; kk < 8; ++kk) {   // K = N: tile kk / 4, 16-column step kk % 4
    const int to = (kk / 4) * 2, co = (kk % 4) * 32;
    const uint8_t* ca = sm + OUT_C + to * T128 + r0 * 128 + co;
    mma3<64, 0, 0>(yacc, ca, T128, sm + OUT_H + to * T64 + co, T64, kk > 0);
    const uint8_t* bb = sm + OUT_B + to * T128 + co;
    if constexpr (NARROW) mma3<64, 0, 0>(lo32(s), ca, T128, bb, T128, kk > 0);
    else mma3<128, 0, 0>(s, ca, T128, bb, T128, kk > 0);
  }
  wgmma_commit();
  wgmma_wait();
  fence_regs(yacc);
  fence_regs(s);
#pragma unroll
  for (int x = 0; x < 32; ++x) yacc[x] *= ecum[r0 + f.row(x)];
  // the masked, decayed scores S L dt_j, split into register A operands
  uint32_t ph[NX / 8][4], pl[NX / 8][4];
#pragma unroll
  for (int x = 0; x < NX; ++x) {
    const int i = r0 + f.row(x), j = f.col(x);
    const bool on = i < Q && (fault == 2 ? j < i : j <= i);
    s[x] = on ? __fmul_rn(__fmul_rn(s[x], expf(cum[i] - cum[j])), dts[j]) : 0.0f;
  }
#pragma unroll
  for (int kb = 0; kb < NX / 8; ++kb)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      split2(s[8 * kb + 2 * q], s[8 * kb + 2 * q + 1], ph[kb][q], pl[kb][q]);
  wgmma_fence();
  fence_regs(yacc);
#pragma unroll
  for (int kb = 0; kb < NX / 8; ++kb) {   // K = j: rows 16 kb .. of the x tile, MN-major
    const uint8_t* xb = sm + OUT_X + kb * KSTEP;
    wgmma_rs_n64(yacc, ph[kb], desc(xb));
    wgmma_rs_n64(yacc, ph[kb], desc(xb + T128));
    wgmma_rs_n64(yacc, pl[kb], desc(xb));
  }
  wgmma_commit();
  wgmma_wait();
  fence_regs(yacc);
#pragma unroll
  for (int x = 0; x < 32; x += 2) {
    const int i = r0 + f.row(x);
    if (i < Q)
      *reinterpret_cast<float2*>(y + i * y_ld + f.col(x)) = make_float2(yacc[x], yacc[x + 1]);
  }
}

// out: the outputs.
__global__ void __launch_bounds__(NT, 1)
ssd_fwd_out_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ a, const float* __restrict__ bm,
                   const float* __restrict__ cm, const float* __restrict__ h0s,
                   float* __restrict__ y, int L, int H, int G, int Q, int fault) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  float* cum = reinterpret_cast<float*>(sm + OUT_F);
  float* dts = cum + QM;
  float* ecum = dts + QM;
  const int tid = threadIdx.x, c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G), nc = L / Q;
  const size_t row0 = static_cast<size_t>(b) * L + c * Q;
  chunk_cum(dts, cum, dt + h, a[h], row0, H, Q);
  const float* h0 = h0s + state_at(b, h, c, H, nc);
  for (int t = 0; t < 2; ++t) {
    stage<QM>(sm + OUT_C + 2 * t * T128, T128, cm + (row0 * G + g) * N + 64 * t,
              static_cast<size_t>(G) * N, Q);
    stage<QM>(sm + OUT_B + 2 * t * T128, T128, bm + (row0 * G + g) * N + 64 * t,
              static_cast<size_t>(G) * N, Q);
    stage<64>(sm + OUT_H + 2 * t * T64, T64, h0 + 64 * t, N, 64);
  }
  stage<QM>(sm + OUT_X, T128, x + (row0 * H + h) * P, static_cast<size_t>(H) * P, Q);
  __syncthreads();
  if (tid < QM) ecum[tid] = tid < Q ? expf(cum[tid]) : 0.0f;
  fence_proxy_async();
  __syncthreads();
  float* yb = y + (row0 * H + h) * P;
  if (tid < 128) out_rows<true>(sm, cum, dts, ecum, yb, static_cast<size_t>(H) * P, 0, Q, fault);
  else out_rows<false>(sm, cum, dts, ecum, yb, static_cast<size_t>(H) * P, 64, Q, fault);
}

// ------------------------------------------------------------ kernel 8c

// Shared memory of kernel 8c (bytes from the aligned base).  The causal
// [Q, Q] tile is three 64 x 64 blocks (i block ib, j block jb) = (0, 0),
// (1, 0), (1, 1) at BW_W + 2 (ib + jb) T64, hi then lo (+T64); block
// (0, 1), above the diagonal, is a tile of zeros that is its own lo.  So
// both warpgroups run every loop of the kernel alike, warpgroup 0 over
// zeros where its rows have no columns: a wgmma under a branch that
// differs between the warpgroups makes ptxas serialize every wgmma of the
// kernel.
constexpr int BW_X = 0;                  // x: hi, lo (+T128)
constexpr int BW_DY = BW_X + 2 * T128;   // dy: hi, lo
constexpr int BW_W = BW_DY + 2 * T128;   // W, later M
constexpr int BW_Z = BW_W + 6 * T64;     // zeros [64 x 64]
constexpr int BW_B = BW_Z + T64;         // half of B: hi, lo (+T128)
constexpr int BW_C = BW_B + 2 * T128;    // half of C
constexpr int BW_H0 = BW_C + 2 * T128;   // half of h0 [P x 64]: hi, lo (+T64)
constexpr int BW_DH = BW_H0 + 2 * T64;   // half of dh
constexpr int BW_F = BW_DH + 2 * T64;    // float32 arrays
constexpr int BW_NF = 7 * QM + 8 * QM + 8;
constexpr int CHUNK_SMEM = BW_F + BW_NF * 4 + 1024;

struct Blk {
  uint8_t* p;   // the hi tile
  int lo;       // bytes to the lo tile
};

__device__ __forceinline__ Blk wblock(uint8_t* sm, int ib, int jb) {
  return ib >= jb ? Blk{sm + BW_W + 2 * (ib + jb) * T64, T64} : Blk{sm + BW_Z, 0};
}

// The register A operand of a k16 step of (W dt) B: rows row, row + 8 and
// columns c0, c0 + 1, c0 + 8, c0 + 9 of a W block read back as hi + lo,
// times dt of each column (dtc: the block's first column), split again.
__device__ __forceinline__ void wd_frag(Blk blk, int row, int c0, const float* dtc,
                                        uint32_t (&ah)[4], uint32_t (&al)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = row + 8 * (q % 2), cc = c0 + 8 * (q / 2);
    const float2 w = read2(blk.p, blk.lo, at(r, cc));
    split2(w.x * dtc[cc], w.y * dtc[cc + 1], ah[q], al[q]);
  }
}

template <int M>
__device__ __forceinline__ void fence_u32(uint32_t (&a)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

__global__ void __launch_bounds__(NT, 1)
ssd_bwd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a, const float* __restrict__ bm,
                     const float* __restrict__ cm, const float* __restrict__ h0s,
                     const float* __restrict__ dhs, const float* __restrict__ dy,
                     float* __restrict__ dx, float* __restrict__ ddt,
                     float* __restrict__ da_part, float* __restrict__ db_part,
                     float* __restrict__ dc_part, int L, int H, int G, int Q) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  float* cum = reinterpret_cast<float*>(sm + BW_F);
  float* dts = cum + QM;
  float* ecum = dts + QM;        // exp(cum_i)
  float* tail = ecum + QM;       // exp(cum_Q - cum_j)
  float* rowt = tail + QM;       // sum_j T_ij
  float* cpart = rowt + QM;      // C_i . dC_state_i
  float* dds = cpart + QM;       // B_j . v_j
  float* colp = dds + QM;        // [8 warps][QM]: column sums of W S over a warp's rows
  float* hdp = colp + 8 * QM;    // [8 warps]: <h0, dh>
  const int tid = threadIdx.x, c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G), nc = L / Q, wg = tid / 128, r0 = 64 * wg;
  const size_t row0 = static_cast<size_t>(b) * L + c * Q;
  const size_t xld = static_cast<size_t>(H) * P, bld = static_cast<size_t>(G) * N;
  const float av = a[h];
  const float* h0 = h0s + state_at(b, h, c, H, nc);
  const float* dh = dhs + state_at(b, h, c, H, nc);
  const float* bsrc = bm + (row0 * G + g) * N;
  const float* csrc = cm + (row0 * G + g) * N;
  const Frag f;

  for (int i = tid; i < T64 / 16; i += NT)
    reinterpret_cast<uint4*>(sm + BW_Z)[i] = make_uint4(0u, 0u, 0u, 0u);
  chunk_cum(dts, cum, dt + h, av, row0, H, Q);
  stage<QM>(sm + BW_X, T128, x + (row0 * H + h) * P, xld, Q);
  stage<QM>(sm + BW_DY, T128, dy + (row0 * H + h) * P, xld, Q);
  __syncthreads();
  const float cl = cum[Q - 1];
  if (tid < QM) {
    ecum[tid] = tid < Q ? expf(cum[tid]) : 0.0f;
    tail[tid] = tid < Q ? expf(cl - cum[tid]) : 0.0f;
  }
  fence_proxy_async();
  __syncthreads();

  // G = dy x^T (rows i); L and W = G L, W into the tile
  float s[64], lr[64];
  {
    float gm[64];
    wgmma_fence();
    for (int kk = 0; kk < 4; ++kk)
      mma3<128, 0, 0>(gm, sm + BW_DY + r0 * 128 + kk * 32, T128, sm + BW_X + kk * 32, T128,
                      kk > 0);
    wgmma_commit();
    wgmma_wait();
    fence_regs(gm);
#pragma unroll
    for (int x2 = 0; x2 < 64; ++x2) {
      const int i = r0 + f.row(x2), j = f.col(x2);
      const bool on = i < Q && j <= i;
      lr[x2] = on ? expf(cum[i] - cum[j]) : 0.0f;
      gm[x2] = on ? gm[x2] * lr[x2] : 0.0f;
    }
#pragma unroll
    for (int x2 = 0; x2 < 64; x2 += 2) {   // warpgroup 0's columns 64 .. are zeros
      const int j = f.col(x2);
      uint32_t hi, lo;
      split2(gm[x2], gm[x2 + 1], hi, lo);
      const Blk w = wblock(sm, wg, j / 64);
      const uint32_t off = at(f.row(x2), j % 64);
      *reinterpret_cast<uint32_t*>(w.p + off) = hi;
      *reinterpret_cast<uint32_t*>(w.p + w.lo + off) = lo;
    }
  }

  float cp[2] = {0.0f, 0.0f};    // this thread's part of C_i . dC_state_i (rows i)
  float dd[2] = {0.0f, 0.0f};    // ... of B_j . v_j (rows j)
  float hd = 0.0f;               // ... of <h0, dh>
  for (int half = 0; half < 2; ++half) {
    __syncthreads();   // the W tile is written; the previous half's readers are done
    stage<QM>(sm + BW_B, T128, bsrc + 64 * half, bld, Q);
    stage<QM>(sm + BW_C, T128, csrc + 64 * half, bld, Q);
    hd += stage_pair(sm + BW_H0, sm + BW_DH, h0 + 64 * half, dh + 64 * half);
    fence_proxy_async();
    __syncthreads();

    // S += C B^T (rows i)
    wgmma_fence();
    fence_regs(s);
    for (int kk = 0; kk < 4; ++kk)
      mma3<128, 0, 0>(s, sm + BW_C + r0 * 128 + kk * 32, T128, sm + BW_B + kk * 32, T128,
                      half > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);

    const size_t out_col = 64 * half;
    {  // dC (rows i) = exp(cum_i) dy h0 + (W dt) B
      float acc[32];
      wgmma_fence();
      for (int kk = 0; kk < 4; ++kk)
        mma3<64, 0, 1>(acc, sm + BW_DY + r0 * 128 + kk * 32, T128, sm + BW_H0 + kk * KSTEP,
                       T64, kk > 0);
      wgmma_commit();
      wgmma_wait();
      fence_regs(acc);
#pragma unroll
      for (int x2 = 0; x2 < 32; x2 += 2) {
        const int i = r0 + f.row(x2);
        const float e = ecum[i];
        acc[x2] *= e;
        acc[x2 + 1] *= e;
        const float2 cv = read2(sm + BW_C, T128, at(i, f.col(x2)));
        cp[(x2 / 2) % 2] += cv.x * acc[x2] + cv.y * acc[x2 + 1];
      }
      for (int jb = 0; jb < 2; ++jb) {   // K = j: the 64 columns of W block (wg, jb)
        uint32_t ah[4][4], al[4][4];
#pragma unroll
        for (int st = 0; st < 4; ++st)
          wd_frag(wblock(sm, wg, jb), 16 * f.w + f.g, 16 * st + 2 * f.t, dts + 64 * jb,
                  ah[st], al[st]);
        wgmma_fence();
        fence_regs(acc);
#pragma unroll
        for (int st = 0; st < 4; ++st) {
          const uint8_t* bb = sm + BW_B + (64 * jb + 16 * st) * 128;
          wgmma_rs_n64(acc, ah[st], desc(bb));
          wgmma_rs_n64(acc, ah[st], desc(bb + T128));
          wgmma_rs_n64(acc, al[st], desc(bb));
        }
        wgmma_commit();
        wgmma_wait();
        fence_regs(acc);
#pragma unroll
        for (int st = 0; st < 4; ++st) {
          fence_u32(ah[st]);
          fence_u32(al[st]);
        }
      }
#pragma unroll
      for (int x2 = 0; x2 < 32; x2 += 2) {
        const int i = r0 + f.row(x2);
        if (i < Q)
          *reinterpret_cast<float2*>(dc_part + ((row0 + i) * H + h) * N + out_col + f.col(x2)) =
              make_float2(acc[x2], acc[x2 + 1]);
      }
    }
    {  // dB (rows j) = dt_j (exp(cum_Q - cum_j) x dh + W^T C)
      float acc[32];
      wgmma_fence();
      for (int kk = 0; kk < 4; ++kk)
        mma3<64, 0, 1>(acc, sm + BW_X + r0 * 128 + kk * 32, T128, sm + BW_DH + kk * KSTEP,
                       T64, kk > 0);
      wgmma_commit();
      wgmma_wait();
      fence_regs(acc);
#pragma unroll
      for (int x2 = 0; x2 < 32; x2 += 2) {
        const int j = r0 + f.row(x2);
        const float e = tail[j];
        acc[x2] *= e;
        acc[x2 + 1] *= e;
        const float2 bv = read2(sm + BW_B, T128, at(j, f.col(x2)));
        dd[(x2 / 2) % 2] += bv.x * acc[x2] + bv.y * acc[x2 + 1];
      }
      wgmma_fence();
      fence_regs(acc);
      for (int ib = 0; ib < 2; ++ib) {   // K = i >= j: blocks (ib, wg), read MN-major
        const Blk w = wblock(sm, ib, wg);
        for (int st = 0; st < 4; ++st)
          mma3<64, 1, 1>(acc, w.p + st * KSTEP, w.lo, sm + BW_C + (64 * ib + 16 * st) * 128,
                         T128, 1);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(acc);
#pragma unroll
      for (int x2 = 0; x2 < 32; x2 += 2) {
        const int j = r0 + f.row(x2);
        if (j < Q)
          *reinterpret_cast<float2*>(db_part + ((row0 + j) * H + h) * N + out_col + f.col(x2)) =
              make_float2(acc[x2] * dts[j], acc[x2 + 1] * dts[j]);
      }
    }
    if (half == 0) {  // dx (rows j): the first half of B dh^T, parked in dx itself
      float acc[32];
      wgmma_fence();
      for (int kk = 0; kk < 4; ++kk)
        mma3<64, 0, 0>(acc, sm + BW_B + r0 * 128 + kk * 32, T128, sm + BW_DH + kk * 32, T64,
                       kk > 0);
      wgmma_commit();
      wgmma_wait();
      fence_regs(acc);
#pragma unroll
      for (int x2 = 0; x2 < 32; x2 += 2) {
        const int j = r0 + f.row(x2);
        if (j < Q)
          *reinterpret_cast<float2*>(dx + ((row0 + j) * H + h) * P + f.col(x2)) =
              make_float2(acc[x2], acc[x2 + 1]);
      }
    }
  }
  __syncthreads();   // every read of the W tile is done

  // T = W S dt_j: row sums (rows i) and column sums of W S; then M = S L
  // dt_j into the tile, each element where its W was
  {
    float rs[2] = {0.0f, 0.0f}, cs[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) cs[k] = 0.0f;
#pragma unroll
    for (int x2 = 0; x2 < 64; x2 += 2) {
      const int rl = f.row(x2), i = r0 + rl, j = f.col(x2);
      const Blk blk = wblock(sm, wg, j / 64);
      const uint32_t off = at(rl, j % 64);
      const float2 w = read2(blk.p, blk.lo, off);
      const float ws0 = w.x * s[x2], ws1 = w.y * s[x2 + 1];
      rs[(x2 / 2) % 2] += ws0 * dts[j] + ws1 * dts[j + 1];
      cs[2 * (x2 / 4)] += ws0;
      cs[2 * (x2 / 4) + 1] += ws1;
      const bool on0 = i < Q && j <= i, on1 = i < Q && j + 1 <= i;
      const float m0 = on0 ? __fmul_rn(__fmul_rn(s[x2], lr[x2]), dts[j]) : 0.0f;
      const float m1 = on1 ? __fmul_rn(__fmul_rn(s[x2 + 1], lr[x2 + 1]), dts[j + 1]) : 0.0f;
      uint32_t hi, lo;
      split2(m0, m1, hi, lo);
      *reinterpret_cast<uint32_t*>(blk.p + off) = hi;
      *reinterpret_cast<uint32_t*>(blk.p + blk.lo + off) = lo;
    }
    const int warp = tid / 32;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      rs[k] += __shfl_xor_sync(FULL, rs[k], 1);
      rs[k] += __shfl_xor_sync(FULL, rs[k], 2);
      cp[k] += __shfl_xor_sync(FULL, cp[k], 1);
      cp[k] += __shfl_xor_sync(FULL, cp[k], 2);
      dd[k] += __shfl_xor_sync(FULL, dd[k], 1);
      dd[k] += __shfl_xor_sync(FULL, dd[k], 2);
      if (f.t == 0) {
        const int r = r0 + 16 * f.w + f.g + 8 * k;
        rowt[r] = rs[k];
        cpart[r] = cp[k];
        dds[r] = dd[k];
      }
    }
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      cs[k] += __shfl_xor_sync(FULL, cs[k], 4);
      cs[k] += __shfl_xor_sync(FULL, cs[k], 8);
      cs[k] += __shfl_xor_sync(FULL, cs[k], 16);
      if (f.g == 0) colp[warp * QM + 8 * (k / 2) + 2 * f.t + k % 2] = cs[k];
    }
    hd = warp_sum(hd);
    if (tid % 32 == 0) hdp[warp] = hd;
  }
  fence_proxy_async();
  __syncthreads();

  {  // dx (rows j) = exp(cum_Q - cum_j) dt_j (B dh^T) + M^T dy: the first
     // half of B dh^T read back (this thread's own stores), the second from
     // the half-N tiles still staged
    float dxa[32];
#pragma unroll
    for (int x2 = 0; x2 < 32; x2 += 2) {
      const int j = r0 + f.row(x2);
      const float2 v = j < Q ? *reinterpret_cast<const float2*>(
                                   dx + ((row0 + j) * H + h) * P + f.col(x2))
                             : make_float2(0.0f, 0.0f);
      dxa[x2] = v.x;
      dxa[x2 + 1] = v.y;
    }
    wgmma_fence();
    fence_regs(dxa);
    for (int kk = 0; kk < 4; ++kk)
      mma3<64, 0, 0>(dxa, sm + BW_B + r0 * 128 + kk * 32, T128, sm + BW_DH + kk * 32, T64, 1);
    wgmma_commit();
    wgmma_wait();
    fence_regs(dxa);
#pragma unroll
    for (int x2 = 0; x2 < 32; ++x2) {
      const int j = r0 + f.row(x2);
      dxa[x2] *= __fmul_rn(tail[j], dts[j]);
    }
    wgmma_fence();
    fence_regs(dxa);
    for (int ib = 0; ib < 2; ++ib) {   // K = i >= j: M blocks (ib, wg), read MN-major
      const Blk w = wblock(sm, ib, wg);
      for (int st = 0; st < 4; ++st)
        mma3<64, 1, 1>(dxa, w.p + st * KSTEP, w.lo, sm + BW_DY + (64 * ib + 16 * st) * 128,
                       T128, 1);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(dxa);
#pragma unroll
    for (int x2 = 0; x2 < 32; x2 += 2) {
      const int j = r0 + f.row(x2);
      if (j < Q)
        *reinterpret_cast<float2*>(dx + ((row0 + j) * H + h) * P + f.col(x2)) =
            make_float2(dxa[x2], dxa[x2 + 1]);
    }
  }

  // the tail, one warp: dcum_k = sum_j T_kj - sum_i T_ik + C_k . dC_state_k
  // - u_k (u_k = dt_k B_k . v_k), + exp(cum_Q) <h0, dh> + sum_k u_k at
  // k = Q - 1; its reverse cumsum dda (warp scan); ddt = sum_i W_ik S_ik +
  // B_k . v_k + a dda_k; da = sum_k dt_k dda_k.  Four positions a lane.
  if (tid < 32) {
    const int lane = tid;
    float hdt = 0.0f;
    for (int w = 0; w < 8; ++w) hdt += hdp[w];
    float dc[4], csum[4], usum = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = 4 * lane + k;
      float cs = 0.0f;
      for (int w = 0; w < 8; ++w) cs += colp[w * QM + i];
      csum[k] = cs;
      const float u = dts[i] * dds[i];
      usum += u;
      dc[k] = rowt[i] - dts[i] * cs + cpart[i] - u;
    }
    usum = warp_sum(usum);
    const float last = expf(cl) * hdt + usum;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (4 * lane + k == Q - 1) dc[k] += last;
    float suf[4], run = 0.0f;
#pragma unroll
    for (int k = 3; k >= 0; --k) {
      run += dc[k];
      suf[k] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_down_sync(FULL, incl, o);
      if (lane + o < 32) incl += v;
    }
    float excl = __shfl_down_sync(FULL, incl, 1);
    if (lane == 31) excl = 0.0f;
    float dap = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = 4 * lane + k;
      const float dda = excl + suf[k];
      if (i < Q) ddt[(row0 + i) * H + h] = csum[k] + dds[i] + av * dda;
      dap += dts[i] * dda;
    }
    dap = warp_sum(dap);
    if (lane == 0) da_part[(static_cast<size_t>(b) * nc + c) * H + h] = dap;
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


template <bool REV>
int launch_states(const float* v, const float* dt, const float* a, const float* k, float* states,
                  float* cumq, int B, int L, int H, int G, int p, int n, int Q, int fault,
                  void* stream) {
  if (bad_shape(B, L, H, G, p, n, Q)) return static_cast<int>(cudaErrorInvalidValue);
  const int nc = L / Q;
  return launch_dyn(ssd_states_kernel<REV>, dim3(nc > 1 ? nc - 1 : 1, H, B), STATES_SMEM,
                    static_cast<cudaStream_t>(stream), v, dt, a, k, states, cumq, L, H, G, Q,
                    fault);
}

int launch_carry(const float* cumq, float* states, int B, int L, int H, int Q, int rev,
                 int fault, void* stream) {
  if (B <= 0 || H <= 0 || Q <= 0 || Q > QM || L % Q != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  ssd_carry_kernel<<<dim3(P * N / (4 * NT), H, B), NT, 0, static_cast<cudaStream_t>(stream)>>>(
      cumq, states, L / Q, rev, fault);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Kernel 8, in three launches on one stream: h0s [B, H, nc, P, N] and the
// scratch cumq [B, H, nc] are the caller's.
extern "C" int ssd_fwd_states(const float* x, const float* dt, const float* a, const float* b,
                              float* h0s, float* cumq, int B, int L, int H, int G, int p,
                              int n, int Q, void* stream) {
  return launch_states<false>(x, dt, a, b, h0s, cumq, B, L, H, G, p, n, Q, 0, stream);
}

extern "C" int ssd_fwd_carry(const float* cumq, float* h0s, int B, int L, int H, int Q,
                             int fault, void* stream) {
  return launch_carry(cumq, h0s, B, L, H, Q, 0, fault, stream);
}

extern "C" int ssd_fwd_out(const float* x, const float* dt, const float* a, const float* b,
                           const float* c, const float* h0s, float* y, int B, int L, int H,
                           int G, int p, int n, int Q, int fault, void* stream) {
  if (bad_shape(B, L, H, G, p, n, Q)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_dyn(ssd_fwd_out_kernel, dim3(L / Q, H, B), OUT_SMEM,
                    static_cast<cudaStream_t>(stream), x, dt, a, b, c, h0s, y, L, H, G, Q,
                    fault);
}

// Kernel 8b, in two launches on one stream: dhs [B, H, nc, P, N] and the
// scratch cumq [B, H, nc] are the caller's.
extern "C" int ssd_bwd_own(const float* dt, const float* a, const float* c, const float* dy,
                           float* dhs, float* cumq, int B, int L, int H, int G, int p, int n,
                           int Q, int fault, void* stream) {
  return launch_states<true>(dy, dt, a, c, dhs, cumq, B, L, H, G, p, n, Q, fault, stream);
}

extern "C" int ssd_bwd_carry(const float* cumq, float* dhs, int B, int L, int H, int Q,
                             int fault, void* stream) {
  return launch_carry(cumq, dhs, B, L, H, Q, 1, fault, stream);
}

extern "C" int ssd_scan_bwd_chunk(const float* x, const float* dt, const float* a,
                                  const float* b, const float* c, const float* h0s,
                                  const float* dhs, const float* dy, float* dx,
                                  float* ddt, float* da_part, float* db_part,
                                  float* dc_part, int B, int L, int H, int G, int p,
                                  int n, int Q, void* stream) {
  if (bad_shape(B, L, H, G, p, n, Q)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_dyn(ssd_bwd_chunk_kernel, dim3(L / Q, H, B), CHUNK_SMEM,
                    static_cast<cudaStream_t>(stream), x, dt, a, b, c, h0s, dhs, dy, dx,
                    ddt, da_part, db_part, dc_part, L, H, G, Q);
}

// Dynamic shared memory of the tensor-core kernels, for the build report:
// 0 the states kernel (kernel 8's states and 8b's own), 1 the output
// kernel, 2 kernel 8c.
extern "C" int ssd_scan_smem(int kind) {
  return kind == 0 ? STATES_SMEM : kind == 1 ? OUT_SMEM : CHUNK_SMEM;
}
