// The split-K weight stream: kernels 1 (ent_matmul_packed_fused, two
// planes, f32 / bf16 X) and 6 (int8_matmul, one plane, int8 X) at the
// decode shape, M <= M_STREAM rows (each wrapper's cut; larger M takes the
// tensor-core loop of int8_tc.cuh).  It computes what the tile loop of
// int8_tile.cuh computes, parameterised the same way (X prologue, plane
// count, shift):
//
//   Xq  = X (int8), or clip(rint(X / sx), -127, 127) from f32/bf16 X
//   acc = sum_i (Xq @ P_i) * 2^(SHIFT * i)       (int32, exact)
//   out = (float(acc) * sx) * sw  in f32 or bf16, or acc itself (int32)
//
// with the tile loop's quantize / store helpers, so each result is
// bit-identical to the plain version (ref.py) and to the tile loop.
//
// What bounds it on the H100: at M = 8 the planes (NP K N bytes at K =
// 2048, N = 11008: 45 MB for kernel 1, 22.5 MB for kernel 6) are read once
// against 2 NP M K N int8 operations, far below the card's ops / byte
// balance: memory bandwidth, ~13.5 / ~6.7 us at 3.35 TB/s.  The tile loop
// pads M = 8 to 64 rows, reads the planes a byte at a time with a stride of
// N and launches N / 64 blocks (4 for N = 256), so it streams far below
// that rate.  Design:
//
// * Grid: column strips of BN = 64 x K slices x M chunks of MB rows.  The
//   wrapper's stream_plan sizes the K slices (multiples of KSTEP = 16 rows)
//   so that every serving shape gives at least 2 blocks per SM.
// * Weight stream: the planes stay in the record's layout, [NP, K, N] int8
//   row-major.  Each block streams its slice through a ring of 8 / NP
//   stages of BK = 64 rows x 64 columns per plane with 16-byte cp.async
//   loads along N (a plain byte path where N is not a multiple of 16 or
//   at a ragged edge, zero outside the slice).  Rows are padded to 80
//   bytes, so a warp's word reads hit 32 distinct banks.
// * Each thread owns 4 columns and one 4-row k word of each stage: it
//   reads the 4 x 4 byte block of each plane as 4 words, transposes it
//   with __byte_perm into one __dp4a word per column, and accumulates
//   acc += dp4a(Xq, P0) + dp4a(Xq, P1) * 16 for each of its MB rows (one
//   int32 sum per row and column: both planes in the same pass).
// * X: each block quantizes its own K slice of its rows into shared memory
//   (the oracle's __fdiv_rn and rintf; int8 X is copied as it is), while
//   its first stages load; Xq never goes to HBM.
// * Split-K: the 16 k lanes of a column are summed by a shuffle and through
//   shared memory; with one slice the block applies the epilogue itself.
//   Otherwise it adds its int32 sums into a workspace [M, N] with atomics
//   (exact in any order), and the last block of each (strip, M chunk),
//   found by a ticket counter, reads the totals back with atomicExch (which
//   leaves them zero), applies the epilogue and resets its ticket: one
//   launch per call, and the caller's workspace (zeroed once, when it is
//   allocated) is zero again for the next call on the same stream.
#pragma once

#include "int8_tile.cuh"

namespace ent_stream {

using ent_mm::OUT_BF16;
using ent_mm::OUT_F32;
using ent_mm::OUT_I32;

constexpr int THREADS = 256;
constexpr int BN = 64;          // columns of a strip
constexpr int BK = 64;          // k rows of a stage
constexpr int ROW = BN + 16;    // padded shared row, bytes
// stages of the ring: 4 at two planes, 8 at one, so that a ring holds the
// same 40 KB in flight at both
template <int NP>
constexpr int STAGES = 8 / NP;
constexpr int KSTEP = 16;       // the K slices are multiples of KSTEP rows
constexpr int CG = BN / 4;      // column groups of 4 (threads per k word)
static_assert(THREADS == CG * (BK / 4), "one k word and one column group per thread");

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows r0..r3 (4 columns each, column j in byte j) -> col[j]: column j's
// 4 rows, row i in byte i
__device__ __forceinline__ void transpose4(unsigned r0, unsigned r1, unsigned r2, unsigned r3,
                                           unsigned (&col)[4]) {
  const unsigned t0 = __byte_perm(r0, r1, 0x5140), t1 = __byte_perm(r0, r1, 0x7362);
  const unsigned t2 = __byte_perm(r2, r3, 0x5140), t3 = __byte_perm(r2, r3, 0x7362);
  col[0] = __byte_perm(t0, t2, 0x5410);
  col[1] = __byte_perm(t0, t2, 0x7632);
  col[2] = __byte_perm(t1, t3, 0x5410);
  col[3] = __byte_perm(t1, t3, 0x7632);
}

template <int NP>
__host__ __device__ constexpr int ring_bytes() {
  return STAGES<NP> * NP * BK * ROW;
}

template <typename XT, int NP, int SHIFT, int MB, typename OT>
__global__ void __launch_bounds__(THREADS)
stream_kernel(const XT* __restrict__ x, const int8_t* __restrict__ planes,
              const float* __restrict__ sx, const float* __restrict__ sw,
              OT* __restrict__ out, int* __restrict__ ws, int* __restrict__ tickets, int M,
              int N, int K, int kslice, int vec) {
  static_assert(8 * MB * BN * 4 <= ring_bytes<NP>(), "the k-lane sums fit in the ring");
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int last;
  uint8_t* ring = smem;                                        // [STAGES<NP>][NP][BK][ROW]
  int* xs = reinterpret_cast<int*>(smem + ring_bytes<NP>());   // [MB][XW]
  const int XW = (kslice + BK - 1) / BK * (BK / 4);            // whole stages of k words
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int cg = tid % CG, kw = tid / CG;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.z * MB;
  const int k0 = blockIdx.y * kslice, kend = min(k0 + kslice, K);
  const int nst = (kend - k0 + BK - 1) / BK;
  const size_t pstride = static_cast<size_t>(K) * N;

  auto load_stage = [&](int i) {
    uint8_t* buf = ring + (i % STAGES<NP>) * NP * BK * ROW;
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const int q = tid + j * THREADS;                // chunk: plane, row, 16 columns
      const int p = q / (BK * BN / 16), r = q % (BK * BN / 16) / (BN / 16), c = q % (BN / 16);
      const int k = k0 + i * BK + r, n = n0 + 16 * c;
      uint8_t* dst = buf + (p * BK + r) * ROW + 16 * c;
      const int8_t* src = planes + p * pstride + static_cast<size_t>(k) * N + n;
      if (vec && k < kend && n < N) {
        cp_async16(dst, src);
      } else {   // unaligned N or outside the slice: bytes, zeros outside
        unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int b = 0; b < 16; ++b)
          if (k < kend && n + b < N)
            w[b / 4] |= (static_cast<unsigned>(src[b]) & 0xffu) << (8 * (b % 4));
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  };

#pragma unroll
  for (int i = 0; i < STAGES<NP> - 1; ++i) {
    if (i < nst) load_stage(i);
    cp_commit();
  }
  // this block's K slice of its rows, quantized while the first stages load
  for (int idx = tid; idx < MB * XW; idx += THREADS) {
    const int mm = idx / XW, w = idx % XW, m = m0 + mm;
    unsigned packed = 0;
    if (m < M) {
      const float s = sx[m];
      const XT* row = x + static_cast<size_t>(m) * K;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int k = k0 + 4 * w + t;
        if (k < kend) packed |= ent_mm::x_byte(row[k], s) << (8 * t);
      }
    }
    xs[idx] = static_cast<int>(packed);
  }

  int acc[MB][4];
#pragma unroll
  for (int mm = 0; mm < MB; ++mm)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[mm][c] = 0;

  for (int i = 0; i < nst; ++i) {
    cp_wait<STAGES<NP> - 2>();
    __syncthreads();   // stage i landed (and xs written); stage i - 1 consumed
    if (i + STAGES<NP> - 1 < nst) load_stage(i + STAGES<NP> - 1);
    cp_commit();
    const uint8_t* buf = ring + (i % STAGES<NP>) * NP * BK * ROW + 4 * kw * ROW + 4 * cg;
    unsigned col[NP][4];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const uint8_t* b = buf + p * BK * ROW;
      transpose4(*reinterpret_cast<const unsigned*>(b),
                 *reinterpret_cast<const unsigned*>(b + ROW),
                 *reinterpret_cast<const unsigned*>(b + 2 * ROW),
                 *reinterpret_cast<const unsigned*>(b + 3 * ROW), col[p]);
    }
#pragma unroll
    for (int mm = 0; mm < MB; ++mm) {
      const int xw = xs[mm * XW + i * (BK / 4) + kw];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        int a = __dp4a(xw, static_cast<int>(col[0][c]), acc[mm][c]);
#pragma unroll
        for (int p = 1; p < NP; ++p)
          a += __dp4a(xw, static_cast<int>(col[p][c]), 0) * (1 << (SHIFT * p));
        acc[mm][c] = a;
      }
    }
  }
  cp_wait<0>();
  __syncthreads();   // the ring is free: it holds the k lanes' sums now

  // sum the 16 k lanes of each column: lanes l and l + 16 by a shuffle, then
  // the 8 warps through shared memory
  int* red = reinterpret_cast<int*>(smem);   // [8][MB][BN]
#pragma unroll
  for (int mm = 0; mm < MB; ++mm)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc[mm][c] += __shfl_xor_sync(0xffffffffu, acc[mm][c], 16);
      if (lane < 16) red[(warp * MB + mm) * BN + 4 * cg + c] = acc[mm][c];
    }
  __syncthreads();

  const bool split = gridDim.y > 1;
  for (int o = tid; o < MB * BN; o += THREADS) {
    const int mm = o / BN, m = m0 + mm, n = n0 + o % BN;
    int v = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) v += red[(w * MB + mm) * BN + o % BN];
    if (m >= M || n >= N) continue;
    if (split) atomicAdd(ws + static_cast<size_t>(m) * N + n, v);
    else ent_mm::store(out + static_cast<size_t>(m) * N + n, v, sx[m], sw[n]);
  }
  if (!split) return;

  // the last block of this (strip, M chunk) applies the epilogue
  __threadfence();
  __syncthreads();
  const int strip = blockIdx.z * gridDim.x + blockIdx.x;
  if (tid == 0) last = atomicAdd(tickets + strip, 1) == static_cast<int>(gridDim.y) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int o = tid; o < MB * BN; o += THREADS) {
    const int m = m0 + o / BN, n = n0 + o % BN;
    if (m >= M || n >= N) continue;
    const int v = atomicExch(ws + static_cast<size_t>(m) * N + n, 0);
    ent_mm::store(out + static_cast<size_t>(m) * N + n, v, sx[m], sw[n]);
  }
  if (tid == 0) tickets[strip] = 0;
}

// Dynamic shared memory of a block of mb rows and a K slice of kslice rows:
// the ring, then the block's Xq words (whole stages of them).
template <int NP>
int smem_bytes(int mb, int kslice) {
  return ring_bytes<NP>() + mb * ((kslice + BK - 1) / BK * (BK / 4)) * 4;
}

template <typename XT, int NP, int SHIFT, int MB, typename OT>
int launch_typed(const XT* x, const int8_t* planes, const float* sx, const float* sw, OT* out,
                 int* ws, int* tickets, int M, int N, int K, int kslice, int splits, int vec,
                 cudaStream_t st) {
  const int smem = smem_bytes<NP>(MB, kslice);
  auto kernel = stream_kernel<XT, NP, SHIFT, MB, OT>;
  if (smem + 1024 > 48 * 1024) {   // the static `last` counts against the default 48 KB
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((N + BN - 1) / BN, splits, (M + MB - 1) / MB);
  kernel<<<grid, THREADS, smem, st>>>(x, planes, sx, sw, out, ws, tickets, M, N, K, kslice, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT, int NP, int SHIFT, int MB>
int launch_mb(const XT* x, const int8_t* planes, const float* sx, const float* sw, void* out,
              int out_kind, int* ws, int* tickets, int M, int N, int K, int kslice, int splits,
              int vec, cudaStream_t st) {
  switch (out_kind) {
    case OUT_F32:
      return launch_typed<XT, NP, SHIFT, MB>(x, planes, sx, sw, static_cast<float*>(out), ws,
                                             tickets, M, N, K, kslice, splits, vec, st);
    case OUT_BF16:
      return launch_typed<XT, NP, SHIFT, MB>(x, planes, sx, sw,
                                             static_cast<__nv_bfloat16*>(out), ws, tickets, M,
                                             N, K, kslice, splits, vec, st);
    case OUT_I32:
      return launch_typed<XT, NP, SHIFT, MB>(x, planes, sx, sw, static_cast<int*>(out), ws,
                                             tickets, M, N, K, kslice, splits, vec, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The plan (mb rows a block, kslice rows a K slice, splits slices) comes
// from the wrapper's stream_plan; it is checked here.  With splits > 1, ws
// is a zeroed int32 workspace of ws_len >= M N ints and tickets n_tickets
// zeroed ints, at least one per (strip of BN columns, M chunk of mb rows).
template <typename XT, int NP, int SHIFT>
int launch(const XT* x, const int8_t* planes, const float* sx, const float* sw, void* out,
           int out_kind, int* ws, long long ws_len, int* tickets, int n_tickets, int M, int N,
           int K, int mb, int kslice, int splits, cudaStream_t st) {
  if (mb <= 0 || kslice <= 0 || kslice % KSTEP || splits != (K + kslice - 1) / kslice)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long strips = static_cast<long long>((N + BN - 1) / BN) * ((M + mb - 1) / mb);
  if (splits > 1 && (ws == nullptr || tickets == nullptr ||
                     ws_len < static_cast<long long>(M) * N || n_tickets < strips))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = N % 16 == 0 && reinterpret_cast<uintptr_t>(planes) % 16 == 0;
  switch (mb) {
    case 4:
      return launch_mb<XT, NP, SHIFT, 4>(x, planes, sx, sw, out, out_kind, ws, tickets, M, N,
                                         K, kslice, splits, vec, st);
    case 8:
      return launch_mb<XT, NP, SHIFT, 8>(x, planes, sx, sw, out, out_kind, ws, tickets, M, N,
                                         K, kslice, splits, vec, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace ent_stream
