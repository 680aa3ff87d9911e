// The int8 tensor-core tile loop: kernels 1 (ent_matmul_packed_fused, two
// packed planes, f32 / bf16 X quantized in the kernel), 4
// (ent_matmul_packed, two packed planes, int8 X), 5 (ent_matmul, four
// digit planes, int8 X) and 6 (int8_matmul, one plane, int8 X) at prefill
// sizes of M, above each wrapper's cut (smaller M takes the split-K stream
// of int8_stream.cuh).  There it replaces the Pallas TPU kernels
// ent_matmul_packed_fused (src/repro/kernels/ent_matmul/ent_matmul.py:227),
// ent_matmul_packed (:205), ent_matmul (:75) and int8_matmul
// (src/repro/kernels/int8_matmul/int8_matmul.py:47), and computes
//
//   Xq  = X (int8), or clip(rint(X / sx), -127, 127) from f32/bf16 X
//   acc = sum_i (Xq @ P_i) * 2^(SHIFT * i)       (int32, exact)
//   out = (float(acc) * sx) * sw  in f32 or bf16, or acc itself (int32)
//
// with the quantize / store helpers of int8_common.cuh; wgmma's s8 x s8 ->
// s32 sums are exact in any order, so each result is bit-identical to the
// plain version (ref.py).
//
// What bounds it on the H100: at M = 512, K = 2048, N = 11008, kernel 1's
// 2 planes x 2 M K N int8 operations take 0.0233 ms at 1,979 TOP/s (kernel
// 4's the same, kernel 5's 4 planes 0.0466 ms), and kernel 6 moves 46 MB
// (X, W, f32 out), 0.0138 ms at 3.35 TB/s.  Design:
//
// * Products: wgmma m64n128k32 s8.s8 -> s32 with A and B from shared
//   memory.  A block of 256 threads (two warpgroups) owns BM = 128 rows x
//   BN = 128 columns; warpgroup w multiplies rows 64 w .. 64 w + 63.  Each
//   plane has its own accumulator set (2 x 64 registers a thread at NP =
//   2), combined as acc0 + acc1 * 16 in the epilogue: exact for every plane
//   code, where a decoded P0 + 16 P1 weight leaves int8 for codes that do
//   not encode an int8 weight.  At NP = 4 four sets would pass ptxas's 255
//   registers a thread, so a block owns 64 rows (bm<4>) and the
//   warpgroups split the planes instead: warpgroup w multiplies all 64
//   rows by planes 2 w and 2 w + 1, and warpgroup 1's part of the sum
//   reaches warpgroup 0 through shared memory before the store.
// * Why B is transposed in shared memory: 8-bit wgmma reads A and B only
//   K-major.  Xq [M, K] is K-major as it stands; the planes are [NP, K, N]
//   with N contiguous (the records' layout, bit-equal to the reference's
//   and read as it is by the stream; a second, K-major copy would add the
//   planes' bytes again), so each 128 x 128 plane tile is rewritten K-major
//   on its way in: every thread reads 4 k rows x 16 columns of a plane
//   tile, transposes the 4 x 4 byte blocks with __byte_perm and stores 16
//   k-words into the 128-byte-swizzled operand tile (a warp's lanes on the
//   32 k-words of one column, and the raw tile's 16-byte chunks rotated by
//   k row / 4: no bank conflict either way).
// * Loads: 16-byte cp.async into a ring of raw steps in shared memory (4
//   slots with int8 X at one plane, 3 with int8 X at two, 2 with bf16, 1
//   with f32 X or with four planes: what fits beside two converted stages,
//   ring_slots), a slot refilled as soon as it is free.  Loads into
//   registers a step ahead stalled: every wgmma fence waits for them.
// * Four planes (kernel 5): one slot, which holds only the planes; int8 X
//   lands directly in the converted stage as its A tile.  While step i's
//   wgmmas run, step i + 1 is converted and step i + 2's planes load into
//   the freed slot; step i + 2's X follows into step i's stage once its
//   wgmmas are done.
// * X: int8 X lands in the ring already in the swizzled A layout and is
//   the wgmma's A operand there, for every plane's accumulator set (at two
//   planes, kernel 4, both wgmmas of a k32 step read the same A rows of the
//   slot), which is refilled only after the step's wgmmas retire.  f32 /
//   bf16 X is quantized from the ring into the converted stage's A tile, so
//   Xq never goes to HBM.  Each X element is quantized once in every
//   128-column tile, so the oracle's IEEE division (__fdiv_rn, then rintf)
//   becomes a branch-free multiply by the row's reciprocal, with the
//   division redone for the rare word within 2^-13 of a rounding boundary
//   (quantize_r): bit-equal, cheaper.
// * Pipeline: while the wgmmas of step i run, the threads convert step
//   i + 1 into the other converted stage.
// * Split-K: where the (M, N) tiles would leave more than half the SMs
//   idle, the wrapper's tc_plan cuts K into slices of whole 128-deep steps;
//   the slices' int32 sums meet in the stream's zeroed workspace by atomics
//   and the last block of each tile, found by a ticket, applies the
//   epilogue and leaves the workspace zero, as in int8_stream.cuh.
// * Ragged shapes: 16-byte loads where N % 16 (planes), K % 16 (int8 X),
//   K % 4 / K % 8 (f32 / bf16 X) and 16-byte-aligned bases allow them, a
//   byte / element path elsewhere; zeros past N and the K slice.  Rows
//   past M are neither loaded nor stored.
#pragma once

#include <type_traits>

#include "int8_stream.cuh"
#include "sm90.cuh"

namespace ent_tc {

using ent_mm::OUT_BF16;
using ent_mm::OUT_F32;
using ent_mm::OUT_I32;

constexpr int THREADS = 256;    // two warpgroups: both convert, both multiply
constexpr int BM = 128;         // rows of a block, 64 a warpgroup
constexpr int BN = 128;         // columns of a block
constexpr int BK = 128;         // k of a step: one 128-byte swizzled row
constexpr int TILE = 128 * 128; // bytes of one plane's B tile (and of a 128-row A tile)

template <typename XT>
constexpr bool int8_x = std::is_same<XT, int8_t>::value;

// Rows of a block: 128, 64 a warpgroup; 64 at four planes, where the two
// warpgroups take two planes each of the same rows (four 64-register
// accumulator sets a thread do not fit ptxas's 255 registers).
template <int NP>
__host__ __device__ constexpr int bm() {
  return NP > 2 ? 64 : BM;
}
// int8 X lands in the converted stage, not the ring, at four planes
template <typename XT, int NP>
__host__ __device__ constexpr bool x_in_stage() {
  return int8_x<XT> && NP > 2;
}
template <typename XT, int NP>
__host__ __device__ constexpr int x_bytes() {
  return bm<NP>() * BK * static_cast<int>(sizeof(XT));
}
// The ring of raw steps, filled by cp.async: a slot holds one step's X
// tile (int8 X: already the swizzled A operand; none at four planes) and
// its NP plane tiles as stored (N contiguous; 16-byte chunk c of k row r at
// chunk c ^ (r / 4 % 8), so that the transposing reads hit distinct banks).
template <typename XT, int NP>
__host__ __device__ constexpr int slot_x() {
  return x_in_stage<XT, NP>() ? 0 : x_bytes<XT, NP>();
}
template <typename XT, int NP>
__host__ __device__ constexpr int slot_bytes() {
  return slot_x<XT, NP>() + NP * TILE;
}
// one converted stage: the int8 A tile (quantized from f32 / bf16 X, or
// int8 X at four planes; none for int8 X otherwise), then the NP K-major B
// tiles
template <typename XT, int NP>
__host__ __device__ constexpr int a_bytes() {
  return int8_x<XT> && !x_in_stage<XT, NP>() ? 0 : bm<NP>() * BK;
}
template <typename XT, int NP>
__host__ __device__ constexpr int stage_bytes() {
  return a_bytes<XT, NP>() + NP * TILE;
}
// shared memory a block may use on the H100 (232,448 bytes), less the
// static `last`
constexpr int SMEM_MAX = 232448 - 16;
// dynamic shared memory beside the ring: two converted stages, the rows'
// 1 / sx (f32 / bf16 X), and alignment slack (the swizzled tiles sit on
// 1024-byte boundaries)
template <typename XT, int NP>
__host__ __device__ constexpr int fixed_bytes() {
  return 2 * stage_bytes<XT, NP>() + (int8_x<XT> ? 0 : 4 * bm<NP>()) + 1024;
}
// slots of the ring: as many as fit, at most 4 (int8 X at one plane: 4;
// int8 X at two planes: 3; bf16 X: 2; f32 X, and four planes: 1)
template <typename XT, int NP>
__host__ __device__ constexpr int ring_slots() {
  int s = 4;
  while (s > 1 && fixed_bytes<XT, NP>() + s * slot_bytes<XT, NP>() > SMEM_MAX) --s;
  return s;
}
template <typename XT, int NP>
__host__ __device__ constexpr int smem_bytes() {
  return fixed_bytes<XT, NP>() + ring_slots<XT, NP>() * slot_bytes<XT, NP>();
}

// clip(rint(X / sx), -127, 127) from r = 1 / sx rounded (__frcp_rn), as
// the low byte of the result: y = X r lies within 2^-22 |X / sx| of the
// correctly rounded quotient fl(X / sx) (two roundings of 2^-24 each
// against one), so rint(y) = rint(fl(X / sx)) unless a half-integer lies
// that close to y.  Clipped to [-127, 127] first (it commutes with rint
// there, and NaN clips to -127 as in ent_mm::quantize), |y| <= 127, so a
// margin of 2^-13 covers it: `exact` is cleared within it, and those words
// are quantized again with the IEEE division.  The bound needs r finite: for
// 0 < sx < 1 / FLT_MAX, r overflows to inf (0 * inf is NaN, any small X
// clips to 127) where the division gives finite quotients, so a row whose r
// is not finite starts with `exact` cleared.  rint rides on the float
// adder: y + 1.5 2^23 rounds y to an integer, ties to even, and holds it in
// its low mantissa bits.  Branch-free, off the conversion unit.
constexpr float RINT_MAGIC = 12582912.0f;   // 1.5 * 2^23, bits 0x4B400000
__device__ __forceinline__ unsigned quantize_r(float x, float r, bool& exact) {
  const float y = fminf(fmaxf(__fmul_rn(x, r), -127.0f), 127.0f);
  const float t = __fadd_rn(y, RINT_MAGIC);
  exact &= fabsf(__fsub_rn(y, __fsub_rn(t, RINT_MAGIC))) < 0.5f - 0x1p-13f;
  return __float_as_uint(t);
}

// 4 consecutive X elements as floats
__device__ __forceinline__ void load4(const float* v, float (&f)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(v);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* v, float (&f)[4]) {
  const uint2 a = *reinterpret_cast<const uint2*>(v);
  f[0] = __uint_as_float(a.x << 16), f[1] = __uint_as_float(a.x & 0xffff0000u);
  f[2] = __uint_as_float(a.y << 16), f[3] = __uint_as_float(a.y & 0xffff0000u);
}

__device__ __forceinline__ unsigned word(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// A step's wgmmas: A from a_tile (the warpgroup's rows), B the warpgroup's
// WP planes from b0 on (TILE bytes apart), a k32 step at a time.
template <int WP>
__device__ __forceinline__ void multiply(int (&acc)[WP][64], const uint8_t* a_tile,
                                         const uint8_t* b0) {
  using namespace sm90;
  wgmma_fence();
#pragma unroll
  for (int p = 0; p < WP; ++p) fence_regs(acc[p]);
#pragma unroll
  for (int kk = 0; kk < BK / 32; ++kk)
#pragma unroll
    for (int p = 0; p < WP; ++p)
      wgmma_s8_n128(acc[p], desc(a_tile + 32 * kk), desc(b0 + p * TILE + 32 * kk));
  wgmma_commit();
}
template <int WP>
__device__ __forceinline__ void retire(int (&acc)[WP][64]) {
  sm90::wgmma_wait();
#pragma unroll
  for (int p = 0; p < WP; ++p) sm90::fence_regs(acc[p]);
}

template <typename XT, int NP, int SHIFT, typename OT>
__global__ void __launch_bounds__(THREADS, 1)
tc_kernel(const XT* __restrict__ x, const int8_t* __restrict__ planes,
          const float* __restrict__ sx, const float* __restrict__ sw, OT* __restrict__ out,
          int* __restrict__ ws, int* __restrict__ tickets, int M, int N, int K, int kslice,
          int vec_w, int vec_x) {
  using namespace sm90;
  constexpr int S = ring_slots<XT, NP>();
  constexpr int R = bm<NP>();              // rows of the block
  constexpr int WP = NP * R / BM;          // planes a warpgroup multiplies
  constexpr bool XS = x_in_stage<XT, NP>();
  static_assert(!int8_x<XT> || XS || S >= 2, "int8 X in the ring needs two slots");
  extern __shared__ uint8_t smem_raw[];
  __shared__ int last;
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = smem + 2 * stage_bytes<XT, NP>();
  float* rrow = reinterpret_cast<float*>(ring + S * slot_bytes<XT, NP>());   // [R] 1 / sx
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wg = tid / 128;
  const int wrow0 = R == BM ? 64 * wg : 0, pofs = R == BM ? 0 : WP * wg;
  const int m0 = blockIdx.x * R, n0 = blockIdx.y * BN;
  const int k0 = blockIdx.z * kslice, kend = min(k0 + kslice, K);
  const int nst = (kend - k0 + BK - 1) / BK;
  const size_t pstride = static_cast<size_t>(K) * N;
  auto stage = [&](int i) { return smem + (i & 1) * stage_bytes<XT, NP>(); };
  auto slot = [&](int i) { return ring + (i % S) * slot_bytes<XT, NP>(); };
  auto b_tile = [&](uint8_t* st, int p) { return st + a_bytes<XT, NP>() + p * TILE; };

  // Step i's plane tiles into its ring slot: 16-byte cp.async where the
  // chunk is whole and aligned, else bytes (zeros outside the slice and
  // past N).
  // this thread's chunks inside a step (k row tid / 8 + 32 j, columns
  // 16 (tid % 8) of each plane) as offsets from the step's corner, for
  // whole steps
  const uint32_t b_dst = (tid / 8) * 128 + (((tid % 8) ^ warp) << 4);
  const size_t b_src = static_cast<size_t>(tid / 8) * N + 16 * (tid % 8);
  auto load_planes = [&](int i) {
    uint8_t* sl = slot(i) + slot_x<XT, NP>();
    const int kb = k0 + i * BK;
    if (vec_w && kb + BK <= kend && n0 + BN <= N) {   // a whole step: no checks
      const int8_t* src = planes + static_cast<size_t>(kb) * N + n0 + b_src;
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          ent_stream::cp_async16(sl + p * TILE + b_dst + 32 * 128 * j,
                                 src + p * pstride + static_cast<size_t>(32 * j) * N);
      return;
    }
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int j = 0; j < 4; ++j) {   // 1024 chunks a plane: k row q / 8, columns 16 (q % 8)
        const int q = tid + THREADS * j, r = q / 8, c = q % 8, k = kb + r, n = n0 + 16 * c;
        uint8_t* dst = sl + p * TILE + r * 128 + ((c ^ (r / 4 % 8)) << 4);
        const int8_t* src = planes + p * pstride + static_cast<size_t>(k) * N + n;
        if (vec_w && k < kend && n < N) {
          ent_stream::cp_async16(dst, src);
        } else {
          unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int b = 0; b < 16; ++b)
            if (k < kend && n + b < N)
              w[b / 4] |= (static_cast<unsigned>(src[b]) & 0xffu) << (8 * (b % 4));
          *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
  };

  // Step i's X tile to `dst` (its ring slot, or at four planes its stage's
  // A tile): int8 X in the swizzled A layout, f32 / bf16 X row-major.
  // Rows past M are not loaded: their outputs are not stored.
  constexpr int EPC = 16 / static_cast<int>(sizeof(XT)), CPR = BK / EPC;
  // this thread's chunks (X row tid / CPR + (256 / CPR) j, chunk tid % CPR)
  const uint32_t x_dst = int8_x<XT> ? sw128(tid / CPR, tid % CPR)
                                    : (tid / CPR * BK + tid % CPR * EPC) * sizeof(XT);
  const size_t x_src = static_cast<size_t>(tid / CPR) * K + tid % CPR * EPC;
  auto load_x = [&](int i, uint8_t* xt) {
    const int kb = k0 + i * BK;
    if (vec_x && kb + BK <= kend && m0 + R <= M) {   // a whole step of rows
      const XT* src = x + static_cast<size_t>(m0) * K + kb + x_src;
      constexpr int ROWS = THREADS / CPR;   // rows a pass of the block
#pragma unroll
      for (int j = 0; j < R / ROWS; ++j)
        ent_stream::cp_async16(xt + x_dst + ROWS * BK * sizeof(XT) * j,
                               src + static_cast<size_t>(ROWS * j) * K);
      return;
    }
    for (int q = tid; q < R * CPR; q += THREADS) {
      const int r = q / CPR, c = q % CPR, m = m0 + r, k = kb + c * EPC;
      if (m >= M) break;
      // int8 X: chunk c of row r in the swizzled A layout; else row-major
      uint8_t* dst = int8_x<XT> ? xt + sw128(r, c) : xt + (r * BK + c * EPC) * sizeof(XT);
      const XT* src = x + static_cast<size_t>(m) * K + k;
      if (vec_x && k < kend) {
        ent_stream::cp_async16(dst, src);
      } else {   // elements, zeros outside the slice
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
        XT* d = reinterpret_cast<XT*>(dst);
#pragma unroll
        for (int e = 0; e < EPC; ++e)
          if (k + e < kend) d[e] = src[e];
      }
    }
  };
  auto load_step = [&](int i) {   // X in the ring
    load_planes(i);
    load_x(i, slot(i));
  };

  // Step i from its ring slot into converted stage st: each thread reads 4
  // k rows (4 lane ..) x 16 columns (16 warp ..) of a plane, transposes the
  // 4 x 4 byte blocks, and stores column n's k-word `lane` into the
  // K-major tile; f32 / bf16 X is quantized against 1 / sx into the A tile
  // (k-word `lane` of rows warp + 8 j).
  auto convert = [&](int i, uint8_t* st) {
    const uint8_t* sl = slot(i);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const uint8_t* rb = sl + slot_x<XT, NP>() + p * TILE;
      uint4 w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)   // row 4 lane + r: its chunk `warp` sits at warp ^ (lane % 8)
        w[r] = *reinterpret_cast<const uint4*>(rb + (4 * lane + r) * 128 +
                                               ((warp ^ (lane % 8)) << 4));
      uint8_t* bt = b_tile(st, p);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        unsigned col[4];
        ent_stream::transpose4(word(w[0], q), word(w[1], q), word(w[2], q), word(w[3], q), col);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = 16 * warp + 4 * q + j;
          *reinterpret_cast<unsigned*>(bt + sw128(n, lane >> 2) + 4 * (lane & 3)) = col[j];
        }
      }
    }
    if constexpr (!int8_x<XT>) {
      const XT* rs = reinterpret_cast<const XT*>(sl);
      unsigned redo = 0;   // bit j: row warp + 8 j's word needs the division
#pragma unroll 4
      for (int j = 0; j < R / 8; ++j) {
        const int row = warp + 8 * j;
        unsigned packed = 0;   // rows past M: zeros
        if (m0 + row < M) {
          const float r = rrow[row];
          float v[4];
          load4(rs + row * BK + 4 * lane, v);
          bool exact = isfinite(r);
          const unsigned t0 = quantize_r(v[0], r, exact), t1 = quantize_r(v[1], r, exact);
          const unsigned t2 = quantize_r(v[2], r, exact), t3 = quantize_r(v[3], r, exact);
          packed = __byte_perm(__byte_perm(t0, t1, 0x0040), __byte_perm(t2, t3, 0x0040), 0x5410);
          redo |= static_cast<unsigned>(!exact) << j;
        }
        *reinterpret_cast<unsigned*>(st + sw128(row, lane >> 2) + 4 * (lane & 3)) = packed;
      }
      while (redo) {   // rare: a quotient within 2^-13 of a rounding boundary, or r not finite
        const int j = __ffs(redo) - 1, row = warp + 8 * j;
        redo &= redo - 1;
        const float s = sx[m0 + row];
        float v[4];
        load4(rs + row * BK + 4 * lane, v);
        unsigned packed = 0;
#pragma unroll
        for (int t = 0; t < 4; ++t) packed |= ent_mm::quantize(v[t], s) << (8 * t);
        *reinterpret_cast<unsigned*>(st + sw128(row, lane >> 2) + 4 * (lane & 3)) = packed;
      }
    }
  };

  int acc[WP][64];
#pragma unroll
  for (int p = 0; p < WP; ++p)
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[p][e] = 0;

  if constexpr (XS) {
    // Four planes, one slot of planes: step i + 1 converted and step i + 2's
    // planes loaded while step i's wgmmas run; step i + 2's X into stage i
    // once they are done.  One cp.async group a step.
    if (nst > 0) {
      load_planes(0);
      load_x(0, stage(0));
      ent_stream::cp_commit();
      ent_stream::cp_wait<0>();
      __syncthreads();
      convert(0, stage(0));
      __syncthreads();
      if (1 < nst) {
        load_planes(1);
        load_x(1, stage(1));
      }
      ent_stream::cp_commit();
    }
    fence_proxy_async();
    __syncthreads();
    for (int i = 0; i < nst; ++i) {
      uint8_t* cur = stage(i);
      multiply(acc, cur, b_tile(cur, pofs));
      if (i + 1 < nst) {
        ent_stream::cp_wait<0>();
        __syncthreads();   // step i + 1 landed: planes in the slot, X in its stage
        convert(i + 1, stage(i + 1));
        __syncthreads();   // the slot is free
        if (i + 2 < nst) load_planes(i + 2);
      }
      retire(acc);
      __syncthreads();     // both warpgroups are done with stage i
      if (i + 2 < nst) load_x(i + 2, cur);
      ent_stream::cp_commit();
      fence_proxy_async();
      __syncthreads();
    }
  } else {
    // Prologue: the rows' 1 / sx; steps 0 .. S - 1 in flight; step 0
    // converted.  A slot is refilled (step i + S) once it is free: with
    // f32 / bf16 X right after its conversion, with int8 X (the slot is the
    // A operand) after its step's wgmmas.  One cp.async group a step.
    if constexpr (!int8_x<XT>) {
      if (tid < R) rrow[tid] = m0 + tid < M ? __frcp_rn(sx[m0 + tid]) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < S; ++i) {
      if (i < nst) load_step(i);
      ent_stream::cp_commit();
    }
    if (nst > 0) {
      ent_stream::cp_wait<S - 1>();
      __syncthreads();
      convert(0, stage(0));
      if constexpr (!int8_x<XT>) {
        __syncthreads();
        if (S < nst) load_step(S);
        ent_stream::cp_commit();
      }
    }
    fence_proxy_async();
    __syncthreads();

    for (int i = 0; i < nst; ++i) {
      uint8_t* cur = stage(i);
      multiply(acc, (int8_x<XT> ? slot(i) : cur) + wrow0 * 128, b_tile(cur, pofs));
      // while they run: step i + 1 converted into the other stage
      if (i + 1 < nst) {
        if constexpr (int8_x<XT>) ent_stream::cp_wait<S - 2>();
        else ent_stream::cp_wait<S - 1>();
        __syncthreads();
        convert(i + 1, stage(i + 1));
        if constexpr (!int8_x<XT>) {
          __syncthreads();   // the slot is free: step i + 1 + S into it
          if (i + 1 + S < nst) load_step(i + 1 + S);
          ent_stream::cp_commit();
        }
      }
      retire(acc);
      fence_proxy_async();
      __syncthreads();
      if constexpr (int8_x<XT>) {   // step i's A is consumed: step i + S into its slot
        if (i + S < nst) load_step(i + S);
        ent_stream::cp_commit();
      }
    }
  }

  // epilogue: d[4 j + 2 i + c] is row 16 warp + lane / 4 + 8 i of the
  // warpgroup's 64, column 8 j + 2 (lane % 4) + c; the warpgroup's planes
  // summed into acc[0]
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    int total = acc[0][e] * (1 << (SHIFT * pofs));
#pragma unroll
    for (int p = 1; p < WP; ++p) total += acc[p][e] * (1 << (SHIFT * (pofs + p)));
    acc[0][e] = total;
  }
  if constexpr (R < BM) {   // warpgroup 1's planes 2, 3 to warpgroup 0 (the stages are free)
    int* part = reinterpret_cast<int*>(smem);   // [64][128]
    if (wg == 1) {
#pragma unroll
      for (int e = 0; e < 64; ++e) part[e * 128 + tid % 128] = acc[0][e];
    }
    __syncthreads();
    if (wg == 0) {
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[0][e] += part[e * 128 + tid];
    }
  }
  const bool split = gridDim.z > 1;
  const int g = lane / 4, t = lane % 4, wrow = m0 + wrow0 + 16 * (warp % 4) + g;
  if (R == BM || wg == 0) {
#pragma unroll
    for (int e = 0; e < 64; ++e) {
      const int m = wrow + 8 * ((e / 2) % 2), n = n0 + 8 * (e / 4) + 2 * t + e % 2;
      if (m >= M || n >= N) continue;
      if (split) atomicAdd(ws + static_cast<size_t>(m) * N + n, acc[0][e]);
      else ent_mm::store(out + static_cast<size_t>(m) * N + n, acc[0][e], sx[m], sw[n]);
    }
  }
  if (!split) return;

  // the last block of this (M, N) tile applies the epilogue; the ticket's
  // fences as in int8_stream.cuh's combine (see its header)
  __syncthreads();
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(tickets + tile, 1) == static_cast<int>(gridDim.z) - 1;
    if (last) __threadfence();
  }
  __syncthreads();
  if (!last) return;
  for (int o = tid; o < R * BN; o += THREADS) {
    const int m = m0 + o / BN, n = n0 + o % BN;
    if (m >= M || n >= N) continue;
    const int v = atomicExch(ws + static_cast<size_t>(m) * N + n, 0);
    ent_mm::store(out + static_cast<size_t>(m) * N + n, v, sx[m], sw[n]);
  }
  if (tid == 0) tickets[tile] = 0;
}

template <typename XT, int NP, int SHIFT, typename OT>
int launch_typed(const XT* x, const int8_t* planes, const float* sx, const float* sw, OT* out,
                 int* ws, int* tickets, int M, int N, int K, int kslice, int splits, int vec_w,
                 int vec_x, cudaStream_t st) {
  constexpr int smem = smem_bytes<XT, NP>();
  static_assert(smem <= SMEM_MAX, "the block's shared memory fits the H100's");
  auto kernel = tc_kernel<XT, NP, SHIFT, OT>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((M + bm<NP>() - 1) / bm<NP>(), (N + BN - 1) / BN, splits);
  kernel<<<grid, THREADS, smem, st>>>(x, planes, sx, sw, out, ws, tickets, M, N, K, kslice,
                                      vec_w, vec_x);
  return static_cast<int>(cudaGetLastError());
}

// The plan (kslice rows a K slice, a multiple of BK; splits slices) comes
// from the wrapper's tc_plan; it is checked here.  With splits > 1, ws is a
// zeroed int32 workspace of ws_len >= M N ints and tickets n_tickets zeroed
// ints, at least one per (bm<NP>() x BN) output tile.
template <typename XT, int NP, int SHIFT>
int launch(const XT* x, const int8_t* planes, const float* sx, const float* sw, void* out,
           int out_kind, int* ws, long long ws_len, int* tickets, int n_tickets, int M, int N,
           int K, int kslice, int splits, cudaStream_t st) {
  if (kslice <= 0 || kslice % BK || splits != (K > 0 ? (K + kslice - 1) / kslice : 1) ||
      (N + BN - 1) / BN > 65535 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles =
      static_cast<long long>((M + bm<NP>() - 1) / bm<NP>()) * ((N + BN - 1) / BN);
  if (splits > 1 && (ws == nullptr || tickets == nullptr ||
                     ws_len < static_cast<long long>(M) * N || n_tickets < tiles))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec_w = N % 16 == 0 && reinterpret_cast<uintptr_t>(planes) % 16 == 0;
  const int vec_x = K % (16 / static_cast<int>(sizeof(XT))) == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  switch (out_kind) {
    case OUT_F32:
      return launch_typed<XT, NP, SHIFT>(x, planes, sx, sw, static_cast<float*>(out), ws,
                                         tickets, M, N, K, kslice, splits, vec_w, vec_x, st);
    case OUT_BF16:
      return launch_typed<XT, NP, SHIFT>(x, planes, sx, sw, static_cast<__nv_bfloat16*>(out),
                                         ws, tickets, M, N, K, kslice, splits, vec_w, vec_x, st);
    case OUT_I32:
      return launch_typed<XT, NP, SHIFT>(x, planes, sx, sw, static_cast<int*>(out), ws,
                                         tickets, M, N, K, kslice, splits, vec_w, vec_x, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace ent_tc
