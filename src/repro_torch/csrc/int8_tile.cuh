// The CUDA-core int8 tile loop, parameterised by the X prologue, the
// number of weight planes and the shift that combines them:
//
//   Xq  = X (int8), or clip(rint(X / sx), -127, 127) from f32/bf16 X
//   acc = sum_i (Xq @ P_i) * 2^(SHIFT * i)       (int32, exact)
//   out = (float(acc) * sx) * sw  in f32 or bf16, or acc itself (int32)
//
// It serves kernels 4 (ent_matmul_packed: 2 packed planes in [-10, 10],
// shift 4, int8 X) and 5 (ent_matmul, the legacy 4 digit planes in
// {-2..2}, shift 2), which no serving or training path launches.
// Kernels 1 (ent_matmul_packed_fused) and 6 (int8_matmul) take the
// split-K stream (int8_stream.cuh) at decode and the int8 tensor-core
// loop (int8_tc.cuh) above it; they keep an entry into this loop only
// for chip_smoke.py to time it beside them.  The quantize / x_byte /
// store helpers and the output kinds here are shared by all three loops.
//
// Quantization divides (IEEE __fdiv_rn) and rounds half to even (rintf),
// exactly like the plain version quantize_rows (ref.py); integer
// accumulation is order-free (two's complement wraps identically in any
// order), and the epilogue multiplies in the reference's order, so each
// result is bit-identical to its plain version.  The bf16 store rounds
// to nearest even, as torch's float32 -> bfloat16 cast does.
//
// What bounds it on the H100: at decode (M = 8 slots) the planes are read
// once per call, NP*K*N bytes against ~2*NP*M*K*N int8 ops, far below
// the card's ops/byte balance, so memory bandwidth bounds it; at M = 512
// the int8 operations do.  Design (simple first): 64x64 output tiles,
// 256 threads, each thread owns 4x4 outputs for every plane; per 64-deep
// k step the block loads (and, fused, quantizes) its X tile and packs 4
// consecutive k of X and of each plane column into 32-bit words in
// shared memory, then __dp4a accumulates 4 int8 products per instruction
// into int32.  Ragged M, N and K edges are masked (zero-filled) in the
// loads.  The planes stream from HBM once per row tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ent_mm {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 64;          // int8 elements per k step
constexpr int KW = BK / 4;      // 32-bit words per k step
constexpr int THREADS = 256;

// output kinds of the C entry points (0: f32, 1: bf16, 2: int32 acc)
enum OutKind { OUT_F32 = 0, OUT_BF16 = 1, OUT_I32 = 2 };

__device__ __forceinline__ unsigned quantize(float x, float s) {
  float q = rintf(__fdiv_rn(x, s));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<unsigned>(static_cast<int>(q)) & 0xffu;
}

// one X element as an int8 byte: as stored, or quantized against sx
__device__ __forceinline__ unsigned x_byte(int8_t v, float) {
  return static_cast<unsigned>(v) & 0xffu;
}
__device__ __forceinline__ unsigned x_byte(float v, float s) { return quantize(v, s); }
__device__ __forceinline__ unsigned x_byte(__nv_bfloat16 v, float s) {
  return quantize(__bfloat162float(v), s);
}

__device__ __forceinline__ void store(float* o, int acc, float s, float w) {
  *o = __fmul_rn(__fmul_rn(__int2float_rn(acc), s), w);
}
__device__ __forceinline__ void store(__nv_bfloat16* o, int acc, float s, float w) {
  *o = __float2bfloat16_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), s), w));
}
__device__ __forceinline__ void store(int* o, int acc, float, float) { *o = acc; }

template <typename XT, int NP, int SHIFT, typename OT>
__global__ void __launch_bounds__(THREADS)
tile_matmul_kernel(const XT* __restrict__ x, const int8_t* __restrict__ planes,
                   const float* __restrict__ sx, const float* __restrict__ sw,
                   OT* __restrict__ out, int M, int N, int K) {
  __shared__ int xs[BM][KW + 1];
  __shared__ int ps[NP][KW][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const size_t plane_stride = static_cast<size_t>(K) * N;

  int acc[NP][4][4];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[p][i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // X tile: (quantize and) pack 4 consecutive k per word
    for (int w = tid; w < BM * KW; w += THREADS) {
      const int r = w / KW, c = w % KW, m = m0 + r;
      unsigned packed = 0;
      if (m < M) {
        const float s = sx[m];
        const XT* row = x + static_cast<size_t>(m) * K;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int k = k0 + c * 4 + t;
          if (k < K) packed |= x_byte(row[k], s) << (8 * t);
        }
      }
      xs[r][c] = static_cast<int>(packed);
    }
    // plane tiles: pack 4 consecutive k of one column n per word
    for (int w = tid; w < NP * KW * BN; w += THREADS) {
      const int pl = w / (KW * BN), rem = w % (KW * BN);
      const int c = rem / BN, nn = rem % BN, n = n0 + nn;
      unsigned packed = 0;
      if (n < N) {
        const int8_t* col = planes + pl * plane_stride + n;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int k = k0 + c * 4 + t;
          if (k < K)
            packed |= (static_cast<unsigned>(col[static_cast<size_t>(k) * N]) & 0xffu)
                      << (8 * t);
        }
      }
      ps[pl][c][nn] = static_cast<int>(packed);
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < KW; ++c) {
      int a[4], b[NP][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[ty + 16 * i][c];
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int j = 0; j < 4; ++j) b[p][j] = ps[p][c][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int p = 0; p < NP; ++p) acc[p][i][j] = __dp4a(a[i], b[p][j], acc[p][i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
    const float s = sx[m];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      int total = acc[0][i][j];
#pragma unroll
      for (int p = 1; p < NP; ++p) total += acc[p][i][j] * (1 << (SHIFT * p));
      store(out + static_cast<size_t>(m) * N + n, total, s, sw[n]);
    }
  }
}

template <typename XT, int NP, int SHIFT>
int launch(const XT* x, const int8_t* planes, const float* sx, const float* sw,
           void* out, int out_kind, int M, int N, int K, cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  switch (out_kind) {
    case OUT_F32:
      tile_matmul_kernel<XT, NP, SHIFT, float><<<grid, THREADS, 0, st>>>(
          x, planes, sx, sw, static_cast<float*>(out), M, N, K);
      break;
    case OUT_BF16:
      tile_matmul_kernel<XT, NP, SHIFT, __nv_bfloat16><<<grid, THREADS, 0, st>>>(
          x, planes, sx, sw, static_cast<__nv_bfloat16*>(out), M, N, K);
      break;
    case OUT_I32:
      tile_matmul_kernel<XT, NP, SHIFT, int><<<grid, THREADS, 0, st>>>(
          x, planes, sx, sw, static_cast<int*>(out), M, N, K);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ent_mm
