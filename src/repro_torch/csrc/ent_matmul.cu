// Packed fused EN-T matmul for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel ent_matmul_packed_fused
// (src/repro/kernels/ent_matmul/ent_matmul.py:227, body
// _packed_fused_kernel :147).  Computes, for X [M, K] (f32 or bf16),
// packed EN-T planes P [2, K, N] int8 in [-10, 10], per-row scale
// sx [M, 1] and per-channel scale sw [1, N]:
//
//   Xq  = clip(rint(X / sx), -127, 127)          (int8, never in HBM)
//   acc = Xq @ P0 + (Xq @ P1) * 16               (int32, exact)
//   out = (float(acc) * sx) * sw                 (f32 [M, N])
//
// Quantization divides (IEEE __fdiv_rn) and rounds half to even (rintf),
// exactly like the plain version quantize_rows (ref.py), not like the
// Pallas kernel's x * (1/sx); integer accumulation is order-free, and
// the epilogue multiplies in the reference's order, so the result is
// bit-identical to the plain version.
//
// What bounds it on the H100: at decode (M = 8 slots) the planes are
// read once per call, 2*K*N bytes against ~4*M*K*N int8 ops — far below
// the card's ops/byte balance, so memory bandwidth bounds it.  At
// admission prefill (M = 256..512) the int8 operations dominate.
// Design (simple first): 64x64 output tiles, 256 threads, each thread
// owns 4x4 outputs for both planes; per 64-deep k step the block
// quantizes its X tile and packs 4 consecutive k of X and of each plane
// column into 32-bit words in shared memory, then __dp4a accumulates
// 4 int8 products per instruction into int32.  Ragged M, N and K edges
// are masked (zero-filled) in the loads.  Each X element is quantized
// once per column tile, and the planes stream from HBM once per row
// tile.  A faster kernel (int8 mma/wgmma, TMA pipelining, split-K for
// the narrow N=256 projections) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 64;          // int8 elements per k step
constexpr int KW = BK / 4;      // 32-bit words per k step
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ unsigned quantize(float x, float s) {
  float q = rintf(__fdiv_rn(x, s));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<unsigned>(static_cast<int>(q)) & 0xffu;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
packed_fused_kernel(const T* __restrict__ x, const int8_t* __restrict__ planes,
                    const float* __restrict__ sx, const float* __restrict__ sw,
                    float* __restrict__ out, int M, int N, int K) {
  __shared__ int xs[BM][KW + 1];
  __shared__ int ps[2][KW][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const size_t plane_stride = static_cast<size_t>(K) * N;

  int lo[4][4], hi[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) lo[i][j] = hi[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // X tile: quantize and pack 4 consecutive k per word
    for (int w = tid; w < BM * KW; w += THREADS) {
      const int r = w / KW, c = w % KW, m = m0 + r;
      unsigned packed = 0;
      if (m < M) {
        const float s = sx[m];
        const T* row = x + static_cast<size_t>(m) * K;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int k = k0 + c * 4 + t;
          if (k < K) packed |= quantize(to_f32(row[k]), s) << (8 * t);
        }
      }
      xs[r][c] = static_cast<int>(packed);
    }
    // plane tiles: pack 4 consecutive k of one column n per word
    for (int w = tid; w < 2 * KW * BN; w += THREADS) {
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
      int a[4], b0[4], b1[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[ty + 16 * i][c];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b0[j] = ps[0][c][tx + 16 * j];
        b1[j] = ps[1][c][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          lo[i][j] = __dp4a(a[i], b0[j], lo[i][j]);
          hi[i][j] = __dp4a(a[i], b1[j], hi[i][j]);
        }
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
      const int acc = lo[i][j] + hi[i][j] * 16;
      out[static_cast<size_t>(m) * N + n] =
          __fmul_rn(__fmul_rn(__int2float_rn(acc), s), sw[n]);
    }
  }
}

}  // namespace

extern "C" int ent_matmul_packed_fused(const void* x, int x_is_bf16,
                                       const int8_t* planes, const float* sx,
                                       const float* sw, float* out, int M,
                                       int N, int K, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    packed_fused_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), planes, sx, sw, out, M, N, K);
  } else {
    packed_fused_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(x), planes, sx, sw, out, M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}
