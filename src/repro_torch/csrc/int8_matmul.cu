// w8a8 int8 matmul for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel int8_matmul
// (src/repro/kernels/int8_matmul/int8_matmul.py:47, body _kernel :24):
// int8 X [M, K] x int8 W [K, N] -> int32 acc, then the epilogue
// (float(acc) * sx) * sw for per-row sx [M, 1] and per-channel sw [1, N],
// stored as f32 or bf16 (or acc itself, int32).  It is the one-plane
// instance of the tile loop in int8_tile.cuh, which describes its
// bit-exactness and its bounds.

#include "int8_tile.cuh"

extern "C" int int8_matmul(const int8_t* x, const int8_t* w, const float* sx,
                           const float* sw, void* out, int out_kind, int M,
                           int N, int K, void* stream) {
  return ent_mm::launch<int8_t, 1, 0>(x, w, sx, sw, out, out_kind, M, N, K,
                                      static_cast<cudaStream_t>(stream));
}
