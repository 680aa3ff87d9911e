// Helpers shared by the two int8 loops of kernels 1, 4, 5 and 6, the
// split-K weight stream (int8_stream.cuh) and the int8 tensor-core loop
// (int8_tc.cuh): the C entry points' output kinds, the X prologue's
// quantization and the epilogue's store.  Both loops compute
//
//   Xq  = X (int8), or clip(rint(X / sx), -127, 127) from f32/bf16 X
//   acc = sum_i (Xq @ P_i) * 2^(SHIFT * i)       (int32, exact)
//   out = (float(acc) * sx) * sw  in f32 or bf16, or acc itself (int32)
//
// Quantization divides (IEEE __fdiv_rn) and rounds half to even (rintf),
// exactly like the plain version quantize_rows (ref.py); integer
// accumulation is order-free (two's complement wraps identically in any
// order), and the epilogue multiplies in the reference's order, so each
// result is bit-identical to its plain version.  The bf16 store rounds
// to nearest even, as torch's float32 -> bfloat16 cast does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ent_mm {

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

}  // namespace ent_mm
