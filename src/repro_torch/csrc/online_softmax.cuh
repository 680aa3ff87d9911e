// Device helpers shared by the attention kernels (flash_attention.cu,
// paged_attention.cu): operand conversion, warp reductions and the
// online-softmax update of one query row over one tile of <= 32 kv
// columns, lane j holding column j.
//
// As in the plain versions (masked_attention_ref, paged_attention_ref),
// the row sum l adds the f32 probabilities and the value product uses
// the probabilities rounded to the value dtype T; with ROUND_P = false
// (the training forward's float32 route, as attention_ref) it keeps them
// in f32.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace ent_attn {

constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// One row's step over a tile of `ncols` columns: lane j's scaled score s
// and whether column j attends; vs holds the tile's V rows in f32 (row
// stride VS); the lane owns accumulator columns lane + 32 * t.  vscale
// is column j's int8-KV V scale (1 without one): it multiplies the
// probability after l has summed it, before the rounding to T.  A fully
// masked tile leaves m, l and acc unchanged.  ROUND_P = false keeps the
// probabilities in f32 for the value product.
template <typename T, int VS, int DT, bool ROUND_P = true>
__device__ __forceinline__ void online_softmax_update(
    float s, bool valid, int ncols, const float* vs, float& m, float& l,
    float (&acc)[DT], int lane, float vscale = 1.0f) {
  s = valid ? s : NEG_INF;
  const float m_new = fmaxf(m, warp_max(s));
  const float p = valid ? expf(s - m_new) : 0.0f;
  const float alpha = expf(m - m_new);
  l = alpha * l + warp_sum(p);
  const float pv = ROUND_P ? to_f32(from_f32<T>(p * vscale)) : p * vscale;
#pragma unroll
  for (int t = 0; t < DT; ++t) acc[t] *= alpha;
#pragma unroll 8
  for (int jj = 0; jj < ncols; ++jj) {
    const float pj = __shfl_sync(FULL, pv, jj);
#pragma unroll
    for (int t = 0; t < DT; ++t) acc[t] = fmaf(pj, vs[jj * VS + lane + 32 * t], acc[t]);
  }
  m = m_new;
}

// acc / l into the row's output; a fully masked row (l = 0) gives zeros.
template <typename O, int DT>
__device__ __forceinline__ void store_row(O* op, const float (&acc)[DT], float l,
                                          int lane) {
  const float den = fmaxf(l, 1e-30f);
#pragma unroll
  for (int t = 0; t < DT; ++t) op[lane + 32 * t] = from_f32<O>(acc[t] / den);
}

}  // namespace ent_attn
