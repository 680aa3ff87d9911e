// A sliding-window ring's row positions (models/kv_cache.py RingCache):
// position p lives in row p mod W, so for a read at pos, with the seam r =
// pos mod W, row j holds position pos - ((pos - j) mod W), which is j +
// pos - r for j <= r and that less W above.  A row attends iff its
// position is written (>= 0), at least start, at most pos and, with a
// window, greater than pos - window: the mask of ref.ring_valid.
#pragma once

namespace ent_attn {

__device__ __forceinline__ int ring_pos(int j, int pos, int r, int W) {
  return j + pos - r - (j > r ? W : 0);
}

// Whether a row at position p attends a read at pos.
__device__ __forceinline__ bool pos_attends(int p, int pos, int st, int window) {
  return p >= max(st, 0) && p <= pos && (window <= 0 || p > pos - window);
}

__device__ __forceinline__ bool ring_attends(int j, int pos, int r, int W, int st, int window) {
  return pos_attends(ring_pos(j, pos, r, W), pos, st, window);
}

}  // namespace ent_attn
