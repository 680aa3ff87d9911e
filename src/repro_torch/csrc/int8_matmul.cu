// w8a8 int8 matmul for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel int8_matmul
// (src/repro/kernels/int8_matmul/int8_matmul.py:47, body _kernel :24):
// int8 X [M, K] x int8 W [K, N] -> int32 acc, then the epilogue
// (float(acc) * sx) * sw for per-row sx [M, 1] and per-channel sw [1, N],
// stored as f32 or bf16 (or acc itself, int32).  The wrapper takes one of
// two one-plane instances of the shared int8 loops, each bit-identical to
// the plain version: the split-K weight stream (int8_stream.cuh) at M <=
// its cut M_STREAM (the decode tick) and the tensor-core loop
// (int8_tc.cuh) above.  Each header describes its bit-exactness and its
// bounds.

#include "int8_stream.cuh"
#include "int8_tc.cuh"

// The split-K weight stream with the wrapper's plan (mb, kslice, splits)
// and, for splits > 1, its zeroed workspace (ws_len ints) and tickets
// (n_tickets ints), which the launcher checks against the plan.
extern "C" int int8_matmul_stream(const int8_t* x, const int8_t* w, const float* sx,
                                  const float* sw, void* out, int out_kind, int* ws,
                                  long long ws_len, int* tickets, int n_tickets, int M, int N,
                                  int K, int mb, int kslice, int splits, void* stream) {
  return ent_stream::launch<int8_t, 1, 0>(x, w, sx, sw, out, out_kind, ws, ws_len, tickets,
                                          n_tickets, M, N, K, mb, kslice, splits,
                                          static_cast<cudaStream_t>(stream));
}

// The tensor-core loop with the wrapper's plan (kslice, splits) and, for
// splits > 1, the same workspace and tickets, checked the same way.
extern "C" int int8_matmul_tc(const int8_t* x, const int8_t* w, const float* sx,
                              const float* sw, void* out, int out_kind, int* ws,
                              long long ws_len, int* tickets, int n_tickets, int M, int N,
                              int K, int kslice, int splits, void* stream) {
  return ent_tc::launch<int8_t, 1, 0>(x, w, sx, sw, out, out_kind, ws, ws_len, tickets,
                                      n_tickets, M, N, K, kslice, splits,
                                      static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory in bytes of the stream's launch at (mb, kslice) and
// of the tensor-core loop's, as their launchers size them, for
// chip_smoke.py's build report.
extern "C" int int8_matmul_stream_smem(int mb, int kslice) {
  return ent_stream::smem_bytes<1>(mb, kslice);
}
extern "C" int int8_matmul_tc_smem() { return ent_tc::smem_bytes<int8_t, 1>(); }
