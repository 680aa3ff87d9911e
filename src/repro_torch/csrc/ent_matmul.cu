// EN-T digit-plane matmuls for Hopper (sm_90a), plain C interface.
//
// Replace the Pallas TPU kernels of src/repro/kernels/ent_matmul/ent_matmul.py:
//
//   ent_matmul_packed_fused  (:227, body _packed_fused_kernel :147)
//     X [M, K] f32/bf16, packed planes P [2, K, N] int8 in [-10, 10]:
//     Xq = clip(rint(X / sx), -127, 127) in the prologue (never in HBM),
//     acc = Xq @ P0 + (Xq @ P1) * 16
//   ent_matmul_packed        (:205, body _packed_kernel :134)
//     the same from int8 Xq and a given sx
//   ent_matmul               (:75, body _kernel :49), the legacy 4-plane form
//     int8 Xq, digit planes P [4, K, N] in {-2..2}: acc = sum_i (Xq @ P_i) * 4^i
//
// and out = (float(acc) * sx) * sw, for per-row sx [M, 1] and per-channel
// sw [1, N].  Each kernel has two loops, each bit-identical to the plain
// version: the split-K weight stream of int8_stream.cuh at the decode shape
// (M <= the wrapper's cut; ent_matmul_packed_fused_stream,
// ent_matmul_packed_stream, ent_matmul_planes_stream) and the int8
// tensor-core loop of int8_tc.cuh above it (the *_tc entries).  Kernel 4
// is kernel 1's two packed planes fed kernel 6's pre-quantized int8 X, and
// no serving or training path launches it.  Kernel 5 takes its four planes
// one by one, acc = sum_i (Xq @ P_i) 4^i, as the TPU kernel does.  Each
// header describes its loop's bit-exactness and bounds.

#include "int8_stream.cuh"
#include "int8_tc.cuh"

// Kernel 1 through the split-K weight stream, with the wrapper's plan (mb,
// kslice, splits) and, for splits > 1, its zeroed workspace (ws_len ints)
// and tickets (n_tickets ints), which the launcher checks against the plan.
extern "C" int ent_matmul_packed_fused_stream(const void* x, int x_is_bf16,
                                              const int8_t* planes, const float* sx,
                                              const float* sw, void* out, int out_kind,
                                              int* ws, long long ws_len, int* tickets,
                                              int n_tickets, int M, int N, int K, int mb,
                                              int kslice, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    return ent_stream::launch<__nv_bfloat16, 2, 4>(
        static_cast<const __nv_bfloat16*>(x), planes, sx, sw, out, out_kind, ws, ws_len,
        tickets, n_tickets, M, N, K, mb, kslice, splits, st);
  return ent_stream::launch<float, 2, 4>(static_cast<const float*>(x), planes, sx, sw, out,
                                         out_kind, ws, ws_len, tickets, n_tickets, M, N, K, mb,
                                         kslice, splits, st);
}

// Kernel 1 through the int8 tensor-core loop, with the wrapper's plan
// (kslice, splits) and, for splits > 1, the stream's workspace and tickets.
extern "C" int ent_matmul_packed_fused_tc(const void* x, int x_is_bf16, const int8_t* planes,
                                          const float* sx, const float* sw, void* out,
                                          int out_kind, int* ws, long long ws_len,
                                          int* tickets, int n_tickets, int M, int N, int K,
                                          int kslice, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    return ent_tc::launch<__nv_bfloat16, 2, 4>(
        static_cast<const __nv_bfloat16*>(x), planes, sx, sw, out, out_kind, ws, ws_len,
        tickets, n_tickets, M, N, K, kslice, splits, st);
  return ent_tc::launch<float, 2, 4>(static_cast<const float*>(x), planes, sx, sw, out,
                                     out_kind, ws, ws_len, tickets, n_tickets, M, N, K, kslice,
                                     splits, st);
}

// Dynamic shared memory in bytes of the stream's launch at (mb, kslice) and
// of the tensor-core loop's (bf16 or f32 X), as their launchers size them,
// for chip_smoke.py's build report.
extern "C" int ent_matmul_stream_smem(int mb, int kslice) {
  return ent_stream::smem_bytes<2>(mb, kslice);
}
extern "C" int ent_matmul_tc_smem(int x_is_bf16) {
  return x_is_bf16 ? ent_tc::smem_bytes<__nv_bfloat16, 2>() : ent_tc::smem_bytes<float, 2>();
}

// Kernel 5 (four digit planes, int8 X) through the split-K weight stream and
// through the int8 tensor-core loop, with the wrapper's plans, workspace
// and tickets, as kernel 1's entries take them.
extern "C" int ent_matmul_planes_stream(const int8_t* x, const int8_t* planes, const float* sx,
                                        const float* sw, void* out, int out_kind, int* ws,
                                        long long ws_len, int* tickets, int n_tickets, int M,
                                        int N, int K, int mb, int kslice, int splits,
                                        void* stream) {
  return ent_stream::launch<int8_t, 4, 2>(x, planes, sx, sw, out, out_kind, ws, ws_len, tickets,
                                          n_tickets, M, N, K, mb, kslice, splits,
                                          static_cast<cudaStream_t>(stream));
}
extern "C" int ent_matmul_planes_tc(const int8_t* x, const int8_t* planes, const float* sx,
                                    const float* sw, void* out, int out_kind, int* ws,
                                    long long ws_len, int* tickets, int n_tickets, int M, int N,
                                    int K, int kslice, int splits, void* stream) {
  return ent_tc::launch<int8_t, 4, 2>(x, planes, sx, sw, out, out_kind, ws, ws_len, tickets,
                                      n_tickets, M, N, K, kslice, splits,
                                      static_cast<cudaStream_t>(stream));
}
extern "C" int ent_matmul_planes_stream_smem(int mb, int kslice) {
  return ent_stream::smem_bytes<4>(mb, kslice);
}
extern "C" int ent_matmul_planes_tc_smem() { return ent_tc::smem_bytes<int8_t, 4>(); }

// Kernel 4 (two packed planes, int8 X) through the split-K weight stream and
// through the int8 tensor-core loop, with the wrapper's plans, workspace
// and tickets, as kernel 1's entries take them.
extern "C" int ent_matmul_packed_stream(const int8_t* x, const int8_t* planes, const float* sx,
                                        const float* sw, void* out, int out_kind, int* ws,
                                        long long ws_len, int* tickets, int n_tickets, int M,
                                        int N, int K, int mb, int kslice, int splits,
                                        void* stream) {
  return ent_stream::launch<int8_t, 2, 4>(x, planes, sx, sw, out, out_kind, ws, ws_len, tickets,
                                          n_tickets, M, N, K, mb, kslice, splits,
                                          static_cast<cudaStream_t>(stream));
}
extern "C" int ent_matmul_packed_tc(const int8_t* x, const int8_t* planes, const float* sx,
                                    const float* sw, void* out, int out_kind, int* ws,
                                    long long ws_len, int* tickets, int n_tickets, int M, int N,
                                    int K, int kslice, int splits, void* stream) {
  return ent_tc::launch<int8_t, 2, 4>(x, planes, sx, sw, out, out_kind, ws, ws_len, tickets,
                                      n_tickets, M, N, K, kslice, splits,
                                      static_cast<cudaStream_t>(stream));
}
extern "C" int ent_matmul_packed_stream_smem(int mb, int kslice) {
  return ent_stream::smem_bytes<2>(mb, kslice);
}
extern "C" int ent_matmul_packed_tc_smem() { return ent_tc::smem_bytes<int8_t, 2>(); }
