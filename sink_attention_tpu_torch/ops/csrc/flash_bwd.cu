// Sink + sliding-window causal attention backward for Hopper: two kernels.
//
// Replace the Pallas TPU kernels `_dq_kernel` and `_dkdv_kernel` of
// sink_attention_tpu/ops/flash.py (launched by `_bwd_impl`): the dQ kernel
// of hopper_dq.cuh and the dK/dV kernel of hopper_bwd.cuh, both wgmma fed
// by TMA, warp-specialised and persistent, over SinkWindowMask (the
// forward's mask, see flash_fwd.cu). delta and the ds_aux term are plain
// torch on the host.
//
// What bounds them on the H100: per valid (q, k) pair and head, the dQ
// kernel does 3 products of depth D (S, dP, dQ) and the dK/dV kernel 4
// (S, dP, dV, dK), against 2 in the forward. At the training shapes
// (D = 64, GQA 64/8, N = 4096) the full layers are bound by tensor-core
// throughput and the W = 128 layers by memory (each kernel reads q, k, v
// and dO once); each header says what its design does about it. dQ walks
// the forward's two KV-block ranges (fwd_kv_ranges at 128 rows x 128 keys
// at D = 64, 64 keys at D = 128) per 128-row q block; dK/dV walks one
// range of 64-row q blocks per 128-key block; both decided per block on
// the host, so negative and chunked offsets are right, and both take
// their work items longest first from a host order table. Coverage as the
// forward's (flash_fwd.cu): any D % 8 == 0, D <= 512 in the instance D_i
// = 64, 80, 96, 128, 256 or 512 (both kernels run D 65-80 and 81-96 in
// the narrow 80 and 96 instances on the 128 instance's tiles; dQ at
// 32-key tiles at 256, and at 512 in 64-row items whose columns the
// consumers split; dK/dV at 64-key items whose columns the two consumers
// split, at 512 in two passes over 32-row q tiles), D > 512 in the wide
// instance (hopper_wide.cuh); bf16, fp16, and fp32 read as bf16 with fp32
// gradients.

#include "hopper_wide.cuh"

using sinkattn::SinkWindowMask;

// q, dout [B*H_q, N_q, D], k/v [B*H_kv, N_kv, D] contiguous, of the
// dtype code's type (sink_fwd's); lse, delta [B*H_q, N_q] fp32; ranges
// [ceil(N_q/128), 4] int32 (fwd_kv_ranges at 128 rows x
// sink_dq_block_n(D) keys), order [ceil(N_q/128)] int32 (the q blocks,
// longest first); dq like q (fp32 for dtype 2).
extern "C" int sink_dq(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       const void* ranges, const void* order, void* dq,
                       int B, int H_q, int H_kv, int N_q, int N_kv, int D,
                       int num_sink, int window, int q_offset, int kv_offset,
                       int dtype, float scale, void* stream) {
  const SinkWindowMask mask{static_cast<const int*>(ranges), N_q, N_kv,
                            num_sink, window, q_offset, kv_offset};
  return sinkattn::hopper::launch_dq_any(dtype, q, k, v, dout, lse, delta,
                                           order, dq, B, H_q, H_kv, N_q,
                                           N_kv, D, scale, mask, stream);
}

// As sink_dq; pieces [1 + max_pieces, 8] int32 (ops/flash.py
// dkdv_pieces: each key block of bn = sink_dkdv_block_n(D) keys cut into
// pieces of consecutive 64-row q blocks, longest first; row 0 the count),
// part and counters the stream's workspace (fp32 partials of the split
// blocks, int32 counters at zero); dk, dv like k (fp32 for dtype 2).
extern "C" int sink_dkdv(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         const void* pieces, void* part, void* counters,
                         void* dk, void* dv, int B, int H_q, int H_kv,
                         int N_q, int N_kv, int D, int max_pieces,
                         int num_sink, int window, int q_offset,
                         int kv_offset, int dtype, float scale,
                         void* stream) {
  const SinkWindowMask mask{nullptr, N_q, N_kv, num_sink, window, q_offset,
                            kv_offset};
  return sinkattn::hopper::launch_dkdv_any(
      dtype, q, k, v, dout, lse, delta,
      sinkattn::hopper::DkdvPieces{pieces, part, counters, max_pieces}, dk,
      dv, B, H_q, H_kv, N_q, N_kv, D, scale, mask, stream);
}

// Tile sizes the host-side range tables must use: dQ's and dK/dV's (keys
// by head dim: the instance's).
extern "C" int sink_dq_block_m() { return sinkattn::hopper::DQ_BM; }
extern "C" int sink_dq_block_n(int D) {
  return sinkattn::hopper::dq_bn_any(D);
}
extern "C" int sink_dkdv_block_m() { return sinkattn::hopper::DKDV_BM; }
extern "C" int sink_dkdv_block_n(int D) {
  return sinkattn::hopper::dkdv_bn_any(D);
}
// The instance head dims that run head dim D in dQ and in dK/dV (one
// rule: the narrow 80 and 96 for D 65-96, the wide instance's 513 past
// 512; 0 for D % 8 != 0).
extern "C" int sink_dq_instance(int D) {
  return sinkattn::hopper::attn_instance_any(D);
}
extern "C" int sink_dkdv_instance(int D) {
  return sinkattn::hopper::attn_instance_any(D);
}
