// Sink + sliding-window causal attention forward (prefill) for Hopper.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of
// sink_attention_tpu/ops/flash.py (launched by `_fwd_impl`): the forward of
// attention.cuh over SinkWindowMask, that is, for every query row i and key
// j at global positions i = q_offset + row, j = kv_offset + col,
//     valid(i, j) = 0 <= j <= i  AND  (j < num_sink  OR  j >= i - window + 1)
// with O, the natural-log LSE and the optional per-head s_aux logit.
//
// What bounds it on the H100: at the main-path shapes (D = 64, bf16,
// GQA 64/8, W = 128 or W = N = 1024) the work is about 110 FLOP per byte of
// Q/K/V/O for W = 128 and about 450 for the full layers, against the card's
// ridge of ~295 FLOP/byte: the sliding layers are bound by memory, the full
// layers by tensor-core throughput. A simple mma.sync kernel reaches neither
// bound; wgmma and TMA are the tools of a later, faster version. Design:
// attention.cuh.

#include "attention.cuh"

using sinkattn::SinkWindowMask;

// q [B*H_q, N_q, D], k/v [B*H_kv, N_kv, D] bf16 contiguous; s_aux [H_q] fp32
// or null; ranges [ceil(N_q/64), 4] int32; o like q; lse [B*H_q, N_q] fp32.
extern "C" int sink_fwd_bf16(const void* q, const void* k, const void* v,
                             const void* s_aux, const void* ranges, void* o,
                             void* lse, int B, int H_q, int H_kv, int N_q,
                             int N_kv, int D, int num_sink, int window,
                             int q_offset, int kv_offset, float scale,
                             void* stream) {
  const SinkWindowMask mask{static_cast<const int*>(ranges), N_q, N_kv,
                            num_sink, window, q_offset, kv_offset};
  return sinkattn::launch_fwd(q, k, v, s_aux, o, lse, B, H_q, H_kv, N_q,
                              N_kv, D, scale, mask, stream);
}

// Tile sizes the host-side range table must use.
extern "C" int sink_fwd_block_m() { return sinkattn::BM; }
extern "C" int sink_fwd_block_n() { return sinkattn::BN; }
