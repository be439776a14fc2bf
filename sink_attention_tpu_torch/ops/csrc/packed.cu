// Packed (multi-segment) sink attention for Hopper: forward, dQ and dK/dV.
//
// Replace the Pallas TPU kernels `_pfwd_kernel`, `_pdq_kernel` and
// `_pdkdv_kernel` of sink_attention_tpu/ops/packed.py (launched by
// `_pfwd_impl` and `_pbwd_impl`): the wgmma/TMA forward of hopper.cuh, dQ
// of hopper_dq.cuh and dK/dV of hopper_bwd.cuh, each the unpacked path's
// template instantiated over PackedMask. One pack row b holds several
// segments back to back; positions[b, i] counts up from 0 in each segment,
// so row i's segment starts at s_i = i - positions[b, i] and
//     valid(i, j) = j <= i  AND  j >= s_i
//                   AND  (j < s_i + num_sink  OR  j >= i - window + 1)
// (j >= s_i with causality already puts j in i's segment). A pack that
// begins inside a segment gives its leading rows s_i < 0: their first
// num_sink - positions[b, 0] columns are sinks, as the eager oracle has it.
// s_i must not decrease along the pack, as it never does for positions that
// count up by 1 and reset to 0.
//
// What bounds them on the H100: the visible pairs of the pack's own mask,
// not N * (W + num_sink), at 4 D FLOPs a pair and head for the forward
// (6 D for dQ, 8 D for dK/dV) at 989 TFLOP/s, or the bytes (each of q, k,
// v read once, o written once, plus the fp32 rows) at 3.35 TB/s. At the
// training pack (N = 4096, segments of 1316, 1002, 816, 461 and 501
// tokens, GQA 64/8, D = 64) a full layer (W = N) costs about sum(len^2) / 2
// pairs and is bound by tensor-core throughput; a W = 128 layer is bound by
// memory. PERF.md has the bounds beside the kernels' times (chip_smoke.py
// on an H100). What the design does about it: the host tables
// (ops/packed.py) clamp every range to the segments the block's rows or
// columns belong to, so no CTA walks a tile wholly outside the pack's
// mask, and order the work items most KV blocks first (a pack's long items
// are each segment's last block); the kernels are the persistent,
// warp-specialised wgmma/TMA kernels of the unpacked path, each row seeing
// two runs of keys (row_span below: forward and dQ, which put the per-cell
// mask on partial tiles only and skip a consumer's dead tiles) and each
// key one interval of rows [j, reach(j)) (dK/dV). Coverage as the
// unpacked kernels' (flash_fwd.cu): any D % 8 == 0, D <= 512 in the
// instance D_i = 64, 128, 256 or 512, and the narrow 80 and 96 for D
// 65-96 (on the 128 instance's tiles: flash_fwd.cu, flash_bwd.cu), D >
// 512 in the wide instance (hopper_wide.cuh); bf16,
// fp16, and fp32 read as bf16 with fp32 outputs (the entries' `dtype`,
// hopper.cuh's DtypeCode).
//
// Tables, built per batch by ops/packed.py:
//   seg   [B, N]          s_i of every row;
//   fwd   [B, n_fwd_blocks, 4]  per 128-row q block (forward): (sink_b0,
//         sink_b1, win_b0, win_b1): the sink blocks of the first row's
//         segment, then the window blocks from max(first row's s, first
//         row - window + 1), disjoint, in KV blocks of
//         sink_packed_block_n(D) keys;
//   fwd_order [B * n_fwd_blocks]: the (b, q block) units b * n_fwd_blocks
//         + qb of the fwd table, most KV blocks first;
//   dq    [B, n_dq_blocks, 4]  the same per 128-row q block in KV blocks
//         of sink_packed_dq_block_n(D) keys (dQ);
//   dq_order [B * n_dq_blocks]: the (b, q block) units b * n_dq_blocks +
//         qb of the dq table, most KV blocks first;
//   kv    [B, n_kv_blocks, 2] per KV block of sink_packed_dkdv_block_n(D)
//         slots (dK/dV): the range of 64-row q blocks that reads it, up to
//         cdiv(max_j reach(j), 64) with
//         reach(j) the end of j's segment for a sink column, else min(that
//         end, j + window);
//   kv_pieces [1 + B * n_kv_blocks * m, 8]: those ranges cut into pieces
//         (ops/flash.py dkdv_pieces; units b * n_kv_blocks + kb), longest
//         first, built on the card (row 0: their number);
//   reach [B, N]: reach(j), so key j sees exactly the rows [j, reach(j)).

#include "hopper_wide.cuh"

namespace {

using sinkattn::RowSpan;
using sinkattn::hopper::attn_instance_any;
using sinkattn::hopper::DKDV_BM;
using sinkattn::hopper::DQ_BM;
using sinkattn::hopper::dkdv_bn_any;
using sinkattn::hopper::dq_bn_any;
using sinkattn::hopper::fwd_bn_any;
using sinkattn::hopper::FWD_BM;

struct PackedMask {
  static constexpr bool kBatchTables = true;  // tables per row b
  const int* table;  // the fwd or the dq table above
  const int* seg;    // [B, N] (forward, dQ)
  const int* reach;  // [B, N] (dK/dV)
  int N, n_blocks, num_sink, window;

  __device__ const int* q_block(int b, int qb) const {
    return table + (b * n_blocks + qb) * 4;
  }
  // Row i's (< N) runs of visible keys: the sink run [max(s_i, 0),
  // min(s_i + num_sink, i + 1)) and the window run [max(s_i, i - window + 1,
  // 0), i + 1): the visible set of valid(i, j) above.
  __device__ RowSpan row_span(int b, int i) const {
    const int s = seg[(size_t)b * N + i];
    RowSpan r;
    r.sink_lo = max(s, 0);
    r.sink_n = max(min(s + num_sink, i + 1) - r.sink_lo, 0);
    r.win_lo = max(max(s, i - window + 1), 0);
    r.win_n = max(i + 1 - r.win_lo, 0);
    return r;
  }
  // Key j's visible rows [j, reach(j)); none past N.
  __device__ void key_span(int b, int j, int& lo, int& n) const {
    lo = j;
    n = j < N ? max(reach[(size_t)b * N + j] - j, 0) : 0;
  }
};

PackedMask make_mask(const void* table, const void* seg, const void* reach,
                     int N, int block, int num_sink, int window) {
  return PackedMask{static_cast<const int*>(table),
                    static_cast<const int*>(seg),
                    static_cast<const int*>(reach), N,
                    (N + block - 1) / block, num_sink, window};
}

}  // namespace

// q [B*H_q, N, D], k/v [B*H_kv, N, D] bf16 contiguous, 16-byte aligned;
// s_aux [H_q] fp32 or null; fwdtable [B, ceil(N/128), 4], fwdorder
// [B * ceil(N/128)], seg [B, N] int32; o like q; lse [B*H_q, N] fp32.
extern "C" int sink_pfwd(const void* q, const void* k, const void* v,
                         const void* s_aux, const void* fwdtable,
                         const void* fwdorder, const void* seg, void* o,
                         void* lse, int B, int H_q, int H_kv, int N, int D,
                         int num_sink, int window, int dtype, float scale,
                         void* stream) {
  return sinkattn::hopper::launch_fwd_any(
      dtype, q, k, v, s_aux, fwdorder, o, lse, B, H_q, H_kv, N, N, D, scale,
      make_mask(fwdtable, seg, nullptr, N, FWD_BM, num_sink, window),
      stream);
}

// As sink_pfwd_bf16, plus dout like q and lse, delta [B*H_q, N] fp32;
// dqtable [B, ceil(N/128), 4] (KV blocks of sink_packed_dq_block_n(D)
// keys) and dqorder [B * ceil(N/128)] int32 in place of fwdtable and
// fwdorder; dq like q.
extern "C" int sink_pdq(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        const void* dqtable, const void* dqorder,
                        const void* seg, void* dq, int B, int H_q, int H_kv,
                        int N, int D, int num_sink, int window, int dtype,
                        float scale, void* stream) {
  return sinkattn::hopper::launch_dq_any(
      dtype, q, k, v, dout, lse, delta, dqorder, dq, B, H_q, H_kv, N, N, D,
      scale,
      make_mask(dqtable, seg, nullptr, N, DQ_BM, num_sink, window), stream);
}

// As sink_pdq_bf16 with pieces [1 + max_pieces, 8] (the kv_pieces table,
// KV blocks of bn = sink_packed_dkdv_block_n(D) slots) and reach [B, N]
// int32 in place of dqtable, dqorder and seg, and the stream's workspace
// (part, counters: flash_bwd.cu's sink_dkdv); dk, dv like k.
extern "C" int sink_pdkdv(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, const void* pieces,
                          const void* reach, void* part, void* counters,
                          void* dk, void* dv, int B, int H_q, int H_kv, int N,
                          int D, int max_pieces, int num_sink, int window,
                          int dtype, float scale, void* stream) {
  return sinkattn::hopper::launch_dkdv_any(
      dtype, q, k, v, dout, lse, delta,
      sinkattn::hopper::DkdvPieces{pieces, part, counters, max_pieces}, dk,
      dv, B, H_q, H_kv, N, N, D, scale,
      make_mask(nullptr, nullptr, reach, N, dkdv_bn_any(D), num_sink,
                window),
      stream);
}

// Tile sizes the host-side tables must use: the forward's, dQ's and
// dK/dV's (keys by head dim: the instance's).
extern "C" int sink_packed_block_m() { return FWD_BM; }
extern "C" int sink_packed_block_n(int D) { return fwd_bn_any(D); }
extern "C" int sink_packed_dq_block_m() { return DQ_BM; }
extern "C" int sink_packed_dq_block_n(int D) { return dq_bn_any(D); }
extern "C" int sink_packed_dkdv_block_m() { return DKDV_BM; }
extern "C" int sink_packed_dkdv_block_n(int D) { return dkdv_bn_any(D); }
// The instance head dims that run head dim D (flash_fwd.cu's and
// flash_bwd.cu's sink_*_instance).
extern "C" int sink_pfwd_instance(int D) { return attn_instance_any(D); }
extern "C" int sink_pdq_instance(int D) { return attn_instance_any(D); }
extern "C" int sink_pdkdv_instance(int D) { return attn_instance_any(D); }
