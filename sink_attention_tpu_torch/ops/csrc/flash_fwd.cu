// Sink + sliding-window causal attention forward (prefill) for Hopper.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of
// sink_attention_tpu/ops/flash.py (launched by `_fwd_impl`): for every query
// row i and key j at global positions i = q_offset + row, j = kv_offset +
// col,
//     valid(i, j) = 0 <= j <= i  AND  (j < num_sink  OR  j >= i - window + 1)
// with O, the natural-log LSE and the optional per-head s_aux logit.
//
// What bounds it on the H100: at the main-path shapes (D = 64, bf16,
// GQA 64/8, W = 128 or W = N = 1024) the work is about 110 FLOP per byte of
// Q/K/V/O for W = 128 and about 450 for the full layers, against the card's
// ridge of ~295 FLOP/byte: the sliding layers are bound by memory, the full
// layers and the long headline shape by tensor-core throughput. The
// kernel is hopper.cuh's fwd_wgmma_kernel: the only road to the tensor
// cores' rate is wgmma fed by TMA with the loads in flight while the
// consumers compute (a producer warpgroup, two consumer warpgroups, a ring
// of K/V stages), and the per-cell mask only on the partial tiles.
//
// The entry point launches the template over SinkWindowMask (hopper.cuh's
// launch_fwd, shared with the packed forward), which builds the three TMA
// descriptors per call. Coverage: any head dim D with D % 8 == 0 (the
// host pads any other D to the next multiple of 8): D <= 512 in the
// instance of D_i = 64, 80, 96, 128, 256 or 512 (hopper.cuh's
// attn_instance_d: the narrow 80 and 96 take D 65-80 and 81-96 on the
// 128 instance's tiles, computing 80 or 96 columns, not 128; exported as
// sink_fwd_instance); the 256 instance walks 64-key tiles, the 512 instance
// 32-key tiles in 64-row items whose O columns its consumers split
// (hopper.cuh's FwdPlan); D > 512 in the wide instance of hopper_wide.cuh
// (runtime depth, 512-column slices); bf16 and fp16 inputs, and fp32
// (rounded to bf16 by the host, O written as fp32).

#include "hopper_wide.cuh"

using sinkattn::SinkWindowMask;
using sinkattn::hopper::FWD_BM;

// q [B*H_q, N_q, D], k/v [B*H_kv, N_kv, D] contiguous, 16-byte aligned,
// bf16 (dtype 0; hopper.cuh's DtypeCode), fp16 (1) or bf16 rounded from
// fp32 (2); s_aux [H_q] fp32 or null; ranges [ceil(N_q/128), 4] int32 (the
// KV blocks of sink_fwd_block_n(D) keys each q block of 128 rows visits);
// o like q (fp32 for dtype 2); lse [B*H_q, N_q] fp32.
extern "C" int sink_fwd(const void* q, const void* k, const void* v,
                        const void* s_aux, const void* ranges, void* o,
                        void* lse, int B, int H_q, int H_kv, int N_q,
                        int N_kv, int D, int num_sink, int window,
                        int q_offset, int kv_offset, int dtype, float scale,
                        void* stream) {
  const SinkWindowMask mask{static_cast<const int*>(ranges), N_q, N_kv,
                            num_sink, window, q_offset, kv_offset};
  return sinkattn::hopper::launch_fwd_any(dtype, q, k, v, s_aux, nullptr, o,
                                          lse, B, H_q, H_kv, N_q, N_kv, D,
                                          scale, mask, stream);
}

// Tile sizes the host-side range table must use (keys by head dim: the
// instance's).
extern "C" int sink_fwd_block_m() { return FWD_BM; }
extern "C" int sink_fwd_block_n(int D) {
  return sinkattn::hopper::fwd_bn_any(D);
}
// The instance head dim that runs head dim D (80 for 65-80, 96 for 81-96,
// the wide instance's 513 past 512; 0 for D % 8 != 0).
extern "C" int sink_fwd_instance(int D) {
  return sinkattn::hopper::attn_instance_any(D);
}
