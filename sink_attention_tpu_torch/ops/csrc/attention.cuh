// Sink attention on Hopper: what every kernel of the port shares (the
// constants, decode.cu's mma.sync and cp.async helpers, the RowSpan of a
// row's visible keys) and the unpacked mask policy.
//
// The attention kernels compute, for every query row i and key j with
// valid(i, j) given by the policy, the forward O = softmax(scale * Q K^T) V
// over the valid keys plus the optional per-head sink logit s_aux (an extra
// logit with no value) and the natural-log LSE; and, from the forward's LSE
// (which counts s_aux, so P below is the true probability and s_aux needs
// no term here) and delta_i = sum_d dO_id O_id (less the LSE cotangent, if
// any):
//     P  = exp(scale * Q K^T - LSE)  on valid cells, 0 elsewhere
//     dP = dO V^T,   dS = P * (dP - delta)
//     dQ = scale * dS K,   dV = P^T dO,   dK = scale * dS^T Q
// Query head h reads KV head h / (H_q / H_kv). Any head dim D up to 512
// with D % 8 == 0 runs, in the instance of D_i = 64, 128, 256 or 512 (the
// smallest D_i >= D; columns past D read as zeros and are not written);
// the host pads any other D to the next multiple of 8. Inputs are bf16 or
// fp16 (fp32 arrives rounded to bf16 by the host and is written as fp32;
// see hopper.cuh's Io types). The forward is hopper.cuh's wgmma/TMA kernel, dQ
// hopper_dq.cuh's and dK/dV hopper_bwd.cuh's, each written once over both
// policies (the forward also over ablation.cu's softmax stages).
//
// Two policies: SinkWindowMask below (global positions with chunk offsets;
// flash_fwd.cu, flash_bwd.cu, ablation.cu) and PackedMask (segments of a
// packed batch; packed.cu). A policy supplies the per-block range tables
// the host built, each row's visible key runs (RowSpan: the forward and
// dQ) and each key's interval of visible query rows (dK/dV).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace sinkattn {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;  // 0 source bytes: zero-fill the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// D += A(16x16, row) * B(16x8, col), fp32 accumulate; A and B bf16, or
// fp16 where F16.
#define SINK_MMA16816(TY)                                                  \
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32." TY "." TY ".f32 " \
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"  \
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])            \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),      \
                 "r"(b1))
template <bool F16 = false>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (F16)
    SINK_MMA16816("f16");
  else
    SINK_MMA16816("bf16");
}
#undef SINK_MMA16816

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x is the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);  // .x is the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two floats rounded to a 16-bit pair (low half first): fp16 where F16,
// else bf16.
template <bool F16>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (F16)
    return pack_f16(lo, hi);
  else
    return pack_bf16(lo, hi);
}

// Two floats as a two-term bf16 split (low half first): the pair rounded
// to nearest, and in `rest` the remainders x - bf16(x) (exact in fp32)
// rounded again, so that a product over both pairs reads x at about 16 of
// its 24 significand bits (the fp32 instances' P and dS).
__device__ __forceinline__ uint32_t pack_bf16_split(float lo, float hi,
                                                    uint32_t& rest) {
  const uint32_t v = pack_bf16(lo, hi);
  rest = pack_bf16(lo - __uint_as_float(v << 16),
                   hi - __uint_as_float(v & 0xffff0000u));
  return v;
}

// The visible keys of one query row, in local key slots: the window run
// [win_lo, win_lo + win_n) and the sink run [sink_lo, sink_lo + sink_n);
// key jl is visible iff it lies in either (a policy's row_span, computed
// once per row and work item; each run test is one unsigned compare).
struct RowSpan {
  int win_lo, win_n, sink_lo, sink_n;
};

// ---------------------------------------------------------------------------
// Mask policy of the unpacked kernels: query row `row` is at global position
// q_offset + row, key slot jl at kv_offset + jl, and
//     valid(i, j) = 0 <= j <= i  AND  (j < num_sink  OR  j >= i - window + 1)
// Table (host-built, ops/flash.py) of the forward and dQ: [n_q_blocks, 4]
// = (sink_b0, sink_b1, win_b0, win_b1), one for every batch row (dK/dV
// walks the host's piece table, hopper_bwd.cuh's DkdvItem).
// ---------------------------------------------------------------------------
struct SinkWindowMask {
  static constexpr bool kBatchTables = false;  // one table for every b
  const int* table;
  int N_q, N_kv, num_sink, window, q_offset, kv_offset;

  __device__ const int* q_block(int, int qb) const { return table + qb * 4; }
  // Key slot jl's visible local query rows [lo, lo + n): from its global
  // position on (causal), to N_q for a sink, else to the last row whose
  // window reaches it; none before the sequence start or past N_kv.
  __device__ void key_span(int, int jl, int& lo, int& n) const {
    const int jg = kv_offset + jl;
    if (jl >= N_kv || jg < 0) {
      lo = n = 0;
      return;
    }
    lo = max(jg - q_offset, 0);
    const int end = jg < num_sink ? N_q : min(jg + window - q_offset, N_q);
    n = max(end - lo, 0);
  }
  // Local query row `row`'s runs, both cut to jg <= ig and the N_kv end:
  // the keys of valid(q_offset + row, .) above that lie in [0, N_kv).
  __device__ RowSpan row_span(int, int row) const {
    const int ig = q_offset + row;
    const int end = min(ig - kv_offset, N_kv - 1) + 1;  // exclusive
    RowSpan r;
    r.win_lo = max(ig - window + 1, 0) - kv_offset;
    r.win_n = max(end - r.win_lo, 0);
    r.sink_lo = -kv_offset;
    r.sink_n = max(min(num_sink - kv_offset, end) - r.sink_lo, 0);
    return r;
  }
};

}  // namespace sinkattn
