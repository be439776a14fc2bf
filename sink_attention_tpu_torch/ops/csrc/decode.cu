// Single-token decode attention over the rolling sink KV cache, for Hopper.
//
// Replaces the Pallas TPU kernel `_decode_kernel` of
// sink_attention_tpu/ops/decode.py (launched by `_decode_call`), in its
// storage branches: bf16 (`sink_decode_bf16`), fp16 (`sink_decode_f16`),
// fp32 (`sink_decode_f32`), int8 codes (`sink_decode_int8`) and
// float8_e4m3fn codes held in int8 (`sink_decode_fp8`), the codes with one
// fp32 scale per token and KV head. One query token per sequence attends
// the cache buffer [B, H_kv, S_total, D] in place: slots [0, sink_cap)
// hold the sink tokens, slots [sink_cap, sink_cap + window) the circular
// window. A slot is live iff
//     slot < sink_len, or
//     0 <= sw < window and age(sw) < window_len, with sw = slot - sink_cap,
//     age(sw) = (write_pos - 1 - sw) mod window   (the circular-age test).
// The per-sequence state (sink_len, window_len, write_pos) is either three
// ints shared by the batch (SinkKVCache) or read on the device from three
// strided int32 arrays (RaggedSinkKVCache's [B] tensors, or the columns of
// a [B, 4] table); the kernel derives the high-water mark from it:
//     hwm = sink_len                                  if window_len == 0
//         = sink_cap + (write_pos >= window_len ? write_pos : window)
// and reads no slot at or past hwm. The optional s_aux [H_q] enters the
// softmax as an extra logit with no value (natural-log domain).
//
// What bounds it on the H100: memory. Each live K/V byte is used for 2*G
// FLOP (G = GQA group), far below the ~295 FLOP/byte ridge, so the least
// time is the live cache bytes over 3.35 TB/s: 4*D bytes per live slot and
// KV head in bf16, 2*D + 8 (codes and two scales) when quantized, 8*D in
// fp32. A layer's cache at the served shapes is a few (b, kv head) pairs of
// thousands of live slots (H2O-Danube-1.8B at B = 2: 16 pairs of 4096, 21
// MB in bf16, ~6 us at 3.35 TB/s; a Llama-style D = 128 layer at B = 1: 8
// pairs), so one CTA per pair, or a cluster of 8, would leave most of the
// 132 SMs idle and every CTA waiting a round trip per tile. The design
// fills the card and keeps the bytes in flight instead, at every head dim
// and storage (one entry per storage, one launch per call):
//  * split-K over the card: the host cuts the live range into n_split
//    ranges (at most 512) of split_slots slots (whole tiles), so that (b,
//    kv head, piece of up to 16 rows) x n_split CTAs are up to twice the
//    SMs, one wave (fewer where the merge below would outweigh a range; a
//    range of at least two tiles unless a tile holds 16 KB of K or more);
//    one launch, grid (n_split, units). The merge of a unit's ranges, by the
//    size of n_split:
//    - one range (a 128-slot sliding ring, or a batch that fills the card
//      by its units): the CTA normalises its rows and writes them itself;
//    - 2-8 ranges of the short rows below (gpt-oss-20b's full layer, 1040
//      live slots: 5): the unit's CTAs are one thread block cluster; each
//      keeps its partial (m, l, unnormalised O) in shared memory, and the
//      cluster merges them over distributed shared memory (merge_cluster);
//    - else each CTA writes an fp32 partial to a workspace the wrapper keeps
//      per stream, and the last CTA of the unit to arrive (an atomic count
//      per unit, zeroed once, which that CTA sets back to 0) merges them
//      (merge_unit): the partials copied into the ring by plain loads where
//      they fit it, else by TMA bulk copies, two chunks in flight.
//    s_aux joins every merge as one more partial of LSE s_aux and value 0,
//    and each row is written once. No host synchronisation: a ragged
//    state's hwm is read on the device, and a range past it is empty (its
//    partial m = -inf, skipped);
//  * a ring of 4 boxes (3 in flight, cp.async from every thread) streams
//    the range's K boxes, then its V boxes, with no bubble between the two:
//    each K and V byte of the range is read once. A box is sized by bytes,
//    not slots. Up to D = 128 (short_decode_kernel; instances of D_i = 64,
//    80, 96 and 128 per storage, the columns past D zero-filled) a box
//    holds 32-128 whole rows (ShortBox: ~8-20 KB of useful bytes, where a
//    512-byte chunk of a row would hold a quarter of that); past it
//    (deep_decode_kernel, one instance per storage, the depth counted at run
//    time) 32 slots x a 512-byte chunk of a row (a depth chunk of K or a
//    column chunk of V);
//  * S once per tile: the 4 warps split a tile's slots (8 at a time, the
//    whole depth; the 16 columns of a k-step permuted alike in q and K, so
//    one 64-bit (codes: 32-bit) load of a K row gives both B registers;
//    short rows keep q's A fragments in registers), so S is computed and
//    every int8 / fp8 code of K decoded once per CTA; S of the whole range
//    waits in shared memory (exp2 domain, scaled, masked), and one exact
//    softmax over the range gives m, l and P (rounded to bf16, fp16 for
//    fp16 storage, times v_scale when quantized, as the A operand; the row
//    sum takes p alone in fp32). A range past 512 slots is walked in passes
//    of 512, each pass's P taken against the running max and the O of the
//    passes before rescaled (short rows: in registers; deep ones: the
//    partial already written, so the host keeps a deep range to one pass
//    unless 512 of them do not cover the cache);
//  * P V: short rows, the warps split each box's 16-slot k-steps, every
//    warp over all D_i columns in groups of 32 (the columns past D_i read
//    from the next row's bytes and dropped), their O in registers over the
//    range and summed over the warps in shared memory at its end; deep ones,
//    the warps split each V column chunk's columns (64 16-bit / 128 code
//    columns a warp). Either way a lane owns 4 adjacent columns of each
//    group of 32 (one load of a V row gives its 4 n-tiles, paired across
//    rows by byte permutes), so each V code is decoded once per CTA;
//  * int8 codes decode by bit operations at the full rate (Int8::from16),
//    not by int -> float converts;
//  * fp32 storage in fp32 on the CUDA cores: S with a lane per (slot,
//    quarter of the depth), the quarters summed by two shuffles; P V with a
//    lane per column (short rows: each warp over a quarter of the box's
//    slots; deep ones: over a column chunk), p read from shared memory by
//    broadcast, 4 query rows at a time (S and P slot-major);
//  * a CTA takes up to 16 query rows (fewer where q's rows would not fit
//    227 KB beside the ring, S and P: fp32 at D = 2048 takes 8), the
//    m16n8k16 tiles' rows past the group's read as zeros.
// Measured (H100 SXM, 700 W; B = 2, GQA 8/4, 4096 live slots): past D =
// 128, bf16, fp16 and fp32 storage reach 50-68% of the byte bound at D =
// 256-1024, the codes 21-43% (compute-bound at two CTAs an SM: the byte
// decode and the mma.sync chain per box). Up to D = 128 see
// sink_attention_tpu_torch/ops/decode.py's decode_kernel.

// Quantized storage computes attention over the dequantized cache: the
// codes decode exactly to bf16 (int8 by bit operations; fp8 by Hopper's
// e4m3 -> f16 convert; every int8 and e4m3 value is a bf16 value), score =
// (q . codes_k) * k_scale in fp32, and P V takes p * v_scale rounded to
// bf16 (the row sum takes p alone in fp32). The bf16 rounding of P, as in
// the prefill kernels, costs up to 2^-9 of an output (DECODE_TOL 2e-2 on
// the bf16 output). fp16 storage is the bf16 branch with fp16 mma.sync and
// P rounded to fp16 (q and the output fp16). Head dims: any D whose rows
// are whole 16 bytes (D % 8 for bf16/fp16, D % 16 for the codes, D % 4 for
// fp32; the host pads any other D).

#include <cooperative_groups.h>

#include "attention.cuh"
#include "hopper_wide.cuh"  // the mbarrier helpers

#include <cuda_fp8.h>

#include <algorithm>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

using sinkattn::LOG2E;
using sinkattn::cp_async16;
using sinkattn::cp_async_commit;
using sinkattn::cp_async_wait;
using sinkattn::mma16816;
using sinkattn::pack2;
using sinkattn::pack_bf16;
using sinkattn::hopper::mbar_expect_tx;
using sinkattn::hopper::mbar_init;
using sinkattn::hopper::mbar_wait_timed;
using sinkattn::hopper::smem_u32;

constexpr int NTHREADS = 128;  // 4 warps
constexpr int NWARPS = NTHREADS / 32;

// 4 bytes global -> shared, zero-filled where !pred.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 4 : 0));
}

// The storage types: SCALED types carry per-token scales, and `from16`
// gives the two codes of a word's low 16 bits (low byte first) as a bf16
// pair, `vpair` byte nt of two words (two rows of a column); the
// conversions are exact. q and the output are fp16 where F16, fp32 where
// SCALAR (Fp32: no mma.sync, fp32 arithmetic), else bf16.
struct Bf16 {
  static constexpr int BYTES = 2;
  static constexpr bool SCALED = false, F16 = false, SCALAR = false;
};

struct Fp16 : Bf16 {
  static constexpr bool F16 = true;
};

struct Fp32 {
  static constexpr int BYTES = 4;
  static constexpr bool SCALED = false, SCALAR = true;
};

struct Int8 {
  static constexpr int BYTES = 1;
  static constexpr bool SCALED = true, F16 = false, SCALAR = false;
  __device__ __forceinline__ static uint32_t from16(uint32_t w) {
    return from_b02(__byte_perm(w, 0u, 0x4140));  // [b0, 0, b1, 0]
  }
  // The codes in bytes 0 and 2 of t (bytes 1 and 3 ignored) as a bf16
  // pair: a code x's low 7 bits under the exponent of bf16 128 give 128 +
  // (x & 127), less bf16 128 (x >= 0) or 256 (x < 0: its sign bit lands in
  // the exponent's lowest bit): exact.
  __device__ __forceinline__ static uint32_t from_b02(uint32_t t) {
    const uint32_t hv = (t & 0x007f007fu) | 0x43004300u;
    const uint32_t hc = (t & 0x00800080u) | 0x43004300u;
    const __nv_bfloat162 d =
        __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&hv),
                *reinterpret_cast<const __nv_bfloat162*>(&hc));
    return *reinterpret_cast<const uint32_t*>(&d);
  }
  __device__ __forceinline__ static uint32_t vpair(uint32_t w0, uint32_t w1,
                                                   int nt) {
    return from_b02(__byte_perm(w0, w1, nt | ((4 + nt) << 8)));
  }
};

struct Fp8 {
  static constexpr int BYTES = 1;
  static constexpr bool SCALED = true, F16 = false, SCALAR = false;
  __device__ __forceinline__ static uint32_t from16(uint32_t w) {
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(w), __NV_E4M3);
    const float2 f = __half22float2(__half2(h));
    return pack_bf16(f.x, f.y);
  }
  __device__ __forceinline__ static uint32_t vpair(uint32_t w0, uint32_t w1,
                                                   int nt) {
    return from16(__byte_perm(w0, w1, nt | ((4 + nt) << 4)));
  }
};

// The per-sequence cache state: three strided device arrays, or (null
// pointers) three ints shared by the batch.
struct State {
  const int* sink_len;
  const int* window_len;
  const int* write_pos;
  int stride;
  int u_sink_len, u_window_len, u_write_pos;
};

// Sequence b's state and high-water mark.
struct SeqState {
  int sink_len, window_len, write_pos, hwm;
};

__device__ __forceinline__ SeqState seq_state(const State& st, int b,
                                              int S_total, int sink_cap,
                                              int window) {
  SeqState s;
  s.sink_len = st.sink_len ? st.sink_len[b * st.stride] : st.u_sink_len;
  s.window_len = st.window_len ? st.window_len[b * st.stride]
                               : st.u_window_len;
  s.write_pos = st.write_pos ? st.write_pos[b * st.stride] : st.u_write_pos;
  s.hwm = min(s.window_len > 0 ? sink_cap + (s.write_pos >= s.window_len
                                                 ? s.write_pos
                                                 : window)
                               : s.sink_len,
              S_total);
  return s;
}

constexpr int DEEP_TL = 32;                 // slots per deep tile
constexpr int DEEP_ROW = 512;               // bytes of a deep box row
constexpr int DEEP_STAGES = 4;              // boxes in the ring
constexpr int DEEP_SLOTS = 512;             // slots of a CTA's pass at most
constexpr int DEEP_SPLITS = 512;            // ranges of a unit at most
constexpr int DEEP_ROWS = 16;               // query rows of a CTA at most
constexpr int DEEP_SROW = DEEP_SLOTS + 4;   // a row of S (floats)
constexpr int DEEP_PROW = DEEP_SLOTS + 8;   // a row of P (16-bit)
constexpr int DEEP_SMEM_MAX = 232448;       // a CTA's shared memory at most
constexpr int DEEP_MERGE_BUF = 32768;       // bytes of a merge chunk
constexpr int SHORT_BOX_CAP = 23552;        // bytes of a short box at most
constexpr int SHORT_CLUSTER = 8;           // ranges merged in a cluster

// The padded row stride of a deep box: 528 bytes puts a warp's 32-bit
// loads of 8 rows x 4 words, and fp32's quarter-warp float4 loads, on
// distinct banks; K boxes of 16-bit storage take 544, so the 64-bit loads
// of a half warp (4 rows x 2 words each) are distinct too.
template <class T>
__host__ __device__ constexpr int deep_kstride() {
  return T::BYTES == 2 ? DEEP_ROW + 32 : DEEP_ROW + 16;
}
constexpr int DEEP_VSTRIDE = DEEP_ROW + 16;
constexpr int DEEP_BOX = DEEP_TL * (DEEP_ROW + 32);  // a stage's bytes

// Shared memory of a deep CTA of `rows` query rows at head dim D, in bytes
// from its start: the ring of boxes; q's rows (whole chunks, zero past D;
// fp32 for fp32 storage, its rows rounded up to 4, else 16-bit); S: [rows]
// [DEEP_SROW] fp32, or for fp32 storage slot-major [DEEP_SLOTS][rows
// rounded up to 4] (then P in its place); P [rows][DEEP_PROW] 16-bit; the
// pass's k and v scales; m, l and the pass's rescale factor [DEEP_ROWS],
// the last-arrival flag and the merge's two mbarriers.
template <class T>
struct DeepLayout {
  static constexpr int EC = DEEP_ROW / T::BYTES;  // elements of a box row
  static constexpr int QB = T::SCALAR ? 4 : 2;    // q's element bytes
  static constexpr int RING = DEEP_STAGES * DEEP_BOX;
  int kch, qrow, rp4, q, s, p, sc, ml, bytes;
  __host__ __device__ DeepLayout(int rows, int D) {
    kch = (D + EC - 1) / EC;  // depth chunks of K, column chunks of V
    qrow = kch * EC * QB + 32;  // a half warp's 64-bit loads: 8 words apart
    rp4 = (rows + 3) & ~3;
    q = RING;
    s = q + (T::SCALAR ? rp4 : rows) * qrow;
    p = s + (T::SCALAR ? DEEP_SLOTS * rp4 : rows * DEEP_SROW) * 4;
    sc = p + (T::SCALAR ? 0 : rows * DEEP_PROW * 2);
    ml = sc + (T::SCALED ? 2 * DEEP_SLOTS * 4 : 0);
    bytes = ml + 3 * DEEP_ROWS * 4 + 32;
  }
};

// A box of the short rows' ring (every storage up to D = 128): TL whole
// rows of the instance's D_i columns, K or V. The row strides keep the
// loads of a box on distinct banks: K's, an odd multiple of 32 bytes for
// 16-bit storage (a half warp's 64-bit loads of 4 rows x 2 words) and of
// 16 for codes (a warp's 32-bit loads of 8 rows x 4 words) and fp32 (a
// quarter warp's float4 loads of 8 rows); V's an odd multiple of 16 (P V's
// loads of 4 rows, 2 apart). TL, a power of two of at least 64 (so each
// warp takes whole 16-slot k-steps of a V box; 32 for fp32, whose warps
// take 8 slots) and at most 128 (a 128-slot sliding ring is one tile: a
// 256-slot code tile half full cost such a ring more than the parent's
// 128-slot tile), is the largest whose box fits SHORT_BOX_CAP: 8-20 KB of
// useful bytes (128 slots of 128-byte rows, 128 of 160, 64 of 192 or 256;
// codes 128 of 64-128; fp32 64 of 256 or 320, 32 of 384 or 512).
template <class T, int DI>
struct ShortBox {
  static constexpr int RB = DI * T::BYTES;  // bytes of a row
  static constexpr int KS = T::BYTES == 2 ? ((RB + 31) / 32 | 1) * 32
                                          : ((RB + 15) / 16 | 1) * 16;
  static constexpr int VS = ((RB + 15) / 16 | 1) * 16;
  static constexpr int STRIDE = KS > VS ? KS : VS;
  static constexpr int TL = 128 * STRIDE <= SHORT_BOX_CAP ? 128
                            : 64 * STRIDE <= SHORT_BOX_CAP || !T::SCALAR
                                ? 64
                                : 32;
  static constexpr int BYTES = TL * STRIDE;
  static constexpr int NG = (DI + 31) / 32;  // V column groups of 32
  static constexpr int RING = DEEP_STAGES * BYTES;
  // a merge chunk: two in the ring
  static constexpr int MERGE_BUF =
      (DEEP_MERGE_BUF < RING / 2 ? DEEP_MERGE_BUF : RING / 2) & ~15;
};

// Shared memory of a short CTA of `rows` query rows: the ring; for fp32
// q's rows [rows rounded up to 4][D_i] (else q's fragments stay in
// registers); S [rows][DEEP_SROW] fp32, or for fp32 slot-major
// [DEEP_SLOTS][rows rounded up to 4] (then P in its place); P [rows]
// [DEEP_PROW] 16-bit; the pass's k and v scales; m, l and the pass's
// rescale factor [DEEP_ROWS], the last-arrival flag and the merge's two
// mbarriers.
template <class T, int DI>
struct ShortLayout {
  int rp4, q, s, p, sc, ml, bytes;
  __host__ __device__ ShortLayout(int rows) {
    rp4 = (rows + 3) & ~3;
    q = ShortBox<T, DI>::RING;
    s = q + (T::SCALAR ? rp4 * DI * 4 : 0);
    p = s + (T::SCALAR ? DEEP_SLOTS * rp4 : rows * DEEP_SROW) * 4;
    sc = p + (T::SCALAR ? 0 : rows * DEEP_PROW * 2);
    ml = sc + (T::SCALED ? 2 * DEEP_SLOTS * 4 : 0);
    bytes = ml + 3 * DEEP_ROWS * 4 + 32;
  }
};

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void fence_acq_rel_gpu() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

// `bytes` (a multiple of 16) global -> shared by the TMA unit, completing
// `bar` by them.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Four output elements at out[i] (16-bit, or fp32 for fp32 storage).
template <class T>
__device__ __forceinline__ void store4(void* out, size_t i, float4 x) {
  if constexpr (T::SCALAR) {
    *reinterpret_cast<float4*>(static_cast<float*>(out) + i) = x;
  } else {
    uint2 o;
    o.x = pack2<T::F16>(x.x, x.y);
    o.y = pack2<T::F16>(x.z, x.w);
    *reinterpret_cast<uint2*>(static_cast<uint16_t*>(out) + i) = o;
  }
}

// What normalises a row that one range covers: its (m, l) and s_aux's
// logit aux2 (exp2 domain; -inf without s_aux) as the weight of the
// unnormalised O, exp2(m - M) / (l exp2(m - M) + exp2(aux2 - M)), M =
// max(m, aux2); 0 where nothing is live.
__device__ __forceinline__ float out_factor(float m, float l, float aux2) {
  const float mx = fmaxf(m, aux2);
  const float mu = mx == -INFINITY ? 0.f : mx;
  const float w = m == -INFINITY ? 0.f : exp2f(m - mu);
  const float den = fmaf(l, w, aux2 == -INFINITY ? 0.f : exp2f(aux2 - mu));
  return den > 0.f ? w / den : 0.f;
}

// A pass's softmax over its nsl slots of S, a warp per row: m, l (p in
// fp32) and P (fp32 storage: p in S's place, slot-major with rows rounded
// to rp4; else p (* v_scale) rounded to 16 bits), p against the running max
// (m_old: the earlier passes'), and the factor that rescales their O.
// Between two barriers: every warp's S is written before, P, m, l and the
// factors after.
template <class T>
__device__ __forceinline__ void pass_softmax(float* s_sm, uint8_t* p_sm,
                                             const float* vsc, float* m_sm,
                                             float* l_sm, float* a_sm, int R,
                                             int nsl, int rp4, bool first,
                                             int warp, int lane) {
  __syncthreads();  // every warp's S is written
  for (int r = warp; r < R; r += NWARPS) {
    const float m_old = first ? -INFINITY : m_sm[r];
    float mx = m_old, sum = 0.f;
    if constexpr (T::SCALAR) {
      float* sr = s_sm + r;  // slot j at sr[j * rp4]
      for (int j = lane; j < nsl; j += 32) mx = fmaxf(mx, sr[j * rp4]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_use = mx == -INFINITY ? 0.f : mx;
      for (int j = lane; j < nsl; j += 32) {
        const float x = sr[j * rp4];
        const float p = x == -INFINITY ? 0.f : exp2f(x - m_use);
        sum += p;
        sr[j * rp4] = p;
      }
    } else {
      float* sr = s_sm + r * DEEP_SROW;
      for (int j = lane * 2; j < nsl; j += 64) {
        const float2 x = *reinterpret_cast<const float2*>(sr + j);
        mx = fmaxf(mx, fmaxf(x.x, x.y));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_use = mx == -INFINITY ? 0.f : mx;
      for (int j = lane * 2; j < nsl; j += 64) {
        const float2 x = *reinterpret_cast<const float2*>(sr + j);
        const float p0 = x.x == -INFINITY ? 0.f : exp2f(x.x - m_use);
        const float p1 = x.y == -INFINITY ? 0.f : exp2f(x.y - m_use);
        sum += p0 + p1;
        *reinterpret_cast<uint32_t*>(p_sm + (r * DEEP_PROW + j) * 2) =
            T::SCALED ? pack2<T::F16>(p0 * vsc[j], p1 * vsc[j + 1])
                      : pack2<T::F16>(p0, p1);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      const float m_use = mx == -INFINITY ? 0.f : mx;
      const float a = m_old == -INFINITY ? 0.f : exp2f(m_old - m_use);
      m_sm[r] = mx;
      l_sm[r] = first ? sum : fmaf(l_sm[r], a, sum);
      a_sm[r] = a;
    }
  }
  __syncthreads();  // P, m, l and the factors are written
}

// The unit's merge: every CTA of a unit calls it after writing its partial
// (O [units][n_split][rows][Dt] fp32 in part, then (m, l) [units][n_split]
// [rows]); the last to arrive (an atomic count per unit, which it sets back
// to 0) merges them and writes the output rows [orow, orow + R), the
// others return. `ring` holds two merge chunks of `buf` bytes; the weights
// [n_split][R] take `wts`, 1 / the denominators `inv_sm` [R]; `flag` is an
// int and then two mbarriers, 16 bytes on. Where the unit's partials fit
// the two chunks and its rows are at most a (row, 4 columns) item a thread
// (every short row's; a deep one's at 2 rows of 256), every thread copies
// them into the ring by plain loads, all issued at once, and the merge
// sums them from there: no TMA, no mbarrier, no proxy fence.
template <class T>
__device__ __forceinline__ void merge_unit(
    unsigned char* ring, int buf, float* wts, float* inv_sm, int* flag,
    const float* part, int* counters, const float* s_aux, void* out,
    int unit, int n_split, int n_units, int rows, int R, int Dt, size_t orow,
    int h0, int tid, int warp, int lane) {
  fence_acq_rel_gpu();  // this CTA's partial before its arrival
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(counters + unit, 1) == n_split - 1;
  __syncthreads();
  if (!*flag) return;
  fence_acq_rel_gpu();  // every partial after the arrivals
  const float* pml = part + (size_t)n_units * n_split * rows * Dt;
  const float* ml = pml + (size_t)unit * n_split * rows * 2;
  const float* o0 = part + (size_t)unit * n_split * rows * Dt;
  // the unit's O in the ring where it fits and its rows are an item a
  // thread (visible after the weights' barrier; the weights' loads of (m,
  // l) overlap the copy)
  const bool fits =
      R * Dt <= 4 * NTHREADS && n_split * rows * Dt * 4 <= 2 * buf;
  if (fits) {
    const int n4 = n_split * rows * Dt / 4;
    const float4* src = reinterpret_cast<const float4*>(o0);
    float4* dst = reinterpret_cast<float4*>(ring);
#pragma unroll 16
    for (int i = tid; i < n4; i += NTHREADS) dst[i] = __ldcg(src + i);
  } else {
    // ... and before the TMA unit (the async proxy) reads them
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
  }
  // The partials' O, a window of wc columns at a time (R x wc <= 2048
  // floats: at most 4 float4 items a thread), in chunks of jc partials
  // [jc][R][wc] that TMA bulk copies bring into the ring, two in flight
  // (one copy a chunk where the window is the whole row of all `rows`
  // rows, else one a (partial, row)); the first two are issued before the
  // weights are known.
  const int wc = min(Dt, (2048 / R) & ~3);
  const int jc = buf / (R * wc * 4);
  const bool whole = wc == Dt && R == rows;
  const int n_chunks = (n_split + jc - 1) / jc;
  const int n_windows = (Dt + wc - 1) / wc;
  uint64_t* bar = reinterpret_cast<uint64_t*>(flag + 4);  // two
  if (tid == 0 && !fits) {
    mbar_init(bar, 1);
    mbar_init(bar + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int gc) {  // chunk gc % n_chunks of window gc / n_chunks
    if (warp != 0) return;
    const int ch = gc % n_chunks, c0 = gc / n_chunks * wc;
    const int j0 = ch * jc, nj = min(jc, n_split - j0);
    const int cw = min(wc, Dt - c0);
    uint8_t* dst = ring + (gc & 1) * buf;
    uint64_t* b = bar + (gc & 1);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (whole) {
      if (lane == 0) {
        const uint32_t bytes = (uint32_t)nj * rows * Dt * 4;
        mbar_expect_tx(b, bytes);
        bulk_load(dst, o0 + (size_t)j0 * rows * Dt, bytes, b);
      }
    } else {
      if (lane == 0) mbar_expect_tx(b, (uint32_t)nj * R * cw * 4);
      __syncwarp();
      for (int c = lane; c < nj * R; c += 32) {
        const int jj = c / R, r = c - jj * R;
        bulk_load(dst + ((size_t)jj * R + r) * wc * 4,
                  o0 + ((size_t)(j0 + jj) * rows + r) * Dt + c0, cw * 4, b);
      }
    }
  };
  const int n_gc = n_windows * n_chunks;
  if (!fits) {
    issue(0);
    if (n_gc > 1) issue(1);
  }
  // Each row's max M over the partials (s_aux as one more of LSE s_aux and
  // value 0), each partial's weight exp2(m_j - M) (0 where nothing was
  // live: its O unwritten, skipped) into wts [n_split][R], and 1 / the
  // denominator; a warp per row, m and l read in one pass (online).
  for (int r = warp; r < R; r += NWARPS) {
    float mx = -INFINITY, den = 0.f;
    for (int j = lane; j < n_split; j += 32) {
      const float2 e =
          __ldcg(reinterpret_cast<const float2*>(ml) + j * rows + r);
      wts[j * R + r] = e.x;
      if (e.x > mx) {
        den = den * exp2f(mx - e.x) + e.y;  // mx = -inf: den is 0
        mx = e.x;
      } else if (e.x != -INFINITY) {
        den = fmaf(exp2f(e.x - mx), e.y, den);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, mx, off);
      const float od = __shfl_xor_sync(0xffffffffu, den, off);
      const float nm = fmaxf(mx, om);
      den = (mx == -INFINITY ? 0.f : den * exp2f(mx - nm)) +
            (om == -INFINITY ? 0.f : od * exp2f(om - nm));
      mx = nm;
    }
    const float aux2 = s_aux != nullptr ? s_aux[h0 + r] * LOG2E : -INFINITY;
    const float m_all = fmaxf(mx, aux2);
    const float m_use = m_all == -INFINITY ? 0.f : m_all;
    for (int j = lane; j < n_split; j += 32) {
      const float mj = wts[j * R + r];
      wts[j * R + r] = mj == -INFINITY ? 0.f : exp2f(mj - m_use);
    }
    if (lane == 0) {
      den = mx == -INFINITY ? 0.f : den * exp2f(mx - m_use);
      if (s_aux != nullptr) den += exp2f(aux2 - m_use);
      inv_sm[r] = den > 0.f ? 1.f / den : 0.f;
    }
  }
  __syncthreads();  // the weights are written (and the copies landed)
  if (fits) {
    const float* sm = reinterpret_cast<const float*>(ring);
    const int c4n = Dt / 4;
    for (int it = tid; it < R * c4n; it += NTHREADS) {
      const int r = it / c4n, c = (it - r * c4n) * 4;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int j = 0; j < n_split; ++j) {
        const float w = wts[j * R + r];
        const float4 o = *reinterpret_cast<const float4*>(
            sm + ((size_t)j * rows + r) * Dt + c);
        const bool ok = w != 0.f;  // a partial of weight 0: any bits
        a.x = ok ? fmaf(w, o.x, a.x) : a.x;
        a.y = ok ? fmaf(w, o.y, a.y) : a.y;
        a.z = ok ? fmaf(w, o.z, a.z) : a.z;
        a.w = ok ? fmaf(w, o.w, a.w) : a.w;
      }
      const float inv = inv_sm[r];
      store4<T>(out, (orow + r) * Dt + c,
                make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv));
    }
    if (tid == 0) counters[unit] = 0;  // for the next launch on this stream
    return;
  }
  float4 a4[4];
  for (int gc = 0; gc < n_gc; ++gc) {
    const int ch = gc % n_chunks, c0 = gc / n_chunks * wc;
    const int c4n = min(wc, Dt - c0) / 4, items = R * c4n;
    if (ch == 0) {
#pragma unroll
      for (int u = 0; u < 4; ++u) a4[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    mbar_wait_timed(bar + (gc & 1), (gc >> 1) & 1);
    const float* src = reinterpret_cast<const float*>(ring + (gc & 1) * buf);
    const int j0 = ch * jc, nj = min(jc, n_split - j0);
    // a thread's (up to) 4 items side by side, so their loads overlap; a
    // partial of weight 0 is selected away (its O may be any bits)
    int ir[4], io[4];  // an item's row, and its offset in a partial
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int it = tid + u * NTHREADS;
      ir[u] = it / c4n;
      io[u] = ir[u] * wc + (it - ir[u] * c4n) * 4;
    }
#pragma unroll 2
    for (int jj = 0; jj < nj; ++jj) {
      const float* sj = src + (size_t)jj * R * wc;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (tid + u * NTHREADS < items) {
          const float w = wts[(j0 + jj) * R + ir[u]];
          const float4 o = *reinterpret_cast<const float4*>(sj + io[u]);
          const bool ok = w != 0.f;
          a4[u].x = ok ? fmaf(w, o.x, a4[u].x) : a4[u].x;
          a4[u].y = ok ? fmaf(w, o.y, a4[u].y) : a4[u].y;
          a4[u].z = ok ? fmaf(w, o.z, a4[u].z) : a4[u].z;
          a4[u].w = ok ? fmaf(w, o.w, a4[u].w) : a4[u].w;
        }
      }
    }
    __syncthreads();  // the chunk's buffer is free for the copy after next
    if (gc + 2 < n_gc) issue(gc + 2);
    if (ch == n_chunks - 1) {  // the window's rows of the output
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int it = tid + u * NTHREADS;
        if (it < items) {
          const int r = it / c4n, q4 = it - r * c4n;
          const float inv = inv_sm[r];
          store4<T>(out, (orow + r) * Dt + c0 + q4 * 4,
                    make_float4(a4[u].x * inv, a4[u].y * inv, a4[u].z * inv,
                                a4[u].w * inv));
        }
      }
    }
  }
  if (tid == 0) counters[unit] = 0;  // for the next launch on this stream
}

// One deep CTA: query rows [row_lo, row_lo + R) of a (b, kv head) over the
// slots [lo, hi) of split blockIdx.x (hi at most hwm), then, if it is the
// unit's last to arrive, the merge of the unit's partials (see
// merge_unit; with one range too: a direct write in the epilogue slowed
// the codes' rows past D = 128 more than it saved on one range).
// Two CTAs an SM: ptxas then takes the registers it needs (below, it
// caps near 96 and spills).
template <class T>
__global__ void __launch_bounds__(NTHREADS, 2)
    deep_decode_kernel(const void* __restrict__ q,
                       const uint8_t* __restrict__ k,
                       const uint8_t* __restrict__ v,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale, State st,
                       const float* __restrict__ s_aux,
                       void* __restrict__ out, float* __restrict__ part,
                       int* __restrict__ counters, int H_kv, int G, int rows,
                       int n_pieces, int split_slots, int S_total,
                       int sink_cap, int window, int Dt, float scale_log2) {
  using L = DeepLayout<T>;
  constexpr int EC = L::EC, QB = L::QB, TL = DEEP_TL;
  constexpr int KS = deep_kstride<T>(), VS = DEEP_VSTRIDE;
  constexpr int WC = EC / NWARPS;                  // a warp's V columns
  constexpr int NTV = T::SCALAR ? 1 : WC / 8;      // their n-tiles
  static_assert(T::SCALAR || NTV % 4 == 0, "V columns in groups of 32");
  constexpr int NACC = T::SCALAR ? DEEP_ROWS : 4 * NTV;
  static_assert(!T::SCALAR || WC == 32, "fp32: a lane per V column");
  static_assert(DEEP_MERGE_BUF >= 4 * 2048 * 4, "a chunk: 4 partials");
  static_assert(2 * DEEP_MERGE_BUF <= L::RING, "two chunks in the ring");
  extern __shared__ __align__(16) unsigned char smem[];
  const L lay(rows, Dt);
  const int kch = lay.kch, qrow = lay.qrow, rp4 = lay.rp4;
  float* s_sm = reinterpret_cast<float*>(smem + lay.s);
  uint8_t* p_sm = smem + lay.p;
  float* ksc = reinterpret_cast<float*>(smem + lay.sc);
  float* vsc = ksc + DEEP_SLOTS;
  float* m_sm = reinterpret_cast<float*>(smem + lay.ml);
  float* l_sm = m_sm + DEEP_ROWS;
  float* a_sm = l_sm + DEEP_ROWS;
  int* last_sm = reinterpret_cast<int*>(a_sm + DEEP_ROWS);

  const int split = blockIdx.x, n_split = gridDim.x;
  const int unit = blockIdx.y;  // (b * H_kv + kv head) * n_pieces + piece
  const int bkv = unit / n_pieces;
  const int row_lo = (unit - bkv * n_pieces) * rows;
  const int R = min(G - row_lo, rows);
  const int b = bkv / H_kv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int h0 = (bkv - b * H_kv) * G + row_lo;  // query head of local row 0
  const size_t orow = (size_t)bkv * G + row_lo;  // output row of local row 0

  const SeqState ss = seq_state(st, b, S_total, sink_cap, window);
  const int lo0 = split * split_slots;
  const int hi0 = min(lo0 + split_slots, ss.hwm);  // the CTA's range
  const size_t head = (size_t)bkv * S_total;
  const int row_bytes = Dt * T::BYTES;  // a cache row
  const size_t pi = (size_t)unit * n_split + split;  // this CTA's partial
  float* po = part + pi * rows * Dt;
  float* pml = part + (size_t)gridDim.y * n_split * rows * Dt;

  if (hi0 > lo0) {
    // q's rows: in the first pass's first commit group.
    const uint8_t* qg = static_cast<const uint8_t*>(q) + orow * Dt * QB;
    const int q16 = kch * EC * QB / 16;  // 16-byte pieces of a q row
    for (int c = tid; c < R * q16; c += NTHREADS) {
      const int r = c / q16, byte = (c - r * q16) * 16;
      const bool ok = byte < Dt * QB;
      cp_async16(smem + lay.q + r * qrow + byte,
                 qg + (ok ? (size_t)r * Dt * QB + byte : 0), ok);
    }
    // The range in passes of at most DEEP_SLOTS slots [lo, hi) (one, unless
    // the cache is past DEEP_SPLITS x DEEP_SLOTS slots).
    for (int lo = lo0; lo < hi0; lo += DEEP_SLOTS) {
      const int hi = min(lo + DEEP_SLOTS, hi0);
      const bool first = lo == lo0;
      const int n_t = (hi - lo + TL - 1) / TL;  // tiles
      const int nk = n_t * kch;  // K boxes, and as many V boxes
      auto live = [&](int slot) {
        const int sw = slot - sink_cap;
        const int age = sw < ss.write_pos ? ss.write_pos - 1 - sw
                                          : ss.write_pos - 1 - sw + window;
        return slot < hi &&
               (slot < ss.sink_len ||
                (sw >= 0 && sw < window && age < ss.window_len));
      };
      if (!first) __syncthreads();  // the last pass's boxes, P, scales read
      // The pass's scales (with q, in the first pass): one commit group.
      if constexpr (T::SCALED) {
        for (int i = tid; i < n_t * TL; i += NTHREADS) {
          const bool ok = lo + i < hi;
          const size_t off = head + (ok ? lo + i : 0);
          cp_async4(ksc + i, k_scale + off, ok);
          cp_async4(vsc + i, v_scale + off, ok);
        }
      }
      cp_async_commit();

      // Box i into its stage: i < nk the K box of tile i / kch, depth chunk
      // i % kch; then the V boxes, column chunk by column chunk. Zeros past
      // the range and past the row.
      auto load_box = [&](int i) {
        const bool isv = i >= nk;
        const int j = isv ? i - nk : i;
        const int tile = isv ? j % n_t : j / kch;
        const int ch = isv ? j / n_t : j % kch;
        const uint8_t* src = isv ? v : k;
        const int stride = isv ? VS : KS;
        uint8_t* dst = smem + (i % DEEP_STAGES) * DEEP_BOX;
        const int slot0 = lo + tile * TL, byte0 = ch * DEEP_ROW;
        constexpr int R16 = DEEP_ROW / 16;
        for (int c = tid; c < TL * R16; c += NTHREADS) {
          const int r = c / R16, cc = (c % R16) * 16;
          const bool ok = slot0 + r < hi && byte0 + cc < row_bytes;
          const size_t off = ok ? (head + slot0 + r) * row_bytes + byte0 + cc
                                : 0;
          cp_async16(dst + r * stride + cc, src + off, ok);
        }
      };

      // S of the tile so far (mma: two chains of k-steps; fp32: a row each)
      float s0[T::SCALAR ? DEEP_ROWS : 4], s1[4];
      float acc[NACC];
#pragma unroll
      for (int s = 0; s < DEEP_STAGES - 1; ++s) {
        if (s < 2 * nk) load_box(s);
        cp_async_commit();
      }
      for (int i = 0; i < 2 * nk; ++i) {
        cp_async_wait<DEEP_STAGES - 2>();  // box i (and q) have landed
        __syncthreads();  // ... for every thread; box i - 1's stage is free
        if (i + DEEP_STAGES - 1 < 2 * nk) load_box(i + DEEP_STAGES - 1);
        cp_async_commit();
        const uint8_t* box = smem + (i % DEEP_STAGES) * DEEP_BOX;
        if (i < nk) {
          // S of the warp's 8 slots of the tile over one depth chunk.
          const int tile = i / kch, ch = i - tile * kch;
          const int cols = min(EC, Dt - ch * EC);  // the chunk's depth
          if (ch == 0) {
#pragma unroll
            for (int e = 0; e < (T::SCALAR ? DEEP_ROWS : 4); ++e) s0[e] = 0.f;
#pragma unroll
            for (int e = 0; e < 4; ++e) s1[e] = 0.f;
          }
          if constexpr (T::SCALAR) {
            // a lane per (slot s8, quarter dq of the chunk's float4s); the
            // rows in groups of 4 (rows past R but inside the group computed
            // and dropped)
            const int s8 = lane & 7, dq = lane >> 3;
            const float* kr =
                reinterpret_cast<const float*>(box + (warp * 8 + s8) * KS);
            const float* qs =
                reinterpret_cast<const float*>(smem + lay.q) + ch * EC;
            for (int f = dq; f * 4 < cols; f += 4) {
              const float4 kv = *reinterpret_cast<const float4*>(kr + f * 4);
#pragma unroll
              for (int g4 = 0; g4 < DEEP_ROWS / 4; ++g4) {
                if (g4 * 4 < R) {
#pragma unroll
                  for (int rr = 0; rr < 4; ++rr) {
                    const int r = g4 * 4 + rr;
                    const float4 qv = *reinterpret_cast<const float4*>(
                        qs + r * (qrow / 4) + f * 4);
                    s0[r] = fmaf(qv.w, kv.w,
                                 fmaf(qv.z, kv.z,
                                      fmaf(qv.y, kv.y,
                                           fmaf(qv.x, kv.x, s0[r]))));
                  }
                }
              }
            }
          } else {
            // m16n8k16 over the warp's slots: q's rows g, g + 8 (zero past
            // R), the k-steps alternating between two accumulators. Inside a
            // k-step the 16 columns are permuted alike in q and K (lane t4's
            // k pairs (2 t4, +1) and (2 t4 + 8, +9) are columns 4 t4 .. 4 t4
            // + 3), so one 64-bit load of q's row and one load of K's row
            // (64-bit 16-bit storage, 32-bit codes) give both registers.
            const uint8_t* kr = box + (warp * 8 + g) * KS + t4 * 4 * T::BYTES;
            const uint8_t* qr =
                smem + lay.q + g * qrow + (ch * EC + t4 * 4) * 2;
            const bool ok0 = g < R, ok1 = g + 8 < R;
            const int nks = (cols + 15) / 16;
            auto kstep = [&](float(&sa)[4], int kk) {
              const uint8_t* qk = qr + kk * 32;
              const uint2 q0 = ok0 ? *reinterpret_cast<const uint2*>(qk)
                                   : make_uint2(0u, 0u);
              const uint2 q1 =
                  ok1 ? *reinterpret_cast<const uint2*>(qk + 8 * qrow)
                      : make_uint2(0u, 0u);
              const uint32_t a[4] = {q0.x, q1.x, q0.y, q1.y};
              const uint8_t* kp = kr + kk * 16 * T::BYTES;
              uint32_t b0, b1;
              if constexpr (T::SCALED) {
                const uint32_t w = lds32(kp);
                b0 = T::from16(w);
                b1 = T::from16(w >> 16);
              } else {
                const uint2 w = *reinterpret_cast<const uint2*>(kp);
                b0 = w.x;
                b1 = w.y;
              }
              mma16816<T::F16>(sa, a, b0, b1);
            };
            int kk = 0;
#pragma unroll 2
            for (; kk + 1 < nks; kk += 2) {
              kstep(s0, kk);
              kstep(s1, kk + 1);
            }
            if (kk < nks) kstep(s0, kk);
          }
          if (ch == kch - 1) {
            // The tile's S into the exp2 domain (k_scale when quantized),
            // masked, into S.
            if constexpr (T::SCALAR) {
              const int s8 = lane & 7, dq = lane >> 3;
              const int idx = tile * TL + warp * 8 + s8;
              const bool ok = live(lo + idx);
#pragma unroll
              for (int r = 0; r < DEEP_ROWS; ++r) {
                if ((r & ~3) < R) {
                  float x = s0[r];
                  x += __shfl_xor_sync(0xffffffffu, x, 8);
                  x += __shfl_xor_sync(0xffffffffu, x, 16);
                  if (r < R && (r & 3) == dq)
                    s_sm[idx * rp4 + r] = ok ? x * scale_log2 : -INFINITY;
                }
              }
            } else {
#pragma unroll
              for (int e2 = 0; e2 < 2; ++e2) {
                const int idx = tile * TL + warp * 8 + t4 * 2 + e2;
                const bool ok = live(lo + idx);
                const float f = T::SCALED ? ksc[idx] * scale_log2 : scale_log2;
                if (g < R)
                  s_sm[g * DEEP_SROW + idx] =
                      ok ? (s0[e2] + s1[e2]) * f : -INFINITY;
                if (g + 8 < R)
                  s_sm[(g + 8) * DEEP_SROW + idx] =
                      ok ? (s0[2 + e2] + s1[2 + e2]) * f : -INFINITY;
              }
            }
          }
          if (i == nk - 1)
            pass_softmax<T>(s_sm, p_sm, vsc, m_sm, l_sm, a_sm, R, n_t * TL,
                            rp4, first, warp, lane);
        } else {
          // O's columns of the warp in one column chunk += P V over a tile.
          const int j = i - nk, ch = j / n_t, tile = j - ch * n_t;
          if (tile == 0) {
#pragma unroll
            for (int e = 0; e < NACC; ++e) acc[e] = 0.f;
          }
          const int ncol = Dt - ch * EC - warp * WC;  // the warp's columns left
          if constexpr (T::SCALAR) {
            if (ncol > 0) {
              const float* vb = reinterpret_cast<const float*>(box) +
                                warp * WC + lane;
              const float* pr = s_sm + tile * TL * rp4;
#pragma unroll 4
              for (int jj = 0; jj < TL; ++jj) {
                const float vv = vb[jj * (VS / 4)];
#pragma unroll
                for (int g4 = 0; g4 < DEEP_ROWS / 4; ++g4) {
                  if (g4 * 4 < R) {
                    const float4 p = *reinterpret_cast<const float4*>(
                        pr + jj * rp4 + g4 * 4);
                    acc[g4 * 4] = fmaf(p.x, vv, acc[g4 * 4]);
                    acc[g4 * 4 + 1] = fmaf(p.y, vv, acc[g4 * 4 + 1]);
                    acc[g4 * 4 + 2] = fmaf(p.z, vv, acc[g4 * 4 + 2]);
                    acc[g4 * 4 + 3] = fmaf(p.w, vv, acc[g4 * 4 + 3]);
                  }
                }
              }
            }
          } else {
            // The warp's columns in groups of 32; n-tile nt of a group's
            // lane column g is the group's column 4 g + nt, so one load of
            // a V row (32-bit codes, 64-bit 16-bit storage) gives a lane its
            // 4 n-tiles' elements, paired across rows by byte permutes.
#pragma unroll
            for (int kk = 0; kk < TL / 16; ++kk) {
              const uint8_t* pa =
                  p_sm + (g * DEEP_PROW + tile * TL + kk * 16 + t4 * 2) * 2;
              const uint32_t a[4] = {
                  g < R ? lds32(pa) : 0u,
                  g + 8 < R ? lds32(pa + 8 * DEEP_PROW * 2) : 0u,
                  g < R ? lds32(pa + 16) : 0u,
                  g + 8 < R ? lds32(pa + 8 * DEEP_PROW * 2 + 16) : 0u};
              const uint8_t* vr = box + (kk * 16 + t4 * 2) * VS +
                                  (warp * WC + 4 * g) * T::BYTES;
#pragma unroll
              for (int gr = 0; gr < NTV / 4; ++gr) {
                if (gr * 32 < ncol) {
                  const uint8_t* pp = vr + gr * 32 * T::BYTES;
                  float(*ac)[4] = reinterpret_cast<float(*)[4]>(&acc[gr * 16]);
                  if constexpr (T::SCALED) {
                    const uint32_t w0 = lds32(pp), w1 = lds32(pp + VS);
                    const uint32_t w8 = lds32(pp + 8 * VS);
                    const uint32_t w9 = lds32(pp + 9 * VS);
#pragma unroll
                    for (int nt = 0; nt < 4; ++nt) {
                      mma16816<T::F16>(ac[nt], a, T::vpair(w0, w1, nt),
                                       T::vpair(w8, w9, nt));
                    }
                  } else {
                    const uint2 x0 = *reinterpret_cast<const uint2*>(pp);
                    const uint2 x1 = *reinterpret_cast<const uint2*>(pp + VS);
                    const uint2 x8 =
                        *reinterpret_cast<const uint2*>(pp + 8 * VS);
                    const uint2 x9 =
                        *reinterpret_cast<const uint2*>(pp + 9 * VS);
#pragma unroll
                    for (int nt = 0; nt < 4; ++nt) {
                      const uint32_t sel = nt & 1 ? 0x7632u : 0x5410u;
                      mma16816<T::F16>(
                          ac[nt], a,
                          __byte_perm(nt < 2 ? x0.x : x0.y,
                                      nt < 2 ? x1.x : x1.y, sel),
                          __byte_perm(nt < 2 ? x8.x : x8.y,
                                      nt < 2 ? x9.x : x9.y, sel));
                    }
                  }
                }
              }
            }
          }
          if (tile == n_t - 1) {  // the chunk's columns of the partial O
            const int c0 = ch * EC + warp * WC;
            if constexpr (T::SCALAR) {
              if (lane < ncol) {
#pragma unroll
                for (int r = 0; r < DEEP_ROWS; ++r) {
                  if (r < R) {
                    float* o = po + (size_t)r * Dt + c0 + lane;
                    *o = first ? acc[r] : fmaf(*o, a_sm[r], acc[r]);
                  }
                }
              }
            } else {
              // acc[gr][nt][e]: row g + 8 (e >> 1), the group's column 8 t4
              // + 4 (e & 1) + nt: the 4 n-tiles one float4
#pragma unroll
              for (int gr = 0; gr < NTV / 4; ++gr) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int row = g + 8 * (e >> 1);
                  const int col = c0 + gr * 32 + 8 * t4 + 4 * (e & 1);
                  if (row < R && col < Dt) {
                    float4 x = make_float4(
                        acc[gr * 16 + e], acc[gr * 16 + 4 + e],
                        acc[gr * 16 + 8 + e], acc[gr * 16 + 12 + e]);
                    float4* o =
                        reinterpret_cast<float4*>(po + (size_t)row * Dt + col);
                    if (!first) {  // this thread wrote *o in the last pass
                      const float4 y = *o;
                      const float a = a_sm[row];
                      x = make_float4(fmaf(y.x, a, x.x), fmaf(y.y, a, x.y),
                                      fmaf(y.z, a, x.z), fmaf(y.w, a, x.w));
                    }
                    *o = x;
                  }
                }
              }
            }
          }
        }
      }
    }
    cp_async_wait<0>();
    if (tid < R) {
      pml[(pi * rows + tid) * 2] = m_sm[tid];
      pml[(pi * rows + tid) * 2 + 1] = l_sm[tid];
    }
  } else if (tid < R) {  // an empty range: nothing live, no O written
    pml[(pi * rows + tid) * 2] = -INFINITY;
    pml[(pi * rows + tid) * 2 + 1] = 0.f;
  }
  // the weights [n_split][R] take S's place
  merge_unit<T>(smem, DEEP_MERGE_BUF, s_sm, l_sm, last_sm, part, counters,
                s_aux, out, unit, n_split, gridDim.y, rows, R, Dt, orow, h0,
                tid, warp, lane);
}

// The merge of a unit whose ranges are one thread block cluster (2 to
// SHORT_CLUSTER CTAs): each CTA's partial waits in its own shared memory
// (O [R][Dt] at co, m and l at m_sm, l_sm; an empty range's m = -inf, its O
// unread); the cluster syncs, and its threads share the (row, 4 columns)
// items, each reading every rank's partial over distributed shared memory
// (all ranks' loads of an item issued together), s_aux joining as one more
// partial of LSE s_aux and value 0 (out_factor); the row is written once. A
// second cluster barrier keeps every CTA's shared memory alive until all
// reads are done. No scratch in device memory, no counter.
template <class T>
__device__ __forceinline__ void merge_cluster(cg::cluster_group& cluster,
                                              float* co, float* m_sm,
                                              float* l_sm,
                                              const float* s_aux, void* out,
                                              int R, int Dt, size_t orow,
                                              int h0, int tid) {
  cluster.sync();  // every rank's partial is written
  const int rank = (int)cluster.block_rank();
  const int n_ranks = (int)cluster.num_blocks();
  const int c4n = Dt / 4;
  for (int it = tid * n_ranks + rank; it < R * c4n;
       it += n_ranks * NTHREADS) {
    const int r = it / c4n, c = (it - r * c4n) * 4;
    float rm[SHORT_CLUSTER], rl[SHORT_CLUSTER];
    float4 ro[SHORT_CLUSTER];
#pragma unroll
    for (int k = 0; k < SHORT_CLUSTER; ++k) {
      if (k < n_ranks) {
        rm[k] = *cluster.map_shared_rank(m_sm + r, k);
        rl[k] = *cluster.map_shared_rank(l_sm + r, k);
        ro[k] = *cluster.map_shared_rank(
            reinterpret_cast<float4*>(co + r * Dt + c), k);
      }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < SHORT_CLUSTER; ++k)
      if (k < n_ranks) mx = fmaxf(mx, rm[k]);
    float den = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < SHORT_CLUSTER; ++k) {
      if (k < n_ranks && rm[k] != -INFINITY) {  // else nothing live
        const float w = exp2f(rm[k] - mx);
        den = fmaf(w, rl[k], den);
        a = make_float4(fmaf(w, ro[k].x, a.x), fmaf(w, ro[k].y, a.y),
                        fmaf(w, ro[k].z, a.z), fmaf(w, ro[k].w, a.w));
      }
    }
    const float f = out_factor(
        mx, den, s_aux != nullptr ? s_aux[h0 + r] * LOG2E : -INFINITY);
    store4<T>(out, (orow + r) * Dt + c,
              make_float4(a.x * f, a.y * f, a.z * f, a.w * f));
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

// One short CTA (every storage at D <= 128, the instance's D_i columns): as
// deep_decode_kernel, over ShortBox's boxes of whole rows. S: a warp takes
// 8 slots of each 32 of a K box (mma: NTW n-tiles, independent chains, q's
// A fragments in registers; fp32: a lane per (slot, quarter of the depth),
// q's rows in shared memory). P V: a warp takes every fourth 16-slot k-step
// of a V box over all D_i columns (NG groups of 32; fp32: a quarter of the
// box's slots, a lane per column of each group), its O in registers over
// the whole range (rescaled between passes); at the range's end the 4
// warps' O are summed through the ring. Then, with one range, the output
// rows; with 2 to SHORT_CLUSTER ranges (launched as one cluster), the
// partial in shared memory and merge_cluster; else the partial and
// merge_unit.
template <class T, int DI>
__global__ void __launch_bounds__(NTHREADS, 2)
    short_decode_kernel(const void* __restrict__ q,
                        const uint8_t* __restrict__ k,
                        const uint8_t* __restrict__ v,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale, State st,
                        const float* __restrict__ s_aux,
                        void* __restrict__ out, float* __restrict__ part,
                        int* __restrict__ counters, int H_kv, int G, int rows,
                        int n_pieces, int split_slots, int S_total,
                        int sink_cap, int window, int Dt, float scale_log2) {
  using Box = ShortBox<T, DI>;
  constexpr int TL = Box::TL, KS = Box::KS, VS = Box::VS, NG = Box::NG;
  constexpr int KT = DI / 16;        // k-steps of S
  constexpr int NTW = TL / 32;       // a warp's 8-slot n-tiles of a K box
  constexpr int KQ = TL / 64;        // a warp's 16-slot k-steps of a V box
  constexpr int R16 = Box::RB / 16;  // 16-byte pieces of a box row
  constexpr int RW = NG * 32 + 4;    // a row of a warp's O in the ring
  static_assert(DI % 16 == 0 && DI <= 128, "short rows");
  static_assert(TL % (T::SCALAR ? 32 : 64) == 0 && DEEP_SLOTS % TL == 0,
                "whole k-steps");
  static_assert((NWARPS * 16 * RW + DEEP_ROWS * DI) * 4 <= Box::RING,
                "the warps' O and the CTA's");
  static_assert(2 * Box::MERGE_BUF <= Box::RING &&
                    Box::MERGE_BUF >= DEEP_ROWS * DI * 4,
                "two chunks in the ring, a partial in a chunk");
  extern __shared__ __align__(16) unsigned char smem[];
  const ShortLayout<T, DI> lay(rows);
  float* s_sm = reinterpret_cast<float*>(smem + lay.s);
  uint8_t* p_sm = smem + lay.p;
  float* ksc = reinterpret_cast<float*>(smem + lay.sc);
  float* vsc = ksc + DEEP_SLOTS;
  float* m_sm = reinterpret_cast<float*>(smem + lay.ml);
  float* l_sm = m_sm + DEEP_ROWS;
  float* a_sm = l_sm + DEEP_ROWS;
  int* last_sm = reinterpret_cast<int*>(a_sm + DEEP_ROWS);

  const int split = blockIdx.x, n_split = gridDim.x;
  const int unit = blockIdx.y;  // (b * H_kv + kv head) * n_pieces + piece
  const int bkv = unit / n_pieces;
  const int row_lo = (unit - bkv * n_pieces) * rows;
  const int R = min(G - row_lo, rows);
  const int b = bkv / H_kv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int h0 = (bkv - b * H_kv) * G + row_lo;  // query head of local row 0
  const size_t orow = (size_t)bkv * G + row_lo;  // output row of local row 0

  const SeqState ss = seq_state(st, b, S_total, sink_cap, window);
  const int lo0 = split * split_slots;
  const int hi0 = min(lo0 + split_slots, ss.hwm);  // the CTA's range
  const size_t head = (size_t)bkv * S_total;
  const int row_bytes = Dt * T::BYTES;  // a cache row
  const size_t pi = (size_t)unit * n_split + split;  // this CTA's partial
  float* po = part + pi * rows * Dt;
  float* pml = part + (size_t)gridDim.y * n_split * rows * Dt;
  const int c4n = Dt / 4;  // float4s of an output row
  cg::cluster_group cluster = cg::this_cluster();
  const bool clustered = cluster.num_blocks() > 1;  // the unit's ranges
  // the CTA's partial O [R][Dt] for the cluster's merge, behind the warps'
  float* co = reinterpret_cast<float*>(smem) + NWARPS * 16 * RW;

  if (hi0 > lo0) {
    // q's A fragments, rows g and g + 8 (zero past R and past Dt), each
    // k-step's 16 columns permuted as K's (lane t4 holds columns 4 t4 .. 4
    // t4 + 3: its k pairs (2 t4, +1) and (2 t4 + 8, +9)); for fp32 q's rows
    // in shared memory (zero past R and past Dt; visible after the box
    // loop's first barrier)
    uint32_t qf[T::SCALAR ? 1 : KT][4];
    if constexpr (T::SCALAR) {
      const float* qg = static_cast<const float*>(q) + orow * Dt;
      for (int i = tid; i < lay.rp4 * (DI / 4); i += NTHREADS) {
        const int r = i / (DI / 4), c = (i - r * (DI / 4)) * 4;
        *reinterpret_cast<float4*>(smem + lay.q + (r * DI + c) * 4) =
            r < R && c < Dt
                ? *reinterpret_cast<const float4*>(qg + (size_t)r * Dt + c)
                : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
      const uint16_t* qr =
          static_cast<const uint16_t*>(q) + (orow + g) * Dt + t4 * 4;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        const bool in = kk * 16 + t4 * 4 < Dt;
        const uint2 x0 = in && g < R
                             ? *reinterpret_cast<const uint2*>(qr + kk * 16)
                             : make_uint2(0u, 0u);
        const uint2 x1 = in && g + 8 < R ? *reinterpret_cast<const uint2*>(
                                               qr + 8 * Dt + kk * 16)
                                         : make_uint2(0u, 0u);
        qf[kk][0] = x0.x;
        qf[kk][1] = x1.x;
        qf[kk][2] = x0.y;
        qf[kk][3] = x1.y;
      }
    }
    // acc[gr][nt][e]: row g + 8 (e >> 1), group gr's column 8 t4 + 4 (e &
    // 1) + nt (n-tile nt of lane column g is the group's column 4 g + nt);
    // for fp32 acf[r][c]: row r, column lane + 32 c
    float acc[T::SCALAR ? 1 : NG][4][4];
    float acf[T::SCALAR ? DEEP_ROWS : 1][NG];
    if constexpr (T::SCALAR) {
#pragma unroll
      for (int r = 0; r < DEEP_ROWS; ++r)
#pragma unroll
        for (int c = 0; c < NG; ++c) acf[r][c] = 0.f;
    } else {
#pragma unroll
      for (int gr = 0; gr < NG; ++gr)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[gr][nt][e] = 0.f;
    }

    // The range in passes of at most DEEP_SLOTS slots [lo, hi).
    for (int lo = lo0; lo < hi0; lo += DEEP_SLOTS) {
      const int hi = min(lo + DEEP_SLOTS, hi0);
      const bool first = lo == lo0;
      const int nk = (hi - lo + TL - 1) / TL;  // K boxes, and as many V boxes
      auto live = [&](int slot) {
        const int sw = slot - sink_cap;
        const int age = sw < ss.write_pos ? ss.write_pos - 1 - sw
                                          : ss.write_pos - 1 - sw + window;
        return slot < hi &&
               (slot < ss.sink_len ||
                (sw >= 0 && sw < window && age < ss.window_len));
      };
      if (!first) __syncthreads();  // the last pass's boxes, P, scales read
      // The pass's scales: one commit group.
      if constexpr (T::SCALED) {
        for (int i = tid; i < nk * TL; i += NTHREADS) {
          const bool ok = lo + i < hi;
          const size_t off = head + (ok ? lo + i : 0);
          cp_async4(ksc + i, k_scale + off, ok);
          cp_async4(vsc + i, v_scale + off, ok);
        }
      }
      cp_async_commit();

      // Box i into its stage: i < nk the K rows of tile i, then the V rows
      // of tile i - nk. Zeros past the range and past the row's Dt columns.
      auto load_box = [&](int i) {
        const bool isv = i >= nk;
        const int slot0 = lo + (isv ? i - nk : i) * TL;
        const uint8_t* src = isv ? v : k;
        const int stride = isv ? VS : KS;
        uint8_t* dst = smem + (i % DEEP_STAGES) * Box::BYTES;
#pragma unroll 4
        for (int c = tid; c < TL * R16; c += NTHREADS) {
          const int r = c / R16, cc = (c - r * R16) * 16;
          const bool ok = slot0 + r < hi && cc < row_bytes;
          const size_t off = ok ? (head + slot0 + r) * row_bytes + cc : 0;
          cp_async16(dst + r * stride + cc, src + off, ok);
        }
      };
#pragma unroll
      for (int s = 0; s < DEEP_STAGES - 1; ++s) {
        if (s < 2 * nk) load_box(s);
        cp_async_commit();
      }
      for (int i = 0; i < 2 * nk; ++i) {
        cp_async_wait<DEEP_STAGES - 2>();  // box i (and the scales) landed
        __syncthreads();  // ... for every thread; box i - 1's stage is free
        if (i + DEEP_STAGES - 1 < 2 * nk) load_box(i + DEEP_STAGES - 1);
        cp_async_commit();
        const uint8_t* box = smem + (i % DEEP_STAGES) * Box::BYTES;
        if constexpr (T::SCALAR) {
          if (i < nk) {
            // fp32: S of the warp's slots j * 32 + warp * 8 + (0..7) of the
            // tile, a lane per (slot s8, quarter dq of the row's float4s), the
            // quarters summed by two shuffles; the rows in groups of 4 (rows
            // past R but inside the group computed and dropped)
            const int s8 = lane & 7, dq = lane >> 3;
            const float* qs = reinterpret_cast<const float*>(smem + lay.q);
#pragma unroll 1
            for (int j = 0; j < NTW; ++j) {
              const float* kr = reinterpret_cast<const float*>(
                  box + (j * 32 + warp * 8 + s8) * KS);
              float s0[DEEP_ROWS];
#pragma unroll
              for (int r = 0; r < DEEP_ROWS; ++r) s0[r] = 0.f;
#pragma unroll
              for (int f = dq; f < DI / 4; f += 4) {
                const float4 kv = *reinterpret_cast<const float4*>(kr + f * 4);
#pragma unroll
                for (int g4 = 0; g4 < DEEP_ROWS / 4; ++g4) {
                  if (g4 * 4 < R) {
#pragma unroll
                    for (int rr = 0; rr < 4; ++rr) {
                      const int r = g4 * 4 + rr;
                      const float4 qv =
                          *reinterpret_cast<const float4*>(qs + r * DI + f * 4);
                      s0[r] = fmaf(qv.w, kv.w,
                                   fmaf(qv.z, kv.z,
                                        fmaf(qv.y, kv.y,
                                             fmaf(qv.x, kv.x, s0[r]))));
                    }
                  }
                }
              }
              const int idx = i * TL + j * 32 + warp * 8 + s8;
              const bool ok = live(lo + idx);
#pragma unroll
              for (int r = 0; r < DEEP_ROWS; ++r) {
                if ((r & ~3) < R) {
                  float x = s0[r];
                  x += __shfl_xor_sync(0xffffffffu, x, 8);
                  x += __shfl_xor_sync(0xffffffffu, x, 16);
                  if (r < R && (r & 3) == dq)
                    s_sm[idx * lay.rp4 + r] = ok ? x * scale_log2 : -INFINITY;
                }
              }
            }
            if (i == nk - 1)
              pass_softmax<T>(s_sm, p_sm, vsc, m_sm, l_sm, a_sm, R, nk * TL,
                              lay.rp4, first, warp, lane);
          } else {
            // fp32: O += P V over the warp's TL / 4 slots of the tile, a lane
            // per column lane + 32 c, p read by broadcast, 4 rows at a time
            const int j = i - nk;  // the tile
            constexpr int SW = TL / NWARPS;
            if (j == 0 && !first) {  // the earlier passes' O to this one's max
#pragma unroll
              for (int r = 0; r < DEEP_ROWS; ++r) {
                const float a = r < R ? a_sm[r] : 0.f;
#pragma unroll
                for (int c = 0; c < NG; ++c) acf[r][c] *= a;
              }
            }
            const float* vb =
                reinterpret_cast<const float*>(box + warp * SW * VS) + lane;
            const float* pr = s_sm + (j * TL + warp * SW) * lay.rp4;
#pragma unroll 4
            for (int jj = 0; jj < SW; ++jj) {
              float vv[NG];
#pragma unroll
              for (int c = 0; c < NG; ++c) vv[c] = vb[jj * (VS / 4) + 32 * c];
#pragma unroll
              for (int g4 = 0; g4 < DEEP_ROWS / 4; ++g4) {
                if (g4 * 4 < R) {
                  const float4 p = *reinterpret_cast<const float4*>(
                      pr + jj * lay.rp4 + g4 * 4);
#pragma unroll
                  for (int c = 0; c < NG; ++c) {
                    acf[g4 * 4][c] = fmaf(p.x, vv[c], acf[g4 * 4][c]);
                    acf[g4 * 4 + 1][c] = fmaf(p.y, vv[c], acf[g4 * 4 + 1][c]);
                    acf[g4 * 4 + 2][c] = fmaf(p.z, vv[c], acf[g4 * 4 + 2][c]);
                    acf[g4 * 4 + 3][c] = fmaf(p.w, vv[c], acf[g4 * 4 + 3][c]);
                  }
                }
              }
            }
          }
        } else {
          if (i < nk) {
            // S of the warp's slots j * 32 + warp * 8 + (0..7) of the tile
            float s[NTW][4];
#pragma unroll
            for (int j = 0; j < NTW; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
            const uint8_t* kr = box + (warp * 8 + g) * KS + t4 * 4 * T::BYTES;
#pragma unroll
            for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
              for (int j = 0; j < NTW; ++j) {
                const uint8_t* kp = kr + j * 32 * KS + kk * 16 * T::BYTES;
                uint32_t b0, b1;
                if constexpr (T::SCALED) {
                  const uint32_t w = lds32(kp);
                  b0 = T::from16(w);
                  b1 = T::from16(w >> 16);
                } else {
                  const uint2 w = *reinterpret_cast<const uint2*>(kp);
                  b0 = w.x;
                  b1 = w.y;
                }
                mma16816<T::F16>(s[j], qf[kk], b0, b1);
              }
            }
            // into the exp2 domain (k_scale when quantized), masked, into S
#pragma unroll
            for (int j = 0; j < NTW; ++j) {
#pragma unroll
              for (int e2 = 0; e2 < 2; ++e2) {
                const int idx = i * TL + j * 32 + warp * 8 + t4 * 2 + e2;
                const bool ok = live(lo + idx);
                const float f = T::SCALED ? ksc[idx] * scale_log2 : scale_log2;
                if (g < R)
                  s_sm[g * DEEP_SROW + idx] = ok ? s[j][e2] * f : -INFINITY;
                if (g + 8 < R)
                  s_sm[(g + 8) * DEEP_SROW + idx] =
                      ok ? s[j][2 + e2] * f : -INFINITY;
              }
            }
            if (i == nk - 1)
              pass_softmax<T>(s_sm, p_sm, vsc, m_sm, l_sm, a_sm, R, nk * TL, 0,
                              first, warp, lane);
          } else {
            const int j = i - nk;  // the tile
            if (j == 0 && !first) {  // the earlier passes' O to this one's max
              const float a0 = g < R ? a_sm[g] : 0.f;
              const float a1 = g + 8 < R ? a_sm[g + 8] : 0.f;
#pragma unroll
              for (int gr = 0; gr < NG; ++gr)
#pragma unroll
                for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                  for (int e = 0; e < 4; ++e) acc[gr][nt][e] *= e < 2 ? a0 : a1;
            }
#pragma unroll
            for (int kq = 0; kq < KQ; ++kq) {
              const int kk = warp + NWARPS * kq;  // the box's 16-slot k-step
              const uint8_t* pa =
                  p_sm + (g * DEEP_PROW + j * TL + kk * 16 + t4 * 2) * 2;
              const uint32_t a[4] = {
                  g < R ? lds32(pa) : 0u,
                  g + 8 < R ? lds32(pa + 8 * DEEP_PROW * 2) : 0u,
                  g < R ? lds32(pa + 16) : 0u,
                  g + 8 < R ? lds32(pa + 8 * DEEP_PROW * 2 + 16) : 0u};
              const uint8_t* vr =
                  box + (kk * 16 + t4 * 2) * VS + 4 * g * T::BYTES;
#pragma unroll
              for (int gr = 0; gr < NG; ++gr) {
                const uint8_t* pp = vr + gr * 32 * T::BYTES;
                if constexpr (T::SCALED) {
                  const uint32_t w0 = lds32(pp), w1 = lds32(pp + VS);
                  const uint32_t w8 = lds32(pp + 8 * VS);
                  const uint32_t w9 = lds32(pp + 9 * VS);
#pragma unroll
                  for (int nt = 0; nt < 4; ++nt)
                    mma16816<T::F16>(acc[gr][nt], a, T::vpair(w0, w1, nt),
                                     T::vpair(w8, w9, nt));
                } else {
                  const uint2 x0 = *reinterpret_cast<const uint2*>(pp);
                  const uint2 x1 = *reinterpret_cast<const uint2*>(pp + VS);
                  const uint2 x8 = *reinterpret_cast<const uint2*>(pp + 8 * VS);
                  const uint2 x9 = *reinterpret_cast<const uint2*>(pp + 9 * VS);
#pragma unroll
                  for (int nt = 0; nt < 4; ++nt) {
                    const uint32_t sel = nt & 1 ? 0x7632u : 0x5410u;
                    mma16816<T::F16>(
                        acc[gr][nt], a,
                        __byte_perm(nt < 2 ? x0.x : x0.y, nt < 2 ? x1.x : x1.y,
                                    sel),
                        __byte_perm(nt < 2 ? x8.x : x8.y, nt < 2 ? x9.x : x9.y,
                                    sel));
                  }
                }
              }
            }
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is read: the warps' O take its place
    float* red = reinterpret_cast<float*>(smem);  // [NWARPS][16][RW]
    if constexpr (T::SCALAR) {
#pragma unroll
      for (int r = 0; r < DEEP_ROWS; ++r)
#pragma unroll
        for (int c = 0; c < NG; ++c)
          red[(warp * 16 + r) * RW + 32 * c + lane] = acf[r][c];
    } else {
#pragma unroll
      for (int gr = 0; gr < NG; ++gr) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = g + 8 * (e >> 1);
          *reinterpret_cast<float4*>(red + (warp * 16 + row) * RW + gr * 32 +
                                     8 * t4 + 4 * (e & 1)) =
              make_float4(acc[gr][0][e], acc[gr][1][e], acc[gr][2][e],
                          acc[gr][3][e]);
        }
      }
    }
    __syncthreads();
    // The warps' O summed: with one range the output rows, else the
    // partial (in shared memory for the cluster's merge).
    for (int it = tid; it < R * c4n; it += NTHREADS) {
      const int r = it / c4n, c = (it - r * c4n) * 4;
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) {
        const float4 x =
            *reinterpret_cast<const float4*>(red + (w * 16 + r) * RW + c);
        o = make_float4(o.x + x.x, o.y + x.y, o.z + x.z, o.w + x.w);
      }
      if (n_split == 1) {
        const float f = out_factor(
            m_sm[r], l_sm[r],
            s_aux != nullptr ? s_aux[h0 + r] * LOG2E : -INFINITY);
        store4<T>(out, (orow + r) * Dt + c,
                  make_float4(o.x * f, o.y * f, o.z * f, o.w * f));
      } else if (clustered) {
        *reinterpret_cast<float4*>(co + r * Dt + c) = o;
      } else {
        *reinterpret_cast<float4*>(po + (size_t)r * Dt + c) = o;
      }
    }
    if (n_split > 1 && !clustered && tid < R) {
      pml[(pi * rows + tid) * 2] = m_sm[tid];
      pml[(pi * rows + tid) * 2 + 1] = l_sm[tid];
    }
  } else if (n_split == 1) {  // one empty range: zeros
    for (int i = tid; i < R * c4n; i += NTHREADS)
      store4<T>(out, orow * Dt + i * 4, make_float4(0.f, 0.f, 0.f, 0.f));
  } else if (clustered) {  // an empty range: nothing live, no O
    if (tid < R) m_sm[tid] = -INFINITY;
  } else if (tid < R) {  // an empty range: nothing live, no O written
    pml[(pi * rows + tid) * 2] = -INFINITY;
    pml[(pi * rows + tid) * 2 + 1] = 0.f;
  }
  if (n_split == 1) return;
  if (clustered) {
    merge_cluster<T>(cluster, co, m_sm, l_sm, s_aux, out, R, Dt, orow, h0,
                     tid);
    return;
  }
  // the weights [n_split][R] take S's place
  merge_unit<T>(smem, Box::MERGE_BUF, s_sm, l_sm, last_sm, part, counters,
                s_aux, out, unit, n_split, gridDim.y, rows, R, Dt, orow, h0,
                tid, warp, lane);
}

// The instance that runs head dim D: f(integral_constant of D_i) for the
// short kernel's 64, 80, 96 or 128 (up to D = 128), f(integral_constant of
// 0) for the deep kernel (past D = 128).
template <class F>
auto by_instance(int D, F&& f) {
  if (D > 128) return f(std::integral_constant<int, 0>{});
  if (D <= 64) return f(std::integral_constant<int, 64>{});
  if (D <= 80) return f(std::integral_constant<int, 80>{});
  if (D <= 96) return f(std::integral_constant<int, 96>{});
  return f(std::integral_constant<int, 128>{});
}

// Shared memory of a CTA of `rows` query rows at head dim D, in bytes.
template <class T>
int layout_bytes(int rows, int D) {
  return by_instance(D, [&](auto di) {
    constexpr int DI = decltype(di)::value;
    if constexpr (DI == 0)
      return DeepLayout<T>(rows, D).bytes;
    else
      return ShortLayout<T, DI>(rows).bytes;
  });
}

// Slots of a tile (the host plans ranges in whole tiles).
template <class T>
int tile_slots(int D) {
  return by_instance(D, [](auto di) {
    constexpr int DI = decltype(di)::value;
    if constexpr (DI == 0)
      return DEEP_TL;
    else
      return ShortBox<T, DI>::TL;
  });
}

template <class T, int DI>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const State& st, const void* s_aux,
           void* out, void* part, void* counters, int B, int H_q, int H_kv,
           int S_total, int sink_cap, int window, int Dt, int rows,
           int n_split, int split_slots, float scale, cudaStream_t stream) {
  decltype(&deep_decode_kernel<T>) kernel;
  if constexpr (DI == 0)
    kernel = deep_decode_kernel<T>;
  else
    kernel = short_decode_kernel<T, DI>;
  static const cudaError_t attr_err = [kernel] {  // once per instance
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DEEP_SMEM_MAX);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared);
  }();
  if (attr_err != cudaSuccess) return (int)attr_err;
  const int G = H_q / H_kv;
  const int bytes = layout_bytes<T>(rows, Dt);
  const int tile = tile_slots<T>(Dt);
  // the ranges cover the live range: with batch-shared int state up to its
  // high-water mark, else the whole buffer
  const int end =
      st.sink_len != nullptr
          ? S_total
          : std::min(S_total, st.u_window_len > 0
                             ? sink_cap + (st.u_write_pos >= st.u_window_len
                                               ? st.u_write_pos
                                               : window)
                             : st.u_sink_len);
  if ((n_split > 1 || DI == 0) && (part == nullptr || counters == nullptr))
    return (int)cudaErrorInvalidValue;  // the merge's workspace
  if (rows < 1 ||
      rows > DEEP_ROWS || n_split < 1 || n_split > DEEP_SPLITS ||
      split_slots < tile || split_slots % tile != 0 ||
      (long)n_split * split_slots < end || bytes > DEEP_SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const int n_pieces = (G + rows - 1) / rows;
  const long units = (long)B * H_kv * n_pieces;
  if (units > 65535) return (int)cudaErrorInvalidValue;
  // the short rows' 2 to SHORT_CLUSTER ranges of a unit: one cluster
  const bool clustered = DI != 0 && n_split > 1 && n_split <= SHORT_CLUSTER;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, (unsigned)units, 1);
  cfg.blockDim = dim3(NTHREADS, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = clustered ? n_split : 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = clustered ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, q, static_cast<const uint8_t*>(k),
      static_cast<const uint8_t*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), st,
      static_cast<const float*>(s_aux), out, static_cast<float*>(part),
      static_cast<int*>(counters), H_kv, G, rows, n_pieces, split_slots,
      S_total, sink_cap, window, Dt, scale * LOG2E);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// What the kernels take: whole GQA groups, whole 16-byte cache rows and q
// rows of whole 4 elements.
template <class T>
bool bad_shape(int H_q, int H_kv, int D) {
  return H_kv <= 0 || H_q % H_kv != 0 || D <= 0 || (D * T::BYTES) % 16 != 0 ||
         D % 4 != 0;
}

template <class T>
int dispatch(const void* q, const void* k, const void* v, const void* k_scale,
             const void* v_scale, const void* st_sink_len,
             const void* st_window_len, const void* st_write_pos,
             const void* s_aux, void* out, void* part, void* counters,
             int st_stride, int sink_len, int window_len, int write_pos, int B,
             int H_q, int H_kv, int S_total, int D, int sink_cap, int window,
             int rows, int n_split, int split_slots, float scale,
             void* stream) {
  if (bad_shape<T>(H_q, H_kv, D)) return (int)cudaErrorInvalidValue;
  if (B == 0 || S_total <= 0) return 0;
  const State st{static_cast<const int*>(st_sink_len),
                 static_cast<const int*>(st_window_len),
                 static_cast<const int*>(st_write_pos), st_stride, sink_len,
                 window_len, write_pos};
  return by_instance(D, [&](auto di) {
    return launch<T, decltype(di)::value>(
        q, k, v, k_scale, v_scale, st, s_aux, out, part, counters, B, H_q,
        H_kv, S_total, sink_cap, window, D, rows, n_split, split_slots, scale,
        static_cast<cudaStream_t>(stream));
  });
}

// The storage of `bytes` bytes an element (1: codes with scales): its
// kernels' geometry, by an instance of one of its types.
template <class F>
int by_storage(int bytes, F&& f) {
  return bytes == 1 ? f(Int8{}) : bytes == 2 ? f(Bf16{}) : f(Fp32{});
}

}  // namespace

// q [B*H_q, D] (bf16; fp16 and fp32 for those caches); k/v [B*H_kv,
// S_total, D] (bf16, fp16, fp32, or int8 codes with k_scale/v_scale
// [B*H_kv, S_total] fp32; null otherwise), D with whole 16-byte rows; the
// state: three int32 arrays read at b * st_stride, or, where the pointers
// are null, the ints sink_len, window_len, write_pos for every sequence;
// s_aux [H_q] fp32 or null; out [B*H_q, D] like q. n_split CTAs of
// split_slots slots each (whole tiles of sink_decode_tile's slots; n_split
// at most 512; covering the live range) per (b, kv head, piece of `rows`
// query rows, as sink_decode_rows gives them); part: fp32 scratch of units
// * n_split * rows * (D + 2) floats (units = B * H_kv * ceil(G / rows));
// counters: `units` int32 zeros, left zero (neither read with n_split = 1).
#define SINK_DECODE_ENTRY(NAME, TYPE)                                        \
  extern "C" int NAME(const void* q, const void* k, const void* v,           \
                      const void* k_scale, const void* v_scale,              \
                      const void* st_sink_len, const void* st_window_len,    \
                      const void* st_write_pos, const void* s_aux, void* out, \
                      void* part, void* counters, int st_stride,             \
                      int sink_len, int window_len, int write_pos, int B,    \
                      int H_q, int H_kv, int S_total, int D, int sink_cap,   \
                      int window, int rows, int n_split, int split_slots,    \
                      float scale, void* stream) {                           \
    return dispatch<TYPE>(q, k, v, k_scale, v_scale, st_sink_len,            \
                          st_window_len, st_write_pos, s_aux, out, part,     \
                          counters, st_stride, sink_len, window_len,         \
                          write_pos, B, H_q, H_kv, S_total, D, sink_cap,     \
                          window, rows, n_split, split_slots, scale,         \
                          stream);                                           \
  }

SINK_DECODE_ENTRY(sink_decode_bf16, Bf16)
SINK_DECODE_ENTRY(sink_decode_f16, Fp16)
SINK_DECODE_ENTRY(sink_decode_f32, Fp32)
SINK_DECODE_ENTRY(sink_decode_int8, Int8)
SINK_DECODE_ENTRY(sink_decode_fp8, Fp8)

// The query rows a CTA takes for a group of G at head dim D in a storage of
// `bytes` bytes an element (1: codes with scales): up to 16, halved until
// the CTA's shared memory fits; 0 if one row does not fit.
extern "C" int sink_decode_rows(int bytes, int G, int D) {
  if (bytes != 1 && bytes != 2 && bytes != 4) return 0;
  return by_storage(bytes, [&](auto t) {
    using T = decltype(t);
    int rows = std::min(G, DEEP_ROWS);
    while (rows > 1 && layout_bytes<T>(rows, D) > DEEP_SMEM_MAX)
      rows = (rows + 1) / 2;
    return rows >= 1 && layout_bytes<T>(rows, D) <= DEEP_SMEM_MAX ? rows : 0;
  });
}

// The slots of a tile at head dim D in that storage: the ranges' unit.
extern "C" int sink_decode_tile(int bytes, int D) {
  if (bytes != 1 && bytes != 2 && bytes != 4) return 0;
  return by_storage(bytes, [&](auto t) { return tile_slots<decltype(t)>(D); });
}

// The instance that runs head dim D in that storage: the short kernel's D_i
// (64, 80, 96 or 128), or 0 for the deep kernel.
extern "C" int sink_decode_instance(int bytes, int D) {
  if (bytes != 1 && bytes != 2 && bytes != 4) return -1;
  return by_storage(bytes, [&](auto t) {
    return by_instance(D, [](auto di) { return (int)decltype(di)::value; });
  });
}
