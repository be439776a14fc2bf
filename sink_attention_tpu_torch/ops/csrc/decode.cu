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
// What bounds it on the H100: memory, and at the serving shapes the launch.
// Each live K/V byte is used for 2*G FLOP (G = GQA group), far below the
// ~295 FLOP/byte ridge, so the least time is the live cache bytes over
// 3.35 TB/s: 4*D bytes per live slot and KV head in bf16, 2*D + 8 (codes
// and two scales) when quantized, 8*D in fp32. Two designs, by head dim:
//
// D <= 128 (decode_kernel; the instances of D_i = 64 and 128): at
// gpt-oss-20b's shapes the bound is ~1 us, under the cost of a launch, so
// the design spends one launch per call, no scratch in device memory and
// no host work beyond the output allocation:
//  * one kernel, launched with cudaLaunchKernelEx as thread block clusters
//    along the split axis: a cluster of C CTAs (1..8, a power of two chosen
//    by the host from the live range: 1 for a 128-slot sliding ring, 8 for
//    a full layer's 1056-2048 slots) per (b, kv head, 64-row piece of the
//    GQA group). CTA r of a cluster walks the 128-slot tiles r, r + C, ...
//    of [0, hwm);
//  * inside a CTA, 4 warps; each owns one 16-row m-tile of the group's
//    query rows (padded to 16) and a 128/SL-slot slice of every tile (SL =
//    4, 2, 1 for groups up to 16, 32, 64 rows), and runs its own online
//    softmax (exp2 domain) over them. Both products are bf16 mma.sync
//    (m16n8k16, fp32 accumulation): S = Q K^T with q as stored, scaled in
//    fp32 afterwards; O += P V with P rounded to bf16 as the A operand. So
//    the group's rows share every K/V read, and any group size runs (the
//    64-row pieces of a larger group are CTAs of their own);
//  * each warp's partial (m, l, unnormalised O) goes to shared memory and
//    the CTA folds its warps' slices into one partial per row; the
//    cluster syncs (barrier.cluster), and the cluster's threads merge the
//    CTAs' partials over distributed shared memory (every rank's loads of
//    an item issued together), s_aux joining as one more partial of LSE
//    s_aux and value 0; the merged bf16 row is written once. A second
//    cluster barrier keeps every CTA's shared memory alive until all
//    reads are done. A CTA with no live tile still arrives at both;
//  * the tiles are double-buffered: the CTA's next tile (K, V and the
//    scales, by cp.async) streams in while this one is computed; slots
//    at or past hwm are not read (zero-filled), and a warp whose slice
//    lies past hwm skips both products.
// Measured floor (H100): ~5.4 us of device time for one tile on one CTA
// (launch, the q and first-tile latency, the merge), ~2.2 us more per
// further tile a CTA walks; a full layer's 1040 live slots are 9 tiles,
// so 8 CTAs leave one walking two. fp32 storage computes in fp32 on the
// CUDA cores (F32Warp below: as the JAX kernel pins Precision.HIGHEST for
// a non-bf16 cache): one buffer of 128 slots (two would not fit beside
// q), a lane per slot for S = q . k (float4 rows, conflict-free at the
// padded row stride) and a lane per column for O += p v.
//
// D > 128 (deep_decode_kernel; one instance per storage, its depth
// counted at run time): a Gemma-2-2B layer's cache at B = 2 is 8 (b, kv
// head) pairs of 4096 live slots, 34 MB in bf16 (~10 us at 3.35 TB/s), and
// at B = 1 over a long context a few pairs hold all the bytes. A cluster
// per pair would leave most of the 132 SMs idle and every CTA waiting a
// round trip per tile, so the design fills the card and keeps the bytes
// in flight instead:
//  * split-K over the card: the host cuts the live range into n_split
//    ranges (at most 512) of split_slots slots (a multiple of 32; at most
//    512 unless 512 ranges of 512 do not cover the cache), so that (b, kv
//    head, piece of up to 16 rows) x n_split CTAs are about twice the SMs
//    (fewer where the merge below would outweigh a range); one launch, grid
//    (n_split, units). Each CTA writes an fp32 partial (m, l,
//    unnormalised O) of its range to a workspace the wrapper keeps per
//    stream; the last CTA of a unit to arrive (an atomic count per unit,
//    zeroed once, which that CTA sets back to 0) merges the unit's
//    partials, s_aux joining as one more partial of LSE s_aux and value 0,
//    and writes the row once: TMA bulk copies bring the partials into the
//    ring, two chunks in flight (the first two issued before the row
//    statistics are read), summed branch-free. No host synchronisation: a
//    ragged state's hwm is read on the device, and a range past it is
//    empty (its partial m = -inf, skipped);
//  * a ring of 4 boxes (32 slots x 512 bytes of a row: a depth chunk of K
//    or a column chunk of V; 3 in flight, cp.async from every thread)
//    streams the range's K boxes, tile by tile, then its V boxes, column
//    chunk by column chunk, with no bubble between the two: each K and V
//    byte of the range is read once, at any D;
//  * S once per tile: the 4 warps split a tile's 32 slots (8 each, the
//    whole depth, q's rows resident in shared memory; the 16 columns of a
//    k-step permuted alike in q and K, so one 64-bit (codes: 32-bit) load
//    of a K row gives both B registers), so S is computed and every int8 /
//    fp8 code of K decoded once per CTA; S of the whole range waits in
//    shared memory (exp2 domain, scaled, masked), and one exact softmax
//    over the range gives m, l and P (rounded to bf16, fp16 for fp16
//    storage, times v_scale when quantized, as the A operand; the row sum
//    takes p alone in fp32). A range past 512 slots (a cache past 512 x
//    512) is walked in passes of 512, each pass's P taken against the
//    running max and the partial O already written rescaled in place;
//  * P V: the warps split each V column chunk's columns (64 16-bit / 128
//    code columns a warp), a lane owning 4 adjacent columns of each group
//    of 32 (one load of a V row gives its 4 n-tiles, paired across rows by
//    byte permutes), so each V code is decoded once per CTA, and a chunk's
//    O leaves registers for the partial when its last tile is done;
//  * int8 codes decode by bit operations at the full rate (Int8::from16),
//    not by int -> float converts;
//  * fp32 storage in fp32 on the CUDA cores in the same boxes: S with a
//    lane per (slot, quarter of the depth), the quarters summed by two
//    shuffles; P V with a lane per column, p read from shared memory by
//    broadcast, 4 query rows at a time (S and P slot-major);
//  * a CTA takes up to 16 query rows (fewer where q's rows would not fit
//    227 KB beside the ring, S and P: fp32 at D = 2048 takes 8), the
//    m16n8k16 tiles' rows past the group's read as zeros.
// Measured (H100 SXM, 700 W; B = 2, GQA 8/4, 4096 live slots): bf16, fp16
// and fp32 storage reach 51-66% of the byte bound at D = 256-1024; the
// codes 21-43%, compute-bound at two CTAs an SM (the byte decode and the
// mma.sync chain per box); a short range is bound by the fixed ~8 us of
// the first box, the softmax and the merge.
//
// Quantized storage computes attention over the dequantized cache: the
// codes decode exactly to bf16 (int8 by an int -> float convert, or by bit
// operations past D = 128; fp8 by Hopper's e4m3 -> f16 convert; every
// int8 and e4m3 value is a bf16 value), score = (q . codes_k) * k_scale in fp32, and P V takes
// p * v_scale rounded to bf16 (the row sum takes p alone in fp32). The
// bf16 rounding of P, as in the prefill kernels, costs up to 2^-9 of an
// output (DECODE_TOL 2e-2 on the bf16 output). fp16 storage is the bf16
// branch with fp16 mma.sync and P rounded to fp16 (q and the output fp16).
// Head dims: any D whose rows are whole 16 bytes (D % 8 for bf16/fp16, D %
// 16 for the codes, D % 4 for fp32; the host pads any other D); D <= 128
// runs in the instance of D_i = 64 or 128 with the columns past D
// zero-filled by cp.async (src-size 0) and not written, D > 128 in the
// deep instance, whose chunks past D are zero-filled and whose k-steps
// and n-tiles past D are skipped.

#include <cooperative_groups.h>

#include "attention.cuh"
#include "hopper_wide.cuh"  // the mbarrier helpers

#include <cuda_fp8.h>

#include <algorithm>

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

constexpr int TILE = 128;      // slots per tile (D <= 128)
constexpr int NTHREADS = 128;  // 4 warps
constexpr int NWARPS = NTHREADS / 32;
static_assert(NTHREADS == TILE, "a thread copies one slot's scales");
constexpr int ROWS = 64;       // query rows per CTA: one 16-row m-tile a warp
constexpr int MAX_CLUSTER = 8;

// 4 bytes global -> shared, zero-filled where !pred.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ uint16_t bf16_bits(float x) {
  __nv_bfloat16 b = __float2bfloat16_rn(x);
  return *reinterpret_cast<uint16_t*>(&b);
}

// The storage types: `pair` gives elements p[0], p[1] of a row as a 16-bit
// pair (low half first; bf16, or fp16 where F16), `one` element p[0] as
// 16-bit bits; SCALED types carry per-token scales; the conversions are
// exact. q and the output are fp16 where F16, fp32 where SCALAR (Fp32: no
// mma.sync, F32Warp's fp32 arithmetic), else bf16.
struct Bf16 {
  static constexpr int BYTES = 2;
  static constexpr bool SCALED = false, F16 = false, SCALAR = false;
  __device__ __forceinline__ static uint32_t pair(const uint8_t* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  __device__ __forceinline__ static uint32_t one(const uint8_t* p) {
    return *reinterpret_cast<const uint16_t*>(p);
  }
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
  __device__ __forceinline__ static uint32_t pair(const uint8_t* p) {
    const uint32_t w = *reinterpret_cast<const uint16_t*>(p);
    return pack_bf16((float)(int8_t)(w & 0xff), (float)(int8_t)(w >> 8));
  }
  __device__ __forceinline__ static uint32_t one(const uint8_t* p) {
    return bf16_bits((float)*reinterpret_cast<const int8_t*>(p));
  }
  // The split decode's conversions, by bit operations at the full rate.
  // The two codes of w's low 16 bits (low byte first) as a bf16 pair.
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
  // Byte nt of w0 and of w1 (two rows of a column) as a bf16 pair.
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
  __device__ __forceinline__ static uint32_t pair(const uint8_t* p) {
    return from16(*reinterpret_cast<const __nv_fp8x2_storage_t*>(p));
  }
  // Byte nt of w0 and of w1 (two rows of a column) as a bf16 pair.
  __device__ __forceinline__ static uint32_t vpair(uint32_t w0, uint32_t w1,
                                                   int nt) {
    return from16(__byte_perm(w0, w1, nt | ((4 + nt) << 4)));
  }
  __device__ __forceinline__ static uint32_t one(const uint8_t* p) {
    const __half_raw h = __nv_cvt_fp8_to_halfraw(*p, __NV_E4M3);
    return bf16_bits(__half2float(__half(h)));
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

// One buffer: a tile's K and V rows (padded) and, when quantized, their
// per-slot scales.
template <class T, int D>
__host__ __device__ constexpr size_t buf_bytes() {
  return 2 * (size_t)TILE * (D * T::BYTES + 16) +
         (T::SCALED ? 2 * TILE * sizeof(float) : 0);
}

// Tile buffers: two (the next tile streams in while one is computed), one
// for fp32 storage (two do not fit at D = 128).
template <class T>
__host__ __device__ constexpr int n_bufs() {
  return T::SCALAR ? 1 : 2;
}

// The buffers, then the CTA's q rows (fp32 storage: [ROWS][D] fp32); after
// the tile loop the partials alias them: per warp [NWARPS][16][D] + m, l
// [NWARPS][16], then the CTA's [ROWS][D] + m, l [ROWS].
template <class T, int D>
constexpr size_t smem_bytes() {
  constexpr size_t tiles = n_bufs<T>() * buf_bytes<T, D>() +
                           (T::SCALAR ? ROWS * D * sizeof(float) : 0);
  constexpr size_t partials =
      (NWARPS * 16 * ((size_t)D + 2) + ROWS * ((size_t)D + 2)) *
      sizeof(float);
  return tiles > partials ? tiles : partials;
}

// The fp32 storage's warp step: the warp (m-tile of 16 query rows, slot
// slice of SW = TILE / SL >= 32 slots of a tile) computes in fp32 on the
// CUDA cores. S: a lane per slot (NS = SW / 32 slots a lane), q rows read
// from shared memory by broadcast, K rows as float4 (row stride D + 4
// floats: a quarter warp's 8 rows fall on distinct banks); the online
// softmax per row over the lanes (exp2 domain); O += p v: a lane per
// column (D / 32 columns a lane), each slot's p taken from its lane by a
// shuffle.
template <int D, int SL>
struct F32Warp {
  static constexpr int SW = TILE / SL;
  static constexpr int NS = SW / 32;  // slots a lane
  static constexpr int NC = D / 32;   // output columns a lane
  static constexpr int ROWF = D + 4;  // padded smem row (floats)
  float m[16], l[16], o[16][NC];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) o[r][c] = 0.f;
    }
  }

  // One tile of the slice: K rows kb, V rows vb (its first slot), q rows
  // qs [16][D]; live(i) says whether slot i of the slice is live.
  template <class Live>
  __device__ __forceinline__ void tile(const float* kb, const float* vb,
                                       const float* qs, int lane,
                                       float scale_log2, const Live& live) {
    float s[16][NS];
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int j = 0; j < NS; ++j) s[r][j] = 0.f;
#pragma unroll 4
    for (int d4 = 0; d4 < D / 4; ++d4) {
      float4 kv[NS];
#pragma unroll
      for (int j = 0; j < NS; ++j)
        kv[j] = *reinterpret_cast<const float4*>(
            kb + (j * 32 + lane) * ROWF + d4 * 4);
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(qs + r * D + d4 * 4);
#pragma unroll
        for (int j = 0; j < NS; ++j)
          s[r][j] = fmaf(qv.w, kv[j].w,
                         fmaf(qv.z, kv[j].z,
                              fmaf(qv.y, kv[j].y,
                                   fmaf(qv.x, kv[j].x, s[r][j]))));
      }
    }
    bool ok[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) ok[j] = live(j * 32 + lane);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        s[r][j] = ok[j] ? s[r][j] * scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[r][j]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[r] - m_use);  // m = -inf: o, l are 0
      m[r] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float p = s[r][j] == -INFINITY ? 0.f : exp2f(s[r][j] - m_use);
        s[r][j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[r] = l[r] * alpha + rs;
#pragma unroll
      for (int c = 0; c < NC; ++c) o[r][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      for (int sl = 0; sl < 32; ++sl) {
        const float* vr = vb + (j * 32 + sl) * ROWF + lane;
        float v[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) v[c] = vr[c * 32];
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          const float p = __shfl_sync(0xffffffffu, s[r][j], sl);
#pragma unroll
          for (int c = 0; c < NC; ++c) o[r][c] = fmaf(p, v[c], o[r][c]);
        }
      }
    }
  }

  // The warp's partial: its O [16][D] at pw, m and l of its rows at pm,
  // pl.
  __device__ __forceinline__ void write(float* pw, float* pm, float* pl,
                                        int lane) const {
#pragma unroll
    for (int r = 0; r < 16; ++r) {
#pragma unroll
      for (int c = 0; c < NC; ++c) pw[r * D + c * 32 + lane] = o[r][c];
      if (lane == 0) {
        pm[r] = m[r];
        pl[r] = l[r];
      }
    }
  }
};

// D is the instance's head dim (64 or 128), Dt <= D the cache's and q's
// (their row length): the columns past Dt are zero-filled in shared memory
// and not written.
template <class T, int D, int SL>
__global__ void __launch_bounds__(NTHREADS)
    decode_kernel(const void* __restrict__ q, const uint8_t* __restrict__ k,
                  const uint8_t* __restrict__ v,
                  const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale, State st,
                  const float* __restrict__ s_aux, void* __restrict__ out,
                  int H_kv, int G, int n_pieces, int S_total, int sink_cap,
                  int window, int Dt, float scale_log2) {
  static_assert(D == 64 || D == 128, "D > 128 runs in deep_decode_kernel");
  constexpr int TL = TILE;                 // slots per tile
  constexpr int ROWB = D * T::BYTES + 16;  // padded smem row (bytes)
  constexpr int VECS = D * T::BYTES / 16;  // 16-byte copies per smem row
  constexpr int SW = TL / SL;              // slots per warp slice
  constexpr int NT = SW / 8;               // n-tiles of S
  constexpr int KT = D / 16;               // k-steps of S
  constexpr int RW = ROWS;                 // query rows per CTA
  constexpr int DT = D / 8;                // n-tiles of O
  constexpr int D4 = D / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  // Buffer b: K [TL][ROWB], V [TL][ROWB], k scales [TL], v scales.
  auto kbuf = [&](int b) { return smem + b * buf_bytes<T, D>(); };
  auto vbuf = [&](int b) { return kbuf(b) + TL * ROWB; };
  auto ksbuf = [&](int b) {
    return reinterpret_cast<float*>(kbuf(b) + 2 * TL * ROWB);
  };
  auto vsbuf = [&](int b) { return ksbuf(b) + TL; };
  float* po = reinterpret_cast<float*>(smem);  // [NWARPS][16][D]
  float* pm = po + NWARPS * 16 * D;            // [NWARPS][16]
  float* pl = pm + NWARPS * 16;                // [NWARPS][16]
  float* co = pl + NWARPS * 16;                // [RW][D]: the CTA's
  float* cm = co + RW * D;                     // [RW]
  float* cl = cm + RW;                         // [RW]
  // fp32 storage: the CTA's q rows [RW][D], after the one buffer
  float* q_sm = reinterpret_cast<float*>(smem + buf_bytes<T, D>());
  const int vecs = Dt * T::BYTES / 16;  // 16-byte copies of a cache row

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_ranks = (int)cluster.num_blocks();
  const int unit = blockIdx.y;  // (b * H_kv + kv head) * n_pieces + piece
  const int bkv = unit / n_pieces;
  const int row_lo = (unit - bkv * n_pieces) * RW;  // first group row here
  const int R = min(G - row_lo, RW);
  const int b = bkv / H_kv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // a warp's m-tile and slot slice
  const int mt = warp / SL, slice = warp - (warp / SL) * SL;
  const bool has_rows = mt * 16 < R;

  const int sink_len = st.sink_len ? st.sink_len[b * st.stride] : st.u_sink_len;
  const int window_len =
      st.window_len ? st.window_len[b * st.stride] : st.u_window_len;
  const int write_pos =
      st.write_pos ? st.write_pos[b * st.stride] : st.u_write_pos;
  const int hwm = min(window_len > 0 ? sink_cap + (write_pos >= window_len
                                                       ? write_pos
                                                       : window)
                                     : sink_len,
                      S_total);
  const int n_tiles = (hwm + TL - 1) / TL;

  const size_t head = (size_t)bkv * S_total;
  // One group of copies: tile `tile`'s K, V (and scales) into buffer bb.
  auto load = [&](int tile, int bb) {
    const int slot0 = tile * TL;
    uint8_t* kd = kbuf(bb);
    uint8_t* vd = vbuf(bb);
    for (int c = tid; c < TL * VECS; c += NTHREADS) {
      const int r = c / VECS, cc = c - (c / VECS) * VECS;
      // zeros past the live range and past the row's Dt columns
      const bool ok = slot0 + r < hwm && cc < vecs;
      const size_t off =
          (head + (ok ? slot0 + r : 0)) * Dt * T::BYTES + (ok ? cc * 16 : 0);
      cp_async16(kd + r * ROWB + cc * 16, k + off, ok);
      cp_async16(vd + r * ROWB + cc * 16, v + off, ok);
    }
    if (T::SCALED) {  // a slot's scales
      const bool ok = slot0 + tid < hwm;
      const size_t off = head + (ok ? slot0 + tid : 0);
      cp_async4(ksbuf(bb) + tid, k_scale + off, ok);
      cp_async4(vsbuf(bb) + tid, v_scale + off, ok);
    }
  };
  auto live = [&](int slot) {
    const int sw = slot - sink_cap;
    const int age = sw < write_pos ? write_pos - 1 - sw
                                   : write_pos - 1 - sw + window;
    return slot < hwm &&
           (slot < sink_len || (sw >= 0 && sw < window && age < window_len));
  };

  int tile = rank;
  if (tile < n_tiles) load(tile, 0);
  cp_async_commit();

  // This warp's A fragments of q (rows past the group's and columns past
  // Dt are zero), read while the first tile is in flight; for fp32
  // storage, the CTA's q rows into shared memory (visible after the loop's
  // first barrier).
  const int r0 = mt * 16 + g;  // local rows r0, r0 + 8
  constexpr int KQ = T::SCALAR ? 1 : KT;
  uint32_t qf[KQ][4];
  if constexpr (T::SCALAR) {
    const float* qg = static_cast<const float*>(q) + (size_t)bkv * G * Dt;
    for (int i = tid; i < RW * D4; i += NTHREADS) {
      const int r = i / D4, c4 = i - (i / D4) * D4;
      *reinterpret_cast<float4*>(q_sm + r * D + c4 * 4) =
          r < R && c4 * 4 < Dt
              ? *reinterpret_cast<const float4*>(
                    qg + (size_t)(row_lo + r) * Dt + c4 * 4)
              : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    const uint16_t* qr =
        static_cast<const uint16_t*>(q) + ((size_t)bkv * G + row_lo + r0) * Dt;
    const bool ok0 = r0 < R, ok1 = r0 + 8 < R;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      const int c = kk * 16 + t4 * 2;
      const bool lo = c < Dt, hi = c + 8 < Dt;
      qf[kk][0] =
          ok0 && lo ? *reinterpret_cast<const uint32_t*>(qr + c) : 0u;
      qf[kk][1] = ok1 && lo
                      ? *reinterpret_cast<const uint32_t*>(qr + 8 * Dt + c)
                      : 0u;
      qf[kk][2] =
          ok0 && hi ? *reinterpret_cast<const uint32_t*>(qr + c + 8) : 0u;
      qf[kk][3] = ok1 && hi ? *reinterpret_cast<const uint32_t*>(
                                  qr + 8 * Dt + c + 8)
                            : 0u;
    }
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  F32Warp<D, SL> fw;
  if constexpr (T::SCALAR) fw.init();

  for (int bb = 0; tile < n_tiles; tile += n_ranks, bb ^= n_bufs<T>() - 1) {
    if constexpr (n_bufs<T>() == 1) {
      if (tile != rank) load(tile, 0);  // the first is already in flight
      cp_async_commit();
      cp_async_wait<0>();
    } else {
      // The next tile of this CTA streams in while this one is computed.
      if (tile + n_ranks < n_tiles) load(tile + n_ranks, bb ^ 1);
      cp_async_commit();
      cp_async_wait<1>();  // this tile's group
    }
    __syncthreads();
    const int c0 = slice * SW;  // the slice's first slot in the tile
    if constexpr (T::SCALAR) {
      if (has_rows && tile * TL + c0 < hwm)
        fw.tile(reinterpret_cast<const float*>(kbuf(bb) + c0 * ROWB),
                reinterpret_cast<const float*>(vbuf(bb) + c0 * ROWB),
                q_sm + mt * 16 * D, lane, scale_log2,
                [&](int i) { return live(tile * TL + c0 + i); });
    } else if (has_rows && tile * TL + c0 < hwm) {  // rows, live slots
      const uint8_t* kb = kbuf(bb) + c0 * ROWB;
      const float* ksc = ksbuf(bb);
      const float* vsc = vsbuf(bb);

      // S = Q K^T over this warp's slice, into the exp2 domain, masked.
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint8_t* kr =
              kb + (nt * 8 + g) * ROWB + (kk * 16 + t4 * 2) * T::BYTES;
          mma16816<T::F16>(s[nt], qf[kk], T::pair(kr),
                           T::pair(kr + 8 * T::BYTES));
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int cl_ = c0 + nt * 8 + t4 * 2 + e2;  // slot within the tile
          const bool ok = live(tile * TL + cl_);
          const float f = T::SCALED ? ksc[cl_] * scale_log2 : scale_log2;
          s[nt][e2] = ok ? s[nt][e2] * f : -INFINITY;
          s[nt][e2 + 2] = ok ? s[nt][e2 + 2] * f : -INFINITY;
        }
      }
      // Online softmax, rows r0 and r0 + 8 (e >> 1).
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = exp2f(m[r] - m_use);  // m = -inf: acc, l are 0
        m[r] = m_new;
        float rs = 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const float x = s[nt][2 * r + e2];
            const float p = x == -INFINITY ? 0.f : exp2f(x - m_use);
            s[nt][2 * r + e2] = p;
            rs += p;
          }
        }
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        l[r] = l[r] * alpha + rs;
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
          acc[dt][2 * r] *= alpha;
          acc[dt][2 * r + 1] *= alpha;
        }
      }

      // O += P V (p * v_scale when quantized), V read down its rows.
      const uint8_t* vb = vbuf(bb) + c0 * ROWB;
#pragma unroll
      for (int j = 0; j < SW / 16; ++j) {
        float p0[4], p1[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p0[e] = s[2 * j][e];
          p1[e] = s[2 * j + 1][e];
          if (T::SCALED) {
            const int cl_ = c0 + j * 16 + t4 * 2 + (e & 1);
            p0[e] *= vsc[cl_];
            p1[e] *= vsc[cl_ + 8];
          }
        }
        const uint32_t a[4] = {
            pack2<T::F16>(p0[0], p0[1]), pack2<T::F16>(p0[2], p0[3]),
            pack2<T::F16>(p1[0], p1[1]), pack2<T::F16>(p1[2], p1[3])};
        const uint8_t* vr = vb + (j * 16 + t4 * 2) * ROWB + g * T::BYTES;
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
          const uint8_t* p = vr + dt * 8 * T::BYTES;
          const uint32_t b0 = T::one(p) | (T::one(p + ROWB) << 16);
          const uint32_t b1 =
              T::one(p + 8 * ROWB) | (T::one(p + 9 * ROWB) << 16);
          mma16816<T::F16>(acc[dt], a, b0, b1);
        }
      }
    }
    __syncthreads();  // every warp is done with buffer bb before its refill
  }
  cp_async_wait<0>();
  __syncthreads();  // the tiles are dead: the partials take their place

  // Each warp's partial (m, l, unnormalised O) of its rows and slice ...
  if constexpr (T::SCALAR) {
    if (has_rows) fw.write(po + warp * 16 * D, pm + warp * 16, pl + warp * 16,
                           lane);
  } else if (has_rows) {
    float* pw = po + warp * 16 * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = g + 8 * r;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
        *reinterpret_cast<float2*>(pw + row * D + dt * 8 + t4 * 2) =
            make_float2(acc[dt][2 * r], acc[dt][2 * r + 1]);
      if (t4 == 0) {
        pm[warp * 16 + row] = m[r];
        pl[warp * 16 + row] = l[r];
      }
    }
  }
  __syncthreads();
  // ... folded over the slices into the CTA's partial of each row.
  for (int i = tid; i < R * D4; i += NTHREADS) {
    const int r = i / D4, d4 = i - (i / D4) * D4;
    const int w0 = (r >> 4) * SL, rr = r & 15;  // the row's warps, row in them
    float mx = -INFINITY;
#pragma unroll
    for (int sl = 0; sl < SL; ++sl) mx = fmaxf(mx, pm[(w0 + sl) * 16 + rr]);
    const float m_use = mx == -INFINITY ? 0.f : mx;
    float lsum = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int sl = 0; sl < SL; ++sl) {
      const int w = w0 + sl;
      const float wt = exp2f(pm[w * 16 + rr] - m_use);  // -inf: 0
      lsum = fmaf(wt, pl[w * 16 + rr], lsum);
      const float4 o =
          *reinterpret_cast<const float4*>(po + (w * 16 + rr) * D + d4 * 4);
      a.x = fmaf(wt, o.x, a.x);
      a.y = fmaf(wt, o.y, a.y);
      a.z = fmaf(wt, o.z, a.z);
      a.w = fmaf(wt, o.w, a.w);
    }
    *reinterpret_cast<float4*>(co + r * D + d4 * 4) = a;
    if (d4 == 0) {
      cm[r] = mx;
      cl[r] = lsum;
    }
  }
  cluster.sync();  // every CTA's partials are written

  // Merge the cluster's partials, s_aux as one more of LSE s_aux and
  // value 0: the cluster's threads share the (row, 4 columns) items, each
  // reading every rank's partial over distributed shared memory.
  const int h0 = (bkv - b * H_kv) * G + row_lo;  // query head of local row 0
  for (int i = tid * n_ranks + rank; i < R * D4; i += n_ranks * NTHREADS) {
    const int r = i / D4, d4 = i - (i / D4) * D4;
    if (d4 * 4 >= Dt) continue;  // a zero column past the row
    float rm[MAX_CLUSTER], rl[MAX_CLUSTER];
    float4 ro[MAX_CLUSTER];
#pragma unroll
    for (int c = 0; c < MAX_CLUSTER; ++c) {
      if (c < n_ranks) {
        rm[c] = *cluster.map_shared_rank(cm + r, c);
        rl[c] = *cluster.map_shared_rank(cl + r, c);
        ro[c] = *cluster.map_shared_rank(
            reinterpret_cast<float4*>(co + r * D + d4 * 4), c);
      }
    }
    const float aux2 = s_aux != nullptr ? s_aux[h0 + r] * LOG2E : -INFINITY;
    float mx = aux2;
#pragma unroll
    for (int c = 0; c < MAX_CLUSTER; ++c)
      if (c < n_ranks) mx = fmaxf(mx, rm[c]);
    const float m_use = mx == -INFINITY ? 0.f : mx;
    float denom = s_aux != nullptr ? exp2f(aux2 - m_use) : 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c = 0; c < MAX_CLUSTER; ++c) {
      if (c < n_ranks) {
        const float wt = exp2f(rm[c] - m_use);  // nothing live: 0
        denom = fmaf(wt, rl[c], denom);
        a.x = fmaf(wt, ro[c].x, a.x);
        a.y = fmaf(wt, ro[c].y, a.y);
        a.z = fmaf(wt, ro[c].z, a.z);
        a.w = fmaf(wt, ro[c].w, a.w);
      }
    }
    const float inv = denom > 0.f ? 1.f / denom : 0.f;
    const size_t o = ((size_t)bkv * G + row_lo + r) * Dt + d4 * 4;
    if constexpr (T::SCALAR) {
      *reinterpret_cast<float4*>(static_cast<float*>(out) + o) =
          make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv);
    } else {
      uint2 ob;
      ob.x = pack2<T::F16>(a.x * inv, a.y * inv);
      ob.y = pack2<T::F16>(a.z * inv, a.w * inv);
      *reinterpret_cast<uint2*>(static_cast<uint16_t*>(out) + o) = ob;
    }
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

template <class T, int D, int SL>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const State& st, const void* s_aux,
           void* out, int B, int H_q, int H_kv, int S_total, int sink_cap,
           int window, int Dt, int cluster, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      decode_kernel<T, D, SL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);  // once per instance
  if (attr_err != cudaSuccess) return (int)attr_err;
  const int G = H_q / H_kv;
  const int n_pieces = (G + ROWS - 1) / ROWS;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, B * H_kv * n_pieces, 1);
  cfg.blockDim = dim3(NTHREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, decode_kernel<T, D, SL>, q, static_cast<const uint8_t*>(k),
      static_cast<const uint8_t*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), st,
      static_cast<const float*>(s_aux), out, H_kv, G, n_pieces, S_total,
      sink_cap, window, Dt, scale * LOG2E);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The slices of a tile (SL) by the group's rows: 4, 2 or 1 for up to 16,
// 32 or 64 rows (fp32 storage's slices are 32 slots or more).
template <class T, int D>
int launch_d(const void* q, const void* k, const void* v, const void* k_scale,
             const void* v_scale, const State& st, const void* s_aux,
             void* out, int B, int H_q, int H_kv, int S_total, int sink_cap,
             int window, int Dt, int cluster, float scale,
             cudaStream_t stream) {
  const int rows = min(H_q / H_kv, ROWS);  // of the largest piece
  if (rows <= 16)
    return launch<T, D, 4>(
        q, k, v, k_scale, v_scale, st, s_aux, out, B, H_q, H_kv, S_total,
        sink_cap, window, Dt, cluster, scale, stream);
  if (rows <= 32)
    return launch<T, D, 2>(
        q, k, v, k_scale, v_scale, st, s_aux, out, B, H_q, H_kv, S_total,
        sink_cap, window, Dt, cluster, scale, stream);
  return launch<T, D, 1>(q, k, v, k_scale, v_scale, st, s_aux, out, B, H_q,
                         H_kv, S_total, sink_cap, window, Dt, cluster, scale,
                         stream);
}

// ---------------------------------------------------------------------------
// Past D = 128: the split decode (see the header). One instance per storage
// runs every D > 128, its depth and column chunks counted at run time.
// ---------------------------------------------------------------------------

constexpr int DEEP_TL = 32;                 // slots per tile
constexpr int DEEP_ROW = 512;               // bytes of a box row
constexpr int DEEP_STAGES = 4;              // boxes in the ring
constexpr int DEEP_SLOTS = 512;             // slots of a CTA's pass at most
constexpr int DEEP_SPLITS = 512;            // ranges of a unit at most
constexpr int DEEP_ROWS = 16;               // query rows of a CTA at most
constexpr int DEEP_SROW = DEEP_SLOTS + 4;   // a row of S (floats)
constexpr int DEEP_PROW = DEEP_SLOTS + 8;   // a row of P (16-bit)
constexpr int DEEP_SMEM_MAX = 232448;       // a CTA's shared memory at most
constexpr int DEEP_MERGE_BUF = 32768;       // bytes of a merge chunk

// The padded row stride of a box: 528 bytes puts a warp's 32-bit loads of
// 8 rows x 4 words, and fp32's quarter-warp float4 loads, on distinct
// banks; K boxes of 16-bit storage take 544, so the 64-bit loads of a half
// warp (4 rows x 2 words each) are distinct too.
template <class T>
__host__ __device__ constexpr int deep_kstride() {
  return T::BYTES == 2 ? DEEP_ROW + 32 : DEEP_ROW + 16;
}
constexpr int DEEP_VSTRIDE = DEEP_ROW + 16;
constexpr int DEEP_BOX = DEEP_TL * (DEEP_ROW + 32);  // a stage's bytes

// Shared memory of a CTA of `rows` query rows at head dim D, in bytes from
// its start: the ring of boxes; q's rows (whole chunks, zero past D; fp32
// for fp32 storage, its rows rounded up to 4, else 16-bit); S: [rows]
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

// One CTA: query rows [row_lo, row_lo + R) of a (b, kv head) over the
// slots [lo, hi) of split blockIdx.x (hi at most hwm), then, if it is the
// unit's last to arrive, the merge of the unit's partials. part holds the
// partials: O [units][n_split][rows][Dt] fp32, then (m, l) [units][n_split]
// [rows]; counters [units] are 0 at the launch and left 0.
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

  const int sink_len = st.sink_len ? st.sink_len[b * st.stride] : st.u_sink_len;
  const int window_len =
      st.window_len ? st.window_len[b * st.stride] : st.u_window_len;
  const int write_pos =
      st.write_pos ? st.write_pos[b * st.stride] : st.u_write_pos;
  const int hwm = min(window_len > 0 ? sink_cap + (write_pos >= window_len
                                                       ? write_pos
                                                       : window)
                                     : sink_len,
                      S_total);
  const int lo0 = split * split_slots;
  const int hi0 = min(lo0 + split_slots, hwm);  // the CTA's range
  const size_t head = (size_t)bkv * S_total;
  const int row_bytes = Dt * T::BYTES;  // a cache row
  const size_t pi = (size_t)unit * n_split + split;  // this CTA's partial
  float* po = part + pi * rows * Dt;
  float* pml = part + (size_t)gridDim.y * n_split * rows * Dt;

  if (hi0 > lo0) {
    // q's rows: in the first pass's first commit group.
    const uint8_t* qg = static_cast<const uint8_t*>(q) +
                        ((size_t)bkv * G + row_lo) * Dt * QB;
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
        const int age = sw < write_pos ? write_pos - 1 - sw
                                       : write_pos - 1 - sw + window;
        return slot < hi && (slot < sink_len ||
                             (sw >= 0 && sw < window && age < window_len));
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
          if (i == nk - 1) {
            // The pass's softmax, a warp per row: m, l (p in fp32) and P
            // (fp32 storage: p in S's place; else p (* v_scale) rounded to
            // 16 bits), p against the running max (m_old: the earlier
            // passes'), and the factor that rescales their O.
            __syncthreads();  // every warp's S is written
            const int nsl = n_t * TL;
            for (int r = warp; r < R; r += NWARPS) {
              const float m_old = first ? -INFINITY : m_sm[r];
              float mx = m_old, sum = 0.f;
              if constexpr (T::SCALAR) {
                float* sr = s_sm + r;  // slot j at sr[j * rp4]
                for (int j = lane; j < nsl; j += 32)
                  mx = fmaxf(mx, sr[j * rp4]);
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
                    float4* o =
                        reinterpret_cast<float4*>(po + (size_t)row * Dt + col);
                    float4 x = make_float4(
                        acc[gr * 16 + e], acc[gr * 16 + 4 + e],
                        acc[gr * 16 + 8 + e], acc[gr * 16 + 12 + e]);
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

  // The unit's last CTA to arrive merges its partials.
  fence_acq_rel_gpu();  // this CTA's partial before its arrival
  __syncthreads();
  if (tid == 0) *last_sm = atomicAdd(counters + unit, 1) == n_split - 1;
  __syncthreads();
  if (!*last_sm) return;
  fence_acq_rel_gpu();  // every partial after the arrivals
  // ... and before the TMA unit (the async proxy) reads them
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  const float* ml = pml + (size_t)unit * n_split * rows * 2;
  const float* o0 = part + (size_t)unit * n_split * rows * Dt;
  const int h0 = (bkv - b * H_kv) * G + row_lo;  // query head of local row 0
  // The partials' O, a window of wc columns at a time (R x wc <= 2048
  // floats: at most 4 float4 items a thread), in chunks of jc >= 4
  // partials [jc][R][wc] that TMA bulk copies bring into the ring, two in
  // flight (one copy a chunk where the window is the whole row of all
  // `rows` rows, else one a (partial, row)); the first two are issued
  // before the weights are known.
  static_assert(DEEP_MERGE_BUF >= 4 * 2048 * 4, "a chunk: 4 partials");
  static_assert(2 * DEEP_MERGE_BUF <= DEEP_STAGES * DEEP_BOX,
                "two chunks in the ring");
  const int wc = min(Dt, (2048 / R) & ~3);
  const int jc = DEEP_MERGE_BUF / (R * wc * 4);
  const bool whole = wc == Dt && R == rows;
  const int n_chunks = (n_split + jc - 1) / jc;
  const int n_windows = (Dt + wc - 1) / wc;
  uint64_t* bar = reinterpret_cast<uint64_t*>(last_sm + 4);  // two
  if (tid == 0) {
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
    uint8_t* dst = smem + (gc & 1) * DEEP_MERGE_BUF;
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
  issue(0);
  if (n_gc > 1) issue(1);
  // Each row's max M over the partials (s_aux as one more of LSE s_aux and
  // value 0), each partial's weight exp2(m_j - M) (0 where nothing was
  // live: its O unwritten, skipped) into S's place [n_split][R], and 1 /
  // the denominator; a warp per row, m and l read in one pass (online).
  float* wts = s_sm;
  for (int r = warp; r < R; r += NWARPS) {
    float mx = -INFINITY, den = 0.f;
    for (int j = lane; j < n_split; j += 32) {
      const float2 e = __ldcg(
          reinterpret_cast<const float2*>(ml + ((size_t)j * rows + r) * 2));
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
      l_sm[r] = den > 0.f ? 1.f / den : 0.f;
    }
  }
  __syncthreads();  // the weights are written
  float4 a4[4];
  for (int gc = 0; gc < n_gc; ++gc) {
    const int ch = gc % n_chunks, c0 = gc / n_chunks * wc;
    const int c4n = min(wc, Dt - c0) / 4, items = R * c4n;
    if (ch == 0) {
#pragma unroll
      for (int u = 0; u < 4; ++u) a4[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    mbar_wait_timed(bar + (gc & 1), (gc >> 1) & 1);
    const float* src =
        reinterpret_cast<const float*>(smem + (gc & 1) * DEEP_MERGE_BUF);
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
          const float inv = l_sm[r];
          const size_t oi = ((size_t)bkv * G + row_lo + r) * Dt + c0 + q4 * 4;
          if constexpr (T::SCALAR) {
            *reinterpret_cast<float4*>(static_cast<float*>(out) + oi) =
                make_float4(a4[u].x * inv, a4[u].y * inv, a4[u].z * inv,
                            a4[u].w * inv);
          } else {
            uint2 ob;
            ob.x = pack2<T::F16>(a4[u].x * inv, a4[u].y * inv);
            ob.y = pack2<T::F16>(a4[u].z * inv, a4[u].w * inv);
            *reinterpret_cast<uint2*>(static_cast<uint16_t*>(out) + oi) = ob;
          }
        }
      }
    }
  }
  if (tid == 0) counters[unit] = 0;  // for the next launch on this stream
}

template <class T>
int launch_deep(const void* q, const void* k, const void* v,
                const void* k_scale, const void* v_scale, const State& st,
                const void* s_aux, void* out, void* part, void* counters,
                int B, int H_q, int H_kv, int S_total, int sink_cap,
                int window, int Dt, int rows, int n_split, int split_slots,
                float scale, cudaStream_t stream) {
  static const cudaError_t attr_err = [] {  // once per storage
    cudaError_t e = cudaFuncSetAttribute(
        deep_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        DEEP_SMEM_MAX);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(deep_decode_kernel<T>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared);
  }();
  if (attr_err != cudaSuccess) return (int)attr_err;
  const int G = H_q / H_kv;
  const DeepLayout<T> lay(rows, Dt);
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
  // the merge's weights [n_split][rows] take S's place
  if (part == nullptr || counters == nullptr || rows < 1 ||
      rows > DEEP_ROWS || n_split < 1 || n_split > DEEP_SPLITS ||
      split_slots < DEEP_TL || split_slots % DEEP_TL != 0 ||
      (long)n_split * split_slots < end || lay.bytes > DEEP_SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const int n_pieces = (G + rows - 1) / rows;
  const long units = (long)B * H_kv * n_pieces;
  if (units > 65535) return (int)cudaErrorInvalidValue;
  deep_decode_kernel<T><<<dim3(n_split, (unsigned)units), NTHREADS,
                          lay.bytes, stream>>>(
      q, static_cast<const uint8_t*>(k), static_cast<const uint8_t*>(v),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      st, static_cast<const float*>(s_aux), out, static_cast<float*>(part),
      static_cast<int*>(counters), H_kv, G, rows, n_pieces, split_slots,
      S_total, sink_cap, window, Dt, scale * LOG2E);
  return (int)cudaGetLastError();
}

// What both designs take: whole GQA groups, whole 16-byte cache rows and q
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
             const void* s_aux, void* out, int st_stride, int sink_len,
             int window_len, int write_pos, int B, int H_q, int H_kv,
             int S_total, int D, int sink_cap, int window, int cluster,
             float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape<T>(H_q, H_kv, D) || D > 128 || cluster < 1 ||
      cluster > MAX_CLUSTER || (cluster & (cluster - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S_total <= 0) return 0;
  const State st{static_cast<const int*>(st_sink_len),
                 static_cast<const int*>(st_window_len),
                 static_cast<const int*>(st_write_pos), st_stride, sink_len,
                 window_len, write_pos};
  if (D <= 64)
    return launch_d<T, 64>(q, k, v, k_scale, v_scale, st, s_aux, out, B, H_q,
                           H_kv, S_total, sink_cap, window, D, cluster, scale,
                           s);
  return launch_d<T, 128>(q, k, v, k_scale, v_scale, st, s_aux, out, B, H_q,
                          H_kv, S_total, sink_cap, window, D, cluster, scale,
                          s);
}

template <class T>
int dispatch_deep(const void* q, const void* k, const void* v,
                  const void* k_scale, const void* v_scale,
                  const void* st_sink_len, const void* st_window_len,
                  const void* st_write_pos, const void* s_aux, void* out,
                  void* part, void* counters, int st_stride, int sink_len,
                  int window_len, int write_pos, int B, int H_q, int H_kv,
                  int S_total, int D, int sink_cap, int window, int rows,
                  int n_split, int split_slots, float scale, void* stream) {
  if (bad_shape<T>(H_q, H_kv, D) || D <= 128)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S_total <= 0) return 0;
  const State st{static_cast<const int*>(st_sink_len),
                 static_cast<const int*>(st_window_len),
                 static_cast<const int*>(st_write_pos), st_stride, sink_len,
                 window_len, write_pos};
  return launch_deep<T>(q, k, v, k_scale, v_scale, st, s_aux, out, part,
                        counters, B, H_q, H_kv, S_total, sink_cap, window, D,
                        rows, n_split, split_slots, scale,
                        static_cast<cudaStream_t>(stream));
}

template <class T>
int deep_smem(int rows, int D) {
  return DeepLayout<T>(rows, D).bytes;
}

}  // namespace

// q [B*H_q, D] (bf16; fp16 and fp32 for those caches); k/v [B*H_kv,
// S_total, D] (bf16, fp16, fp32, or int8 codes with k_scale/v_scale
// [B*H_kv, S_total] fp32; null otherwise), D with whole 16-byte rows; the
// state: three int32 arrays read at b * st_stride, or, where the pointers
// are null, the ints sink_len, window_len, write_pos for every sequence;
// s_aux [H_q] fp32 or null; out [B*H_q, D] like q.
// sink_decode_*: D <= 128, `cluster` CTAs (1, 2, 4 or 8) per (b, kv head,
// 64-row piece of the group).
#define SINK_DECODE_ENTRY(NAME, TYPE)                                        \
  extern "C" int NAME(const void* q, const void* k, const void* v,           \
                      const void* k_scale, const void* v_scale,              \
                      const void* st_sink_len, const void* st_window_len,    \
                      const void* st_write_pos, const void* s_aux, void* out, \
                      int st_stride, int sink_len, int window_len,           \
                      int write_pos, int B, int H_q, int H_kv, int S_total,  \
                      int D, int sink_cap, int window, int cluster,          \
                      float scale, void* stream) {                           \
    return dispatch<TYPE>(q, k, v, k_scale, v_scale, st_sink_len,            \
                          st_window_len, st_write_pos, s_aux, out,           \
                          st_stride, sink_len, window_len, write_pos, B,     \
                          H_q, H_kv, S_total, D, sink_cap, window, cluster,  \
                          scale, stream);                                    \
  }
// sink_decode_deep_*: D > 128, n_split CTAs of split_slots slots each (a
// multiple of 32; n_split at most 512; covering the live range) per (b, kv
// head, piece of `rows` query rows, as sink_decode_deep_rows gives them);
// part: fp32 scratch of units * n_split * rows * (D + 2) floats (units =
// B * H_kv * ceil(G / rows)); counters: `units` int32 zeros, left zero.
#define SINK_DECODE_DEEP_ENTRY(NAME, TYPE)                                   \
  extern "C" int NAME(const void* q, const void* k, const void* v,           \
                      const void* k_scale, const void* v_scale,              \
                      const void* st_sink_len, const void* st_window_len,    \
                      const void* st_write_pos, const void* s_aux, void* out, \
                      void* part, void* counters, int st_stride,             \
                      int sink_len, int window_len, int write_pos, int B,    \
                      int H_q, int H_kv, int S_total, int D, int sink_cap,   \
                      int window, int rows, int n_split, int split_slots,    \
                      float scale, void* stream) {                           \
    return dispatch_deep<TYPE>(                                              \
        q, k, v, k_scale, v_scale, st_sink_len, st_window_len, st_write_pos, \
        s_aux, out, part, counters, st_stride, sink_len, window_len,         \
        write_pos, B, H_q, H_kv, S_total, D, sink_cap, window, rows,         \
        n_split, split_slots, scale, stream);                                \
  }

SINK_DECODE_ENTRY(sink_decode_bf16, Bf16)
SINK_DECODE_ENTRY(sink_decode_f16, Fp16)
SINK_DECODE_ENTRY(sink_decode_f32, Fp32)
SINK_DECODE_ENTRY(sink_decode_int8, Int8)
SINK_DECODE_ENTRY(sink_decode_fp8, Fp8)
SINK_DECODE_DEEP_ENTRY(sink_decode_deep_bf16, Bf16)
SINK_DECODE_DEEP_ENTRY(sink_decode_deep_f16, Fp16)
SINK_DECODE_DEEP_ENTRY(sink_decode_deep_f32, Fp32)
SINK_DECODE_DEEP_ENTRY(sink_decode_deep_int8, Int8)
SINK_DECODE_DEEP_ENTRY(sink_decode_deep_fp8, Fp8)

// The 128-slot tile the host sizes clusters by (D <= 128).
extern "C" int sink_decode_tile() { return TILE; }
extern "C" int sink_decode_max_cluster() { return MAX_CLUSTER; }
// The query rows a CTA of the split decode takes for a group of G at head
// dim D in a storage of `bytes` bytes an element (1: codes with scales):
// up to 16, halved until the CTA's shared memory fits; 0 if one row does
// not fit.
extern "C" int sink_decode_deep_rows(int bytes, int G, int D) {
  auto smem = [&](int rows) {
    return bytes == 1   ? deep_smem<Int8>(rows, D)
           : bytes == 2 ? deep_smem<Bf16>(rows, D)
           : bytes == 4 ? deep_smem<Fp32>(rows, D)
                        : DEEP_SMEM_MAX + 1;
  };
  int rows = std::min(G, DEEP_ROWS);
  while (rows > 1 && smem(rows) > DEEP_SMEM_MAX) rows = (rows + 1) / 2;
  return rows >= 1 && smem(rows) <= DEEP_SMEM_MAX ? rows : 0;
}
