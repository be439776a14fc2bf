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
// and two scales) when quantized. At gpt-oss-20b's shapes that is ~1 us, under
// the cost of a launch, so the design spends one launch per call, no
// scratch in device memory and no host work beyond the output allocation:
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
// so 8 CTAs leave one walking two.
// Quantized storage computes attention over the dequantized cache: the
// codes decode exactly to bf16 (int8 by an int -> float convert, fp8 by
// Hopper's e4m3 -> f16 convert; every int8 and e4m3 value is a bf16
// value), score = (q . codes_k) * k_scale in fp32, and P V takes
// p * v_scale rounded to bf16 (the row sum takes p alone in fp32). The
// bf16 rounding of P, as in the prefill kernels, costs up to 2^-9 of an
// output (DECODE_TOL 2e-2 on the bf16 output). fp16 storage is the bf16
// branch with fp16 mma.sync and P rounded to fp16 (q and the output fp16).
// fp32 storage computes in fp32 on the CUDA cores (F32Warp below: as the
// JAX kernel pins Precision.HIGHEST for a non-bf16 cache): one buffer of
// 128 slots (two would not fit beside q), a lane per slot for S = q . k
// (float4 rows, conflict-free at the padded row stride) and a lane per
// column for O += p v, q and the output fp32.
// Head dims: any D whose rows are whole 16 bytes (D % 8 for bf16/fp16, D %
// 16 for the codes, D % 4 for fp32; the host pads any other D), D <= 512
// run by the instance of D_i = 64, 128, 256 or 512 with the columns past D
// zero-filled by cp.async (src-size 0) and not written: at D = 80 the
// tensor cores do 128 / 80 = 1.6x the products, on a kernel bound by its
// launch and its bytes. The 256 instance of the 16-bit and fp32 storage
// walks tiles of 64 slots (tile_slots): two 128-slot bf16 buffers would
// take 270 KB; the codes keep 128 (a tile of K and V codes is 70 KB). A
// warp's O of 16 rows x 256 columns is 128 fp32 registers a lane beside
// q's 64 (bf16 A fragments); the fp32 storage's lane-per-slot step keeps
// its warp slices at 32 slots or more (at most 2 slices of a 64-slot
// tile).
// Past D = 512 one wide instance per storage (wide_decode_kernel) takes
// every D: a CTA owns 16 query rows and one 512-column slice of their
// output (the slices a grid dimension beside the pieces), walks 32-slot
// tiles, and streams S's depth in chunks of 256 columns of K and q
// (double-buffered) with the slice's V loaded beside the first chunk; every
// warp computes the same S and accumulates its 128 of the slice's columns.
// S is computed 4x per slice: at D = 1024 8x the products the bound
// counts, on a kernel bound by its bytes.
// The 512 instance splits O's columns across the warps (col_slices): a
// warp's O of 16 rows x 512 would take 256 registers a lane. A CTA takes
// 16 query rows (cta_rows; the 64-row pieces of the other instances become
// 16-row pieces); each of its 4 warps computes the same S = q K^T of those
// rows over the whole tile and the same softmax, and accumulates only its
// 128 columns of O (64 registers a lane), so the warps' partials write
// disjoint columns and share m and l; q's rows sit in shared memory (their
// fragments, 128 registers a lane, are read per k-step). Tiles of 32
// slots for the 16-bit and fp32 storages (two 16-bit buffers 130 KB, the
// one fp32 buffer 129 KB beside q's 32 KB), 64 for the codes (two buffers
// 133 KB). S is computed by every warp: 4x its products, on a kernel
// bound by its bytes and its launch.

#include <cooperative_groups.h>

#include "attention.cuh"

#include <cuda_fp8.h>

namespace cg = cooperative_groups;

namespace {

using sinkattn::LOG2E;
using sinkattn::cp_async16;
using sinkattn::cp_async_commit;
using sinkattn::cp_async_wait;
using sinkattn::mma16816;
using sinkattn::pack2;
using sinkattn::pack_bf16;

constexpr int TILE = 128;      // slots per tile (fewer at D >= 256)
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
};

struct Fp8 {
  static constexpr int BYTES = 1;
  static constexpr bool SCALED = true, F16 = false, SCALAR = false;
  __device__ __forceinline__ static uint32_t pair(const uint8_t* p) {
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
        *reinterpret_cast<const __nv_fp8x2_storage_t*>(p), __NV_E4M3);
    const float2 f = __half22float2(__half2(h));
    return pack_bf16(f.x, f.y);
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

// Slots per tile of an instance: TILE, but 64 for unquantized storage at
// D = 256, where two 128-slot buffers would not fit, and at D = 512 32
// (unquantized) or 64 (codes) (see the header).
template <class T, int D>
__host__ __device__ constexpr int tile_slots() {
  return D == 512   ? (T::SCALED ? 64 : 32)
         : D == 256 ? (T::SCALED ? TILE : 64)
                    : TILE;
}

// Warps that split O's columns (the 512 instance: each of the 4 owns a
// quarter), and query rows per CTA: 64, one 16-row m-tile a warp, or 16
// where the warps split the columns.
template <int D>
__host__ __device__ constexpr int col_slices() {
  return D == 512 ? NWARPS : 1;
}
template <int D>
__host__ __device__ constexpr int cta_rows() {
  return col_slices<D>() > 1 ? 16 : ROWS;
}

// One buffer: a tile's K and V rows (padded) and, when quantized, their
// per-slot scales.
template <class T, int D>
__host__ __device__ constexpr size_t buf_bytes() {
  return 2 * (size_t)tile_slots<T, D>() * (D * T::BYTES + 16) +
         (T::SCALED ? 2 * tile_slots<T, D>() * sizeof(float) : 0);
}

// Tile buffers: two (the next tile streams in while one is computed), one
// for fp32 storage (two do not fit at D = 128 or 256).
template <class T>
__host__ __device__ constexpr int n_bufs() {
  return T::SCALAR ? 1 : 2;
}

// The CTA's q rows in shared memory where the warps split O's columns
// (16-bit or code storage: bf16 / fp16 rows padded by 16 bytes, so a
// fragment's 8 rows fall on distinct banks).
template <class T, int D>
__host__ __device__ constexpr bool q_in_smem() {
  return col_slices<D>() > 1 && !T::SCALAR;
}
__host__ __device__ constexpr int q_row_bytes(int D) { return D * 2 + 16; }

// The buffers, then the CTA's q rows (fp32 storage: [cta_rows][D] fp32;
// q_in_smem: [cta_rows][q_row_bytes]); after the tile loop the partials
// alias them: per warp [NWARPS][16][D] + m, l [NWARPS][16], then the
// CTA's [cta_rows][D] + m, l [cta_rows].
template <class T, int D>
constexpr size_t smem_bytes() {
  constexpr size_t RW = cta_rows<D>();
  constexpr size_t tiles =
      n_bufs<T>() * buf_bytes<T, D>() +
      (T::SCALAR ? RW * D * sizeof(float) : 0) +
      (q_in_smem<T, D>() ? RW * q_row_bytes(D) : 0);
  constexpr size_t partials =
      (NWARPS * 16 * ((size_t)D + 2) + RW * ((size_t)D + 2)) * sizeof(float);
  return tiles > partials ? tiles : partials;
}

// The fp32 storage's warp step: the warp (m-tile of 16 query rows, slot
// slice of SW = TL / SL >= 32 slots of a TL-slot tile) computes in fp32 on
// the CUDA cores. S: a
// lane per slot (NS = SW / 32 slots a lane), q rows read from shared
// memory by broadcast, K rows as float4 (row stride D + 4 floats: a
// quarter warp's 8 rows fall on distinct banks); the online softmax per
// row over the lanes (exp2 domain); O += p v over the warp's D / CS
// columns from col0 (CS warps split them): a lane per column (D / CS / 32
// columns a lane), each slot's p taken from its lane by a shuffle.
template <int D, int SL, int TL, int CS = 1>
struct F32Warp {
  static constexpr int SW = TL / SL;
  static constexpr int NS = SW / 32;  // slots a lane
  static constexpr int NC = D / CS / 32;  // output columns a lane
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
  // qs [16][D]; live(i) says whether slot i of the slice is live; the
  // warp's O columns start at col0.
  template <class Live>
  __device__ __forceinline__ void tile(const float* kb, const float* vb,
                                       const float* qs, int lane, int col0,
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
        const float* vr = vb + (j * 32 + sl) * ROWF + col0 + lane;
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

  // The warp's partial: its O columns of [16][D] at pw, m and l of its
  // rows at pm, pl (where `ml`: one warp of those that split the columns).
  __device__ __forceinline__ void write(float* pw, float* pm, float* pl,
                                        int lane, int col0, bool ml) const {
#pragma unroll
    for (int r = 0; r < 16; ++r) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
        pw[r * D + col0 + c * 32 + lane] = o[r][c];
      if (ml && lane == 0) {
        pm[r] = m[r];
        pl[r] = l[r];
      }
    }
  }
};

// D is the instance's head dim, Dt <= D the cache's and q's (their row
// length): the columns past Dt are zero-filled in shared memory and not
// written.
template <class T, int D, int SL>
__global__ void __launch_bounds__(NTHREADS)
    decode_kernel(const void* __restrict__ q, const uint8_t* __restrict__ k,
                  const uint8_t* __restrict__ v,
                  const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale, State st,
                  const float* __restrict__ s_aux, void* __restrict__ out,
                  int H_kv, int G, int n_pieces, int S_total, int sink_cap,
                  int window, int Dt, float scale_log2) {
  constexpr int TL = tile_slots<T, D>();   // slots per tile
  constexpr int ROWB = D * T::BYTES + 16;  // padded smem row (bytes)
  constexpr int VECS = D * T::BYTES / 16;  // 16-byte copies per smem row
  constexpr int SW = TL / SL;              // slots per warp slice
  constexpr int NT = SW / 8;               // n-tiles of S
  constexpr int KT = D / 16;               // k-steps of S
  constexpr int CS = col_slices<D>();      // warps splitting O's columns
  constexpr int RW = cta_rows<D>();        // query rows per CTA
  constexpr bool QSM = q_in_smem<T, D>();  // q's rows in shared memory
  constexpr int DC = D / CS;               // a warp's O columns
  constexpr int DT = DC / 8;               // n-tiles of O
  constexpr int D4 = D / 4;
  static_assert(CS == 1 || SL == 1, "column-split warps walk whole tiles");
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
  // fp32 storage: the CTA's q rows [RW][D], after the one buffer;
  // q_in_smem: [RW][q_row_bytes] 16-bit, after the two
  float* q_sm = reinterpret_cast<float*>(smem + buf_bytes<T, D>());
  uint8_t* q16_sm = smem + n_bufs<T>() * buf_bytes<T, D>();
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
  // a warp's m-tile and slot slice, or (CS > 1) its quarter of O's columns
  const int wr = CS > 1 ? 0 : warp, cs = CS > 1 ? warp : 0;
  const int mt = wr / SL, slice = wr - (wr / SL) * SL;
  const int col0 = cs * DC;  // the warp's first O column
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
    if (T::SCALED && (TL == NTHREADS || tid < TL)) {  // a slot's scales
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
  constexpr int KQ = T::SCALAR || QSM ? 1 : KT;
  uint32_t qf[KQ][4];
  if constexpr (QSM) {
    const uint16_t* qg =
        static_cast<const uint16_t*>(q) + ((size_t)bkv * G + row_lo) * Dt;
    for (int i = tid; i < RW * (D / 8); i += NTHREADS) {
      const int r = i / (D / 8), c8 = i - (i / (D / 8)) * (D / 8);
      *reinterpret_cast<uint4*>(q16_sm + r * q_row_bytes(D) + c8 * 16) =
          r < R && c8 * 8 < Dt
              ? *reinterpret_cast<const uint4*>(qg + (size_t)r * Dt + c8 * 8)
              : make_uint4(0u, 0u, 0u, 0u);
    }
  } else if constexpr (T::SCALAR) {
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
  F32Warp<D, SL, TL, CS> fw;
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
                q_sm + mt * 16 * D, lane, col0, scale_log2,
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
        uint32_t qa[4];  // q's A fragment of the k-step
        if constexpr (QSM) {
          const uint8_t* qr =
              q16_sm + r0 * q_row_bytes(D) + (kk * 16 + t4 * 2) * 2;
          qa[0] = *reinterpret_cast<const uint32_t*>(qr);
          qa[1] = *reinterpret_cast<const uint32_t*>(qr + 8 * q_row_bytes(D));
          qa[2] = *reinterpret_cast<const uint32_t*>(qr + 16);
          qa[3] = *reinterpret_cast<const uint32_t*>(
              qr + 8 * q_row_bytes(D) + 16);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint8_t* kr =
              kb + (nt * 8 + g) * ROWB + (kk * 16 + t4 * 2) * T::BYTES;
          mma16816<T::F16>(s[nt], qa, T::pair(kr),
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

      // O += P V (p * v_scale when quantized), V read down its rows (the
      // warp's columns from col0).
      const uint8_t* vb = vbuf(bb) + c0 * ROWB + col0 * T::BYTES;
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
  // (CS > 1: the warps' columns of one partial, m and l from warp 0)
  if constexpr (T::SCALAR) {
    if (has_rows)
      fw.write(po + wr * 16 * D, pm + wr * 16, pl + wr * 16, lane, col0,
               cs == 0);
  } else if (has_rows) {
    float* pw = po + wr * 16 * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = g + 8 * r;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
        *reinterpret_cast<float2*>(pw + row * D + col0 + dt * 8 + t4 * 2) =
            make_float2(acc[dt][2 * r], acc[dt][2 * r + 1]);
      if (t4 == 0 && cs == 0) {
        pm[wr * 16 + row] = m[r];
        pl[wr * 16 + row] = l[r];
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
  const int n_pieces = (G + cta_rows<D>() - 1) / cta_rows<D>();
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
// 32 or 64 rows; fp32 storage's slices at least 32 slots (SLMAX); 1 where
// the warps split O's columns.
template <class T, int D>
int launch_d(const void* q, const void* k, const void* v, const void* k_scale,
             const void* v_scale, const State& st, const void* s_aux,
             void* out, int B, int H_q, int H_kv, int S_total, int sink_cap,
             int window, int Dt, int cluster, float scale,
             cudaStream_t stream) {
  constexpr int SLMAX = col_slices<D>() > 1 ? 1
                        : T::SCALAR           ? tile_slots<T, D>() / 32
                                              : 4;
  const int rows = min(H_q / H_kv, ROWS);  // of the largest piece
  if (rows <= 16)
    return launch<T, D, (SLMAX < 4 ? SLMAX : 4)>(
        q, k, v, k_scale, v_scale, st, s_aux, out, B, H_q, H_kv, S_total,
        sink_cap, window, Dt, cluster, scale, stream);
  if (rows <= 32)
    return launch<T, D, (SLMAX < 2 ? SLMAX : 2)>(
        q, k, v, k_scale, v_scale, st, s_aux, out, B, H_q, H_kv, S_total,
        sink_cap, window, Dt, cluster, scale, stream);
  return launch<T, D, 1>(q, k, v, k_scale, v_scale, st, s_aux, out, B, H_q,
                         H_kv, S_total, sink_cap, window, Dt, cluster, scale,
                         stream);
}

// ---------------------------------------------------------------------------
// The wide instance (D > 512): its depth and its column slices are counted
// at run time, so one instance per storage runs every D past 512.
// ---------------------------------------------------------------------------

constexpr int WIDE_MIN_D = 513;  // the smallest head dim of the instance
constexpr int WIDE_TL = 32;      // slots per tile
constexpr int WIDE_KC = 256;     // columns of a depth chunk of K and q
constexpr int WIDE_SC = 512;     // output columns of a CTA (a slice)
constexpr int WIDE_RW = 16;      // query rows of a CTA
constexpr int WIDE_WC = WIDE_SC / NWARPS;  // a warp's output columns

// Shared memory of the wide instance of storage T: two chunk buffers (a
// tile's K rows over WIDE_KC columns, then the CTA's q rows over the same
// columns), the tile's V rows over the slice's columns, its k and v scales;
// rows padded by 16 bytes. After the tile loop the CTA's partial aliases
// them: O [WIDE_RW][WIDE_SC] fp32, then m and l [WIDE_RW].
template <class T>
struct WideDecode {
  static constexpr int QB = T::SCALAR ? 4 : 2;  // q's element bytes
  static constexpr int KROW = WIDE_KC * T::BYTES + 16;
  static constexpr int QROW = WIDE_KC * QB + 16;
  static constexpr int VROW = WIDE_SC * T::BYTES + 16;
  static constexpr int CHUNK = WIDE_TL * KROW + WIDE_RW * QROW;
  static constexpr int V_OFF = 2 * CHUNK;
  static constexpr int SC_OFF = V_OFF + WIDE_TL * VROW;  // k, v scales
  static constexpr int TILES = SC_OFF + 2 * WIDE_TL * 4;
  static constexpr int PART = (WIDE_RW * WIDE_SC + 2 * WIDE_RW) * 4;
  static constexpr int BYTES = TILES > PART ? TILES : PART;
};

// One CTA: 16 query rows of a (b, kv head) and one 512-column slice of
// their output, over the tiles rank, rank + C, ... of a cluster of C. A
// tile's S = q K^T runs over the depth in chunks of WIDE_KC columns (K's
// and q's, double-buffered by cp.async; the slice's V and the scales load
// with the first chunk), every warp computing the same S and softmax (the
// same products in the same order, so the warps and the slices of a row
// agree bit for bit) and accumulating its 128 of the slice's columns of O;
// the 16-bit and code storages on mma.sync as the other instances, fp32 in
// fp32 on the CUDA cores (a lane per slot for S, a lane per column for O).
// The CTA's partial merges over the cluster as decode_kernel's does.
template <class T>
__global__ void __launch_bounds__(NTHREADS)
    wide_decode_kernel(const void* __restrict__ q,
                       const uint8_t* __restrict__ k,
                       const uint8_t* __restrict__ v,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale, State st,
                       const float* __restrict__ s_aux,
                       void* __restrict__ out, int H_kv, int G, int n_pieces,
                       int n_slices, int S_total, int sink_cap, int window,
                       int Dt, float scale_log2) {
  using W = WideDecode<T>;
  constexpr int TL = WIDE_TL, RW = WIDE_RW;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ksc = reinterpret_cast<float*>(smem + W::SC_OFF);
  float* vsc = ksc + TL;
  uint8_t* vbuf = smem + W::V_OFF;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_ranks = (int)cluster.num_blocks();
  // unit: ((b * H_kv + kv head) * n_pieces + piece) * n_slices + slice
  const int unit = blockIdx.y;
  const int up = unit / n_slices, sl = unit - up * n_slices;
  const int bkv = up / n_pieces;
  const int row_lo = (up - bkv * n_pieces) * RW;  // first group row here
  const int R = min(G - row_lo, RW);
  const int b = bkv / H_kv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int col0 = warp * WIDE_WC;  // the warp's first column in the slice
  const int scol = sl * WIDE_SC;    // the slice's first column

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
  const int n_chunks = (Dt + WIDE_KC - 1) / WIDE_KC;
  const size_t head = (size_t)bkv * S_total;
  const int row_bytes = Dt * T::BYTES;  // a cache row
  const uint8_t* qg = static_cast<const uint8_t*>(q) +
                      ((size_t)bkv * G + row_lo) * Dt * W::QB;

  // Chunk ch of tile `tile` (K's and q's columns [ch KC, ch KC + KC)) into
  // chunk buffer bb; zeros past the live range, the rows and Dt.
  auto load_chunk = [&](int tile, int ch, int bb) {
    constexpr int K16 = WIDE_KC * T::BYTES / 16, Q16 = WIDE_KC * W::QB / 16;
    uint8_t* kd = smem + bb * W::CHUNK;
    uint8_t* qd = kd + TL * W::KROW;
    const int slot0 = tile * TL;
    for (int c = tid; c < TL * K16; c += NTHREADS) {
      const int r = c / K16, byte = ch * WIDE_KC * T::BYTES + (c % K16) * 16;
      const bool ok = slot0 + r < hwm && byte < row_bytes;
      const size_t off = ok ? (head + slot0 + r) * row_bytes + byte : 0;
      cp_async16(kd + r * W::KROW + (c % K16) * 16, k + off, ok);
    }
    for (int c = tid; c < RW * Q16; c += NTHREADS) {
      const int r = c / Q16, byte = ch * WIDE_KC * W::QB + (c % Q16) * 16;
      const bool ok = r < R && byte < Dt * W::QB;
      cp_async16(qd + r * W::QROW + (c % Q16) * 16,
                 qg + (ok ? (size_t)r * Dt * W::QB + byte : 0), ok);
    }
  };
  // The tile's V rows over the slice's columns, and its scales.
  auto load_v = [&](int tile) {
    constexpr int V16 = WIDE_SC * T::BYTES / 16;
    const int slot0 = tile * TL;
    for (int c = tid; c < TL * V16; c += NTHREADS) {
      const int r = c / V16, byte = scol * T::BYTES + (c % V16) * 16;
      const bool ok = slot0 + r < hwm && byte < row_bytes;
      const size_t off = ok ? (head + slot0 + r) * row_bytes + byte : 0;
      cp_async16(vbuf + r * W::VROW + (c % V16) * 16, v + off, ok);
    }
    if (T::SCALED && tid < TL) {
      const bool ok = slot0 + tid < hwm;
      const size_t off = head + (ok ? slot0 + tid : 0);
      cp_async4(ksc + tid, k_scale + off, ok);
      cp_async4(vsc + tid, v_scale + off, ok);
    }
  };
  auto live = [&](int slot) {
    const int sw = slot - sink_cap;
    const int age = sw < write_pos ? write_pos - 1 - sw
                                   : write_pos - 1 - sw + window;
    return slot < hwm &&
           (slot < sink_len || (sw >= 0 && sw < window && age < window_len));
  };

  // mma.sync storages: rows g and g + 8, m, l and O's 16 n-tiles of the
  // warp's columns; fp32: all 16 rows, a lane per slot and per 4 columns.
  constexpr int NR = T::SCALAR ? 16 : 2;
  constexpr int NO = T::SCALAR ? 16 * (WIDE_WC / 32) : 4 * (WIDE_WC / 8);
  float m[NR], l[NR], acc[NO];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;

  for (int tile = rank; tile < n_tiles; tile += n_ranks) {
    load_v(tile);
    load_chunk(tile, 0, 0);
    cp_async_commit();
    // S: fp32, s[r] row r's score of the lane's slot; else s[nt * 4 + e]
    // the m16n8 accumulators of slots nt * 8 + 2 t4 + (e & 1)
    float s[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = 0.f;
    for (int ch = 0; ch < n_chunks; ++ch) {
      if (ch + 1 < n_chunks) {
        load_chunk(tile, ch + 1, (ch + 1) & 1);
        cp_async_commit();
        cp_async_wait<1>();  // this chunk's group (and the V group)
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const uint8_t* kb = smem + (ch & 1) * W::CHUNK;
      const uint8_t* qb = kb + TL * W::KROW;
      const int cols = min(WIDE_KC, Dt - ch * WIDE_KC);
      if constexpr (T::SCALAR) {
        const float* kr = reinterpret_cast<const float*>(kb + lane * W::KROW);
        for (int d4 = 0; d4 < cols / 4; ++d4) {
          const float4 kv = *reinterpret_cast<const float4*>(kr + d4 * 4);
#pragma unroll
          for (int r = 0; r < 16; ++r) {
            const float4 qv = *reinterpret_cast<const float4*>(
                qb + r * W::QROW + d4 * 16);
            s[r] = fmaf(qv.w, kv.w,
                        fmaf(qv.z, kv.z,
                             fmaf(qv.y, kv.y, fmaf(qv.x, kv.x, s[r]))));
          }
        }
      } else {
        for (int kk = 0; kk < (cols + 15) / 16; ++kk) {
          const uint8_t* qr = qb + g * W::QROW + (kk * 16 + t4 * 2) * 2;
          const uint32_t qa[4] = {
              *reinterpret_cast<const uint32_t*>(qr),
              *reinterpret_cast<const uint32_t*>(qr + 8 * W::QROW),
              *reinterpret_cast<const uint32_t*>(qr + 16),
              *reinterpret_cast<const uint32_t*>(qr + 8 * W::QROW + 16)};
#pragma unroll
          for (int nt = 0; nt < TL / 8; ++nt) {
            const uint8_t* kr =
                kb + (nt * 8 + g) * W::KROW + (kk * 16 + t4 * 2) * T::BYTES;
            mma16816<T::F16>(*reinterpret_cast<float(*)[4]>(&s[nt * 4]), qa,
                             T::pair(kr), T::pair(kr + 8 * T::BYTES));
          }
        }
      }
      __syncthreads();  // the chunk buffer is free for the load after next
    }

    if constexpr (T::SCALAR) {
      const bool ok = live(tile * TL + lane);
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float x = ok ? s[r] * scale_log2 : -INFINITY;
        float mx = x;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[r], mx);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = exp2f(m[r] - m_use);  // m = -inf: o, l are 0
        m[r] = m_new;
        const float p = x == -INFINITY ? 0.f : exp2f(x - m_use);
        s[r] = p;
        float rs = p;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          rs += __shfl_xor_sync(0xffffffffu, rs, off);
        l[r] = l[r] * alpha + rs;
#pragma unroll
        for (int c = 0; c < WIDE_WC / 32; ++c)
          acc[r * (WIDE_WC / 32) + c] *= alpha;
      }
      // O += p v: a lane per column (4 of the warp's 128), each slot's p
      // from its lane.
      for (int j = 0; j < TL; ++j) {
        const float* vr = reinterpret_cast<const float*>(vbuf + j * W::VROW) +
                          col0 + lane;
        float vv[WIDE_WC / 32];
#pragma unroll
        for (int c = 0; c < WIDE_WC / 32; ++c) vv[c] = vr[c * 32];
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          const float p = __shfl_sync(0xffffffffu, s[r], j);
#pragma unroll
          for (int c = 0; c < WIDE_WC / 32; ++c)
            acc[r * (WIDE_WC / 32) + c] =
                fmaf(p, vv[c], acc[r * (WIDE_WC / 32) + c]);
        }
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < TL / 8; ++nt) {
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int cl_ = nt * 8 + t4 * 2 + e2;  // slot within the tile
          const bool ok = live(tile * TL + cl_);
          const float f = T::SCALED ? ksc[cl_] * scale_log2 : scale_log2;
          s[nt * 4 + e2] = ok ? s[nt * 4 + e2] * f : -INFINITY;
          s[nt * 4 + e2 + 2] = ok ? s[nt * 4 + e2 + 2] * f : -INFINITY;
        }
      }
      // Online softmax, rows g and g + 8 (e >> 1), as decode_kernel's.
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < TL / 8; ++nt)
          mx = fmaxf(mx, fmaxf(s[nt * 4 + 2 * r], s[nt * 4 + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = exp2f(m[r] - m_use);
        m[r] = m_new;
        float rs = 0.f;
#pragma unroll
        for (int nt = 0; nt < TL / 8; ++nt) {
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const float x = s[nt * 4 + 2 * r + e2];
            const float p = x == -INFINITY ? 0.f : exp2f(x - m_use);
            s[nt * 4 + 2 * r + e2] = p;
            rs += p;
          }
        }
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        l[r] = l[r] * alpha + rs;
#pragma unroll
        for (int dt = 0; dt < WIDE_WC / 8; ++dt) {
          acc[dt * 4 + 2 * r] *= alpha;
          acc[dt * 4 + 2 * r + 1] *= alpha;
        }
      }
      // O += P V (p * v_scale when quantized), V read down its rows (the
      // warp's columns from col0).
      const uint8_t* vb = vbuf + col0 * T::BYTES;
#pragma unroll
      for (int j = 0; j < TL / 16; ++j) {
        float p0[4], p1[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p0[e] = s[(2 * j) * 4 + e];
          p1[e] = s[(2 * j + 1) * 4 + e];
          if (T::SCALED) {
            const int cl_ = j * 16 + t4 * 2 + (e & 1);
            p0[e] *= vsc[cl_];
            p1[e] *= vsc[cl_ + 8];
          }
        }
        const uint32_t a[4] = {
            pack2<T::F16>(p0[0], p0[1]), pack2<T::F16>(p0[2], p0[3]),
            pack2<T::F16>(p1[0], p1[1]), pack2<T::F16>(p1[2], p1[3])};
        const uint8_t* vr = vb + (j * 16 + t4 * 2) * W::VROW + g * T::BYTES;
#pragma unroll
        for (int dt = 0; dt < WIDE_WC / 8; ++dt) {
          const uint8_t* p = vr + dt * 8 * T::BYTES;
          const uint32_t b0 = T::one(p) | (T::one(p + W::VROW) << 16);
          const uint32_t b1 =
              T::one(p + 8 * W::VROW) | (T::one(p + 9 * W::VROW) << 16);
          mma16816<T::F16>(*reinterpret_cast<float(*)[4]>(&acc[dt * 4]), a,
                           b0, b1);
        }
      }
    }
    __syncthreads();  // V and the scales are free for the next tile
  }
  cp_async_wait<0>();
  __syncthreads();  // the tiles are dead: the partial takes their place

  // The CTA's partial (m, l from warp 0: every warp holds the same).
  float* co = reinterpret_cast<float*>(smem);  // [RW][WIDE_SC]
  float* cm = co + RW * WIDE_SC;               // [RW]
  float* cl = cm + RW;                         // [RW]
  if constexpr (T::SCALAR) {
#pragma unroll
    for (int r = 0; r < 16; ++r) {
#pragma unroll
      for (int c = 0; c < WIDE_WC / 32; ++c)
        co[r * WIDE_SC + col0 + c * 32 + lane] = acc[r * (WIDE_WC / 32) + c];
      if (warp == 0 && lane == 0) {
        cm[r] = m[r];
        cl[r] = l[r];
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = g + 8 * r;
#pragma unroll
      for (int dt = 0; dt < WIDE_WC / 8; ++dt)
        *reinterpret_cast<float2*>(co + row * WIDE_SC + col0 + dt * 8 +
                                   t4 * 2) =
            make_float2(acc[dt * 4 + 2 * r], acc[dt * 4 + 2 * r + 1]);
      if (warp == 0 && t4 == 0) {
        cm[row] = m[r];
        cl[row] = l[r];
      }
    }
  }
  cluster.sync();  // every CTA's partial is written

  // Merge the cluster's partials, s_aux as one more of LSE s_aux and value
  // 0 (decode_kernel's merge over the slice's columns).
  constexpr int C4 = WIDE_SC / 4;
  const int h0 = (bkv - b * H_kv) * G + row_lo;  // query head of local row 0
  for (int i = tid * n_ranks + rank; i < R * C4; i += n_ranks * NTHREADS) {
    const int r = i / C4, d4 = i - (i / C4) * C4;
    const int col = scol + d4 * 4;
    if (col >= Dt) continue;  // past the row
    float rm[MAX_CLUSTER], rl[MAX_CLUSTER];
    float4 ro[MAX_CLUSTER];
#pragma unroll
    for (int c = 0; c < MAX_CLUSTER; ++c) {
      if (c < n_ranks) {
        rm[c] = *cluster.map_shared_rank(cm + r, c);
        rl[c] = *cluster.map_shared_rank(cl + r, c);
        ro[c] = *cluster.map_shared_rank(
            reinterpret_cast<float4*>(co + r * WIDE_SC + d4 * 4), c);
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
    const size_t o = ((size_t)bkv * G + row_lo + r) * Dt + col;
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

template <class T>
int launch_wide(const void* q, const void* k, const void* v,
                const void* k_scale, const void* v_scale, const State& st,
                const void* s_aux, void* out, int B, int H_q, int H_kv,
                int S_total, int sink_cap, int window, int Dt, int cluster,
                float scale, cudaStream_t stream) {
  constexpr size_t smem = WideDecode<T>::BYTES;
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      wide_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);  // once per storage
  if (attr_err != cudaSuccess) return (int)attr_err;
  const int G = H_q / H_kv;
  const int n_pieces = (G + WIDE_RW - 1) / WIDE_RW;
  const int n_slices = (Dt + WIDE_SC - 1) / WIDE_SC;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, B * H_kv * n_pieces * n_slices, 1);
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
      &cfg, wide_decode_kernel<T>, q, static_cast<const uint8_t*>(k),
      static_cast<const uint8_t*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), st,
      static_cast<const float*>(s_aux), out, H_kv, G, n_pieces, n_slices,
      S_total, sink_cap, window, Dt, scale * LOG2E);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
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
  if (H_kv <= 0 || H_q % H_kv != 0 || cluster < 1 || cluster > MAX_CLUSTER ||
      (cluster & (cluster - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  // whole 16-byte cache rows, and q rows of whole 4 elements
  if (D <= 0 || (D * T::BYTES) % 16 != 0 || D % 4 != 0)
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
  if (D <= 128)
    return launch_d<T, 128>(q, k, v, k_scale, v_scale, st, s_aux, out, B,
                            H_q, H_kv, S_total, sink_cap, window, D, cluster,
                            scale, s);
  if (D <= 256)
    return launch_d<T, 256>(q, k, v, k_scale, v_scale, st, s_aux, out, B,
                            H_q, H_kv, S_total, sink_cap, window, D, cluster,
                            scale, s);
  if (D >= WIDE_MIN_D)
    return launch_wide<T>(q, k, v, k_scale, v_scale, st, s_aux, out, B, H_q,
                          H_kv, S_total, sink_cap, window, D, cluster, scale,
                          s);
  return launch_d<T, 512>(q, k, v, k_scale, v_scale, st, s_aux, out, B, H_q,
                          H_kv, S_total, sink_cap, window, D, cluster, scale,
                          s);
}

}  // namespace

// q [B*H_q, D] (bf16; fp16 and fp32 for those caches); k/v [B*H_kv,
// S_total, D] (bf16, fp16, fp32, or int8 codes with k_scale/v_scale
// [B*H_kv, S_total] fp32; null otherwise), any D with whole 16-byte
// rows; the state: three int32 arrays read at b * st_stride, or, where the
// pointers are null, the ints sink_len, window_len, write_pos for every
// sequence; s_aux [H_q] fp32 or null; out [B*H_q, D] like q. `cluster`
// CTAs (1, 2, 4 or 8) per (b, kv head, 64-row piece of the group; 16-row
// at D > 256; and 512-column slice at D > 512).
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
                          st_window_len, st_write_pos, s_aux, out, st_stride, \
                          sink_len, window_len, write_pos, B, H_q, H_kv,     \
                          S_total, D, sink_cap, window, cluster, scale,      \
                          stream);                                           \
  }

SINK_DECODE_ENTRY(sink_decode_bf16, Bf16)
SINK_DECODE_ENTRY(sink_decode_f16, Fp16)
SINK_DECODE_ENTRY(sink_decode_f32, Fp32)
SINK_DECODE_ENTRY(sink_decode_int8, Int8)
SINK_DECODE_ENTRY(sink_decode_fp8, Fp8)

// The 128-slot tile the host sizes clusters by (an instance of 64-slot
// tiles walks two per 128 slots).
extern "C" int sink_decode_tile() { return TILE; }
extern "C" int sink_decode_max_cluster() { return MAX_CLUSTER; }
