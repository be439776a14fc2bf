// Single-token decode attention over the rolling sink KV cache, for Hopper.
//
// Replaces the Pallas TPU kernel `_decode_kernel` of
// sink_attention_tpu/ops/decode.py (launched by `_decode_call`), in its
// three storage branches: bf16 (`sink_decode_bf16`), int8 codes
// (`sink_decode_int8`) and float8_e4m3fn codes held in int8
// (`sink_decode_fp8`), the codes with one fp32 scale per token and KV
// head. One query token per sequence attends the cache buffer
// [B, H_kv, S_total, D] in place: slots [0, sink_cap) hold the sink tokens,
// slots [sink_cap, sink_cap + window) the circular window. A slot is live iff
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
// output (DECODE_TOL 2e-2 on the bf16 output).
// D must be 64 or 128.

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
using sinkattn::pack_bf16;

constexpr int TILE = 128;      // slots per tile
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

// The storage types: `pair` gives elements p[0], p[1] of a row as a bf16x2
// (low half first), `one` element p[0] as bf16 bits; SCALED types carry
// per-token scales. The conversions are exact.
struct Bf16 {
  static constexpr int BYTES = 2;
  static constexpr bool SCALED = false;
  __device__ __forceinline__ static uint32_t pair(const uint8_t* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  __device__ __forceinline__ static uint32_t one(const uint8_t* p) {
    return *reinterpret_cast<const uint16_t*>(p);
  }
};

struct Int8 {
  static constexpr int BYTES = 1;
  static constexpr bool SCALED = true;
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
  static constexpr bool SCALED = true;
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

// One buffer: a tile's K and V rows (padded) and, when quantized, their
// per-slot scales.
template <class T, int D>
__host__ __device__ constexpr size_t buf_bytes() {
  return 2 * (size_t)TILE * (D * T::BYTES + 16) +
         (T::SCALED ? 2 * TILE * sizeof(float) : 0);
}

// Two buffers; after the tile loop the partials alias them: per warp
// [NWARPS][16][D] + m, l [NWARPS][16], then the CTA's [ROWS][D] + m, l
// [ROWS].
template <class T, int D>
constexpr size_t smem_bytes() {
  constexpr size_t tiles = 2 * buf_bytes<T, D>();
  constexpr size_t partials =
      (NWARPS * 16 * ((size_t)D + 2) + ROWS * ((size_t)D + 2)) *
      sizeof(float);
  return tiles > partials ? tiles : partials;
}

template <class T, int D, int SL>
__global__ void __launch_bounds__(NTHREADS)
    decode_kernel(const uint16_t* __restrict__ q,
                  const uint8_t* __restrict__ k,
                  const uint8_t* __restrict__ v,
                  const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale, State st,
                  const float* __restrict__ s_aux, uint16_t* __restrict__ out,
                  int H_kv, int G, int n_pieces, int S_total, int sink_cap,
                  int window, float scale_log2) {
  constexpr int ROWB = D * T::BYTES + 16;  // padded smem row (bytes)
  constexpr int VECS = D * T::BYTES / 16;  // 16-byte copies per row
  constexpr int SW = TILE / SL;            // slots per warp slice
  constexpr int NT = SW / 8;               // n-tiles of S
  constexpr int KT = D / 16;               // k-steps of S
  constexpr int DT = D / 8;                // n-tiles of O
  constexpr int D4 = D / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  // Buffer b: K [TILE][ROWB], V [TILE][ROWB], k scales [TILE], v scales.
  auto kbuf = [&](int b) { return smem + b * buf_bytes<T, D>(); };
  auto vbuf = [&](int b) { return kbuf(b) + TILE * ROWB; };
  auto ksbuf = [&](int b) {
    return reinterpret_cast<float*>(kbuf(b) + 2 * TILE * ROWB);
  };
  auto vsbuf = [&](int b) { return ksbuf(b) + TILE; };
  float* po = reinterpret_cast<float*>(smem);  // [NWARPS][16][D]
  float* pm = po + NWARPS * 16 * D;            // [NWARPS][16]
  float* pl = pm + NWARPS * 16;                // [NWARPS][16]
  float* co = pl + NWARPS * 16;                // [ROWS][D]: the CTA's
  float* cm = co + ROWS * D;                   // [ROWS]
  float* cl = cm + ROWS;                       // [ROWS]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_ranks = (int)cluster.num_blocks();
  const int unit = blockIdx.y;  // (b * H_kv + kv head) * n_pieces + piece
  const int bkv = unit / n_pieces;
  const int row_lo = (unit - bkv * n_pieces) * ROWS;  // first group row here
  const int R = min(G - row_lo, ROWS);
  const int b = bkv / H_kv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
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
  const int n_tiles = (hwm + TILE - 1) / TILE;

  const size_t head = (size_t)bkv * S_total;
  // One group of copies: tile `tile`'s K, V (and scales) into buffer bb.
  auto load = [&](int tile, int bb) {
    const int slot0 = tile * TILE;
    uint8_t* kd = kbuf(bb);
    uint8_t* vd = vbuf(bb);
    for (int c = tid; c < TILE * VECS; c += NTHREADS) {
      const int r = c / VECS, cc = c - (c / VECS) * VECS;
      const bool ok = slot0 + r < hwm;  // zeros past the live range
      const size_t off = (head + (ok ? slot0 + r : 0)) * D * T::BYTES + cc * 16;
      cp_async16(kd + r * ROWB + cc * 16, k + off, ok);
      cp_async16(vd + r * ROWB + cc * 16, v + off, ok);
    }
    if (T::SCALED) {  // one slot's scales a thread
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

  // This warp's A fragments of q (rows past the group's are zero), read
  // while the first tile is in flight.
  const int r0 = mt * 16 + g;  // local rows r0, r0 + 8
  const uint16_t* qr = q + ((size_t)bkv * G + row_lo + r0) * D;
  const bool ok0 = r0 < R, ok1 = r0 + 8 < R;
  uint32_t qf[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const int c = kk * 16 + t4 * 2;
    qf[kk][0] = ok0 ? *reinterpret_cast<const uint32_t*>(qr + c) : 0u;
    qf[kk][1] = ok1 ? *reinterpret_cast<const uint32_t*>(qr + 8 * D + c) : 0u;
    qf[kk][2] = ok0 ? *reinterpret_cast<const uint32_t*>(qr + c + 8) : 0u;
    qf[kk][3] =
        ok1 ? *reinterpret_cast<const uint32_t*>(qr + 8 * D + c + 8) : 0u;
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  for (int bb = 0; tile < n_tiles; tile += n_ranks, bb ^= 1) {
    // The next tile of this CTA streams in while this one is computed.
    if (tile + n_ranks < n_tiles) load(tile + n_ranks, bb ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's group
    __syncthreads();
    const int c0 = slice * SW;  // the slice's first slot in the tile
    if (has_rows && tile * TILE + c0 < hwm) {  // rows, and live slots
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
          mma16816(s[nt], qf[kk], T::pair(kr), T::pair(kr + 8 * T::BYTES));
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int cl_ = c0 + nt * 8 + t4 * 2 + e2;  // slot within the tile
          const bool ok = live(tile * TILE + cl_);
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
        const uint32_t a[4] = {pack_bf16(p0[0], p0[1]), pack_bf16(p0[2], p0[3]),
                               pack_bf16(p1[0], p1[1]), pack_bf16(p1[2], p1[3])};
        const uint8_t* vr = vb + (j * 16 + t4 * 2) * ROWB + g * T::BYTES;
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
          const uint8_t* p = vr + dt * 8 * T::BYTES;
          const uint32_t b0 = T::one(p) | (T::one(p + ROWB) << 16);
          const uint32_t b1 =
              T::one(p + 8 * ROWB) | (T::one(p + 9 * ROWB) << 16);
          mma16816(acc[dt], a, b0, b1);
        }
      }
    }
    __syncthreads();  // every warp is done with buffer bb before its refill
  }
  cp_async_wait<0>();
  __syncthreads();  // the tiles are dead: the partials take their place

  // Each warp's partial (m, l, unnormalised O) of its rows and slice ...
  if (has_rows) {
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
    uint2 ob;
    ob.x = pack_bf16(a.x * inv, a.y * inv);
    ob.y = pack_bf16(a.z * inv, a.w * inv);
    *reinterpret_cast<uint2*>(out + ((size_t)bkv * G + row_lo + r) * D +
                              d4 * 4) = ob;
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

template <class T, int D, int SL>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const State& st, const void* s_aux,
           void* out, int B, int H_q, int H_kv, int S_total, int sink_cap,
           int window, int cluster, float scale, cudaStream_t stream) {
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
      &cfg, decode_kernel<T, D, SL>, static_cast<const uint16_t*>(q),
      static_cast<const uint8_t*>(k), static_cast<const uint8_t*>(v),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      st, static_cast<const float*>(s_aux), static_cast<uint16_t*>(out),
      H_kv, G, n_pieces, S_total, sink_cap, window, scale * LOG2E);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <class T, int D>
int launch_d(const void* q, const void* k, const void* v, const void* k_scale,
             const void* v_scale, const State& st, const void* s_aux,
             void* out, int B, int H_q, int H_kv, int S_total, int sink_cap,
             int window, int cluster, float scale, cudaStream_t stream) {
  const int rows = min(H_q / H_kv, ROWS);  // of the largest piece
  if (rows <= 16)
    return launch<T, D, 4>(q, k, v, k_scale, v_scale, st, s_aux, out, B, H_q,
                           H_kv, S_total, sink_cap, window, cluster, scale,
                           stream);
  if (rows <= 32)
    return launch<T, D, 2>(q, k, v, k_scale, v_scale, st, s_aux, out, B, H_q,
                           H_kv, S_total, sink_cap, window, cluster, scale,
                           stream);
  return launch<T, D, 1>(q, k, v, k_scale, v_scale, st, s_aux, out, B, H_q,
                         H_kv, S_total, sink_cap, window, cluster, scale,
                         stream);
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
  if (B == 0 || S_total <= 0) return 0;
  const State st{static_cast<const int*>(st_sink_len),
                 static_cast<const int*>(st_window_len),
                 static_cast<const int*>(st_write_pos), st_stride, sink_len,
                 window_len, write_pos};
  if (D == 64)
    return launch_d<T, 64>(q, k, v, k_scale, v_scale, st, s_aux, out, B, H_q,
                           H_kv, S_total, sink_cap, window, cluster, scale, s);
  if (D == 128)
    return launch_d<T, 128>(q, k, v, k_scale, v_scale, st, s_aux, out, B,
                            H_q, H_kv, S_total, sink_cap, window, cluster,
                            scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [B*H_q, D] bf16; k/v [B*H_kv, S_total, D] (bf16, or int8 codes with
// k_scale/v_scale [B*H_kv, S_total] fp32; null for bf16); the state: three
// int32 arrays read at b * st_stride, or, where the pointers are null, the
// ints sink_len, window_len, write_pos for every sequence; s_aux [H_q] fp32
// or null; out [B*H_q, D] bf16. `cluster` CTAs (1, 2, 4 or 8) per (b, kv
// head, 64-row piece of the group).
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
SINK_DECODE_ENTRY(sink_decode_int8, Int8)
SINK_DECODE_ENTRY(sink_decode_fp8, Fp8)

extern "C" int sink_decode_tile() { return TILE; }
extern "C" int sink_decode_max_cluster() { return MAX_CLUSTER; }
