// Per-stage ablation of the forward (prefill) kernel, for Hopper.
//
// Replaces the Pallas TPU kernels of scripts/mfu_ablation.py, both launched
// by its run_ablation: `_ablation_kernel` (sink_ablation_bf16: stripped
// copies of the forward that add the online softmax back one stage at a
// time, and candidate variants of it) and `_mask_stage_kernel`
// (sink_mask_stage_bf16: correct attention whose diagonal and window-start
// tiles read a constant mask tile instead of comparing positions).
//
// Each stage is a softmax policy (StageSoftmax) of hopper.cuh's
// fwd_wgmma_kernel, the forward that prefill runs: the same persistent grid
// over (b*h_q, 128-row q block) items, producer warpgroup, TMA ring of
// 128-key K/V stages, two consumer warpgroups of 64 rows, wgmma m64n128k16
// for S and register-A wgmma for P V, O staged through the Q buffer; only
// the consumers' tile step differs. So a stage's time less mxu_floor's is
// what that piece of the softmax costs in the kernel the main path
// launches, at its tiles (the JAX script likewise runs its stages over the
// production kernel's grid and tiles). Offsets are zero, there is no s_aux
// and no LSE; N is a multiple of 128.
//
// Every stage computes s = (q * c) k^T with c = log2(e) / sqrt(D) rounded
// to bf16 and q * c rounded to bf16 (as the JAX script does). Each consumer
// scales its 64 rows of the item's Q buffer in place before its first
// product, then fences them for the async proxy and meets its warpgroup's
// barrier, so the wgmma reads the scaled rows: 64 x D values once per item,
// and S stays the forward's shared-memory product (Q held scaled as
// register A fragments would take 32 more registers a thread at D = 128
// beside S, O and P). Per KV tile (m = -inf, l = 0 to start; out = acc /
// (l or 1)):
//   MXU_FLOOR     p = s: the two products and P's bf16 pack
//   ROWMAX        + the running row max (two shuffles) and acc *= alpha
//   EXP2          p = 2^(s - m); l not kept
//   SUM           + l = l alpha + rowsum(p) (two more shuffles)
//   GENERAL       SUM with the sink/window/causal mask on every cell (no
//                 whole-tile test) and the unguarded update of the JAX
//                 script: a row whose first tile is wholly masked is NaN
//   SUM_MXU       l = l alpha + rowsum(bf16 p), the row sum as one more
//                 wgmma per 16-key step (m64n8k16, P as the register A
//                 operand, B a tile of ones in shared memory)
//   NOMAX         p = 2^(s - 16), l += rowsum(p): no max, no rescale
//   NOMAX_SUMMXU  NOMAX with the row sum on the tensor cores
//   BF16EXP       p = 2^x of x = bf16(s - m) by ex2.approx.ftz.bf16x2 (two
//                 per instruction), which is P's A fragment as it stands;
//                 l sums that p in fp32
//   MASKADD       correct attention: tiles are fast (no mask), diagonal
//                 (add a bf16 {0, -inf} tile: ii >= jj), window start (add
//                 its complement) or general (the forward's per-cell mask of
//                 positions); the guarded update
//   MASKSEL       the same with one int8 tile ii >= jj and a select (the
//                 arguments swapped on window-start tiles)
// The stripped stages and GENERAL run every visited tile on both consumers
// (they sum over masked cells too); only the mask stages, whose guarded
// update makes a wholly masked tile a no-op, skip a consumer's dead tiles
// as the forward does. The tile kinds are the JAX kernel's, from the tile's
// first row r0 and key c0: a window that is not a multiple of 128 has no
// window-start tiles, and those tiles fall to general. The constant tiles
// (128 x 128) come from the caller, as the JAX script passes them. The
// JAX kernel keeps them in fast memory; here masksel's 16 KB int8 tile is
// copied into shared memory once per CTA, but maskadd's 64 KB bf16 pair
// does not fit beside the forward's 192 KB of Q and K/V stages at D = 128,
// so each thread reads its own cells of it through the L2 (ld.global.nc)
// on diagonal and window-start tiles only (two of an item's ~33 tiles at
// the headline shape, every tile of a W = 128 layer).
//
// What bounds it on the H100: the useful work is the forward's (about 450
// FLOP per byte of Q/K/V/O at the headline shape, above the card's ridge of
// ~295: tensor-core bound); the stripped stages do the same tensor-core
// work over whole visited tiles.

#include "hopper.cuh"

namespace sinkattn {
namespace ablation {

using hopper::FWD_BM;
using hopper::FWD_BN;

enum Stage {
  MXU_FLOOR = 0,
  ROWMAX,
  EXP2,
  SUM,
  GENERAL,
  SUM_MXU,
  NOMAX,
  NOMAX_SUMMXU,
  BF16EXP,
  MASKADD,
  MASKSEL,
};

__host__ __device__ constexpr bool is_mask(int s) {
  return s == MASKADD || s == MASKSEL;
}
__host__ __device__ constexpr bool no_max(int s) {
  return s == MXU_FLOOR || s == NOMAX || s == NOMAX_SUMMXU;
}
__host__ __device__ constexpr bool sum_mxu(int s) {
  return s == SUM_MXU || s == NOMAX_SUMMXU;
}
__host__ __device__ constexpr bool sum_fp32(int s) {
  return s == SUM || s == GENERAL || s == NOMAX || s == BF16EXP ||
         is_mask(s);
}

constexpr float NOMAX_BOUND = 16.f;  // the nomax stages' fixed bound
constexpr int SEL_STRIDE = FWD_BN + 8;  // bytes per staged int8 mask row

enum TileKind { FAST = 0, DIAG, WINSTART, MIXED };

// The JAX kernel's class of the tile of rows [r0, r0 + 128) and keys
// [c0, c0 + 128) (zero offsets).
__device__ __forceinline__ int tile_kind(int r0, int c0, int num_sink,
                                         int window) {
  const bool causal = c0 + FWD_BN - 1 > r0;
  const bool win = c0 < r0 + FWD_BM - window;
  if (causal && r0 == c0 && !win) return DIAG;
  if (win && r0 - c0 == window && c0 >= num_sink && !causal) return WINSTART;
  return causal || win ? MIXED : FAST;
}

__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// Each bf16 of a pair times c, rounded to bf16 (the product is exact in
// fp32, so this is the correctly rounded bf16 product).
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t v, float c) {
  return pack_bf16(bf16_lo(v) * c, bf16_hi(v) * c);
}

// 2^x of both halves of a bf16 pair (sm_90).
__device__ __forceinline__ uint32_t ex2_bf16x2(uint32_t x) {
  uint32_t y;
  asm("ex2.approx.ftz.bf16x2 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// D[64 x 8] += A[64 x 16] B[16 x 8]: A from registers (bf16x2 fragments),
// B from shared memory, K-major; d[4].
__device__ __forceinline__ void wgmma_rs_n8(float (&d)[4],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// One stage as fwd_wgmma_kernel's softmax policy (see FwdSoftmax there).
template <int STAGE>
struct StageSoftmax {
  static constexpr bool kSkipDead = is_mask(STAGE);
  // the tile of bf16 ones (the row sum on the cores); masksel's int8 tile
  // in rows padded to SEL_STRIDE bytes (conflict-free reads)
  static constexpr int kSmem = sum_mxu(STAGE)      ? 1024
                               : STAGE == MASKSEL ? FWD_BM * SEL_STRIDE
                                                  : 0;
  static_assert(kSmem % 1024 == 0, "a policy's shared memory is 1024-aligned");
  static constexpr bool kLse = false;
  struct Tile {
    float alpha[2];  // the tile's rescale of l (the row sum on the cores)
    float lacc[4];   // the row sums' accumulators
  };

  float q_scale;      // log2(e) / sqrt(D) rounded to bf16
  const void* tiles;  // the mask stages' constant tiles

  // Every thread of the CTA, once: the ones tile (fenced for the async
  // proxy: the wgmma reads it), or masksel's tile copied in.
  __device__ __forceinline__ void init(uint8_t* own, int tid) const {
    if constexpr (sum_mxu(STAGE)) {
      for (int i = tid; i < 256; i += hopper::FWD_THREADS)
        reinterpret_cast<uint32_t*>(own)[i] = 0x3F803F80u;  // (1.0, 1.0)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    } else if constexpr (STAGE == MASKSEL) {  // 16 8-byte chunks a row
      for (int i = tid; i < FWD_BM * 16; i += hopper::FWD_THREADS)
        *reinterpret_cast<uint2*>(own + (i / 16) * SEL_STRIDE + (i % 16) * 8) =
            __ldg(static_cast<const uint2*>(tiles) + i);
    }
  }

  // Consumer cw's rows [64 cw, 64 cw + 64) of the item's Q buffer (BOXES
  // boxes of 128 rows x 128 bytes), times q_scale in place.
  template <int BOXES>
  __device__ __forceinline__ void begin_item(uint8_t* qbuf, int cw,
                                             int ct) const {
#pragma unroll
    for (int x = 0; x < BOXES; ++x) {
      uint4* rows =
          reinterpret_cast<uint4*>(qbuf + x * FWD_BM * 128 + cw * 64 * 128);
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // 512 16-byte chunks over 128 threads
        uint4 v = rows[ct + 128 * i];
        v.x = scale_bf16x2(v.x, q_scale);
        v.y = scale_bf16x2(v.y, q_scale);
        v.z = scale_bf16x2(v.z, q_scale);
        v.w = scale_bf16x2(v.w, q_scale);
        rows[ct + 128 * i] = v;
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    hopper::named_sync(1 + cw, 128);
  }

  // The constant tile on the thread's cells of a diagonal or window-start
  // tile: rows r_loc, r_loc + 8 of the 128 x 128 tile (maskadd's from the
  // L2, masksel's from shared memory).
  template <int NS>
  __device__ __forceinline__ void const_mask(float (&sacc)[NS], int kind,
                                             int r_loc, int t4,
                                             const uint8_t* own) const {
    const bool swap = kind == WINSTART;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r_loc + 8 * r;
#pragma unroll
      for (int jj = 0; jj < FWD_BN / 8; ++jj) {
        const int col = jj * 8 + t4 * 2;
        float& s0 = sacc[jj * 4 + 2 * r];
        float& s1 = sacc[jj * 4 + 2 * r + 1];
        if constexpr (STAGE == MASKADD) {  // [2][128][128] bf16
          const uint32_t bias =
              __ldg(static_cast<const unsigned int*>(tiles) +
                    ((swap * FWD_BM + row) * FWD_BN + col) / 2);
          s0 += bf16_lo(bias);
          s1 += bf16_hi(bias);
        } else {  // [1][128][128] int8; a window-start tile swaps the
                  // select's arguments: keeps where the tile is 0
          const unsigned short keep2 = *reinterpret_cast<const unsigned short*>(
              own + row * SEL_STRIDE + col);
          s0 = ((keep2 & 0xff) != 0) != swap ? s0 : -INFINITY;
          s1 = ((keep2 >> 8) != 0) != swap ? s1 : -INFINITY;
        }
      }
    }
  }

  template <class Mask, int NS, int OR>
  __device__ __forceinline__ void tile(const Mask& mask, float (&sacc)[NS],
                                       float (&oacc)[OR],
                                       uint32_t (&pa)[FWD_BN / 16][4],
                                       float (&m)[2], float (&l)[2],
                                       const RowSpan (&rows)[2], int col0,
                                       int r0, int r_loc, int t4, float,
                                       const uint8_t* own, Tile& t) const {
    if constexpr (STAGE == GENERAL) {
      hopper::mask_tile<true>(sacc, rows, col0 + t4 * 2, -INFINITY);
    } else if constexpr (is_mask(STAGE)) {  // a CTA-uniform branch
      const int kind = tile_kind(r0, col0, mask.num_sink, mask.window);
      if (kind == MIXED)
        hopper::mask_partial(sacc, rows, col0, t4);
      else if (kind != FAST)
        const_mask(sacc, kind, r_loc, t4, own);
    }

    // The stage's softmax, rows r_loc (e < 2) and r_loc + 8 (e >= 2).
    float m_use[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      t.alpha[r] = 1.f;
      if constexpr (no_max(STAGE)) {
        if constexpr (STAGE != MXU_FLOOR) {
#pragma unroll
          for (int i = 0; i < FWD_BN / 4; ++i) {
            float& x = sacc[(i >> 1) * 4 + 2 * r + (i & 1)];
            x = hopper::fast_exp2(x - NOMAX_BOUND);
            if constexpr (STAGE == NOMAX) rs[r] += x;
          }
        }
        continue;
      }
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < FWD_BN / 8; ++jj)
        mx = fmaxf(mx, fmaxf(sacc[jj * 4 + 2 * r], sacc[jj * 4 + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      // The mask stages' guarded update (on a fast tile every score is
      // finite, so it is the unguarded one there); the others unguarded, as
      // JAX's: a row whose max is still -inf gets 2^(-inf - -inf) = NaN.
      m_use[r] = is_mask(STAGE) && m_new == -INFINITY ? 0.f : m_new;
      const float alpha = hopper::fast_exp2(m[r] - m_use[r]);
      m[r] = m_new;
      t.alpha[r] = alpha;
      if constexpr (STAGE != ROWMAX && STAGE != BF16EXP) {
#pragma unroll
        for (int i = 0; i < FWD_BN / 4; ++i) {
          float& x = sacc[(i >> 1) * 4 + 2 * r + (i & 1)];
          x = hopper::fast_exp2(x - m_use[r]);
          if constexpr (sum_fp32(STAGE)) rs[r] += x;
        }
      }
#pragma unroll
      for (int jj = 0; jj < OR / 4; ++jj) {
        oacc[jj * 4 + 2 * r] *= alpha;
        oacc[jj * 4 + 2 * r + 1] *= alpha;
      }
    }

    if constexpr (STAGE == BF16EXP) {  // fragment i holds row i & 1
#pragma unroll
      for (int jj = 0; jj < FWD_BN / 16; ++jj)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float mu = m_use[i & 1];
          pa[jj][i] = ex2_bf16x2(pack_bf16(sacc[8 * jj + 2 * i] - mu,
                                           sacc[8 * jj + 2 * i + 1] - mu));
          rs[i & 1] += bf16_lo(pa[jj][i]) + bf16_hi(pa[jj][i]);
        }
    } else {
      hopper::pack_p(sacc, pa);
    }

    if constexpr (sum_fp32(STAGE)) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
        l[r] = no_max(STAGE) ? l[r] + rs[r] : l[r] * t.alpha[r] + rs[r];
      }
    }
    if constexpr (sum_mxu(STAGE)) {
#pragma unroll
      for (int i = 0; i < 4; ++i) t.lacc[i] = 0.f;
    }
  }

  // The row sum on the tensor cores: P times the tile of ones, every
  // column of the product the row's sum (issued with P V's products).
  __device__ __forceinline__ void sum(const uint32_t (&pa)[FWD_BN / 16][4],
                                      const uint8_t* own, Tile& t) const {
    if constexpr (sum_mxu(STAGE)) {
      const uint64_t ones = hopper::desc_sw128(own, 16, 1024);
#pragma unroll
      for (int jj = 0; jj < FWD_BN / 16; ++jj)
        wgmma_rs_n8(t.lacc, pa[jj], ones);
    }
  }

  __device__ __forceinline__ void done(float (&l)[2], Tile& t) const {
    if constexpr (sum_mxu(STAGE)) {
      hopper::fence_regs(t.lacc);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        l[r] = no_max(STAGE) ? l[r] + t.lacc[2 * r]
                             : l[r] * t.alpha[r] + t.lacc[2 * r];
    }
  }

  __device__ __forceinline__ float inv_l(float l) const {
    return l == 0.f ? 1.f : 1.f / l;
  }
};

template <int STAGE>
int launch(const void* q, const void* k, const void* v, const void* tiles,
           void* o, int B, int H_q, int H_kv, int N, int D, float c,
           const SinkWindowMask& mask, void* stream) {
  if (N % FWD_BM != 0) return (int)cudaErrorInvalidValue;
  if (N <= 0 || B * H_q <= 0) return 0;
  if (H_kv <= 0 || H_q % H_kv != 0) return (int)cudaErrorInvalidValue;
  // the stages run in the forward's instances of D 64 and 128 only
  const StageSoftmax<STAGE> softmax{c, tiles};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hopper::instance_d(D) == 64)
    return hopper::launch_fwd_d<64, 3, SinkWindowMask, StageSoftmax<STAGE>,
                                hopper::IoBf16>(
        q, k, v, nullptr, nullptr, o, nullptr, B, H_q, H_kv, N, N, D, 1.f,
        mask, softmax, st);
  if (hopper::instance_d(D) == 128)
    return hopper::launch_fwd_d<128, 2, SinkWindowMask, StageSoftmax<STAGE>,
                                hopper::IoBf16>(
        q, k, v, nullptr, nullptr, o, nullptr, B, H_q, H_kv, N, N, D, 1.f,
        mask, softmax, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace ablation
}  // namespace sinkattn

using sinkattn::SinkWindowMask;
namespace abl = sinkattn::ablation;

// q [B*H_q, N, D], k/v [B*H_kv, N, D] bf16 contiguous, 16-byte aligned;
// ranges [N/128, 4] int32 (fwd_kv_ranges at zero offsets, 128 x 128
// tiles); o like q. `stage` is the index of ops/ablation.py's STAGES (0-8
// here, 9-10 in sink_mask_stage_bf16); c = log2(e)/sqrt(D) rounded to
// bf16.
extern "C" int sink_ablation_bf16(const void* q, const void* k, const void* v,
                                  const void* ranges, void* o, int B, int H_q,
                                  int H_kv, int N, int D, int num_sink,
                                  int window, int stage, float c,
                                  void* stream) {
  const SinkWindowMask mask{static_cast<const int*>(ranges), N, N, num_sink,
                            window, 0, 0};
#define ABL_CASE(S)                                                          \
  case abl::S:                                                               \
    return abl::launch<abl::S>(q, k, v, nullptr, o, B, H_q, H_kv, N, D, c,   \
                               mask, stream);
  switch (stage) {
    ABL_CASE(MXU_FLOOR)
    ABL_CASE(ROWMAX)
    ABL_CASE(EXP2)
    ABL_CASE(SUM)
    ABL_CASE(GENERAL)
    ABL_CASE(SUM_MXU)
    ABL_CASE(NOMAX)
    ABL_CASE(NOMAX_SUMMXU)
    ABL_CASE(BF16EXP)
  }
#undef ABL_CASE
  return (int)cudaErrorInvalidValue;
}

// As sink_ablation_bf16, plus `tiles`: for MASKADD (stage 9) [2, 128, 128]
// bf16 {0, -inf} tiles (ii >= jj, its complement), for MASKSEL (stage 10)
// [1, 128, 128] int8 (ii >= jj), 4-byte aligned.
extern "C" int sink_mask_stage_bf16(const void* q, const void* k,
                                    const void* v, const void* ranges,
                                    const void* tiles, void* o, int B,
                                    int H_q, int H_kv, int N, int D,
                                    int num_sink, int window, int stage,
                                    float c, void* stream) {
  const SinkWindowMask mask{static_cast<const int*>(ranges), N, N, num_sink,
                            window, 0, 0};
  if (stage == abl::MASKADD)
    return abl::launch<abl::MASKADD>(q, k, v, tiles, o, B, H_q, H_kv, N, D, c,
                                     mask, stream);
  if (stage == abl::MASKSEL)
    return abl::launch<abl::MASKSEL>(q, k, v, tiles, o, B, H_q, H_kv, N, D, c,
                                     mask, stream);
  return (int)cudaErrorInvalidValue;
}

// Tile sizes the host-side range table must use.
extern "C" int sink_ablation_block_m() { return abl::FWD_BM; }
extern "C" int sink_ablation_block_n() { return abl::FWD_BN; }
