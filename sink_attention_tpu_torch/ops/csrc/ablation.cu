// Per-stage ablation of the forward (prefill) kernel, for Hopper.
//
// Replaces the Pallas TPU kernels of scripts/mfu_ablation.py, both launched
// by its run_ablation: `_ablation_kernel` (sink_ablation_bf16: stripped
// copies of the forward that add the online softmax back one stage at a
// time, and candidate variants of it) and `_mask_stage_kernel`
// (sink_mask_stage_bf16: correct attention whose diagonal and window-start
// tiles read a constant mask tile instead of comparing positions).
//
// Each kernel is the first port's forward skeleton, of which this file
// keeps its own copy (the production forward is now hopper.cuh's wgmma/TMA
// kernel), with its softmax cut to one stage, so the time a stage adds is
// a cost of that skeleton: one CTA of 4 warps per (b*h_q, 64-row q block)
// over the host's two KV ranges (ops/flash.py fwd_kv_ranges),
// double-buffered cp.async K/V tiles of 64 keys, bf16 mma.sync.m16n8k16
// with fp32 accumulation, P kept in registers as the P V product's A
// fragments.
// Offsets are zero, there is no s_aux and no LSE; N is a multiple of 64.
//
// Every stage computes s = (q * c) k^T with c = log2(e) / sqrt(D) rounded
// to bf16 and q * c rounded to bf16 (as the JAX script does); Q is scaled
// once per CTA, as its fragments are loaded. Per KV tile (m = -inf, l = 0
// to start; out = acc / (l or 1)):
//   MXU_FLOOR     p = s: the two products and P's bf16 pack
//   ROWMAX        + the running row max (two shuffles) and acc *= alpha
//   EXP2          p = exp2f(s - m); l not kept
//   SUM           + l = l alpha + rowsum(p) (two more shuffles)
//   GENERAL       SUM with the sink/window/causal mask on every cell (no
//                 full-tile skip) and the unguarded update of the JAX
//                 script: a row whose first tile is wholly masked is NaN
//   SUM_MXU       l = l alpha + rowsum(bf16 p), the row sum as one more
//                 mma per k-step with a B fragment of ones
//   NOMAX         p = exp2f(s - 16), l += rowsum(p): no max, no rescale
//   NOMAX_SUMMXU  NOMAX with the row sum on the tensor cores
//   BF16EXP       p = 2^x of x = bf16(s - m) by ex2.approx.ftz.bf16x2 (two
//                 per instruction), which is P's A fragment as it stands;
//                 l sums that p in fp32
//   MASKADD       correct attention: tiles are fast (no mask), diagonal
//                 (add a bf16 {0, -inf} tile: ii >= jj), window start (add
//                 its complement) or general (compare positions); masked
//                 tiles take the guarded update
//   MASKSEL       the same with one int8 tile ii >= jj and a select (the
//                 arguments swapped on window-start tiles)
// The constant tiles come from the caller, as the JAX script passes them,
// and are staged in shared memory once per CTA (rows padded so the reads
// are free of bank conflicts).
//
// What bounds it on the H100: the useful work is the forward's (about 450
// FLOP per byte of Q/K/V/O at the headline shape, above the card's ridge of
// ~295: tensor-core bound); the stripped stages do the same tensor-core
// work over whole visited tiles. A simple mma.sync kernel reaches neither
// bound; the stage deltas measure what each piece of the softmax costs in
// it, which is what a wgmma/TMA redesign has to remove.

#include "attention.cuh"

namespace sinkattn {
namespace ablation {

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

__host__ __device__ constexpr bool is_mask(int s) { return s == MASKADD || s == MASKSEL; }
__host__ __device__ constexpr bool no_max(int s) {
  return s == MXU_FLOOR || s == NOMAX || s == NOMAX_SUMMXU;
}
__host__ __device__ constexpr bool sum_mxu(int s) { return s == SUM_MXU || s == NOMAX_SUMMXU; }
__host__ __device__ constexpr bool sum_fp32(int s) {
  return s == SUM || s == GENERAL || s == NOMAX || s == BF16EXP ||
         is_mask(s);
}

constexpr float NOMAX_BOUND = 16.f;  // the nomax stages' fixed bound
constexpr int ADD_STRIDE = BN + 8;   // bf16 elements per staged bias row
constexpr int SEL_STRIDE = BN + 16;  // bytes per staged int8 mask row
constexpr uint32_t ONES_BF16X2 = 0x3F803F80u;  // (1.0, 1.0) in bf16

// Bytes of shared memory the constant tiles of a stage take.
template <int STAGE>
constexpr int mask_smem_bytes() {
  return STAGE == MASKADD   ? 2 * BM * ADD_STRIDE * 2
         : STAGE == MASKSEL ? BM * SEL_STRIDE
                            : 0;
}

enum TileKind { FAST = 0, DIAG, WINSTART, MIXED };

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

template <int D, int STAGE>
__global__ void __launch_bounds__(NTHREADS)
    ablation_kernel(const uint16_t* __restrict__ q,
                    const uint16_t* __restrict__ k,
                    const uint16_t* __restrict__ v,
                    const void* __restrict__ tiles, uint16_t* __restrict__ o,
                    int H_q, int H_kv, int N, float c, SinkWindowMask mask) {
  constexpr int STRIDE = D + 8;
  constexpr int CHUNKS = D / 8;
  constexpr int KT = D / 16;
  constexpr int DT = D / 8;
  constexpr int NT = BN / 8;

  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* Qs = smem;                  // [BM][STRIDE]
  uint16_t* Ks = Qs + BM * STRIDE;      // [2][BN][STRIDE]
  uint16_t* Vs = Ks + 2 * BN * STRIDE;  // [2][BN][STRIDE]
  uint16_t* Ms = Vs + 2 * BN * STRIDE;  // the constant tiles, if any

  const int qb = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H_q;
  const int h = bh - b * H_q;
  const int kvh = b * H_kv + h / (H_q / H_kv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  const uint16_t* qg = q + (size_t)bh * N * D;
  const uint16_t* kg = k + (size_t)kvh * N * D;
  const uint16_t* vg = v + (size_t)kvh * N * D;

  const int* rg = mask.q_block(b, qb);
  const int sb0 = rg[0];
  const int wb0 = rg[2];
  const int n_sink_blocks = max(rg[1] - sb0, 0);
  const int n_blocks = n_sink_blocks + max(rg[3] - wb0, 0);

  for (int i = tid; i < BM * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS, cc = i - (i / CHUNKS) * CHUNKS;
    cp_async16(Qs + r * STRIDE + cc * 8,
               qg + (size_t)(qb * BM + r) * D + cc * 8, true);
  }
  if constexpr (STAGE == MASKADD) {  // [2][BM][BN] bf16, 8 chunks a row
    const uint16_t* tg = static_cast<const uint16_t*>(tiles);
    for (int i = tid; i < 2 * BM * 8; i += NTHREADS)
      cp_async16(Ms + (i / 8) * ADD_STRIDE + (i % 8) * 8,
                 tg + (i / 8) * BN + (i % 8) * 8, true);
  } else if constexpr (STAGE == MASKSEL) {  // [BM][BN] int8, 4 chunks a row
    const uint8_t* tg = static_cast<const uint8_t*>(tiles);
    uint8_t* ms = reinterpret_cast<uint8_t*>(Ms);
    for (int i = tid; i < BM * 4; i += NTHREADS)
      cp_async16(ms + (i / 4) * SEL_STRIDE + (i % 4) * 16,
                 tg + (i / 4) * BN + (i % 4) * 16, true);
  }

  auto block_of = [&](int t) {
    return t < n_sink_blocks ? sb0 + t : wb0 + (t - n_sink_blocks);
  };
  auto load_kv = [&](int t, int buf) {
    const int blk = block_of(t);
    for (int i = tid; i < BN * CHUNKS; i += NTHREADS) {
      const int r = i / CHUNKS, cc = i - (i / CHUNKS) * CHUNKS;
      const size_t off = (size_t)(blk * BN + r) * D + cc * 8;
      cp_async16(Ks + (buf * BN + r) * STRIDE + cc * 8, kg + off, true);
      cp_async16(Vs + (buf * BN + r) * STRIDE + cc * 8, vg + off, true);
    }
  };
  if (n_blocks > 0) load_kv(0, 0);
  cp_async_commit();

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  const int r_loc = warp * 16 + g;  // this thread's first row in the tile
  const int rows[2] = {qb * BM + r_loc, qb * BM + r_loc + 8};
  uint32_t qf[KT][4];

  for (int t = 0; t < n_blocks; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_blocks) load_kv(t + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    if (t == 0) {  // Q's fragments, scaled into the exp2 domain once
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        const uint16_t* qr = Qs + r_loc * STRIDE + kk * 16 + t4 * 2;
        qf[kk][0] = scale_bf16x2(ld32(qr), c);
        qf[kk][1] = scale_bf16x2(ld32(qr + 8 * STRIDE), c);
        qf[kk][2] = scale_bf16x2(ld32(qr + 8), c);
        qf[kk][3] = scale_bf16x2(ld32(qr + 8 * STRIDE + 8), c);
      }
    }

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    const uint16_t* kb = Ks + buf * BN * STRIDE;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint16_t* kr = kb + (nt * 8 + g) * STRIDE + kk * 16 + t4 * 2;
        mma16816(s[nt], qf[kk], ld32(kr), ld32(kr + 8));
      }
    }

    // The mask: every cell (GENERAL), or by tile kind (the mask stages).
    const int col0 = block_of(t) * BN;
    int kind = FAST;
    if constexpr (is_mask(STAGE)) {
      const int r0 = qb * BM;
      const bool causal = col0 + BN - 1 > r0;
      const bool win = col0 < r0 + BM - mask.window;
      if (causal && r0 == col0 && !win)
        kind = DIAG;
      else if (win && r0 - col0 == mask.window && col0 >= mask.num_sink &&
               !causal)
        kind = WINSTART;
      else if (causal || win)
        kind = MIXED;
    }
    if (STAGE == GENERAL || kind == MIXED) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jl = col0 + nt * 8 + t4 * 2 + (e & 1);
          s[nt][e] = mask.visible(rows[e >> 1], jl) ? s[nt][e] : -INFINITY;
        }
    } else if (kind != FAST) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int tr = r_loc + 8 * r, tc = nt * 8 + t4 * 2;
          if constexpr (STAGE == MASKADD) {
            const uint32_t bias =
                ld32(Ms + ((kind == WINSTART) * BM + tr) * ADD_STRIDE + tc);
            s[nt][2 * r] += bf16_lo(bias);
            s[nt][2 * r + 1] += bf16_hi(bias);
          } else if constexpr (STAGE == MASKSEL) {
            const uint8_t* ms = reinterpret_cast<const uint8_t*>(Ms);
            const uint16_t keep2 =
                *reinterpret_cast<const uint16_t*>(ms + tr * SEL_STRIDE + tc);
            const bool k0 = (keep2 & 0xff) != 0, k1 = (keep2 >> 8) != 0;
            if (kind == DIAG) {
              s[nt][2 * r] = k0 ? s[nt][2 * r] : -INFINITY;
              s[nt][2 * r + 1] = k1 ? s[nt][2 * r + 1] : -INFINITY;
            } else {
              s[nt][2 * r] = k0 ? -INFINITY : s[nt][2 * r];
              s[nt][2 * r + 1] = k1 ? -INFINITY : s[nt][2 * r + 1];
            }
          }
        }
    }

    // The softmax of the stage, one row pair per thread.
    float alpha[2] = {1.f, 1.f}, m_use[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if constexpr (no_max(STAGE)) {
        if constexpr (STAGE != MXU_FLOOR) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            s[nt][2 * r] = exp2f(s[nt][2 * r] - NOMAX_BOUND);
            s[nt][2 * r + 1] = exp2f(s[nt][2 * r + 1] - NOMAX_BOUND);
            if constexpr (STAGE == NOMAX) rs[r] += s[nt][2 * r] + s[nt][2 * r + 1];
          }
        }
        continue;
      }
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float m_new;
      if (is_mask(STAGE) && kind != FAST) {  // the guarded update
        m_new = mx > -INFINITY ? fmaxf(m[r], mx) : m[r];
        m_use[r] = m_new > -INFINITY ? m_new : 0.f;
        alpha[r] = m[r] > -INFINITY ? exp2f(m[r] - m_use[r]) : 0.f;
      } else {
        m_new = fmaxf(m[r], mx);
        m_use[r] = m_new;
        alpha[r] = exp2f(m[r] - m_new);  // NaN where both are -inf
      }
      m[r] = m_new;
      if constexpr (STAGE != ROWMAX && STAGE != BF16EXP) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          s[nt][2 * r] = exp2f(s[nt][2 * r] - m_use[r]);
          s[nt][2 * r + 1] = exp2f(s[nt][2 * r + 1] - m_use[r]);
          if constexpr (sum_fp32(STAGE))
            rs[r] += s[nt][2 * r] + s[nt][2 * r + 1];
        }
      }
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        acc[dt][2 * r] *= alpha[r];
        acc[dt][2 * r + 1] *= alpha[r];
      }
    }

    // acc += P V; the tensor-core row sum beside it.
    float lacc[4] = {0.f, 0.f, 0.f, 0.f};
    const uint16_t* vb = Vs + buf * BN * STRIDE;
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      uint32_t a[4];
      if constexpr (STAGE == BF16EXP) {
        const float* c0 = s[2 * j];
        const float* c1 = s[2 * j + 1];
        a[0] = ex2_bf16x2(pack_bf16(c0[0] - m_use[0], c0[1] - m_use[0]));
        a[1] = ex2_bf16x2(pack_bf16(c0[2] - m_use[1], c0[3] - m_use[1]));
        a[2] = ex2_bf16x2(pack_bf16(c1[0] - m_use[0], c1[1] - m_use[0]));
        a[3] = ex2_bf16x2(pack_bf16(c1[2] - m_use[1], c1[3] - m_use[1]));
        rs[0] += bf16_lo(a[0]) + bf16_hi(a[0]) + bf16_lo(a[2]) + bf16_hi(a[2]);
        rs[1] += bf16_lo(a[1]) + bf16_hi(a[1]) + bf16_lo(a[3]) + bf16_hi(a[3]);
      } else {
        acc_to_a(a, s[2 * j], s[2 * j + 1]);
      }
      mma_rows_b<STRIDE, DT>(acc, a, vb, j * 16, g, t4);
      if constexpr (sum_mxu(STAGE)) mma16816(lacc, a, ONES_BF16X2, ONES_BF16X2);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float add;
      if constexpr (sum_mxu(STAGE)) {
        add = lacc[2 * r];  // every column of the product is the row sum
      } else if constexpr (sum_fp32(STAGE)) {
        add = rs[r];
        add += __shfl_xor_sync(0xffffffffu, add, 1);
        add += __shfl_xor_sync(0xffffffffu, add, 2);
      } else {
        continue;  // l is not kept
      }
      l[r] = no_max(STAGE) ? l[r] + add : l[r] * alpha[r] + add;
    }
    __syncthreads();  // this buffer is refilled two iterations on
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float div = l[r] == 0.f ? 1.f : l[r];
    uint16_t* orow = o + ((size_t)bh * N + rows[r]) * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + t4 * 2) =
          pack_bf16(acc[dt][2 * r] / div, acc[dt][2 * r + 1] / div);
    }
  }
}

template <int D, int STAGE>
int launch_d(const void* q, const void* k, const void* v, const void* tiles,
             void* o, int B, int H_q, int H_kv, int N, float c,
             const SinkWindowMask& mask, cudaStream_t stream) {
  const size_t smem = (size_t)(BM + 4 * BN) * (D + 8) * sizeof(uint16_t) +
                      mask_smem_bytes<STAGE>();
  cudaError_t err = set_smem(ablation_kernel<D, STAGE>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(N / BM, B * H_q);
  ablation_kernel<D, STAGE><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), tiles, static_cast<uint16_t*>(o), H_q,
      H_kv, N, c, mask);
  return (int)cudaGetLastError();
}

template <int STAGE>
int launch(const void* q, const void* k, const void* v, const void* tiles,
           void* o, int B, int H_q, int H_kv, int N, int D, float c,
           const SinkWindowMask& mask, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 0 || B * H_q <= 0) return 0;
  if (N % BM != 0) return (int)cudaErrorInvalidValue;
  if (D == 64)
    return launch_d<64, STAGE>(q, k, v, tiles, o, B, H_q, H_kv, N, c, mask,
                               st);
  if (D == 128)
    return launch_d<128, STAGE>(q, k, v, tiles, o, B, H_q, H_kv, N, c, mask,
                                st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace ablation
}  // namespace sinkattn

using sinkattn::SinkWindowMask;
namespace abl = sinkattn::ablation;

// q [B*H_q, N, D], k/v [B*H_kv, N, D] bf16 contiguous; ranges
// [N/64, 4] int32 (fwd_kv_ranges at zero offsets); o like q. `stage` is
// the index of ops/ablation.py's STAGES (0-8 here, 9-10 in
// sink_mask_stage_bf16); c = log2(e)/sqrt(D) rounded to bf16.
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

// As sink_ablation_bf16, plus `tiles`: for MASKADD (stage 9) [2, 64, 64]
// bf16 {0, -inf} tiles (ii >= jj, its complement), for MASKSEL (stage 10)
// [1, 64, 64] int8 (ii >= jj). window must be a multiple of 64.
extern "C" int sink_mask_stage_bf16(const void* q, const void* k,
                                    const void* v, const void* ranges,
                                    const void* tiles, void* o, int B,
                                    int H_q, int H_kv, int N, int D,
                                    int num_sink, int window, int stage,
                                    float c, void* stream) {
  const SinkWindowMask mask{static_cast<const int*>(ranges), N, N, num_sink,
                            window, 0, 0};
  if (window % sinkattn::BN != 0) return (int)cudaErrorInvalidValue;
  if (stage == abl::MASKADD)
    return abl::launch<abl::MASKADD>(q, k, v, tiles, o, B, H_q, H_kv, N, D, c,
                                     mask, stream);
  if (stage == abl::MASKSEL)
    return abl::launch<abl::MASKSEL>(q, k, v, tiles, o, B, H_q, H_kv, N, D, c,
                                     mask, stream);
  return (int)cudaErrorInvalidValue;
}

// Tile sizes the host-side range table must use.
extern "C" int sink_ablation_block_m() { return sinkattn::BM; }
extern "C" int sink_ablation_block_n() { return sinkattn::BN; }
