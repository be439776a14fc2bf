// Sink attention on Hopper: the mma.sync forward (the packed forward, and
// the skeleton ablation.cu copies), written once over a mask policy, and
// the unpacked mask policy itself.
//
// The kernels of the port compute, for every query row i and key j with
// valid(i, j) given by the policy, the forward O = softmax(scale * Q K^T) V
// over the valid keys plus the optional per-head sink logit s_aux (an extra
// logit with no value) and the natural-log LSE; and, from the forward's LSE
// (which counts s_aux, so P below is the true probability and s_aux needs
// no term here) and delta_i = sum_d dO_id O_id (less the LSE cotangent, if
// any):
//     P  = exp(scale * Q K^T - LSE)  on valid cells, 0 elsewhere
//     dP = dO V^T,   dS = P * (dP - delta)
//     dQ = scale * dS K,   dV = P^T dO,   dK = scale * dS^T Q
// Query head h reads KV head h / (H_q / H_kv). D must be 64 or 128. The
// unpacked forward is hopper.cuh's wgmma/TMA kernel, dQ hopper_dq.cuh's and
// dK/dV hopper_bwd.cuh's, the last two over both policies.
//
// Two policies: SinkWindowMask below (global positions with chunk offsets;
// flash_fwd.cu, flash_bwd.cu, ablation.cu) and PackedMask (segments of a
// packed batch; packed.cu). A policy supplies the per-block range tables
// the host built, each row's visible key runs (RowSpan: the wgmma forward
// and dQ), each key's interval of visible query rows (dK/dV) and the
// per-cell predicate; PackedMask also fwd_kernel's row descriptor and the
// predicate of a tile that lies wholly inside the mask.
//
// fwd_kernel's design (right first, simple): one CTA of 4 warps per
// (b*h_q, 64-row q block), each warp 16 rows; the CTA visits only the KV
// blocks of two ranges from the policy's table (the sink blocks, then the
// window blocks after them); K/V tiles of 64 keys are double-buffered in
// shared memory with cp.async, so the next tile's copy overlaps this
// tile's math; P stays in registers (the S accumulator layout is the
// A-operand layout of the P V product) under the classic online softmax in
// the exp2 domain, seeded with m = s_aux*log2e, l = 1 when s_aux is given
// (m = -inf, l = 0 otherwise): exact for every input; bf16
// mma.sync.m16n8k16 with fp32 accumulation. Masked cells are excluded by a
// select, never by arithmetic on the exponent, so rows that see no key
// give 0 and not NaN.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace sinkattn {

constexpr int BM = 64;  // query rows per tile
constexpr int BN = 64;  // keys per tile
constexpr int NTHREADS = 128;
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

// D += A(16x16 bf16, row) * B(16x8 bf16, col), fp32 accumulate.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x is the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// acc[j] += A * T[k0 .. k0+16)[j*8 .. j*8+8) for a row-major tile T whose
// rows are the product's depth (the B operand read down the columns).
template <int STRIDE, int NJ>
__device__ __forceinline__ void mma_rows_b(float (&acc)[NJ][4],
                                           const uint32_t (&a)[4],
                                           const uint16_t* t, int k0, int g,
                                           int t4) {
  const uint16_t* base = t + (k0 + t4 * 2) * STRIDE + g;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const uint16_t* p = base + j * 8;
    const uint32_t b0 = (uint32_t)p[0] | ((uint32_t)p[STRIDE] << 16);
    const uint32_t b1 =
        (uint32_t)p[8 * STRIDE] | ((uint32_t)p[9 * STRIDE] << 16);
    mma16816(acc[j], a, b0, b1);
  }
}

// A fragments of a 16 x 16 slice [n0 .. n0 + 2) of an accumulator (the
// accumulator layout of two n-tiles is the A layout of one k-step).
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
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
// Tables (host-built, ops/flash.py): forward/dQ [n_q_blocks, 4] =
// (sink_b0, sink_b1, win_b0, win_b1); dK/dV [n_kv_blocks, 2] = (qb0, qb1),
// one table for every batch row.
// ---------------------------------------------------------------------------
struct SinkWindowMask {
  static constexpr bool kBatchTables = false;  // one table for every b
  const int* table;
  int N_q, N_kv, num_sink, window, q_offset, kv_offset;

  __device__ const int* q_block(int, int qb) const { return table + qb * 4; }
  __device__ const int* kv_block(int, int kb) const { return table + kb * 2; }
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
  // the visible set of visible() below.
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
  // Key slot jl is visible to the row at global position ig.
  __device__ bool visible(int ig, int jl) const {
    const int jg = kv_offset + jl;
    return jl < N_kv && jg >= 0 && jg <= ig &&
           (jg < num_sink || jg >= ig - window + 1);
  }
};

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

template <int D, class Mask>
__global__ void __launch_bounds__(NTHREADS)
    fwd_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
               const uint16_t* __restrict__ v,
               const float* __restrict__ s_aux, uint16_t* __restrict__ o,
               float* __restrict__ lse, int H_q, int H_kv, int N_q, int N_kv,
               float scale_log2, Mask mask) {
  constexpr int STRIDE = D + 8;  // padded smem row (elements): no conflicts
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  constexpr int KT = D / 16;     // k-steps of Q K^T
  constexpr int DT = D / 8;      // n-tiles of P V
  constexpr int NT = BN / 8;     // n-tiles of Q K^T

  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* Qs = smem;                 // [BM][STRIDE]
  uint16_t* Ks = Qs + BM * STRIDE;     // [2][BN][STRIDE]
  uint16_t* Vs = Ks + 2 * BN * STRIDE; // [2][BN][STRIDE]

  const int qb = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H_q;
  const int h = bh - b * H_q;
  const int kvh = b * H_kv + h / (H_q / H_kv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // row within the 8-row half of the warp tile
  const int t4 = lane & 3;   // column pair within an 8-wide n-tile

  const uint16_t* qg = q + (size_t)bh * N_q * D;
  const uint16_t* kg = k + (size_t)kvh * N_kv * D;
  const uint16_t* vg = v + (size_t)kvh * N_kv * D;

  const int* rg = mask.q_block(b, qb);
  const int sb0 = rg[0];
  const int sb1 = rg[1];
  const int wb0 = rg[2];
  const int wb1 = rg[3];
  const int n_sink_blocks = max(sb1 - sb0, 0);
  const int n_blocks = n_sink_blocks + max(wb1 - wb0, 0);

  for (int c = tid; c < BM * CHUNKS; c += NTHREADS) {
    const int r = c / CHUNKS, cc = c - (c / CHUNKS) * CHUNKS;
    const int row = qb * BM + r;
    const bool ok = row < N_q;
    cp_async16(Qs + r * STRIDE + cc * 8,
               qg + (size_t)(ok ? row : 0) * D + cc * 8, ok);
  }

  auto block_of = [&](int t) {
    return t < n_sink_blocks ? sb0 + t : wb0 + (t - n_sink_blocks);
  };
  auto load_kv = [&](int t, int buf) {
    const int blk = block_of(t);
    for (int c = tid; c < BN * CHUNKS; c += NTHREADS) {
      const int r = c / CHUNKS, cc = c - (c / CHUNKS) * CHUNKS;
      const int row = blk * BN + r;
      const bool ok = row < N_kv;
      const size_t off = (size_t)(ok ? row : 0) * D + cc * 8;
      cp_async16(Ks + (buf * BN + r) * STRIDE + cc * 8, kg + off, ok);
      cp_async16(Vs + (buf * BN + r) * STRIDE + cc * 8, vg + off, ok);
    }
  };
  if (n_blocks > 0) load_kv(0, 0);
  cp_async_commit();

  const bool use_aux = s_aux != nullptr;
  float m[2], l[2];
  m[0] = m[1] = use_aux ? s_aux[h] * LOG2E : -INFINITY;
  l[0] = l[1] = use_aux ? 1.f : 0.f;
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  const int r_loc = warp * 16 + g;  // this thread's first row (second: +8)
  const typename Mask::Row rows[2] = {mask.row(b, qb * BM + r_loc),
                                      mask.row(b, qb * BM + r_loc + 8)};
  uint32_t qf[KT][4];

  for (int t = 0; t < n_blocks; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_blocks) load_kv(t + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        const uint16_t* qr = Qs + r_loc * STRIDE + kk * 16 + t4 * 2;
        qf[kk][0] = ld32(qr);
        qf[kk][1] = ld32(qr + 8 * STRIDE);
        qf[kk][2] = ld32(qr + 8);
        qf[kk][3] = ld32(qr + 8 * STRIDE + 8);
      }
    }

    // S = Q K^T for this warp's 16 rows x 64 keys.
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

    // Scale into the exp2 domain and mask.
    const int col0 = block_of(t) * BN;
    const bool full = mask.q_tile_full(rg, qb, col0);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale_log2;
        if (!full) {
          const int jl = col0 + nt * 8 + t4 * 2 + (e & 1);
          x = mask.visible(rows[e >> 1], jl) ? x : -INFINITY;
        }
        s[nt][e] = x;
      }
    }

    // Online softmax, one row pair per thread (rows r_loc and r_loc + 8).
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
        const float p0 = exp2f(s[nt][2 * r] - m_use);
        const float p1 = exp2f(s[nt][2 * r + 1] - m_use);
        s[nt][2 * r] = p0;
        s[nt][2 * r + 1] = p1;
        rs += p0 + p1;
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

    // acc += P V. P's accumulator layout is the A-fragment layout.
    const uint16_t* vb = Vs + buf * BN * STRIDE;
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      uint32_t a[4];
      acc_to_a(a, s[2 * j], s[2 * j + 1]);
      mma_rows_b<STRIDE, DT>(acc, a, vb, j * 16, g, t4);
    }
    __syncthreads();  // this buffer is refilled two iterations on
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qb * BM + r_loc + r * 8;
    if (row >= N_q) continue;
    const float inv = l[r] == 0.f ? 0.f : 1.f / l[r];
    uint16_t* orow = o + ((size_t)bh * N_q + row) * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + t4 * 2) =
          pack_bf16(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
    }
    if (t4 == 0) {
      lse[(size_t)bh * N_q + row] =
          l[r] == 0.f ? -INFINITY : m[r] * LN2 + logf(l[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launcher: returns cudaGetLastError() of its launch (0 on success).
// q [B*H_q, N_q, D], k/v [B*H_kv, N_kv, D] bf16 contiguous; s_aux [H_q]
// fp32 or null; o like q, lse [B*H_q, N_q] fp32.
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D, class Mask>
int launch_fwd_d(const void* q, const void* k, const void* v,
                 const void* s_aux, void* o, void* lse, int B, int H_q,
                 int H_kv, int N_q, int N_kv, float scale, Mask mask,
                 cudaStream_t stream) {
  const size_t smem = (size_t)(BM + 4 * BN) * (D + 8) * sizeof(uint16_t);
  static const cudaError_t err = set_smem(fwd_kernel<D, Mask>, smem);  // once
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N_q + BM - 1) / BM, B * H_q);
  fwd_kernel<D, Mask><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<const float*>(s_aux),
      static_cast<uint16_t*>(o), static_cast<float*>(lse), H_q, H_kv, N_q,
      N_kv, scale * LOG2E, mask);
  return (int)cudaGetLastError();
}

template <class Mask>
int launch_fwd(const void* q, const void* k, const void* v,
               const void* s_aux, void* o, void* lse, int B, int H_q,
               int H_kv, int N_q, int N_kv, int D, float scale, Mask mask,
               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N_q <= 0 || B * H_q <= 0) return 0;
  if (D == 64)
    return launch_fwd_d<64>(q, k, v, s_aux, o, lse, B, H_q, H_kv, N_q, N_kv,
                            scale, mask, st);
  if (D == 128)
    return launch_fwd_d<128>(q, k, v, s_aux, o, lse, B, H_q, H_kv, N_q, N_kv,
                             scale, mask, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace sinkattn
