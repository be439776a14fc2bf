// Sink + sliding-window causal attention backward for Hopper: two kernels.
//
// Replace the Pallas TPU kernels `_dq_kernel` and `_dkdv_kernel` of
// sink_attention_tpu/ops/flash.py (launched by `_bwd_impl`). With the
// forward's mask valid(i, j) (see flash_fwd.cu), its LSE (which counts the
// s_aux logit, so P below is the true probability and s_aux needs no term
// here) and delta_i = sum_d dO_id O_id (less the LSE cotangent, if any),
// computed on the host:
//     P  = exp(scale * Q K^T - LSE)  on valid cells, 0 elsewhere
//     dP = dO V^T,   dS = P * (dP - delta)
//     dQ = scale * dS K                      (sink_dq_bf16)
//     dV = P^T dO,   dK = scale * dS^T Q     (sink_dkdv_bf16)
// dK and dV are summed over the query heads of each GQA group. The ds_aux
// term and delta are plain torch on the host.
//
// What bounds them on the H100: per valid (q, k) pair and head, the dQ
// kernel does 3 products of depth D (S, dP, dQ) and the dK/dV kernel 4
// (S, dP, dV, dK), against 2 in the forward. At the training shapes
// (D = 64, GQA 64/8, N = 4096) the full layers are bound by tensor-core
// throughput and the W = 128 layers by memory (each kernel reads q, k, v
// and dO once). These simple mma.sync kernels reach neither bound: wgmma,
// TMA and a fused single pass are the tools of a later, faster version.
//
// Design (right first, simple):
//  * dQ: one CTA of 4 warps per (b*h_q, 64-row q block), each warp 16
//    rows; it walks the same two KV-block ranges as the forward (the host
//    table [n_q_blocks, 4]), K/V tiles double-buffered with cp.async, and
//    keeps dQ in fp32 registers, written once.
//  * dK/dV: one CTA of 4 warps per (b*h_kv, 64-slot KV block), each warp
//    16 keys; it loops over the GQA group and over the q blocks of one
//    range per KV block (host table [n_kv_blocks, 2], decided per block, so
//    negative and chunked offsets are right), Q/dO/LSE/delta tiles
//    double-buffered, and keeps dK and dV in fp32 registers, written once.
//    No atomics: the GQA sum is in the loop, the result is deterministic.
//  * S^T = K Q^T is computed directly (the warp's keys are the MMA rows),
//    so P^T and dS^T come out in the accumulator layout that is the
//    A-operand layout of P^T dO and dS^T Q, and never leave registers.
//  * bf16 mma.sync.m16n8k16 with fp32 accumulation; P and dS are rounded
//    to bf16 as MMA operands, as in the forward.
//  * Masked cells give p = 0 by a select, never by arithmetic on the
//    exponent, so rows whose LSE is -inf (no visible key and no s_aux)
//    give 0 and not NaN. Query rows past N_q get LSE = +inf (p = 0) and
//    delta = 0, and zero-filled Q/dO, so they add nothing to dK/dV.
//  * tiles fully inside the mask skip the per-element mask.
// GQA: query head h reads KV head h / (H_q / H_kv). D must be 64 or 128.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;  // query rows per tile
constexpr int BN = 64;  // keys per tile
constexpr int NTHREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;

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

// A fragment (16x16) of rows [row0, row0 + 16) and columns [col0, col0 + 16)
// of a row-major bf16 tile in shared memory.
template <int STRIDE>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const uint16_t* t,
                                       int row0, int col0, int g, int t4) {
  const uint16_t* p = t + (row0 + g) * STRIDE + col0 + t4 * 2;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * STRIDE);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * STRIDE + 8);
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

__device__ __forceinline__ bool visible(int ig, int jg, int num_sink,
                                        int window) {
  return jg >= 0 && jg <= ig && (jg < num_sink || jg >= ig - window + 1);
}

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(NTHREADS)
    sink_dq_kernel(const uint16_t* __restrict__ q,
                   const uint16_t* __restrict__ k,
                   const uint16_t* __restrict__ v,
                   const uint16_t* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   const int* __restrict__ ranges, uint16_t* __restrict__ dq,
                   int H_q, int H_kv, int N_q, int N_kv, int num_sink,
                   int window, int q_offset, int kv_offset, float scale_log2,
                   float scale) {
  constexpr int STRIDE = D + 8;  // padded smem row (elements): no conflicts
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  constexpr int KT = D / 16;     // k-steps over the head dim
  constexpr int DT = D / 8;      // n-tiles of dS K
  constexpr int NT = BN / 8;     // n-tiles of Q K^T and dO V^T

  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* Qs = smem;                  // [BM][STRIDE]
  uint16_t* dOs = Qs + BM * STRIDE;     // [BM][STRIDE]
  uint16_t* Ks = dOs + BM * STRIDE;     // [2][BN][STRIDE]
  uint16_t* Vs = Ks + 2 * BN * STRIDE;  // [2][BN][STRIDE]

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

  const uint16_t* qg = q + (size_t)bh * N_q * D;
  const uint16_t* dog = dout + (size_t)bh * N_q * D;
  const uint16_t* kg = k + (size_t)kvh * N_kv * D;
  const uint16_t* vg = v + (size_t)kvh * N_kv * D;

  const int sb0 = ranges[qb * 4 + 0];
  const int sb1 = ranges[qb * 4 + 1];
  const int wb0 = ranges[qb * 4 + 2];
  const int wb1 = ranges[qb * 4 + 3];
  const int n_sink_blocks = max(sb1 - sb0, 0);
  const int n_blocks = n_sink_blocks + max(wb1 - wb0, 0);

  for (int c = tid; c < BM * CHUNKS; c += NTHREADS) {
    const int r = c / CHUNKS, cc = c - (c / CHUNKS) * CHUNKS;
    const int row = qb * BM + r;
    const bool ok = row < N_q;
    const size_t off = (size_t)(ok ? row : 0) * D + cc * 8;
    cp_async16(Qs + r * STRIDE + cc * 8, qg + off, ok);
    cp_async16(dOs + r * STRIDE + cc * 8, dog + off, ok);
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

  const int r_loc = warp * 16 + g;                // this thread's first row
  const int row_g0 = q_offset + qb * BM + r_loc;  // global row (second: +8)
  const int blk_row_lo = q_offset + qb * BM;
  const int blk_row_hi = blk_row_lo + BM - 1;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qb * BM + r_loc + r * 8;
    const bool ok = row < N_q;
    lse2[r] = ok ? lse[(size_t)bh * N_q + row] * LOG2E : INFINITY;
    dl[r] = ok ? delta[(size_t)bh * N_q + row] : 0.f;
  }

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  for (int t = 0; t < n_blocks; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_blocks) load_kv(t + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const uint16_t* kb = Ks + buf * BN * STRIDE;
    const uint16_t* vb = Vs + buf * BN * STRIDE;
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    // S = Q K^T and dP = dO V^T for this warp's 16 rows x 64 keys.
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t aq[4], ado[4];
      load_a<STRIDE>(aq, Qs, warp * 16, kk * 16, g, t4);
      load_a<STRIDE>(ado, dOs, warp * 16, kk * 16, g, t4);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int off = (nt * 8 + g) * STRIDE + kk * 16 + t4 * 2;
        mma16816(s[nt], aq, ld32(kb + off), ld32(kb + off + 8));
        mma16816(dp[nt], ado, ld32(vb + off), ld32(vb + off + 8));
      }
    }

    // dS = P * (dP - delta), with P recomputed from the LSE.
    const int col0 = block_of(t) * BN;
    const int cg_lo = kv_offset + col0;
    const int cg_hi = cg_lo + BN - 1;
    const bool full = (col0 + BN <= N_kv) && (cg_lo >= 0) &&
                      (cg_hi <= blk_row_lo) &&
                      (cg_hi < num_sink || cg_lo >= blk_row_hi - window + 1);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = exp2f(s[nt][e] * scale_log2 - lse2[r]);
        if (!full) {
          const int jl = col0 + nt * 8 + t4 * 2 + (e & 1);
          const bool ok = jl < N_kv &&
                          visible(row_g0 + r * 8, kv_offset + jl, num_sink,
                                  window);
          p = ok ? p : 0.f;
        }
        s[nt][e] = p * (dp[nt][e] - dl[r]);
      }
    }

    // dQ += dS K (K read down its rows: the keys are the depth).
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      uint32_t a[4];
      acc_to_a(a, s[2 * j], s[2 * j + 1]);
      mma_rows_b<STRIDE, DT>(acc, a, kb, j * 16, g, t4);
    }
    __syncthreads();  // this buffer is refilled two iterations on
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qb * BM + r_loc + r * 8;
    if (row >= N_q) continue;
    uint16_t* orow = dq + ((size_t)bh * N_q + row) * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + t4 * 2) =
          pack_bf16(acc[dt][2 * r] * scale, acc[dt][2 * r + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// dK / dV
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(NTHREADS)
    sink_dkdv_kernel(const uint16_t* __restrict__ q,
                     const uint16_t* __restrict__ k,
                     const uint16_t* __restrict__ v,
                     const uint16_t* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ qranges,
                     uint16_t* __restrict__ dk, uint16_t* __restrict__ dv,
                     int H_q, int H_kv, int N_q, int N_kv, int num_sink,
                     int window, int q_offset, int kv_offset,
                     float scale_log2, float scale) {
  constexpr int STRIDE = D + 8;
  constexpr int CHUNKS = D / 8;
  constexpr int KT = D / 16;  // k-steps over the head dim
  constexpr int DT = D / 8;   // n-tiles of dV and dK
  constexpr int QS = 32;      // query columns per sub-tile (register bound)
  constexpr int NT = QS / 8;  // n-tiles of K Q^T and V dO^T per sub-tile

  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* Ks = smem;                   // [BN][STRIDE]
  uint16_t* Vs = Ks + BN * STRIDE;       // [BN][STRIDE]
  uint16_t* Qs = Vs + BN * STRIDE;       // [2][BM][STRIDE]
  uint16_t* dOs = Qs + 2 * BM * STRIDE;  // [2][BM][STRIDE]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * BM * STRIDE);  // [2][BM]
  float* Dl = Ls + 2 * BM;                                       // [2][BM]

  const int kb = blockIdx.x;
  const int bkh = blockIdx.y;  // b * H_kv + kv head
  const int b = bkh / H_kv;
  const int group = H_q / H_kv;
  const int head0 = b * H_q + (bkh - b * H_kv) * group;  // first q head
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  const uint16_t* kg = k + (size_t)bkh * N_kv * D;
  const uint16_t* vg = v + (size_t)bkh * N_kv * D;

  for (int c = tid; c < BN * CHUNKS; c += NTHREADS) {
    const int r = c / CHUNKS, cc = c - (c / CHUNKS) * CHUNKS;
    const int row = kb * BN + r;
    const bool ok = row < N_kv;
    const size_t off = (size_t)(ok ? row : 0) * D + cc * 8;
    cp_async16(Ks + r * STRIDE + cc * 8, kg + off, ok);
    cp_async16(Vs + r * STRIDE + cc * 8, vg + off, ok);
  }
  cp_async_commit();

  const int qb0 = qranges[kb * 2 + 0];
  const int n_qb = max(qranges[kb * 2 + 1] - qb0, 0);
  const int n_tiles = group * n_qb;  // (head in group, q block), q fastest

  auto load_q = [&](int t, int buf) {
    const int bh = head0 + t / n_qb;
    const int qb = qb0 + t % n_qb;
    const uint16_t* qg = q + (size_t)bh * N_q * D;
    const uint16_t* dog = dout + (size_t)bh * N_q * D;
    for (int c = tid; c < BM * CHUNKS; c += NTHREADS) {
      const int r = c / CHUNKS, cc = c - (c / CHUNKS) * CHUNKS;
      const int row = qb * BM + r;
      const bool ok = row < N_q;
      const size_t off = (size_t)(ok ? row : 0) * D + cc * 8;
      cp_async16(Qs + (buf * BM + r) * STRIDE + cc * 8, qg + off, ok);
      cp_async16(dOs + (buf * BM + r) * STRIDE + cc * 8, dog + off, ok);
    }
    if (tid < BM) {
      const int row = qb * BM + tid;
      const bool ok = row < N_q;
      Ls[buf * BM + tid] =
          ok ? lse[(size_t)bh * N_q + row] * LOG2E : INFINITY;
      Dl[buf * BM + tid] = ok ? delta[(size_t)bh * N_q + row] : 0.f;
    }
  };
  if (n_tiles > 0) load_q(0, 0);
  cp_async_commit();

  float acc_dk[DT][4], acc_dv[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[dt][e] = acc_dv[dt][e] = 0.f;

  const int key0 = warp * 16 + g;            // this thread's first key row
  const int col_g0 = kv_offset + kb * BN + key0;  // its global column
  const int cg_lo = kv_offset + kb * BN;
  const int cg_hi = cg_lo + BN - 1;
  const bool keys_in = (kb * BN + BN <= N_kv) && cg_lo >= 0;

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) load_q(t + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int qb = qb0 + t % n_qb;
    const int rg_lo = q_offset + qb * BM;
    const int rg_hi = rg_lo + BM - 1;
    const bool full = keys_in && (qb * BM + BM <= N_q) &&
                      (cg_hi <= rg_lo) &&
                      (cg_hi < num_sink || cg_lo >= rg_hi - window + 1);
    const uint16_t* qs = Qs + buf * BM * STRIDE;
    const uint16_t* dos = dOs + buf * BM * STRIDE;
    const float* ls = Ls + buf * BM;
    const float* dls = Dl + buf * BM;

#pragma unroll
    for (int half = 0; half < BM / QS; ++half) {
      const int q0 = half * QS;
      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x 32 queries.
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t ak[4], av[4];
        load_a<STRIDE>(ak, Ks, warp * 16, kk * 16, g, t4);
        load_a<STRIDE>(av, Vs, warp * 16, kk * 16, g, t4);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int off = (q0 + nt * 8 + g) * STRIDE + kk * 16 + t4 * 2;
          mma16816(s[nt], ak, ld32(qs + off), ld32(qs + off + 8));
          mma16816(dp[nt], av, ld32(dos + off), ld32(dos + off + 8));
        }
      }

      // P^T into s, dS^T into dp.
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = q0 + nt * 8 + t4 * 2 + (e & 1);  // query in tile
          float p = exp2f(s[nt][e] * scale_log2 - ls[ql]);
          if (!full) {
            const int r = e >> 1;
            const bool ok = qb * BM + ql < N_q &&
                            kb * BN + key0 + r * 8 < N_kv &&
                            visible(rg_lo + ql, col_g0 + r * 8, num_sink,
                                    window);
            p = ok ? p : 0.f;
          }
          s[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - dls[ql]);
        }
      }

      // dV += P^T dO and dK += dS^T Q (dO, Q read down their rows).
#pragma unroll
      for (int j = 0; j < QS / 16; ++j) {
        uint32_t a[4];
        acc_to_a(a, s[2 * j], s[2 * j + 1]);
        mma_rows_b<STRIDE, DT>(acc_dv, a, dos, q0 + j * 16, g, t4);
        acc_to_a(a, dp[2 * j], dp[2 * j + 1]);
        mma_rows_b<STRIDE, DT>(acc_dk, a, qs, q0 + j * 16, g, t4);
      }
    }
    __syncthreads();  // this buffer is refilled two iterations on
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = kb * BN + key0 + r * 8;
    if (row >= N_kv) continue;
    uint16_t* krow = dk + ((size_t)bkh * N_kv + row) * D;
    uint16_t* vrow = dv + ((size_t)bkh * N_kv + row) * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      *reinterpret_cast<uint32_t*>(krow + dt * 8 + t4 * 2) = pack_bf16(
          acc_dk[dt][2 * r] * scale, acc_dk[dt][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(vrow + dt * 8 + t4 * 2) =
          pack_bf16(acc_dv[dt][2 * r], acc_dv[dt][2 * r + 1]);
    }
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, const void* ranges,
              void* dq, int B, int H_q, int H_kv, int N_q, int N_kv,
              int num_sink, int window, int q_offset, int kv_offset,
              float scale, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * BM + 4 * BN) * (D + 8) * sizeof(uint16_t);
  cudaError_t err = set_smem(sink_dq_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N_q + BM - 1) / BM, B * H_q);
  sink_dq_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<const uint16_t*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(ranges), static_cast<uint16_t*>(dq), H_q, H_kv,
      N_q, N_kv, num_sink, window, q_offset, kv_offset, scale * LOG2E,
      scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkdv(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                const void* qranges, void* dk, void* dv, int B, int H_q,
                int H_kv, int N_q, int N_kv, int num_sink, int window,
                int q_offset, int kv_offset, float scale,
                cudaStream_t stream) {
  const size_t smem = (size_t)(2 * BN + 4 * BM) * (D + 8) * sizeof(uint16_t) +
                      4 * BM * sizeof(float);
  cudaError_t err = set_smem(sink_dkdv_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N_kv + BN - 1) / BN, B * H_kv);
  sink_dkdv_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<const uint16_t*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(qranges), static_cast<uint16_t*>(dk),
      static_cast<uint16_t*>(dv), H_q, H_kv, N_q, N_kv, num_sink, window,
      q_offset, kv_offset, scale * LOG2E, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, dout [B*H_q, N_q, D], k/v [B*H_kv, N_kv, D] bf16 contiguous; lse, delta
// [B*H_q, N_q] fp32; ranges [ceil(N_q/64), 4] int32 (the forward's table);
// dq like q.
extern "C" int sink_dq_bf16(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, const void* ranges, void* dq,
                            int B, int H_q, int H_kv, int N_q, int N_kv, int D,
                            int num_sink, int window, int q_offset,
                            int kv_offset, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N_q <= 0 || B * H_q <= 0) return 0;
  if (D == 64)
    return launch_dq<64>(q, k, v, dout, lse, delta, ranges, dq, B, H_q, H_kv,
                         N_q, N_kv, num_sink, window, q_offset, kv_offset,
                         scale, st);
  if (D == 128)
    return launch_dq<128>(q, k, v, dout, lse, delta, ranges, dq, B, H_q, H_kv,
                          N_q, N_kv, num_sink, window, q_offset, kv_offset,
                          scale, st);
  return (int)cudaErrorInvalidValue;
}

// As sink_dq_bf16; qranges [ceil(N_kv/64), 2] int32 (q-block range per KV
// block); dk, dv like k.
extern "C" int sink_dkdv_bf16(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, const void* qranges,
                              void* dk, void* dv, int B, int H_q, int H_kv,
                              int N_q, int N_kv, int D, int num_sink,
                              int window, int q_offset, int kv_offset,
                              float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N_kv <= 0 || B * H_kv <= 0) return 0;
  if (D == 64)
    return launch_dkdv<64>(q, k, v, dout, lse, delta, qranges, dk, dv, B, H_q,
                           H_kv, N_q, N_kv, num_sink, window, q_offset,
                           kv_offset, scale, st);
  if (D == 128)
    return launch_dkdv<128>(q, k, v, dout, lse, delta, qranges, dk, dv, B,
                            H_q, H_kv, N_q, N_kv, num_sink, window, q_offset,
                            kv_offset, scale, st);
  return (int)cudaErrorInvalidValue;
}

// Tile sizes the host-side range tables must use.
extern "C" int sink_bwd_block_m() { return BM; }
extern "C" int sink_bwd_block_n() { return BN; }
