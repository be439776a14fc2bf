// Sink attention forward for Hopper: a warp-specialised kernel on wgmma,
// TMA and mbarriers, over attention.cuh's SinkWindowMask.
//
// It computes what attention.cuh's fwd_kernel computes (O, the natural-log
// LSE counting s_aux, s_aux as a value-less logit) for the unpacked sink +
// window mask; the dQ, dK/dV, packed and ablation kernels stay on
// attention.cuh's mma.sync skeleton.
//
// Design:
//  * a persistent grid, one CTA of three warpgroups per SM, walking the
//    work items (b*h_q, 128-row q block), longest first: warpgroup 0 is
//    the producer (one thread issues every TMA load, the rest idle;
//    setmaxnreg gives its registers to the consumers: 40 against 232),
//    warpgroups 1 and 2 are consumers, 64 query rows each;
//  * the producer loads each item's Q once, into one of two Q buffers, and
//    walks the q block's two ranges of KV blocks from the host table (the
//    sink blocks, then the window blocks), 128 keys a tile, into a ring of
//    STAGES (K, V) stages, each with a full barrier for K, one for V (TMA
//    completes them by bytes) and an empty barrier each consumer
//    warpgroup arrives at once (after its wgmma wait, which is
//    warpgroup-wide); it hands each item's table row and the seed of m
//    to the consumers in shared memory beside the Q buffer (released with
//    Q's barrier); it runs ahead into the next item while the
//    consumers finish this one, so an item's prologue and epilogue overlap
//    its neighbours' loads (the short sliding-window items need that);
//  * Q, K and V land in shared memory in 128-byte-swizzled boxes of 64
//    columns (a D = 128 row is two boxes); TMA zero-fills rows past N_q
//    and N_kv;
//  * S = Q K^T is wgmma m64n128k16 with both operands in shared memory;
//    the online softmax runs on the accumulators in the exp2 domain (the
//    scale folded into the exponent's FMA, ex2.approx), seeded with
//    m = s_aux*log2e, l = 1 (exact for every input); P is rounded to bf16
//    in registers and is the A operand of O += P V (wgmma m64nDk16, V from
//    shared memory as a transposed B operand). The two consumer
//    warpgroups overlap each other's products and softmax. (Overlapping
//    the softmax with the previous tile's P V inside a warpgroup was
//    tried: ptxas then serialises the products, 25% slower at D = 128);
//  * the mask: each consumer decides once per tile whether its 64 x 128
//    tile lies wholly inside the mask and applies the per-cell mask only
//    on partial tiles (the diagonal, the window and sink edges, the N
//    edge, slots before the sequence start), from per-row key bounds
//    computed once per work item (one unsigned compare per run and cell);
//    masked cells give p = 0 by a select of the score (exp2 of -inf is 0),
//    so a row that sees nothing gives 0 and not NaN;
//  * O goes out as bf16 through the warpgroup's rows of the item's Q
//    buffer (then free) as 16-byte stores of whole rows; the Q buffer is
//    released to the producer after that. The LSE is written as
//    fwd_kernel writes it, for the backward kernels.

#pragma once

#include <cuda.h>

#include "attention.cuh"

namespace sinkattn {
namespace hopper {

constexpr int FWD_BM = 128;       // query rows per item, 64 per consumer
constexpr int FWD_BN = 128;       // keys per tile
constexpr int FWD_THREADS = 384;  // producer + two consumer warpgroups
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed. A wait
// that outlasts any tile by orders of magnitude traps (the launch fails)
// rather than hold the card forever.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 28)) __trap();
  }
}

// --- named barriers -----------------------------------------------------------

// Barrier `id` (0 is __syncthreads') over `count` threads.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// --- TMA ----------------------------------------------------------------------

// One box of the 3-D tensor map at coordinates (c0 innermost, c1, c2) into
// shared memory; completes `bar` by its bytes.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// --- wgmma ----------------------------------------------------------------------

// Shared-memory matrix descriptor of a 128-byte-swizzled operand (the
// layout TMA's CU_TENSOR_MAP_SWIZZLE_128B writes; atoms 1024-byte
// aligned): lbo / sbo in bytes.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3ffff) >> 4) | ((uint64_t)((lbo >> 4) & 0x3fff) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3fff) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses to accumulators across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128]: A and B from shared memory
// (descriptors), both K-major; fp32 accumulators d[64].
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] B[16 x 64]: A from registers (bf16x2
// fragments), B from shared memory, MN-major (transposed); d[32].
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D[64 x 128] += A[64 x 16] B[16 x 128]: A from registers (bf16x2
// fragments), B from shared memory, MN-major (transposed); d[64].
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int N>
struct RsMma;
template <>
struct RsMma<32> {
  __device__ __forceinline__ static void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    wgmma_rs_n64(d, a, db, 1);
  }
};
template <>
struct RsMma<64> {
  __device__ __forceinline__ static void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    wgmma_rs_n128(d, a, db, 1);
  }
};

// Shared-memory layout of one CTA (byte offsets; every tile 1024-aligned).
template <int D, int STAGES>
struct FwdSmem {
  static constexpr int BOXES = D / 64;                // 64-column boxes a row
  static constexpr int Q_BYTES = FWD_BM * D * 2;      // one Q tile
  static constexpr int KV_BYTES = FWD_BN * D * 2;     // one K or V tile
  static constexpr int Q_OFF = 0;                     // two Q tiles
  static constexpr int K_OFF = Q_OFF + 2 * Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // q_full[2], q_empty[2], then k_full, v_full, empty [STAGES] each
  static constexpr int N_BARS = 4 + 3 * STAGES;
  static constexpr int INFO_OFF = BAR_OFF + N_BARS * 8;  // int [2][8]
  static constexpr int BYTES = INFO_OFF + 2 * 8 * 4 + 1024;  // + alignment
};

// Every cell of rows [r0, r0 + 64) x keys [col0, col0 + FWD_BN) is visible.
__device__ __forceinline__ bool tile_full(const SinkWindowMask& mk, int r0,
                                          int col0) {
  const int r_lo = mk.q_offset + r0, r_hi = r_lo + 63;
  const int c_lo = mk.kv_offset + col0, c_hi = c_lo + FWD_BN - 1;
  return (col0 + FWD_BN <= mk.N_kv) && (c_lo >= 0) && (c_hi <= r_lo) &&
         (c_hi < mk.num_sink || c_lo >= r_hi - mk.window + 1);
}

// The visible keys of one query row at global position ig, in local key
// slots (computed once per row and work item): the window run [win_lo,
// win_lo + win_n) and the sink run [sink_lo, sink_lo + sink_n), both cut
// to jg <= ig and the N_kv end. Key jl is visible iff it is in either:
// SinkWindowMask::visible (0 <= jg <= ig, jl < N_kv, and jg < num_sink
// or jg >= ig - window + 1, with jg = kv_offset + jl).
struct RowSpan {
  int win_lo, win_n, sink_lo, sink_n;
  __device__ __forceinline__ RowSpan(const SinkWindowMask& mk, int ig) {
    const int end = min(ig - mk.kv_offset, mk.N_kv - 1) + 1;  // exclusive
    win_lo = max(ig - mk.window + 1, 0) - mk.kv_offset;
    win_n = max(end - win_lo, 0);
    sink_lo = -mk.kv_offset;
    sink_n = max(min(mk.num_sink - mk.kv_offset, end) - sink_lo, 0);
  }
};

// The per-cell mask of a partial tile: the thread's keys jl0 + o (o = 8 jj
// + e, e in {0, 1}) of its two rows; a masked score becomes -inf by a
// select. Each run test is one unsigned compare; SINKS adds the sink run.
template <bool SINKS>
__device__ __forceinline__ void mask_tile(float (&sacc)[FWD_BN / 2],
                                          const RowSpan (&rows)[2], int jl0) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int wl = rows[r].win_lo - jl0, sl = rows[r].sink_lo - jl0;
    const unsigned wn = rows[r].win_n, sn = rows[r].sink_n;
#pragma unroll
    for (int jj = 0; jj < FWD_BN / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int o = jj * 8 + e;
        bool vis = (unsigned)(o - wl) < wn;
        if (SINKS) vis = vis || (unsigned)(o - sl) < sn;
        float& x = sacc[jj * 4 + 2 * r + e];
        x = vis ? x : -INFINITY;
      }
    }
  }
}

// 2^x on the special-function unit (ex2.approx.ftz: 2^-inf is 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A work item: one 128-row q block of one (batch, query head), and the KV
// blocks it visits (the sink range, then the window range). Items run
// longest first: the last q blocks, across all heads, then the earlier.
// The producer reads it from the host table and hands it to the consumers
// in shared memory beside the item's Q buffer (with the seed of m), so
// their item starts wait on no global load.
struct FwdItem {
  int qb, bh, h, kvh, sb0, wb0, n_sink_blocks, n_blocks;
  __device__ __forceinline__ FwdItem(int w, int n_qb, int BH, int H_q,
                                     int H_kv, const SinkWindowMask& mask) {
    qb = n_qb - 1 - w / BH;
    bh = w - (w / BH) * BH;
    const int b = bh / H_q;
    h = bh - b * H_q;
    kvh = b * H_kv + h / (H_q / H_kv);
    const int* rg = mask.q_block(b, qb);
    sb0 = rg[0];
    wb0 = rg[2];
    n_sink_blocks = max(rg[1] - sb0, 0);
    n_blocks = n_sink_blocks + max(rg[3] - wb0, 0);
  }
  __device__ __forceinline__ void store(int* info, float m0) const {
    info[0] = qb;
    info[1] = bh;
    info[2] = sb0;
    info[3] = wb0;
    info[4] = n_sink_blocks;
    info[5] = n_blocks;
    info[6] = __float_as_int(m0);
  }
  __device__ __forceinline__ explicit FwdItem(const int* info)
      : qb(info[0]), bh(info[1]), h(0), kvh(0), sb0(info[2]), wb0(info[3]),
        n_sink_blocks(info[4]), n_blocks(info[5]) {}
  __device__ __forceinline__ int block(int t) const {
    return t < n_sink_blocks ? sb0 + t : wb0 + (t - n_sink_blocks);
  }
};

// Persistent: each CTA walks the work items blockIdx.x, + gridDim.x, ...;
// the producer runs ahead into the next item (its Q into the other Q
// buffer, its K/V tiles into the ring) while the consumers finish this
// one, so one item's epilogue overlaps the next one's loads.
template <int D, int STAGES>
__global__ void __launch_bounds__(FWD_THREADS, 1)
    fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const float* __restrict__ s_aux,
                     uint16_t* __restrict__ o, float* __restrict__ lse,
                     int B, int H_q, int H_kv, int N_q, float scale_log2,
                     SinkWindowMask mask) {
  using L = FwdSmem<D, STAGES>;
  constexpr int NJ = FWD_BN / 8;  // 8-key chunks of an S accumulator row
  constexpr int OR = D / 2;       // O accumulators a thread
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + 2;
  uint64_t* k_full = bars + 4;
  uint64_t* v_full = bars + 4 + STAGES;
  uint64_t* empty = bars + 4 + 2 * STAGES;
  int* info = reinterpret_cast<int*>(smem + L::INFO_OFF);  // [Q buffer][8]

  const int BH = B * H_q;
  const int n_qb = (N_q + FWD_BM - 1) / FWD_BM;
  const int n_work = n_qb * BH;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full + i, 1);
      mbar_init(q_empty + i, 2 * 128);  // every consumer thread, per item
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ---- producer: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      int t = 0;  // the ring's tile count, across items
      int it = 0;
      for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++it) {
        const FwdItem item(w, n_qb, BH, H_q, H_kv, mask);
        const int qs = it & 1;
        mbar_wait(q_empty + qs, ((it >> 1) & 1) ^ 1);
        item.store(info + qs * 8,
                   s_aux != nullptr ? s_aux[item.h] * LOG2E : -INFINITY);
        mbar_expect_tx(q_full + qs, L::Q_BYTES);  // releases the info too
#pragma unroll
        for (int x = 0; x < L::BOXES; ++x)
          tma_load_3d(smem + L::Q_OFF + qs * L::Q_BYTES + x * FWD_BM * 128,
                      &tm_q, q_full + qs, x * 64, item.qb * FWD_BM, item.bh);
        for (int j = 0; j < item.n_blocks; ++j, ++t) {
          const int s = t % STAGES;
          mbar_wait(empty + s, ((t / STAGES) & 1) ^ 1);
          const int row = item.block(j) * FWD_BN;
          mbar_expect_tx(k_full + s, L::KV_BYTES);
#pragma unroll
          for (int x = 0; x < L::BOXES; ++x)
            tma_load_3d(smem + L::K_OFF + s * L::KV_BYTES + x * FWD_BN * 128,
                        &tm_k, k_full + s, x * 64, row, item.kvh);
          mbar_expect_tx(v_full + s, L::KV_BYTES);
#pragma unroll
          for (int x = 0; x < L::BOXES; ++x)
            tma_load_3d(smem + L::V_OFF + s * L::KV_BYTES + x * FWD_BN * 128,
                        &tm_v, v_full + s, x * 64, row, item.kvh);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup c owns rows [64 c, 64 c + 64) of a block ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int c = wg - 1;
    const int ct = threadIdx.x - 128 * wg;
    const int lane = ct & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int r_loc = c * 64 + (ct >> 5) * 16 + g;  // rows r_loc, r_loc + 8
    int t = 0;
    int it = 0;
    const bool use_aux = s_aux != nullptr;
    for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++it) {
      const int qs = it & 1;
      mbar_wait(q_full + qs, (it >> 1) & 1);
      const FwdItem item(info + qs * 8);
      const RowSpan rows[2] = {
          RowSpan(mask, mask.q_offset + item.qb * FWD_BM + r_loc),
          RowSpan(mask, mask.q_offset + item.qb * FWD_BM + r_loc + 8)};
      float m[2], l[2];
      m[0] = m[1] = __int_as_float(info[qs * 8 + 6]);
      l[0] = l[1] = use_aux ? 1.f : 0.f;
      float oacc[OR], sacc[FWD_BN / 2];
#pragma unroll
      for (int i = 0; i < OR; ++i) oacc[i] = 0.f;

      const uint8_t* qsm = smem + L::Q_OFF + qs * L::Q_BYTES + c * 64 * 128;
      for (int j = 0; j < item.n_blocks; ++j, ++t) {
        const int s = t % STAGES;
        const int ph = (t / STAGES) & 1;
        const uint8_t* ks = smem + L::K_OFF + s * L::KV_BYTES;
        const uint8_t* vs = smem + L::V_OFF + s * L::KV_BYTES;

        // S = Q K^T: 64 rows x 128 keys, D / 16 k-steps.
        mbar_wait(k_full + s, ph);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int x = kk / 4, off = (kk % 4) * 32;
          wgmma_ss_n128(sacc,
                        desc_sw128(qsm + x * FWD_BM * 128 + off, 16, 1024),
                        desc_sw128(ks + x * FWD_BN * 128 + off, 16, 1024),
                        kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sacc);

        // The per-cell mask on partial tiles only: a masked score becomes
        // -inf by a select (exp2 of -inf is 0). A whole tile skips it.
        const int col0 = item.block(j) * FWD_BN;
        if (!tile_full(mask, item.qb * FWD_BM + c * 64, col0)) {
          if (mask.kv_offset + col0 < mask.num_sink)  // a sink tile
            mask_tile<true>(sacc, rows, col0 + t4 * 2);
          else
            mask_tile<false>(sacc, rows, col0 + t4 * 2);
        }

        // Online softmax in the exp2 domain, rows r_loc (e < 2) and
        // r_loc + 8 (e >= 2): m is kept scaled, the scale folded into the
        // exponent's FMA (scale > 0, so the max of raw scores serves).
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = -INFINITY;
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj)
            mx = fmaxf(mx,
                       fmaxf(sacc[jj * 4 + 2 * r], sacc[jj * 4 + 2 * r + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[r], mx * scale_log2);
          const float m_use = m_new == -INFINITY ? 0.f : m_new;
          const float alpha = fast_exp2(m[r] - m_use);  // m = -inf: 0
          m[r] = m_new;
          float rs = 0.f;
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float p = fast_exp2(
                  fmaf(sacc[jj * 4 + 2 * r + e], scale_log2, -m_use));
              sacc[jj * 4 + 2 * r + e] = p;
              rs += p;
            }
          }
          rs += __shfl_xor_sync(0xffffffffu, rs, 1);
          rs += __shfl_xor_sync(0xffffffffu, rs, 2);
          l[r] = l[r] * alpha + rs;
#pragma unroll
          for (int jj = 0; jj < D / 8; ++jj) {
            oacc[jj * 4 + 2 * r] *= alpha;
            oacc[jj * 4 + 2 * r + 1] *= alpha;
          }
        }

        // O += P V: P's accumulator layout is the register A layout.
        uint32_t pa[FWD_BN / 16][4];
#pragma unroll
        for (int jj = 0; jj < FWD_BN / 16; ++jj) {
          pa[jj][0] = pack_bf16(sacc[8 * jj + 0], sacc[8 * jj + 1]);
          pa[jj][1] = pack_bf16(sacc[8 * jj + 2], sacc[8 * jj + 3]);
          pa[jj][2] = pack_bf16(sacc[8 * jj + 4], sacc[8 * jj + 5]);
          pa[jj][3] = pack_bf16(sacc[8 * jj + 6], sacc[8 * jj + 7]);
        }
        mbar_wait(v_full + s, ph);
        wgmma_fence();
#pragma unroll
        for (int jj = 0; jj < FWD_BN / 16; ++jj)
          RsMma<OR>::run(oacc, pa[jj],
                         desc_sw128(vs + jj * 16 * 128, FWD_BN * 128, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(oacc);
        if (ct == 0) mbar_arrive(empty + s);  // the warpgroup is done
      }

      // O goes out through this warpgroup's rows of the item's Q buffer
      // (its S products, the last readers, are done), in Q's swizzled
      // layout, then as 16-byte stores of whole rows.
      uint8_t* qbuf = smem + L::Q_OFF + qs * L::Q_BYTES;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rb = r_loc + r * 8;  // the row within the q block
        const float inv = l[r] == 0.f ? 0.f : 1.f / l[r];
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj)
          *reinterpret_cast<uint32_t*>(
              qbuf + (jj / 8) * FWD_BM * 128 + rb * 128 +
              (((jj % 8) ^ (rb & 7)) * 16) + t4 * 4) =
              pack_bf16(oacc[jj * 4 + 2 * r] * inv,
                        oacc[jj * 4 + 2 * r + 1] * inv);
        const int row = item.qb * FWD_BM + rb;
        if (t4 == 0 && row < N_q)
          lse[(size_t)item.bh * N_q + row] =
              l[r] == 0.f ? -INFINITY : m[r] * LN2 + logf(l[r]);
      }
      named_sync(1 + c, 128);  // the warpgroup's rows are staged
      constexpr int CH = D / 8;  // 16-byte chunks a row
      for (int i = ct; i < 64 * CH; i += 128) {
        const int rb = c * 64 + i / CH, ch = i % CH;
        const int row = item.qb * FWD_BM + rb;
        if (row < N_q)
          *reinterpret_cast<uint4*>(o + ((size_t)item.bh * N_q + row) * D +
                                    ch * 8) =
              *reinterpret_cast<const uint4*>(
                  qbuf + (ch / 8) * FWD_BM * 128 + rb * 128 +
                  (((ch % 8) ^ (rb & 7)) * 16));
      }
      // Q's buffer is free once every consumer thread is done with it; the
      // proxy fence orders these generic accesses before the TMA refill.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(q_empty + qs);
    }
  }
}

}  // namespace hopper
}  // namespace sinkattn
