// Sink attention dQ for Hopper: a warp-specialised kernel on wgmma, TMA and
// mbarriers, written once over a mask policy (attention.cuh's
// SinkWindowMask in flash_bwd.cu, packed.cu's PackedMask).
//
// It computes, from the forward's LSE (which counts s_aux) and delta_i =
// sum_d dO_id O_id (less any LSE cotangent), for every query row i:
//     P = exp(scale * Q K^T - LSE) on visible cells, 0 elsewhere
//     dS = P (dO V^T - delta),   dQ_i = scale * sum_j dS_ij K_j
// over the keys of the row's KV head. One CTA owns each output tile: no
// atomics, so the result is bitwise repeatable.
//
// Design:
//  * a persistent grid, one CTA of three warpgroups per SM, walking the
//    work items (b*h_q, 128-row q block) longest first (by the host's order
//    table; the query heads of one KV group adjacent, so their K/V tiles
//    come from L2) in the snake of hopper.cuh's snake_item;
//  * warpgroup 0 produces (setmaxnreg gives its registers to the
//    consumers: 40 against 232): one thread issues every TMA load, the
//    item's Q and dO once into one of dq_qbufs(D) Q/dO buffers (two at D
//    = 64 and 128, so the next item's load overlaps this one's tail; one
//    at D = 256, where a 128 x 256 Q and dO take 128 KB), then the q
//    block's KV blocks from the host table (the sink range, then the
//    window range), dq_bn(D) keys a tile (128 at D = 64, 64 at D = 80, 96
//    and 128, 32 at D = 256), into a ring of STAGES (K, V) stages with
//    full and empty barriers;
//    warp 1 writes, beside the Q/dO buffer, the item's 128 LSE values
//    (times log2e; +inf past N_q), 128 delta values (0 past N_q), each
//    row's visible key runs from the policy (row_span; none past N_q) and
//    the hull of each consumer's 64 rows' runs, with plain loads, which
//    takes any N_q (a 2-D fp32 tensor map would need N_q * 4 % 16 == 0);
//    the buffer's full barrier counts the TMA bytes and warp 1's 32
//    arrivals;
//  * warpgroups 1 and 2 consume, 64 rows each: per KV tile S = Q K^T and
//    dP = dO V^T (wgmma m64nBNk16, both operands in 128-byte-swizzled
//    shared memory, one commit group), P = exp2(S * scale * log2e - LSE *
//    log2e) and dS = P (dP - delta) in registers, dS rounded to bf16 as the
//    register A operand of dQ += dS K (wgmma m64nDk16, K from shared memory
//    as the transposed B operand, as the forward reads V); dQ stays in fp32
//    registers across the item; for fp32 inputs (IoF32) dS enters as two
//    bf16 terms, two products a step (as hopper_bwd.cuh's P and dS);
//  * the mask: each warp decides per tile, by one vote over its rows'
//    runs, whether the tile is whole for its 16 rows; only a partial tile
//    takes the per-cell select (hopper.cuh's mask_tile, outside the
//    unrolled products); masked cells give p = 0 by a select of p, so a row
//    whose LSE is -inf gives 0 and not NaN, and halo slots before the
//    sequence start, keys past N_kv and rows past N_q contribute nothing;
//  * a consumer whose 64 rows see no key of a tile (outside the hull of
//    their runs) skips the tile's products, waiting and releasing the stage
//    only (at 64-key tiles a sliding-window item's first or last tile is
//    dead for one of its two consumers);
//  * the epilogue: dQ (scaled) goes out in the input type through the
//    consumer's own rows of the item's Q buffer (then free) as 16-byte
//    stores of whole rows, or as fp32 (IoF32) straight from the
//    accumulators; the Q/dO buffer is released to the producer after that;
//  * any head dim D <= 512 (D % 8 == 0) runs in the instance D_i =
//    attn_instance_d(D) (hopper.cuh): 80 for D 65-80, 96 for 81-96, else
//    the smallest of 64, 128, 256 and 512 that holds it. TMA reads the
//    columns past D as zeros, and only D columns are written; bf16 or
//    fp16 inputs (hopper.cuh's Io types).
//    The narrow instances of 80 and 96 keep the 128 instance's plan and
//    shared memory (64-key tiles, two Q/dO buffers and two K/V stages of
//    two 64-column boxes a row, box 1 zero-filled past D: 192 KB, so the
//    host tables key on 128) but compute on D_i columns: S = Q K^T and dP
//    = dO V^T take D_i / 16 = 5 or 6 k-steps, not 8, and dQ += dS K (and
//    for fp32 inputs its low term) is an m64n64k16 over box 0 beside an
//    m64n16k16 or m64n32k16 over the first columns of box 1 (hopper.cuh's
//    rs_mma): 6 D_i FLOPs a visible pair, not 6 x 128. A consumer holds dQ
//    in 40 or 48 fp32 registers a thread, not 64, beside S and dP's 32
//    each. On an H100 (scripts/kernel_compare.py) the Danube backward
//    (B=1, 32/8, N=8192, W=4096, bf16) took 0.88 -> 0.76 ms at D = 80
//    and 0.90 -> 0.83 at 96 against the 128 instance; fp32 -17% / -12%.
//    The registers freed would hold a 128-key tile: a variant build of
//    the narrow instances at 128 keys shows no spill and no serialised
//    wgmma in bf16, fp16 or fp32 (ptxas). Its shared memory does not
//    fit: a 128-key stage of two boxes is 32 KB a tensor, so two stages
//    beside two Q/dO buffers take 256 KB, past the 227 KB a block has,
//    and one of them would have to go; not tried.
//    At D = 256 a consumer holds dQ in 128 fp32 registers a thread, S and
//    dP of a 32-key tile in 16 each (m64n32) and dS in 8; dQ += dS K is
//    two m64n128k16 products a 16-key step (hopper.cuh's rs_mma). Shared
//    memory: Q and dO 2 x 64 KB, two stages of 32-key K and V 2 x 32 KB:
//    192 KB.
//    At D = 512 the consumers split dQ's columns, as the forward splits
//    O's (hopper.cuh's FwdPlan): an item is 64 query rows (a half of the
//    host's 128-row q block), both consumers compute the same S and dP of
//    the item's rows (depth 512) and the same P and dS, and consumer c
//    accumulates dQ's columns [256 c, 256 c + 256) (128 registers),
//    reading those columns of K. S and dP are computed twice: 10 D FLOPs
//    a pair against the 6 D the bound counts. Shared memory: Q and dO of
//    64 x 512 (2 x 64 KB) and one stage of 32-key K and V (2 x 32 KB):
//    192 KB, so a tile's loads wait for the previous tile's products.
//
// Replaces the Pallas TPU kernels `_dq_kernel` of
// sink_attention_tpu/ops/flash.py and `_pdq_kernel` of
// sink_attention_tpu/ops/packed.py. Bound on the H100: 6 D FLOPs per
// visible (query, key) pair and head (three products of depth D) at 989
// TFLOP/s, or the bytes 3 * |q| + 2 * |kv| + the fp32 rows (q, dO read, dq
// written, k and v read, lse and delta read) at 3.35 TB/s: the full layers
// are bound by operations, the W = 128 layers by bytes. What the design
// does about it: wgmma on TMA-fed shared memory at the tensor cores' rate,
// the mask's cost only on partial tiles, dead tiles skipped per consumer,
// Q and dO read once per item and K/V once per (item, tile), no second
// pass.

#pragma once

#include "hopper.cuh"

namespace sinkattn {
namespace hopper {

constexpr int DQ_BM = 128;  // query rows per q block, 64 per consumer
constexpr int DQ_THREADS = 384;

// Keys per KV tile of the instance of head dim D (64, 80, 96, 128, 256 or
// 512; the host keys its tables on instance_d, not the tensors' head dim):
// 128 at D = 64 (fewer, larger products: 17% faster on a full layer), 64
// at D = 128 and the narrow 80 and 96 (the S, dP and dQ accumulators of a
// 128-key tile would not fit beside the operands without spills), 32 at
// D = 256 (two stages of K and V beside one Q/dO buffer) and 512 (one
// stage).
__host__ __device__ constexpr int dq_bn(int D) {
  return D == 64 ? 128 : D <= 128 ? 64 : 32;
}
// Q/dO buffers of the instance of head dim D: two, one at D >= 256.
__host__ __device__ constexpr int dq_qbufs(int D) { return D >= 256 ? 1 : 2; }
// Query rows per work item: a 128-row q block, or at D = 512 one 64-row
// half of it (the consumers split dQ's columns; see the header).
__host__ __device__ constexpr int dq_bm(int D) {
  return D == 512 ? 64 : DQ_BM;
}
constexpr int DQ_PRODUCER_REGS = 40;
constexpr int DQ_CONSUMER_REGS = 232;

// An int known at compile time, usable in device code (the standard
// library's integral_constant converts on the host only).
template <int N>
struct Const {
  __host__ __device__ constexpr operator int() const { return N; }
};

// f(CH), CH = Dt / 8 16-byte chunks of a 16-bit dQ row: a compile-time
// constant at the instance's own width D, a runtime value for a narrower
// Dt. The two loops are the dQ kernel's: with the forward's single
// constant loop that skips the chunks past Dt, this kernel's D = 64
// instance measured 2-25% slower on the main path's shapes than with
// these two (scripts/kernel_compare.py); the forward is the other way
// round.
template <int D, class F>
__device__ __forceinline__ void with_row_chunks(int Dt, F&& f) {
  if (Dt == D)
    f(Const<D / 8>());
  else
    f(Dt / 8);
}

// Shared-memory layout of one CTA (byte offsets; every tile 1024-aligned).
template <int D, int STAGES>
struct DqSmem {
  static constexpr int QB = dq_qbufs(D);            // Q/dO buffers
  static constexpr int BOXES = smem_d(D) / 64;       // 64-column boxes a row
  static constexpr int QT_BYTES = dq_bm(D) * BOXES * 128;  // one Q or dO tile
  static constexpr int KV_BYTES = dq_bn(D) * BOXES * 128;  // one K or V tile
  static constexpr int Q_OFF = 0;                   // QB Q tiles
  static constexpr int DO_OFF = Q_OFF + QB * QT_BYTES;   // QB dO tiles
  static constexpr int K_OFF = DO_OFF + QB * QT_BYTES;   // STAGES K tiles
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  // per Q/dO buffer: lse2 [128] f32, delta [128] f32, RowSpan [128], the
  // two consumers' hulls int [2][2]
  static constexpr int ROWS_BYTES = DQ_BM * (4 + 4 + 16) + 16;
  static constexpr int ROW_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = ROW_OFF + QB * ROWS_BYTES;
  // q_full[QB], q_empty[QB], then full, empty [STAGES] each
  static constexpr int N_BARS = 2 * QB + 2 * STAGES;
  static constexpr int INFO_OFF = BAR_OFF + N_BARS * 8;  // int [QB][8]
  static constexpr int BYTES = INFO_OFF + QB * 8 * 4 + 1024;  // + alignment
};

// A work item: one 128-row q block of one (batch, query head) (at D = 512
// each 64-row half of it is an item), and the KV blocks it visits (the
// sink range, then the window range) from the policy's table. Unit u of
// the order table is a q block (its table shared by the batch) or, where
// the policy keeps a table per batch row, a (b, block) pair: b * n_qb +
// block.
struct DqItem {
  int b, qb, bh, kvh, sb0, wb0, n_sink_blocks, n_blocks;
  int row0;  // the item's first query row (read back from shared memory)
  template <class Mask>
  __device__ __forceinline__ DqItem(int w, const int* order, int B, int H_q,
                                    int H_kv, int n_qb, const Mask& mask) {
    const int per = Mask::kBatchTables ? H_q : B * H_q;
    const int u = order[w / per], r = w - (w / per) * per;
    if (Mask::kBatchTables) {
      b = u / n_qb;
      qb = u - b * n_qb;
      bh = b * H_q + r;
    } else {
      qb = u;
      bh = r;
      b = r / H_q;
    }
    kvh = b * H_kv + (bh - b * H_q) / (H_q / H_kv);
    const int* rg = mask.q_block(b, qb);
    sb0 = rg[0];
    wb0 = rg[2];
    n_sink_blocks = max(rg[1] - sb0, 0);
    n_blocks = n_sink_blocks + max(rg[3] - wb0, 0);
    row0 = qb * DQ_BM;
  }
  __device__ __forceinline__ void store(int* info, int first_row) const {
    info[0] = qb;
    info[1] = bh;
    info[2] = sb0;
    info[3] = wb0;
    info[4] = n_sink_blocks;
    info[5] = n_blocks;
    info[6] = first_row;
  }
  __device__ __forceinline__ explicit DqItem(const int* info)
      : b(0), qb(info[0]), bh(info[1]), kvh(0), sb0(info[2]), wb0(info[3]),
        n_sink_blocks(info[4]), n_blocks(info[5]), row0(info[6]) {}
  __device__ __forceinline__ int block(int t) const {
    return t < n_sink_blocks ? sb0 + t : wb0 + (t - n_sink_blocks);
  }
};

// D is the instance's head dim, Dt <= D the tensors' (see
// fwd_wgmma_kernel); IO the element types. At D = 512 work item w is half
// w % 2 of the q block of unit w / 2.
template <int D, int STAGES, class Mask, class IO>
__global__ void __launch_bounds__(DQ_THREADS, 1)
    dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ order, void* __restrict__ dq,
                    int B, int H_q, int H_kv, int N_q, int Dt,
                    float scale_log2, float scale, Mask mask) {
  using L = DqSmem<D, STAGES>;
  constexpr int QB = L::QB;     // Q/dO buffers
  constexpr int BN = dq_bn(D);  // keys per KV tile
  constexpr int BM = dq_bm(D);  // query rows per item
  constexpr int HALVES = DQ_BM / BM;  // items per q block
  constexpr bool SPLIT = BM != DQ_BM;  // consumers split dQ's columns
  constexpr int DC = SPLIT ? D / 2 : D;  // a consumer's dQ columns
  constexpr int OR = DC / 2;    // dQ accumulators a thread
  constexpr int SR = BN / 2;    // S or dP accumulators a thread
  constexpr int NJ = BN / 8;    // 8-key chunks of an accumulator row
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + QB;
  uint64_t* full = bars + 2 * QB;
  uint64_t* empty = bars + 2 * QB + STAGES;
  int* info = reinterpret_cast<int*>(smem + L::INFO_OFF);  // [Q buffer][8]

  const int n_qb = (N_q + DQ_BM - 1) / DQ_BM;
  const int n_work = n_qb * B * H_q * HALVES;

  if (threadIdx.x == 0) {
    for (int i = 0; i < QB; ++i) {
      mbar_init(q_full + i, 1 + 32);     // the TMA thread and warp 1's lanes
      mbar_init(q_empty + i, 2 * 128);   // every consumer thread, per item
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        DQ_PRODUCER_REGS));
    const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
    if (warp == 0 && lane == 0) {
      // ---- one thread issues every TMA load ----
      Ring<STAGES> ring;
      for (int it = 0;; ++it) {
        const int w = snake_item(it, blockIdx.x, gridDim.x);
        if (w >= n_work) break;
        const DqItem item(w / HALVES, order, B, H_q, H_kv, n_qb, mask);
        const int row0 = item.row0 + (w % HALVES) * BM;
        const int qs = buf_of<QB>(it);
        mbar_wait(q_empty + qs, buf_phase<QB>(it) ^ 1);
        item.store(info + qs * 8, row0);
        mbar_expect_tx(q_full + qs, 2 * L::QT_BYTES);  // and the info
#pragma unroll
        for (int x = 0; x < L::BOXES; ++x) {
          tma_load_3d(smem + L::Q_OFF + qs * L::QT_BYTES + x * BM * 128,
                      &tm_q, q_full + qs, x * 64, row0, item.bh);
          tma_load_3d(smem + L::DO_OFF + qs * L::QT_BYTES + x * BM * 128,
                      &tm_do, q_full + qs, x * 64, row0, item.bh);
        }
        for (int j = 0; j < item.n_blocks; ++j, ring.next()) {
          const int s = ring.s;
          mbar_wait(empty + s, ring.ph ^ 1);
          const int row = item.block(j) * BN;
          mbar_expect_tx(full + s, 2 * L::KV_BYTES);
#pragma unroll
          for (int x = 0; x < L::BOXES; ++x) {
            tma_load_3d(smem + L::K_OFF + s * L::KV_BYTES + x * BN * 128,
                        &tm_k, full + s, x * 64, row, item.kvh);
            tma_load_3d(smem + L::V_OFF + s * L::KV_BYTES + x * BN * 128,
                        &tm_v, full + s, x * 64, row, item.kvh);
          }
        }
      }
    } else if (warp == 1) {
      // ---- warp 1: the item's LSE (log2 domain), delta and key runs ----
      for (int it = 0;; ++it) {
        const int w = snake_item(it, blockIdx.x, gridDim.x);
        if (w >= n_work) break;
        const DqItem item(w / HALVES, order, B, H_q, H_kv, n_qb, mask);
        // (at D = 512 the item's 64 rows and the 64 after them: hull 0 is
        // the item's)
        const int row0 = item.row0 + (w % HALVES) * BM;
        const int qs = buf_of<QB>(it);
        mbar_wait(q_empty + qs, buf_phase<QB>(it) ^ 1);
        uint8_t* rows = smem + L::ROW_OFF + qs * L::ROWS_BYTES;
        float* lse_sm = reinterpret_cast<float*>(rows);
        float* delta_sm = lse_sm + DQ_BM;
        RowSpan* span_sm = reinterpret_cast<RowSpan*>(rows + DQ_BM * 8);
        int* hull_sm = reinterpret_cast<int*>(rows + DQ_BM * 24);
        const float* lse_row = lse + (size_t)item.bh * N_q;
        const float* delta_row = delta + (size_t)item.bh * N_q;
#pragma unroll
        for (int h = 0; h < DQ_BM / 32; ++h) {
          const int r = h * 32 + lane;
          const int row = row0 + r;
          const bool ok = row < N_q;
          lse_sm[r] = ok ? lse_row[row] * LOG2E : INFINITY;
          delta_sm[r] = ok ? delta_row[row] : 0.f;
        }
        stage_row_spans(mask, item.b, row0, N_q, lane, span_sm, hull_sm);
        __syncwarp();
        mbar_arrive(q_full + qs);  // release: the rows are visible
      }
    }
  } else {
    // ---- consumers: warpgroup c owns rows [64 c, 64 c + 64) of an item,
    // or (SPLIT) dQ's columns [DC c, DC c + DC) of its 64 rows ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        DQ_CONSUMER_REGS));
    const int c = wg - 1;
    const int ct = threadIdx.x - 128 * wg;
    const int lane = ct & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int rw0 = SPLIT ? 0 : c * 64;  // the consumer's first row
    const int r_loc = rw0 + (ct >> 5) * 16 + g;  // rows r_loc, r_loc + 8
    const int hc = SPLIT ? 0 : c;  // the hull of the consumer's rows
    const int c0 = SPLIT ? c * DC : 0;  // its first dQ column
    Ring<STAGES> ring;
    for (int it = 0;; ++it) {
      const int w = snake_item(it, blockIdx.x, gridDim.x);
      if (w >= n_work) break;
      const int qs = buf_of<QB>(it);
      mbar_wait(q_full + qs, buf_phase<QB>(it));
      const DqItem item(info + qs * 8);
      const uint8_t* rows_sm = smem + L::ROW_OFF + qs * L::ROWS_BYTES;
      const float* lse_sm = reinterpret_cast<const float*>(rows_sm);
      const RowSpan* span_sm =
          reinterpret_cast<const RowSpan*>(rows_sm + DQ_BM * 8);
      const int* hull_sm = reinterpret_cast<const int*>(rows_sm + DQ_BM * 24);
      float l2[2], dl[2];
      RowSpan rows[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l2[r] = lse_sm[r_loc + 8 * r];
        dl[r] = lse_sm[DQ_BM + r_loc + 8 * r];
        rows[r] = span_sm[r_loc + 8 * r];
      }
      const int h_lo = hull_sm[2 * hc], h_hi = hull_sm[2 * hc + 1];

      float dq_acc[OR];
#pragma unroll
      for (int i = 0; i < OR; ++i) dq_acc[i] = 0.f;
      const uint8_t* qsm = smem + L::Q_OFF + qs * L::QT_BYTES + rw0 * 128;
      const uint8_t* dosm = smem + L::DO_OFF + qs * L::QT_BYTES + rw0 * 128;

      for (int j = 0; j < item.n_blocks; ++j, ring.next()) {
        const int s = ring.s;
        const int col0 = item.block(j) * BN;
        mbar_wait(full + s, ring.ph);
        if (col0 >= h_hi || col0 + BN <= h_lo) {  // no row sees the tile
          named_sync(1 + c, 128);  // every warp has seen the stage's phase
          if (ct == 0) mbar_arrive(empty + s);
          continue;
        }
        const uint8_t* ks = smem + L::K_OFF + s * L::KV_BYTES;
        const uint8_t* vs = smem + L::V_OFF + s * L::KV_BYTES;

        // S = Q K^T and dP = dO V^T: 64 rows x BN keys, D / 16
        // k-steps each, one commit group.
        float sacc[SR], dpacc[SR];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int x = kk / 4, off = (kk % 4) * 32;
          SsMma<SR, IO::kF16>::run(sacc,
                         desc_sw128(qsm + x * BM * 128 + off, 16, 1024),
                         desc_sw128(ks + x * BN * 128 + off, 16, 1024),
                         kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int x = kk / 4, off = (kk % 4) * 32;
          SsMma<SR, IO::kF16>::run(dpacc,
                         desc_sw128(dosm + x * BM * 128 + off, 16, 1024),
                         desc_sw128(vs + x * BN * 128 + off, 16, 1024),
                         kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sacc);
        fence_regs(dpacc);

        // P: accumulator i = jj * 4 + 2 r + e is row r_loc + 8 r, key
        // col0 + 8 jj + 2 t4 + e; the scale folded into the exponent's FMA.
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& x = sacc[jj * 4 + 2 * r + e];
              x = fast_exp2(fmaf(x, scale_log2, -l2[r]));
            }
          }
        }
        // The per-cell mask on partial tiles only (a warp-uniform branch):
        // p = 0 by a select where the key is outside both of the row's runs.
        const bool whole =
            __all_sync(0xffffffffu, span_covers(rows[0], col0, BN) &&
                                        span_covers(rows[1], col0, BN));
        if (!whole) {
          if (__any_sync(0xffffffffu, sink_meets(rows[0], col0, BN) ||
                                          sink_meets(rows[1], col0, BN)))
            mask_tile<true>(sacc, rows, col0 + t4 * 2, 0.f);
          else
            mask_tile<false>(sacc, rows, col0 + t4 * 2, 0.f);
        }
        // dS = P (dP - delta), as 16-bit A fragments; for IoF32 as two
        // bf16 terms (da + dr).
        constexpr int LO = IO::kOut32 ? BN / 16 : 1;
        uint32_t da[BN / 16][4], dr[LO][4];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = jj * 4 + 2 * r + e;
              dpacc[i] = sacc[i] * (dpacc[i] - dl[r]);
            }
          }
        }
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            if constexpr (IO::kOut32)
              da[kk][h] = pack_bf16_split(dpacc[8 * kk + 2 * h],
                                          dpacc[8 * kk + 2 * h + 1],
                                          dr[kk][h]);
            else
              da[kk][h] = pack2<IO::kF16>(dpacc[8 * kk + 2 * h],
                                          dpacc[8 * kk + 2 * h + 1]);
          }
        }

        // dQ += dS K: the keys are the depth, K (the consumer's columns,
        // from its first box) read as the transposed B operand (box stride
        // BN rows x 128 B).
        const uint8_t* kc = ks + (c0 / 64) * BN * 128;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          rs_mma<OR, IO::kF16>(dq_acc, da[kk], kc + kk * 16 * 128, BN * 128);
        if constexpr (IO::kOut32) {
#pragma unroll
          for (int kk = 0; kk < BN / 16; ++kk)
            rs_mma<OR, false>(dq_acc, dr[kk], kc + kk * 16 * 128, BN * 128);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq_acc);
        if (ct == 0) mbar_arrive(empty + s);  // the warpgroup is done
      }

      // dQ goes out through this warpgroup's rows (SPLIT: its column
      // boxes) of the item's Q buffer (its S products, the last readers,
      // are done; SPLIT: once both warpgroups' are), in Q's swizzled
      // layout, then as 16-byte stores of whole rows (Dt / 8 chunks a
      // row); as fp32 (IoF32), straight from the accumulators as 8-byte
      // stores of column pairs.
      uint8_t* qbuf = smem + L::Q_OFF + qs * L::QT_BYTES;
      if constexpr (SPLIT && !IO::kOut32)
        named_sync(3, 256);  // both consumers' products have read Q
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rb = r_loc + 8 * r;  // the row within the item
        const int row = item.row0 + rb;
        if constexpr (IO::kOut32) {
          float* drow =
              static_cast<float*>(dq) + ((size_t)item.bh * N_q + row) * Dt;
#pragma unroll
          for (int jj = 0; jj < DC / 8; ++jj) {
            const int col = c0 + jj * 8 + t4 * 2;
            if (row < N_q && col < Dt)
              *reinterpret_cast<float2*>(drow + col) =
                  make_float2(dq_acc[jj * 4 + 2 * r] * scale,
                              dq_acc[jj * 4 + 2 * r + 1] * scale);
          }
        } else {
#pragma unroll
          for (int jj = 0; jj < DC / 8; ++jj) {
            const int jg = c0 / 8 + jj;  // the row's 16-byte chunk
            *reinterpret_cast<uint32_t*>(
                qbuf + (jg / 8) * BM * 128 + rb * 128 +
                (((jg % 8) ^ (rb & 7)) * 16) + t4 * 4) =
                pack2<IO::kF16>(dq_acc[jj * 4 + 2 * r] * scale,
                                dq_acc[jj * 4 + 2 * r + 1] * scale);
          }
        }
      }
      if constexpr (!IO::kOut32) {
        named_sync(1 + c, 128);  // the warpgroup's rows are staged
        uint16_t* dq16 = static_cast<uint16_t*>(dq);
        if constexpr (SPLIT) {
          // the consumer's DC / 8 chunks a row, those past Dt not stored
          constexpr int CH = DC / 8;
          for (int i = ct; i < 64 * CH; i += 128) {
            const int rb = i / CH, ch = c0 / 8 + i % CH;
            const int row = item.row0 + rb;
            if (row < N_q && ch * 8 < Dt)
              *reinterpret_cast<uint4*>(
                  dq16 + ((size_t)item.bh * N_q + row) * Dt + ch * 8) =
                  *reinterpret_cast<const uint4*>(
                      qbuf + (ch / 8) * BM * 128 + rb * 128 +
                      (((ch % 8) ^ (rb & 7)) * 16));
          }
        } else {
          with_row_chunks<D>(Dt, [&](auto CH) {  // 16-byte chunks a row
            for (int i = ct; i < 64 * CH; i += 128) {
              const int rb = c * 64 + i / CH, ch = i % CH;
              const int row = item.row0 + rb;
              if (row < N_q)
                *reinterpret_cast<uint4*>(
                    dq16 + ((size_t)item.bh * N_q + row) * Dt + ch * 8) =
                    *reinterpret_cast<const uint4*>(
                        qbuf + (ch / 8) * DQ_BM * 128 + rb * 128 +
                        (((ch % 8) ^ (rb & 7)) * 16));
            }
          });
        }
      }
      // The Q/dO buffer (and its rows) is free once every consumer thread
      // is done with it; the proxy fence orders these generic accesses
      // before the TMA refill.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(q_empty + qs);
    }
  }
}

// Launch over a mask policy: q, dout [B*H_q, N_q, Dt], k/v [B*H_kv, N_kv,
// Dt] 16-bit (IO) contiguous, 16-byte aligned, Dt <= D, Dt % 8 == 0; lse,
// delta [B*H_q, N_q] fp32; order the host's units longest first (see
// DqItem); dq like q (fp32 for IoF32). Returns cudaGetLastError() of the
// launch.
template <int D, int STAGES, class Mask, class IO>
int launch_dq_d(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                const void* order, void* dq, int B, int H_q, int H_kv,
                int N_q, int N_kv, int Dt, float scale, const Mask& mask,
                cudaStream_t stream) {
  constexpr int smem = DqSmem<D, STAGES>::BYTES;
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      dq_wgmma_kernel<D, STAGES, Mask, IO>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);  // once
  if (attr_err != cudaSuccess) return (int)attr_err;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, q, B * H_q, N_q, Dt, dq_bm(D), IO::kF16) ||
      !make_map(&tdo, dout, B * H_q, N_q, Dt, dq_bm(D), IO::kF16) ||
      !make_map(&tk, k, B * H_kv, N_kv, Dt, dq_bn(D), IO::kF16) ||
      !make_map(&tv, v, B * H_kv, N_kv, Dt, dq_bn(D), IO::kF16))
    return (int)cudaErrorInvalidValue;
  const long n_work =
      (long)((N_q + DQ_BM - 1) / DQ_BM) * B * H_q * (DQ_BM / dq_bm(D));
  const int grid = (int)std::min<long>(n_work, sm_count());
  if (grid <= 0) return (int)cudaErrorInvalidValue;
  dq_wgmma_kernel<D, STAGES, Mask, IO><<<grid, DQ_THREADS, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(order), dq,
      B, H_q, H_kv, N_q, Dt, scale * LOG2E, scale, mask);
  return (int)cudaGetLastError();
}

// dQ over a mask policy at head dim D (attn_instance_d(D)) in the element
// types IO.
template <class Mask, class IO>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, const void* order, void* dq,
              int B, int H_q, int H_kv, int N_q, int N_kv, int D, float scale,
              const Mask& mask, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N_q <= 0 || B * H_q <= 0) return 0;
  if (H_kv <= 0 || H_q % H_kv != 0 || N_kv < 0 || instance_d(D) == 0)
    return (int)cudaErrorInvalidValue;
  if (N_kv == 0) {  // no key to read (and no tensor map of k)
    cudaMemsetAsync(dq, 0, (size_t)B * H_q * N_q * D * (IO::kOut32 ? 4 : 2),
                    st);
    return (int)cudaGetLastError();
  }
  const int di = attn_instance_d(D);
  if (di == 64)
    return launch_dq_d<64, 4, Mask, IO>(q, k, v, dout, lse, delta, order, dq,
                                        B, H_q, H_kv, N_q, N_kv, D, scale,
                                        mask, st);
  if (di == 80)
    return launch_dq_d<80, 2, Mask, IO>(q, k, v, dout, lse, delta, order, dq,
                                        B, H_q, H_kv, N_q, N_kv, D, scale,
                                        mask, st);
  if (di == 96)
    return launch_dq_d<96, 2, Mask, IO>(q, k, v, dout, lse, delta, order, dq,
                                        B, H_q, H_kv, N_q, N_kv, D, scale,
                                        mask, st);
  if (di == 128)
    return launch_dq_d<128, 2, Mask, IO>(q, k, v, dout, lse, delta, order,
                                         dq, B, H_q, H_kv, N_q, N_kv, D,
                                         scale, mask, st);
  if (di == 256)
    return launch_dq_d<256, 2, Mask, IO>(q, k, v, dout, lse, delta, order,
                                         dq, B, H_q, H_kv, N_q, N_kv, D,
                                         scale, mask, st);
  return launch_dq_d<512, 1, Mask, IO>(q, k, v, dout, lse, delta, order, dq,
                                       B, H_q, H_kv, N_q, N_kv, D, scale,
                                       mask, st);
}

// dQ in the element types of a dtype code (DtypeCode).
template <class Mask>
int launch_dq_dtype(int dtype, const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    const void* order, void* dq, int B, int H_q, int H_kv,
                    int N_q, int N_kv, int D, float scale, const Mask& mask,
                    void* stream) {
  switch (dtype) {
    case kDtypeBf16:
      return launch_dq<Mask, IoBf16>(q, k, v, dout, lse, delta, order, dq, B,
                                     H_q, H_kv, N_q, N_kv, D, scale, mask,
                                     stream);
    case kDtypeF16:
      return launch_dq<Mask, IoF16>(q, k, v, dout, lse, delta, order, dq, B,
                                    H_q, H_kv, N_q, N_kv, D, scale, mask,
                                    stream);
    case kDtypeF32:
      return launch_dq<Mask, IoF32>(q, k, v, dout, lse, delta, order, dq, B,
                                    H_q, H_kv, N_q, N_kv, D, scale, mask,
                                    stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace hopper
}  // namespace sinkattn
