// Sink attention at any head dim past 512 for Hopper: one wide instance of
// the forward, dQ and dK/dV kernels (each over a mask policy, as the
// instances of hopper.cuh, hopper_dq.cuh and hopper_bwd.cuh), whose depth
// and output columns are counted at run time.
//
// Where the instances of D <= 512 run out: a consumer warpgroup holds at
// most 256 columns of a 64-row fp32 accumulator (128 registers a thread),
// and a 64 x D tile of Q (128 D bytes) does not stay in the 227 KB of
// shared memory beside a K/V stage past D = 512 (at D = 2048 Q alone takes
// 256 KB). So the wide instance
//  * gives the grid a column-slice dimension: a work item owns 512 of the
//    output's columns (O, dQ, or dK and dV), 256 a consumer; the slices of
//    one row are items of their own, side by side in the walk so that they
//    share their K/V (Q/dO) tiles in L2;
//  * streams the depth: the products over the head dim (S = Q K^T, dP = dO
//    V^T, and their transposes in dK/dV) take their operands one 64-column
//    box at a time through a ring of depth stages (the Q box and the K box
//    of a box index, and the dO and V boxes where dP is needed), the
//    accumulators summed over the boxes, one commit group a box, a stage
//    released once its group is waited for (one group stays in flight);
//    the operand of the output product (V, K, dO or Q), cut to the item's
//    512 columns, arrives through a ring of slice stages;
//  * recomputes S (and dP) in every slice and in both consumers, over the
//    whole depth: the same products in the same order on the same tiles,
//    so the softmax (and P, dS) is bit for bit the same in every slice of a
//    row; exactly one slice (slice 0, consumer 0) writes the forward's LSE;
//  * writes its outputs straight from the registers (4-byte stores of
//    16-bit column pairs, 8-byte stores of fp32 pairs), as the 512 dK/dV
//    does: no Q or K/V buffer is left to stage them through.
// TMA reads the columns past the tensors' head dim Dt as zeros (so a last
// partial box, or a slice past Dt, adds nothing) and only Dt columns are
// written. Dt % 8 == 0 (the host pads any other D). Tiles: 64-row items and
// 64-key K/V tiles in the forward (S of 32 registers, O of 128), 64-row
// items and 32-key tiles in dQ (S and dP 16 each beside dQ's 128), 64-key
// items and 32-row q tiles in dK/dV, walked twice (dV, then dK, in the same
// 128 registers, as DkdvPlan<512>); fp32 inputs carry P and dS as two bf16
// terms in the backward (attention.cuh's pack_bf16_split).
//
// FLOPs against the bound: per visible pair and head the forward does 4 D
// for S (both consumers) and 2 x 256 for its slice's O, times D / 512
// slices: about 4 D^2 / 512 + 2 D, i.e. 10 D at D = 1024 against the 4 D
// the bound counts; dQ 8 D^2 / 512 + 2 D (S, dP twice a slice), dK/dV 12
// D^2 / 512 + 4 D (S twice, dP once, both consumers). Q (and dO) are read
// again for every K/V tile, from L2. A simple kernel that is right: the
// levers (S and dP shared across slices, the depth split across the two
// consumers, a resident Q where it fits) are parked in ROADMAP.md.
//
// Replaces, for D > 512, the Pallas TPU kernels `_fwd_kernel`, `_dq_kernel`
// and `_dkdv_kernel` of sink_attention_tpu/ops/flash.py and `_pfwd_kernel`,
// `_pdq_kernel` and `_pdkdv_kernel` of sink_attention_tpu/ops/packed.py,
// which pad any D to 128 lanes.

#pragma once

#include "hopper_bwd.cuh"
#include "hopper_dq.cuh"

namespace sinkattn {
namespace hopper {

constexpr int WIDE_MIN_D = 513;   // the smallest head dim of the instance
constexpr int WIDE_COLS = 512;    // output columns of a work item (a slice)
constexpr int WIDE_BM = 64;       // query rows of a forward or dQ item
constexpr int WIDE_FWD_BN = 64;   // keys per forward K/V tile
constexpr int WIDE_DQ_BN = 32;    // keys per dQ K/V tile
constexpr int WIDE_DKDV_BN = 64;  // keys per dK/dV item
constexpr int WIDE_TM = 32;       // query rows per dK/dV q tile
constexpr int WIDE_DS = 4;        // depth stages
constexpr int WIDE_SS = 2;        // slice stages
constexpr int WIDE_OR = WIDE_COLS / 4;  // a consumer's accumulators a thread
constexpr int WIDE_INFO = 16;     // ints of an item's info

// 64-column boxes of a row of Dt columns, and the item's column slices.
__host__ __device__ __forceinline__ int wide_boxes(int Dt) {
  return (Dt + 63) / 64;
}
__host__ __device__ __forceinline__ int wide_slices(int Dt) {
  return (Dt + WIDE_COLS - 1) / WIDE_COLS;
}

// Shared memory of a wide kernel (byte offsets; every tile 1024-aligned):
// WIDE_DS depth stages of DEPTH bytes, WIDE_SS slice stages of SLICE bytes
// (each with ROWS bytes of fp32 rows), two item buffers of ITEM bytes (the
// rows' runs, LSE and delta), the barriers and two items' info.
template <int DEPTH, int SLICE, int ROWS, int ITEM>
struct WideSmem {
  static constexpr int D_OFF = 0;
  static constexpr int S_OFF = D_OFF + WIDE_DS * DEPTH;
  static constexpr int R_OFF = S_OFF + WIDE_SS * SLICE;   // slice rows
  static constexpr int I_OFF = R_OFF + WIDE_SS * ROWS;    // item buffers
  static constexpr int BAR_OFF = (I_OFF + 2 * ITEM + 7) / 8 * 8;
  // item_full[2], item_empty[2], d_full, d_empty [WIDE_DS], s_full,
  // s_empty [WIDE_SS]
  static constexpr int N_BARS = 4 + 2 * WIDE_DS + 2 * WIDE_SS;
  static constexpr int INFO_OFF = BAR_OFF + N_BARS * 8;  // int [2][16]
  static constexpr int SPAN_OFF = INFO_OFF + 2 * WIDE_INFO * 4;  // int [2][8]
  // int [4] (dK/dV): a consumer's merge flag each, the number of items
  static constexpr int FLAG_OFF = SPAN_OFF + 2 * 8 * 4;
  static constexpr int BYTES = FLAG_OFF + 4 * 4 + 1024;  // + alignment
};

// The barriers of a wide kernel, at L::BAR_OFF.
struct WideBars {
  uint64_t *item_full, *item_empty, *d_full, *d_empty, *s_full, *s_empty;
  __device__ __forceinline__ explicit WideBars(uint8_t* p) {
    uint64_t* b = reinterpret_cast<uint64_t*>(p);
    item_full = b;
    item_empty = b + 2;
    d_full = b + 4;
    d_empty = b + 4 + WIDE_DS;
    s_full = b + 4 + 2 * WIDE_DS;
    s_empty = b + 4 + 2 * WIDE_DS + WIDE_SS;
  }
  // item_full takes the producer thread's arrival and, where `item_rows`,
  // warp 1's 32; a slice stage's full barrier the producer's and, where
  // `slice_rows`, warp 1's too.
  __device__ __forceinline__ void init(bool item_rows, bool slice_rows) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(item_full + i, item_rows ? 1 + 32 : 1);
      mbar_init(item_empty + i, 2 * 128);  // every consumer thread
    }
    for (int s = 0; s < WIDE_DS; ++s) {
      mbar_init(d_full + s, 1);
      mbar_init(d_empty + s, 2);  // one arrival per consumer warpgroup
    }
    for (int s = 0; s < WIDE_SS; ++s) {
      mbar_init(s_full + s, slice_rows ? 1 + 32 : 1);
      mbar_init(s_empty + s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
};

// mbar_wait with a bound in time: a wait longer than 10 s on the global
// timer (read once every 4096 polls) traps, so a hang fails its launch. A
// count of polls alone bounds no time, as try_wait may suspend the thread
// between polls for as long as it likes. (The instances of D <= 512 keep
// mbar_wait: the timer's check in their wait loops moved their small
// shapes' device time by up to 9%, kernel_compare.py on one H100.)
__device__ __forceinline__ void mbar_wait_timed(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  uint64_t t0 = 0;
  for (uint32_t polls = 1;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if ((polls & 4095) == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
      if (t0 == 0)
        t0 = now;
      else if (now - t0 > 10000000000ull)
        __trap();
    }
  }
}

// Consumer warpgroup c's walk of a dead tile: every depth stage of the
// tile and its slice stage waited for and released, no product. The
// warpgroup meets at a named barrier before each release: with no product
// to hold its warps together, thread 0 could otherwise release a stage
// (and the producer refill it) while another warp still waits on it; that
// warp would then see the stage's parity come round again and wait for a
// phase that never completes (a dead tile is nb releases in a row, more
// than the ring's WIDE_DS stages).
__device__ __forceinline__ void wide_skip(const WideBars& bars,
                                          Ring<WIDE_DS>& dr,
                                          Ring<WIDE_SS>& sr, int nb, int c,
                                          int ct) {
  for (int x = 0; x < nb; ++x, dr.next()) {
    mbar_wait_timed(bars.d_full + dr.s, dr.ph);
    named_sync(1 + c, 128);  // every warp has seen the stage's phase
    if (ct == 0) mbar_arrive(bars.d_empty + dr.s);
  }
  mbar_wait_timed(bars.s_full + sr.s, sr.ph);
  named_sync(1 + c, 128);  // every warp has seen the stage's phase
  if (ct == 0) mbar_arrive(bars.s_empty + sr.s);
  sr.next();
}

// A consumer's accumulators of rows (or keys) row0 and row0 + 8, each times
// mul, straight from the registers into out (rows base + row of Dt
// elements) as fp32 pairs (IO::kOut32) or 16-bit pairs; rows at or past
// n_rows and columns at or past Dt are not written.
template <class IO, int NA>
__device__ __forceinline__ void wide_store(void* out, const float (&acc)[NA],
                                           const float (&mul)[2], size_t base,
                                           int row0, int n_rows, int Dt,
                                           int c0, int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n_rows) continue;
    const size_t o = (base + (size_t)row) * Dt;
#pragma unroll
    for (int jj = 0; jj < NA / 4; ++jj) {
      const int col = c0 + jj * 8 + t4 * 2;
      if (col >= Dt) continue;
      const float x0 = acc[jj * 4 + 2 * r] * mul[r];
      const float x1 = acc[jj * 4 + 2 * r + 1] * mul[r];
      if constexpr (IO::kOut32)
        *reinterpret_cast<float2*>(static_cast<float*>(out) + o + col) =
            make_float2(x0, x1);
      else
        *reinterpret_cast<uint32_t*>(static_cast<uint16_t*>(out) + o + col) =
            pack2<IO::kF16>(x0, x1);
    }
  }
}

// ---------------------------------------------------------------------------
// The forward
// ---------------------------------------------------------------------------

// depth stage: a 64-row Q box and a 64-key K box; slice stage: V of 64
// keys x 512 columns; item buffer: RowSpan [128] and two hulls.
using WideFwdSmem = WideSmem<2 * 64 * 128, WIDE_FWD_BN * WIDE_COLS * 2, 0,
                             FWD_BM * 16 + 16>;

// Work item w: slice w % NS of half (w / NS) % 2 of the q block of unit
// w / (2 NS) (FwdItem's units); the consumers' tile step is FwdSoftmax.
template <class Mask, class IO>
__global__ void __launch_bounds__(FWD_THREADS, 1)
    wide_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const float* __restrict__ s_aux,
                          const int* __restrict__ order,
                          void* __restrict__ o, float* __restrict__ lse,
                          int B, int H_q, int H_kv, int N_q, int Dt,
                          float scale_log2, Mask mask) {
  using L = WideFwdSmem;
  constexpr int BN = WIDE_FWD_BN;
  constexpr int QBOX = 64 * 128, KBOX = BN * 128;
  constexpr int ITEM = FWD_BM * 16 + 16;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  WideBars bars(smem + L::BAR_OFF);
  int* info = reinterpret_cast<int*>(smem + L::INFO_OFF);

  const int nb = wide_boxes(Dt), ns = wide_slices(Dt);
  const int per = 2 * ns;  // items per (q block, head) unit
  const int n_qb = (N_q + FWD_BM - 1) / FWD_BM;
  const int n_work = n_qb * B * H_q * per;

  if (threadIdx.x == 0) bars.init(true, false);
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
    if (warp == 0 && lane == 0) {
      // ---- one thread issues every TMA load ----
      Ring<WIDE_DS> dr;
      Ring<WIDE_SS> sr;
      int it = 0;
      for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++it) {
        const int u = w / per, sub = w - u * per;
        const int half = sub / ns, sl = sub - half * ns;
        const FwdItem item(u, order, n_qb, B, H_q, H_kv, mask);
        const int row0 = item.row0 + half * WIDE_BM;
        const int qs = it & 1;
        mbar_wait_timed(bars.item_empty + qs, ((it >> 1) & 1) ^ 1);
        item.store(info + qs * WIDE_INFO,
                   s_aux != nullptr ? s_aux[item.h] * LOG2E : -INFINITY,
                   row0);
        info[qs * WIDE_INFO + 8] = sl;
        mbar_arrive(bars.item_full + qs);  // release: the info is visible
        for (int j = 0; j < item.n_blocks; ++j) {
          const int row = item.block(j) * BN;
          for (int x = 0; x < nb; ++x, dr.next()) {
            uint8_t* st = smem + L::D_OFF + dr.s * (QBOX + KBOX);
            mbar_wait_timed(bars.d_empty + dr.s, dr.ph ^ 1);
            mbar_expect_tx(bars.d_full + dr.s, QBOX + KBOX);
            tma_load_3d(st, &tm_q, bars.d_full + dr.s, x * 64, row0, item.bh);
            tma_load_3d(st + QBOX, &tm_k, bars.d_full + dr.s, x * 64, row,
                        item.kvh);
          }
          uint8_t* vs = smem + L::S_OFF + sr.s * (WIDE_COLS / 64) * KBOX;
          mbar_wait_timed(bars.s_empty + sr.s, sr.ph ^ 1);
          mbar_expect_tx(bars.s_full + sr.s, (WIDE_COLS / 64) * KBOX);
#pragma unroll
          for (int x = 0; x < WIDE_COLS / 64; ++x)
            tma_load_3d(vs + x * KBOX, &tm_v, bars.s_full + sr.s,
                        sl * WIDE_COLS + x * 64, row, item.kvh);
          sr.next();
        }
      }
    } else if (warp == 1) {
      // ---- warp 1: the item's rows' runs of visible keys ----
      int it = 0;
      for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++it) {
        const int u = w / per, half = (w - u * per) / ns;
        const FwdItem item(u, order, n_qb, B, H_q, H_kv, mask);
        const int qs = it & 1;
        mbar_wait_timed(bars.item_empty + qs, ((it >> 1) & 1) ^ 1);
        RowSpan* span_sm =
            reinterpret_cast<RowSpan*>(smem + L::I_OFF + qs * ITEM);
        // the item's 64 rows and the 64 after them: hull 0 is the item's
        stage_row_spans(mask, item.b, item.row0 + half * WIDE_BM, N_q, lane,
                        span_sm, reinterpret_cast<int*>(span_sm + FWD_BM));
        __syncwarp();
        mbar_arrive(bars.item_full + qs);
      }
    }
  } else {
    // ---- consumers: warpgroup c owns the item's columns [256 c, 256 c +
    // 256) of its slice, over the item's 64 rows ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int c = wg - 1;
    const int ct = threadIdx.x - 128 * wg;
    const int lane = ct & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int r_loc = (ct >> 5) * 16 + g;  // rows r_loc, r_loc + 8
    const FwdSoftmax<IO::kF16> softmax{};
    Ring<WIDE_DS> dr;
    Ring<WIDE_SS> sr;
    int it = 0;
    const bool use_aux = s_aux != nullptr;
    for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++it) {
      const int qs = it & 1;
      mbar_wait_timed(bars.item_full + qs, (it >> 1) & 1);
      const int* inf = info + qs * WIDE_INFO;
      const FwdItem item(inf);
      const int c0 = inf[8] * WIDE_COLS + c * (WIDE_COLS / 2);
      const RowSpan* span_sm =
          reinterpret_cast<const RowSpan*>(smem + L::I_OFF + qs * ITEM);
      const int* hull_sm = reinterpret_cast<const int*>(span_sm + FWD_BM);
      const RowSpan rows[2] = {span_sm[r_loc], span_sm[r_loc + 8]};
      const int h_lo = hull_sm[0], h_hi = hull_sm[1];
      float m[2], l[2];
      m[0] = m[1] = __int_as_float(inf[6]);
      l[0] = l[1] = use_aux ? 1.f : 0.f;
      float oacc[WIDE_OR], sacc[BN / 2];
#pragma unroll
      for (int i = 0; i < WIDE_OR; ++i) oacc[i] = 0.f;

      for (int j = 0; j < item.n_blocks; ++j) {
        const int col0 = item.block(j) * BN;
        if (col0 >= h_hi || col0 + BN <= h_lo) {  // no row sees it
          wide_skip(bars, dr, sr, nb, c, ct);
          continue;
        }
        // S = Q K^T over the depth, a box a commit group; a depth stage
        // is released once its group is done (one stays in flight).
        wgmma_fence();
        int prev = 0;
        for (int x = 0; x < nb; ++x, dr.next()) {
          const uint8_t* st = smem + L::D_OFF + dr.s * (QBOX + KBOX);
          mbar_wait_timed(bars.d_full + dr.s, dr.ph);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            SsMma<BN / 2, IO::kF16>::run(
                sacc, desc_sw128(st + kk * 32, 16, 1024),
                desc_sw128(st + QBOX + kk * 32, 16, 1024), (x | kk) != 0);
          wgmma_commit();
          if (x > 0) {
            wgmma_wait<1>();
            if (ct == 0) mbar_arrive(bars.d_empty + prev);
          }
          prev = dr.s;
        }
        wgmma_wait<0>();
        if (ct == 0) mbar_arrive(bars.d_empty + prev);
        fence_regs(sacc);

        uint32_t pa[BN / 16][4];
        typename FwdSoftmax<IO::kF16>::Tile tile;
        softmax.tile(mask, sacc, oacc, pa, m, l, rows, col0, item.row0,
                     r_loc, t4, scale_log2, nullptr, tile);
        // O += P V over the consumer's 256 columns of the slice.
        const uint8_t* vs = smem + L::S_OFF +
                            sr.s * (WIDE_COLS / 64) * KBOX + c * 4 * KBOX;
        mbar_wait_timed(bars.s_full + sr.s, sr.ph);
        wgmma_fence();
#pragma unroll
        for (int jj = 0; jj < BN / 16; ++jj)
          rs_mma<WIDE_OR, IO::kF16>(oacc, pa[jj], vs + jj * 16 * 128, KBOX);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(oacc);
        if (ct == 0) mbar_arrive(bars.s_empty + sr.s);
        sr.next();
      }

      const float inv[2] = {softmax.inv_l(l[0]), softmax.inv_l(l[1])};
      wide_store<IO>(o, oacc, inv, (size_t)item.bh * N_q, item.row0 + r_loc,
                     N_q, Dt, c0, t4);
      if (inf[8] == 0 && c == 0 && t4 == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = item.row0 + r_loc + 8 * r;
          if (row < N_q)
            lse[(size_t)item.bh * N_q + row] =
                l[r] == 0.f ? -INFINITY : m[r] * LN2 + logf(l[r]);
        }
      }
      mbar_arrive(bars.item_empty + qs);
    }
  }
}

// Launch over a mask policy: as launch_fwd_d (hopper.cuh), any Dt >= 8 with
// Dt % 8 == 0.
template <class Mask, class IO>
int launch_fwd_wide(const void* q, const void* k, const void* v,
                    const void* s_aux, const void* order, void* o, void* lse,
                    int B, int H_q, int H_kv, int N_q, int N_kv, int Dt,
                    float scale, const Mask& mask, cudaStream_t stream) {
  constexpr int smem = WideFwdSmem::BYTES;
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      wide_fwd_wgmma_kernel<Mask, IO>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);  // once
  if (attr_err != cudaSuccess) return (int)attr_err;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B * H_q, N_q, Dt, WIDE_BM, IO::kF16) ||
      !make_map(&tk, k, B * H_kv, N_kv, Dt, WIDE_FWD_BN, IO::kF16) ||
      !make_map(&tv, v, B * H_kv, N_kv, Dt, WIDE_FWD_BN, IO::kF16))
    return (int)cudaErrorInvalidValue;
  const long n_work = (long)((N_q + FWD_BM - 1) / FWD_BM) * B * H_q * 2 *
                      wide_slices(Dt);
  if (n_work > INT_MAX) return (int)cudaErrorInvalidValue;
  const int grid = (int)std::min<long>(n_work, sm_count());
  if (grid <= 0) return (int)cudaErrorInvalidValue;
  wide_fwd_wgmma_kernel<Mask, IO><<<grid, FWD_THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<const float*>(s_aux),
      static_cast<const int*>(order), o, static_cast<float*>(lse), B, H_q,
      H_kv, N_q, Dt, scale * LOG2E, mask);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

// depth stage: 64-row Q and dO boxes, 32-key K and V boxes; slice stage: K
// of 32 keys x 512 columns; item buffer: lse2, delta [128] f32, RowSpan
// [128] and two hulls (hopper_dq.cuh's DqSmem rows).
using WideDqSmem =
    WideSmem<2 * 64 * 128 + 2 * WIDE_DQ_BN * 128, WIDE_DQ_BN * WIDE_COLS * 2,
             0, DQ_BM * (4 + 4 + 16) + 16>;

// Work item w: slice w % NS of half (w / NS) % 2 of the q block of unit
// w / (2 NS) (DqItem's units), in the snake of snake_item.
template <class Mask, class IO>
__global__ void __launch_bounds__(DQ_THREADS, 1)
    wide_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ order, void* __restrict__ dq,
                         int B, int H_q, int H_kv, int N_q, int Dt,
                         float scale_log2, float scale, Mask mask) {
  using L = WideDqSmem;
  constexpr int BN = WIDE_DQ_BN;
  constexpr int QBOX = 64 * 128, KBOX = BN * 128;
  constexpr int DEPTH = 2 * QBOX + 2 * KBOX;
  constexpr int ITEM = DQ_BM * (4 + 4 + 16) + 16;
  constexpr int SR = BN / 2;  // S or dP accumulators a thread
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  WideBars bars(smem + L::BAR_OFF);
  int* info = reinterpret_cast<int*>(smem + L::INFO_OFF);

  const int nb = wide_boxes(Dt), ns = wide_slices(Dt);
  const int per = 2 * ns;
  const int n_qb = (N_q + DQ_BM - 1) / DQ_BM;
  const int n_work = n_qb * B * H_q * per;

  if (threadIdx.x == 0) bars.init(true, false);
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        DQ_PRODUCER_REGS));
    const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
    if (warp == 0 && lane == 0) {
      // ---- one thread issues every TMA load ----
      Ring<WIDE_DS> dr;
      Ring<WIDE_SS> sr;
      for (int it = 0;; ++it) {
        const int w = snake_item(it, blockIdx.x, gridDim.x);
        if (w >= n_work) break;
        const int u = w / per, sub = w - u * per;
        const int half = sub / ns, sl = sub - half * ns;
        const DqItem item(u, order, B, H_q, H_kv, n_qb, mask);
        const int row0 = item.row0 + half * WIDE_BM;
        const int qs = it & 1;
        mbar_wait_timed(bars.item_empty + qs, ((it >> 1) & 1) ^ 1);
        item.store(info + qs * WIDE_INFO, row0);
        info[qs * WIDE_INFO + 8] = sl;
        mbar_arrive(bars.item_full + qs);
        for (int j = 0; j < item.n_blocks; ++j) {
          const int row = item.block(j) * BN;
          for (int x = 0; x < nb; ++x, dr.next()) {
            uint8_t* st = smem + L::D_OFF + dr.s * DEPTH;
            uint64_t* full = bars.d_full + dr.s;
            mbar_wait_timed(bars.d_empty + dr.s, dr.ph ^ 1);
            mbar_expect_tx(full, DEPTH);
            tma_load_3d(st, &tm_q, full, x * 64, row0, item.bh);
            tma_load_3d(st + QBOX, &tm_do, full, x * 64, row0, item.bh);
            tma_load_3d(st + 2 * QBOX, &tm_k, full, x * 64, row, item.kvh);
            tma_load_3d(st + 2 * QBOX + KBOX, &tm_v, full, x * 64, row,
                        item.kvh);
          }
          uint8_t* ks = smem + L::S_OFF + sr.s * (WIDE_COLS / 64) * KBOX;
          mbar_wait_timed(bars.s_empty + sr.s, sr.ph ^ 1);
          mbar_expect_tx(bars.s_full + sr.s, (WIDE_COLS / 64) * KBOX);
#pragma unroll
          for (int x = 0; x < WIDE_COLS / 64; ++x)
            tma_load_3d(ks + x * KBOX, &tm_k, bars.s_full + sr.s,
                        sl * WIDE_COLS + x * 64, row, item.kvh);
          sr.next();
        }
      }
    } else if (warp == 1) {
      // ---- warp 1: the item's LSE (log2 domain), delta and key runs ----
      for (int it = 0;; ++it) {
        const int w = snake_item(it, blockIdx.x, gridDim.x);
        if (w >= n_work) break;
        const int u = w / per, half = (w - u * per) / ns;
        const DqItem item(u, order, B, H_q, H_kv, n_qb, mask);
        // the item's 64 rows and the 64 after them: hull 0 is the item's
        const int row0 = item.row0 + half * WIDE_BM;
        const int qs = it & 1;
        mbar_wait_timed(bars.item_empty + qs, ((it >> 1) & 1) ^ 1);
        uint8_t* rows = smem + L::I_OFF + qs * ITEM;
        float* lse_sm = reinterpret_cast<float*>(rows);
        float* delta_sm = lse_sm + DQ_BM;
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
        stage_row_spans(mask, item.b, row0, N_q, lane,
                        reinterpret_cast<RowSpan*>(rows + DQ_BM * 8),
                        reinterpret_cast<int*>(rows + DQ_BM * 24));
        __syncwarp();
        mbar_arrive(bars.item_full + qs);
      }
    }
  } else {
    // ---- consumers: warpgroup c owns dQ's columns [256 c, 256 c + 256)
    // of the item's slice, over its 64 rows ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        DQ_CONSUMER_REGS));
    const int c = wg - 1;
    const int ct = threadIdx.x - 128 * wg;
    const int lane = ct & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int r_loc = (ct >> 5) * 16 + g;  // rows r_loc, r_loc + 8
    Ring<WIDE_DS> dr;
    Ring<WIDE_SS> sr;
    for (int it = 0;; ++it) {
      const int w = snake_item(it, blockIdx.x, gridDim.x);
      if (w >= n_work) break;
      const int qs = it & 1;
      mbar_wait_timed(bars.item_full + qs, (it >> 1) & 1);
      const int* inf = info + qs * WIDE_INFO;
      const DqItem item(inf);
      const int c0 = inf[8] * WIDE_COLS + c * (WIDE_COLS / 2);
      const uint8_t* rows_sm = smem + L::I_OFF + qs * ITEM;
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
      const int h_lo = hull_sm[0], h_hi = hull_sm[1];
      float dq_acc[WIDE_OR];
#pragma unroll
      for (int i = 0; i < WIDE_OR; ++i) dq_acc[i] = 0.f;

      for (int j = 0; j < item.n_blocks; ++j) {
        const int col0 = item.block(j) * BN;
        if (col0 >= h_hi || col0 + BN <= h_lo) {  // no row sees the tile
          wide_skip(bars, dr, sr, nb, c, ct);
          continue;
        }
        // S = Q K^T and dP = dO V^T over the depth, a box a commit group.
        float sacc[SR], dpacc[SR];
        wgmma_fence();
        int prev = 0;
        for (int x = 0; x < nb; ++x, dr.next()) {
          const uint8_t* st = smem + L::D_OFF + dr.s * DEPTH;
          mbar_wait_timed(bars.d_full + dr.s, dr.ph);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            SsMma<SR, IO::kF16>::run(
                sacc, desc_sw128(st + kk * 32, 16, 1024),
                desc_sw128(st + 2 * QBOX + kk * 32, 16, 1024), (x | kk) != 0);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            SsMma<SR, IO::kF16>::run(
                dpacc, desc_sw128(st + QBOX + kk * 32, 16, 1024),
                desc_sw128(st + 2 * QBOX + KBOX + kk * 32, 16, 1024),
                (x | kk) != 0);
          wgmma_commit();
          if (x > 0) {
            wgmma_wait<1>();
            if (ct == 0) mbar_arrive(bars.d_empty + prev);
          }
          prev = dr.s;
        }
        wgmma_wait<0>();
        if (ct == 0) mbar_arrive(bars.d_empty + prev);
        fence_regs(sacc);
        fence_regs(dpacc);

        // P, its mask on partial tiles, dS = P (dP - delta): as
        // hopper_dq.cuh's consumers.
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int jj = 0; jj < BN / 8; ++jj) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& x = sacc[jj * 4 + 2 * r + e];
              x = fast_exp2(fmaf(x, scale_log2, -l2[r]));
            }
          }
        }
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
        constexpr int LO = IO::kOut32 ? BN / 16 : 1;
        uint32_t da[BN / 16][4], dr_[LO][4];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int jj = 0; jj < BN / 8; ++jj) {
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
                                          dr_[kk][h]);
            else
              da[kk][h] = pack2<IO::kF16>(dpacc[8 * kk + 2 * h],
                                          dpacc[8 * kk + 2 * h + 1]);
          }
        }

        // dQ += dS K over the consumer's 256 columns of the slice.
        const uint8_t* kc = smem + L::S_OFF +
                            sr.s * (WIDE_COLS / 64) * KBOX + c * 4 * KBOX;
        mbar_wait_timed(bars.s_full + sr.s, sr.ph);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          rs_mma<WIDE_OR, IO::kF16>(dq_acc, da[kk], kc + kk * 16 * 128, KBOX);
          if constexpr (IO::kOut32)
            rs_mma<WIDE_OR, false>(dq_acc, dr_[kk], kc + kk * 16 * 128, KBOX);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq_acc);
        if (ct == 0) mbar_arrive(bars.s_empty + sr.s);
        sr.next();
      }

      const float mul[2] = {scale, scale};
      wide_store<IO>(dq, dq_acc, mul, (size_t)item.bh * N_q,
                     item.row0 + r_loc, N_q, Dt, c0, t4);
      mbar_arrive(bars.item_empty + qs);
    }
  }
}

// Launch over a mask policy: as launch_dq_d (hopper_dq.cuh), any Dt >= 8
// with Dt % 8 == 0.
template <class Mask, class IO>
int launch_dq_wide(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   const void* order, void* dq, int B, int H_q, int H_kv,
                   int N_q, int N_kv, int Dt, float scale, const Mask& mask,
                   cudaStream_t stream) {
  constexpr int smem = WideDqSmem::BYTES;
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      wide_dq_wgmma_kernel<Mask, IO>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);  // once
  if (attr_err != cudaSuccess) return (int)attr_err;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, q, B * H_q, N_q, Dt, WIDE_BM, IO::kF16) ||
      !make_map(&tdo, dout, B * H_q, N_q, Dt, WIDE_BM, IO::kF16) ||
      !make_map(&tk, k, B * H_kv, N_kv, Dt, WIDE_DQ_BN, IO::kF16) ||
      !make_map(&tv, v, B * H_kv, N_kv, Dt, WIDE_DQ_BN, IO::kF16))
    return (int)cudaErrorInvalidValue;
  const long n_work =
      (long)((N_q + DQ_BM - 1) / DQ_BM) * B * H_q * 2 * wide_slices(Dt);
  if (n_work > INT_MAX) return (int)cudaErrorInvalidValue;
  const int grid = (int)std::min<long>(n_work, sm_count());
  if (grid <= 0) return (int)cudaErrorInvalidValue;
  wide_dq_wgmma_kernel<Mask, IO><<<grid, DQ_THREADS, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(order), dq,
      B, H_q, H_kv, N_q, Dt, scale * LOG2E, scale, mask);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dK/dV
// ---------------------------------------------------------------------------

// depth stage: 64-key K and V boxes, 32-row Q and dO boxes (V and dO in
// the dK pass only); slice stage: dO (dV pass) or Q (dK pass) of 32 rows x
// 512 columns, with the tile's LSE and delta rows.
using WideDkdvSmem =
    WideSmem<2 * WIDE_DKDV_BN * 128 + 2 * WIDE_TM * 128,
             WIDE_TM * WIDE_COLS * 2, 2 * WIDE_TM * 4, 0>;

// Work item w: slice w % NS of work unit w / NS (DkdvItem's: a piece of a
// key block of one batch x KV head). Each item's q tiles (by query head of
// the group, 64-row q block of its range and 32-row half of the block) are
// walked twice: dV, then dK, each pass's result merged over the block's
// pieces (merge_pieces) where the block is split.
template <class Mask, class IO>
__global__ void __launch_bounds__(DKDV_THREADS, 1)
    wide_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           const int* __restrict__ pieces,
                           float* __restrict__ part,
                           int* __restrict__ counters,
                           void* __restrict__ dk, void* __restrict__ dv,
                           int B, int H_q, int H_kv, int N_q, int N_kv,
                           int Dt, float scale_log2, float scale,
                           Mask mask) {
  using L = WideDkdvSmem;
  constexpr int SL = WIDE_INFO - 1;  // the info slot of the item's slice
  constexpr int BN = WIDE_DKDV_BN, TM = WIDE_TM;
  constexpr int SUB = DKDV_BM / TM;  // q tiles per q block
  constexpr int KBOX = BN * 128, QBOX = TM * 128;
  constexpr int DEPTH = 2 * KBOX + 2 * QBOX;
  constexpr int SLICE = (WIDE_COLS / 64) * QBOX;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  WideBars bars(smem + L::BAR_OFF);
  int* info = reinterpret_cast<int*>(smem + L::INFO_OFF);
  float* rows_sm = reinterpret_cast<float*>(smem + L::R_OFF);  // [SS][2][TM]

  const int nb = wide_boxes(Dt), ns = wide_slices(Dt);
  const int n_kb = (N_kv + BN - 1) / BN;
  const int group = H_q / H_kv;
  // merge flags and the number of work items, as the instances' kernel
  const auto flag = [&](int i) {
    return reinterpret_cast<int*>(smem + L::FLAG_OFF) + i;
  };
  const auto n_work = [&] { return *static_cast<volatile int*>(flag(2)); };

  if (threadIdx.x == 0) {
    *flag(2) = pieces[0] * dkdv_per<Mask>(B, H_kv) * ns;
    bars.init(false, true);
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
    if (warp == 0 && lane == 0) {
      // ---- one thread issues every TMA load ----
      Ring<WIDE_DS> dr;
      Ring<WIDE_SS> sr;
      for (int it = 0;; ++it) {
        const int w = snake_item(it, blockIdx.x, gridDim.x);
        if (w >= n_work()) break;
        const int u = w / ns, sl = w - u * ns;
        const DkdvItem item(u, pieces, B, H_q, H_kv, n_kb, mask);
        const int qs = it & 1;
        mbar_wait_timed(bars.item_empty + qs, ((it >> 1) & 1) ^ 1);
        item.store(info + qs * WIDE_INFO);
        info[qs * WIDE_INFO + SL] = sl;
        mbar_arrive(bars.item_full + qs);
        const int key0 = item.kb * BN;
        const int per_head = item.n_qb * SUB;  // q tiles of a head
        for (int t = 0; t < 2 * group * per_head; ++t) {
          // tiles: q tile fastest, then the head, then the pass (dV, dK)
          const bool pass = t >= group * per_head;
          const int tt = pass ? t - group * per_head : t;
          const int hq = tt / per_head;
          const int row = (item.qb0 * SUB + tt - hq * per_head) * TM;
          const int head = item.head0 + hq;
          for (int x = 0; x < nb; ++x, dr.next()) {
            uint8_t* st = smem + L::D_OFF + dr.s * DEPTH;
            uint64_t* full = bars.d_full + dr.s;
            mbar_wait_timed(bars.d_empty + dr.s, dr.ph ^ 1);
            mbar_expect_tx(full, pass ? DEPTH : KBOX + QBOX);
            tma_load_3d(st, &tm_k, full, x * 64, key0, item.bkh);
            tma_load_3d(st + KBOX, &tm_q, full, x * 64, row, head);
            if (pass) {
              tma_load_3d(st + KBOX + QBOX, &tm_v, full, x * 64, key0,
                          item.bkh);
              tma_load_3d(st + 2 * KBOX + QBOX, &tm_do, full, x * 64, row,
                          head);
            }
          }
          uint8_t* ss = smem + L::S_OFF + sr.s * SLICE;
          mbar_wait_timed(bars.s_empty + sr.s, sr.ph ^ 1);
          mbar_expect_tx(bars.s_full + sr.s, SLICE);
#pragma unroll
          for (int x = 0; x < WIDE_COLS / 64; ++x) {
            if (pass)
              tma_load_3d(ss + x * QBOX, &tm_q, bars.s_full + sr.s,
                          sl * WIDE_COLS + x * 64, row, head);
            else
              tma_load_3d(ss + x * QBOX, &tm_do, bars.s_full + sr.s,
                          sl * WIDE_COLS + x * 64, row, head);
          }
          sr.next();
        }
      }
    } else if (warp == 1) {
      // ---- warp 1: each tile's LSE (log2 domain) and delta rows ----
      Ring<WIDE_SS> sr;
      for (int it = 0;; ++it) {
        const int w = snake_item(it, blockIdx.x, gridDim.x);
        if (w >= n_work()) break;
        const DkdvItem item(w / ns, pieces, B, H_q, H_kv, n_kb, mask);
        const int per_head = item.n_qb * SUB;
        for (int t = 0; t < 2 * group * per_head; ++t, sr.next()) {
          const int tt = t < group * per_head ? t : t - group * per_head;
          const int hq = tt / per_head;
          const int row = (item.qb0 * SUB + tt - hq * per_head) * TM + lane;
          const int head = item.head0 + hq;
          mbar_wait_timed(bars.s_empty + sr.s, sr.ph ^ 1);
          float* rs = rows_sm + sr.s * 2 * TM;
          const bool ok = row < N_q;  // TM == 32: a row a lane
          rs[lane] = ok ? lse[(size_t)head * N_q + row] * LOG2E : INFINITY;
          rs[TM + lane] = ok ? delta[(size_t)head * N_q + row] : 0.f;
          mbar_arrive(bars.s_full + sr.s);  // release: the rows
        }
      }
    }
  } else {
    // ---- consumers: warpgroup c owns columns [256 c, 256 c + 256) of the
    // item's slice, over its 64 keys ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int c = wg - 1;
    const int ct = threadIdx.x - 128 * wg;
    const int warp = ct >> 5, lane = ct & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int r_key = warp * 16 + g;  // keys r_key, r_key + 8
    int* span_sm = reinterpret_cast<int*>(smem + L::SPAN_OFF) + c * 8;
    Ring<WIDE_DS> dr;
    Ring<WIDE_SS> sr;
    for (int it = 0;; ++it) {
      const int w = snake_item(it, blockIdx.x, gridDim.x);
      if (w >= n_work()) break;
      const int qs = it & 1;
      mbar_wait_timed(bars.item_full + qs, (it >> 1) & 1);
      const int* inf = info + qs * WIDE_INFO;
      const DkdvItem item(inf);
      const int n_tiles = group * item.n_qb * SUB;

      // Each key's interval of visible local query rows [lo, lo + n), and
      // the hull of the item's 64 keys' intervals [w_lo, w_hi).
      int lo[2];
      unsigned cnt[2];
      int my_lo = INT_MAX, my_hi = INT_MIN;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        int n;
        mask.key_span(item.b, item.kb * BN + r_key + 8 * r, lo[r], n);
        cnt[r] = (unsigned)n;
        if (n > 0) {
          my_lo = min(my_lo, lo[r]);
          my_hi = max(my_hi, lo[r] + n);
        }
      }
      my_lo = __reduce_min_sync(0xffffffffu, my_lo);
      my_hi = __reduce_max_sync(0xffffffffu, my_hi);
      if (lane == 0) {
        span_sm[warp * 2] = my_lo;
        span_sm[warp * 2 + 1] = my_hi;
      }
      named_sync(1 + c, 128);
      int w_lo = INT_MAX, w_hi = INT_MIN;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        w_lo = min(w_lo, span_sm[i * 2]);
        w_hi = max(w_hi, span_sm[i * 2 + 1]);
      }
      named_sync(1 + c, 128);  // span_sm is read before the next item's

      // One pass over the item's tiles: dV (P^T dO), or dK (dS^T Q) where
      // DK; each a compile-time body, so that the products of a pass are
      // the same wgmma sequence in every tile.
      auto run_pass = [&](auto pass) {
        constexpr bool DK = int(decltype(pass)()) == 1;
        float acc[WIDE_OR];
#pragma unroll
        for (int i = 0; i < WIDE_OR; ++i) acc[i] = 0.f;
        int qt = item.qb0 * SUB;
        for (int t = 0; t < n_tiles; ++t) {
          const int q0 = qt * TM;  // the tile's first local query row
          if (++qt == (item.qb0 + item.n_qb) * SUB) qt = item.qb0 * SUB;
          if (q0 >= w_hi || q0 + TM <= w_lo) {  // no key sees the tile
            wide_skip(bars, dr, sr, nb, c, ct);
            continue;
          }
          // S^T = K Q^T (and dP^T = V dO^T in the dK pass) over the depth,
          // summed onto zeros: with the first box's product overwriting
          // them instead, ptxas kept both arrays in local memory across
          // the depth loop (128 bytes of stack, every product serialised).
          float sacc[TM / 2], dpacc[TM / 2];
#pragma unroll
          for (int i = 0; i < TM / 2; ++i) sacc[i] = dpacc[i] = 0.f;
          wgmma_fence();
          int prev = 0;
          for (int x = 0; x < nb; ++x, dr.next()) {
            const uint8_t* st = smem + L::D_OFF + dr.s * DEPTH;
            mbar_wait_timed(bars.d_full + dr.s, dr.ph);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              SsMma<TM / 2, IO::kF16>::run(
                  sacc, desc_sw128(st + kk * 32, 16, 1024),
                  desc_sw128(st + KBOX + kk * 32, 16, 1024), 1);
            if constexpr (DK) {
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
                SsMma<TM / 2, IO::kF16>::run(
                    dpacc, desc_sw128(st + KBOX + QBOX + kk * 32, 16, 1024),
                    desc_sw128(st + 2 * KBOX + QBOX + kk * 32, 16, 1024),
                    1);
            }
            wgmma_commit();
            if (x > 0) {
              wgmma_wait<1>();
              if (ct == 0) mbar_arrive(bars.d_empty + prev);
            }
            prev = dr.s;
          }
          wgmma_wait<0>();
          if (ct == 0) mbar_arrive(bars.d_empty + prev);
          fence_regs(sacc);
          if constexpr (DK) fence_regs(dpacc);

          mbar_wait_timed(bars.s_full + sr.s, sr.ph);  // the slice and its rows
          const float* rs = rows_sm + sr.s * 2 * TM;
          // P^T: accumulator i = jj * 4 + 2 r + e is key r_key + 8 r,
          // query q0 + 8 jj + 2 t4 + e.
#pragma unroll
          for (int jj = 0; jj < TM / 8; ++jj) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float l2 = rs[jj * 8 + 2 * t4 + e];
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                float& x = sacc[jj * 4 + 2 * r + e];
                x = fast_exp2(fmaf(x, scale_log2, -l2));
              }
            }
          }
          const bool whole =
              __all_sync(0xffffffffu, lo[0] <= q0 &&
                                          q0 + TM <= lo[0] + (int)cnt[0] &&
                                          lo[1] <= q0 &&
                                          q0 + TM <= lo[1] + (int)cnt[1]);
          if (!whole) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int base = q0 + 2 * t4 - lo[r];
#pragma unroll
              for (int jj = 0; jj < TM / 8; ++jj) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  float& x = sacc[jj * 4 + 2 * r + e];
                  x = (unsigned)(base + jj * 8 + e) < cnt[r] ? x : 0.f;
                }
              }
            }
          }
          if constexpr (DK) {  // dS^T = P^T (dP^T - delta), in P^T's place
#pragma unroll
            for (int jj = 0; jj < TM / 8; ++jj) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float dl = rs[TM + jj * 8 + 2 * t4 + e];
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                  const int i = jj * 4 + 2 * r + e;
                  sacc[i] = sacc[i] * (dpacc[i] - dl);
                }
              }
            }
          }
          // P^T (dV pass) or dS^T (dK pass) as 16-bit A fragments, for
          // IoF32 as two bf16 terms.
          constexpr int LO = IO::kOut32 ? TM / 16 : 1;
          uint32_t fa[TM / 16][4], fl[LO][4];
#pragma unroll
          for (int kk = 0; kk < TM / 16; ++kk) {
#pragma unroll
            for (int h = 0; h < 4; ++h) {
              if constexpr (IO::kOut32)
                fa[kk][h] = pack_bf16_split(sacc[8 * kk + 2 * h],
                                            sacc[8 * kk + 2 * h + 1],
                                            fl[kk][h]);
              else
                fa[kk][h] = pack2<IO::kF16>(sacc[8 * kk + 2 * h],
                                            sacc[8 * kk + 2 * h + 1]);
            }
          }
          // dV += P^T dO or dK += dS^T Q over the consumer's 256 columns of
          // the slice (the queries are the depth; the slice's boxes TM rows
          // x 128 B apart).
          const uint8_t* sc =
              smem + L::S_OFF + sr.s * SLICE + c * 4 * QBOX;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < TM / 16; ++kk) {
            rs_mma<WIDE_OR, IO::kF16>(acc, fa[kk], sc + kk * 16 * 128, QBOX);
            if constexpr (IO::kOut32)
              rs_mma<WIDE_OR, false>(acc, fl[kk], sc + kk * 16 * 128, QBOX);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc);
          if (ct == 0) mbar_arrive(bars.s_empty + sr.s);
          sr.next();
        }
        // the pass's result, merged over the block's pieces, straight from
        // the registers (the item read again from shared memory: its
        // buffer is held until the end)
        const DkdvItem out(inf);
        const float mul[2] = {DK ? scale : 1.f, DK ? scale : 1.f};
        // the partials of a split block: 2 x 64 keys x the slices' 512
        // columns a (slot, r) pair; results: (slice, consumer, pass)
        const int n_sl = wide_slices(Dt);
        if (merge_pieces(PieceMerge(part, counters,
                                    (size_t)2 * BN * WIDE_COLS * n_sl,
                                    dkdv_per<Mask>(B, H_kv), B * H_kv,
                                    4 * n_sl),
                         out, (inf[SL] * 2 + c) * 2 + DK, flag(c), 1 + c,
                         ct, acc))
          wide_store<IO>(DK ? dk : dv, acc, mul, (size_t)out.bkh * N_kv,
                         out.kb * BN + r_key, N_kv, Dt,
                         inf[SL] * WIDE_COLS + c * (WIDE_COLS / 2), t4);
      };
      run_pass(Const<0>());
      run_pass(Const<1>());
      mbar_arrive(bars.item_empty + qs);
    }
  }
}

// Launch over a mask policy: as launch_dkdv_d (hopper_bwd.cuh), any Dt >= 8
// with Dt % 8 == 0.
template <class Mask, class IO>
int launch_dkdv_wide(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     const DkdvPieces& pc, void* dk, void* dv, int B, int H_q,
                     int H_kv, int N_q, int N_kv, int Dt, float scale,
                     const Mask& mask, cudaStream_t stream) {
  constexpr int smem = WideDkdvSmem::BYTES;
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      wide_dkdv_wgmma_kernel<Mask, IO>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);  // once
  if (attr_err != cudaSuccess) return (int)attr_err;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, q, B * H_q, N_q, Dt, WIDE_TM, IO::kF16) ||
      !make_map(&tdo, dout, B * H_q, N_q, Dt, WIDE_TM, IO::kF16) ||
      !make_map(&tk, k, B * H_kv, N_kv, Dt, WIDE_DKDV_BN, IO::kF16) ||
      !make_map(&tv, v, B * H_kv, N_kv, Dt, WIDE_DKDV_BN, IO::kF16))
    return (int)cudaErrorInvalidValue;
  const long n_work =
      (long)pc.max_pieces * dkdv_per<Mask>(B, H_kv) * wide_slices(Dt);
  if (n_work > INT_MAX) return (int)cudaErrorInvalidValue;
  const int grid = (int)std::min<long>(n_work, sm_count());
  if (grid <= 0) return (int)cudaErrorInvalidValue;
  wide_dkdv_wgmma_kernel<Mask, IO><<<grid, DKDV_THREADS, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(pc.table),
      static_cast<float*>(pc.part), static_cast<int*>(pc.counters), dk, dv,
      B, H_q, H_kv, N_q, N_kv, Dt, scale * LOG2E, scale, mask);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Every head dim: the instances of D <= 512 (attn_instance_d) and the wide one
// ---------------------------------------------------------------------------

// The wide instance's element types of a dtype code (DtypeCode), f(IO()).
template <class F>
int with_io(int dtype, F&& f) {
  switch (dtype) {
    case kDtypeBf16:
      return f(IoBf16());
    case kDtypeF16:
      return f(IoF16());
    case kDtypeF32:
      return f(IoF32());
  }
  return (int)cudaErrorInvalidValue;
}

// The forward at any head dim D % 8 == 0 in a dtype code's types.
template <class Mask>
int launch_fwd_any(int dtype, const void* q, const void* k, const void* v,
                   const void* s_aux, const void* order, void* o, void* lse,
                   int B, int H_q, int H_kv, int N_q, int N_kv, int D,
                   float scale, const Mask& mask, void* stream) {
  if (D < WIDE_MIN_D)
    return launch_fwd_dtype(dtype, q, k, v, s_aux, order, o, lse, B, H_q,
                            H_kv, N_q, N_kv, D, scale, mask, stream);
  if (N_q <= 0 || B * H_q <= 0) return 0;
  if (N_kv <= 0 || H_kv <= 0 || H_q % H_kv != 0 || D % 8 != 0)
    return (int)cudaErrorInvalidValue;
  return with_io(dtype, [&](auto io) {
    return launch_fwd_wide<Mask, decltype(io)>(
        q, k, v, s_aux, order, o, lse, B, H_q, H_kv, N_q, N_kv, D, scale,
        mask, static_cast<cudaStream_t>(stream));
  });
}

// dQ at any head dim D % 8 == 0 in a dtype code's types.
template <class Mask>
int launch_dq_any(int dtype, const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  const void* order, void* dq, int B, int H_q, int H_kv,
                  int N_q, int N_kv, int D, float scale, const Mask& mask,
                  void* stream) {
  if (D < WIDE_MIN_D)
    return launch_dq_dtype(dtype, q, k, v, dout, lse, delta, order, dq, B,
                           H_q, H_kv, N_q, N_kv, D, scale, mask, stream);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N_q <= 0 || B * H_q <= 0) return 0;
  if (H_kv <= 0 || H_q % H_kv != 0 || N_kv < 0 || D % 8 != 0 ||
      dtype < kDtypeBf16 || dtype > kDtypeF32)
    return (int)cudaErrorInvalidValue;
  if (N_kv == 0) {  // no key to read (and no tensor map of k)
    cudaMemsetAsync(dq, 0,
                    (size_t)B * H_q * N_q * D * (dtype == kDtypeF32 ? 4 : 2),
                    st);
    return (int)cudaGetLastError();
  }
  return with_io(dtype, [&](auto io) {
    return launch_dq_wide<Mask, decltype(io)>(q, k, v, dout, lse, delta,
                                              order, dq, B, H_q, H_kv, N_q,
                                              N_kv, D, scale, mask, st);
  });
}

// dK/dV at any head dim D % 8 == 0 in a dtype code's types.
template <class Mask>
int launch_dkdv_any(int dtype, const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    const DkdvPieces& pc, void* dk, void* dv, int B, int H_q,
                    int H_kv, int N_q, int N_kv, int D, float scale,
                    const Mask& mask, void* stream) {
  if (D < WIDE_MIN_D)
    return launch_dkdv_dtype(dtype, q, k, v, dout, lse, delta, pc, dk, dv,
                             B, H_q, H_kv, N_q, N_kv, D, scale, mask, stream);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N_kv <= 0 || B * H_kv <= 0) return 0;
  if (H_kv <= 0 || H_q % H_kv != 0 || N_q < 0 || D % 8 != 0 ||
      dtype < kDtypeBf16 || dtype > kDtypeF32)
    return (int)cudaErrorInvalidValue;
  if (N_q == 0) {  // no query reads any key (and no tensor map of q)
    const size_t bytes =
        (size_t)B * H_kv * N_kv * D * (dtype == kDtypeF32 ? 4 : 2);
    cudaMemsetAsync(dk, 0, bytes, st);
    cudaMemsetAsync(dv, 0, bytes, st);
    return (int)cudaGetLastError();
  }
  return with_io(dtype, [&](auto io) {
    return launch_dkdv_wide<Mask, decltype(io)>(q, k, v, dout, lse, delta,
                                                pc, dk, dv, B, H_q, H_kv,
                                                N_q, N_kv, D, scale, mask,
                                                st);
  });
}

// Keys per KV tile of the forward, dQ and dK/dV at head dim D (the host's
// tables): the instance's of D <= 512, else the wide instance's.
__host__ __device__ constexpr int fwd_bn_any(int D) {
  return D >= WIDE_MIN_D ? WIDE_FWD_BN : fwd_bn(instance_d(D));
}
__host__ __device__ constexpr int dq_bn_any(int D) {
  return D >= WIDE_MIN_D ? WIDE_DQ_BN : dq_bn(instance_d(D));
}
__host__ __device__ constexpr int dkdv_bn_any(int D) {
  return D >= WIDE_MIN_D ? WIDE_DKDV_BN : dkdv_bn(instance_d(D));
}

// The instance that runs head dim D in the forward, dQ and dK/dV (the C
// libraries export it per kernel): attn_instance_d (the narrow 80 and 96
// among them), and WIDE_MIN_D for every D past 512; 0 for a D that no
// instance takes (D % 8 != 0: the host pads it).
__host__ __device__ constexpr int attn_instance_any(int D) {
  return D % 8 != 0        ? 0
         : D >= WIDE_MIN_D ? WIDE_MIN_D
                           : attn_instance_d(D);
}

}  // namespace hopper
}  // namespace sinkattn
