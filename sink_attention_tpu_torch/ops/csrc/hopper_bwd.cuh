// Sink attention dK/dV for Hopper: a warp-specialised kernel on wgmma, TMA
// and mbarriers, written once over a mask policy (attention.cuh's
// SinkWindowMask in flash_bwd.cu, packed.cu's PackedMask).
//
// It computes, from the forward's LSE (which counts s_aux) and delta_i =
// sum_d dO_id O_id (less any LSE cotangent), for every key j:
//     P = exp(scale * Q K^T - LSE) on visible cells, 0 elsewhere
//     dV_j = sum_i P_ij dO_i,  dK_j = scale * sum_i P_ij (dP_ij - delta_i) Q_i
// with dP = dO V^T, summed over the query heads of the key's GQA group
// inside the kernel: no atomics, so the result is bitwise repeatable. Key
// slots no query sees (before the sequence start, or read by no row) get
// exact zeros.
//
// Design:
//  * a persistent grid, one CTA of three warpgroups per SM, walking the
//    work items (b*h_kv, a piece of a 128-key block) longest first in a
//    snake: round r takes items r*G + i, or r*G + G-1-i on odd rounds, so
//    the long and the short items of two rounds pair up;
//  * pieces (the host's piece table, ops/flash.py dkdv_pieces): a key
//    block's q range is cut into pieces of at most the longest range a
//    block without sink columns can have (about (bn + W) / 64 q blocks, at
//    least 4). Only a block holding sink columns is longer: every later
//    query reads it, so beside a short window its one item walked every q
//    block (256 tiles against ~34 at W = 1024) and alone set the call's
//    time, however early it started. Its pieces run on different CTAs; each
//    stores its fp32 dK / dV partial (per warpgroup and result, in the
//    registers' own order) in the stream's workspace and counts in, and
//    the block's last piece sums all of them in piece order and writes the
//    outputs (merge_pieces): one launch, no atomics on the data, bitwise
//    repeatable. A block that fits is one piece and runs as before;
//  * warpgroup 0 produces (setmaxnreg gives its registers to the
//    consumers: 24 against 240 at D = 128, 40 against 232 at D = 64; no
//    spill either way): one thread issues every TMA load, the
//    item's K and V once into one of two K/V buffers (so the next item's
//    load overlaps this one's tail), then for each (query head of the
//    group, 64-row q block) of the item's range from the host table the Q
//    and dO tiles into a ring of STAGES stages; warp 1 writes the tile's
//    64 LSE values (times log2e; +inf past N_q) and 64 delta values (0
//    past N_q) into the same stage with plain loads, which takes any N_q
//    (a 2-D fp32 tensor map would need N_q * 4 % 16 == 0); one full
//    barrier counts the TMA bytes and warp 1's 32 arrivals;
//  * warpgroups 1 and 2 consume, 64 keys each: per q tile S^T = K Q^T and
//    dP^T = V dO^T (wgmma m64n64k16, both operands in 128-byte-swizzled
//    shared memory: the forward's S = Q K^T with the keys as the M rows),
//    P^T = exp2(S^T * scale * log2e - LSE * log2e) and dS^T = P^T (dP^T -
//    delta) in registers, rounded to bf16 as the A operands of dV += P^T dO
//    and dK += dS^T Q (wgmma m64nDk16, dO and Q from shared memory as
//    transposed B operands, as the forward reads V); dK and dV stay in fp32
//    registers across the item's whole range and GQA group;
//  * fp32 inputs (IoF32): the host rounds Q, K, V and dO to bf16, but P^T
//    and dS^T enter their products as two bf16 terms each (attention.cuh's
//    pack_bf16_split: x ~ hi + lo at about 16 bits, two wgmma where the
//    16-bit instances issue one). One bf16 rounding of P or dS moves a
//    gradient by up to 2^-8 |P| |dO|, past the fp32 tolerance wherever a
//    large P sits near a rounding midpoint and two computations of it
//    (the kernel's exp2 of a folded FMA, another's exp) round it apart;
//    the two-term split leaves 2^-17 of it. The low term's product
//    follows the high term's on the same B operand, and dV's products are
//    waited for before dK's are issued (as one group, the four fragment
//    sets beside the 128 accumulators spilled at D = 128 and 256);
//  * the mask, per key: each key j sees one interval of local query rows
//    [lo_j, lo_j + n_j) from the policy (key_span), computed once per item;
//    each warp decides per tile, by one vote, whether its 16 keys see every
//    query of the tile, and only a partial tile takes the per-cell select
//    (one unsigned compare a cell), outside the unrolled cell loops; masked
//    cells give p = 0 by a select of p, so a row whose LSE is -inf gives 0
//    and not NaN, and zero-filled or garbage rows past N_q give 0;
//  * a consumer whose 64 keys see no query of a tile (the hull of its keys'
//    intervals, found once per item) skips that tile's products, waiting
//    and releasing the stage only (the sliding-window layers' diagonal
//    tiles are half dead for each consumer);
//  * the epilogue: dK (scaled) and dV go out in the input type through the
//    consumer's own rows of the item's K and V buffers (then free: only
//    this warpgroup's products read them) as 16-byte stores of whole rows,
//    or as fp32 (IoF32) straight from the accumulators; the buffers are
//    released to the producer after that;
//  * any head dim D <= 512 (D % 8 == 0) runs in the instance D_i =
//    attn_instance_d(D) (hopper.cuh): 80 for D 65-80, 96 for 81-96,
//    else the smallest of 64, 128, 256 and 512 that holds it. TMA reads
//    the columns past D of K, V, Q and dO as zeros, so the accumulators'
//    columns past D are zeros, and only D columns are written (each key's
//    whole row: the GQA group's sum is in the accumulators); bf16 or fp16
//    inputs (hopper.cuh's Io types);
//  * the narrow instances of 80 and 96 keep the 128 instance's plan and
//    shared memory (two boxes a row, box 1 zero-filled past D) but
//    compute on D_i columns: S^T and dP^T take D_i / 16 = 5 or 6 k-steps,
//    and dV += P^T dO and dK += dS^T Q are each an m64n64k16 over box 0
//    beside an m64n16k16 or m64n32k16 over box 1 (hopper.cuh's rs_mma), so
//    dK and dV hold 80 or 96 fp32 registers a thread, not 128;
//  * the instance of D = 256 splits each tile's products between the
//    consumers, not its keys or columns (DkdvPlan's SHARE): dK and dV of
//    64 keys x 256 columns take 128 fp32 registers a thread each, so one
//    warpgroup cannot hold both, and an item is 64 keys. Per live q tile
//    warpgroup 1 computes S^T = K Q^T (m64n64k16, 16 k-steps), P^T (the
//    mask on partial tiles) and dV += P^T dO over all 256 columns (two
//    m64n128k16 a 16-query step, P^T from registers); warpgroup 2 computes
//    dP^T = V dO^T and, once P^T has come, dS^T = P^T (dP^T - delta) and
//    dK += dS^T Q. Each element of S^T and dP^T is computed once: 8 D
//    FLOPs a visible pair, the bound's count (an earlier plan had both
//    consumers compute the same S^T and dP^T and accumulate 128 columns
//    each: 12 D). Splitting the queries instead (m64n32 products whose A
//    operand is re-read from shared memory, P^T and dS^T shared as bf16 A
//    operands) moves more shared-memory bytes a tile. P^T goes over in
//    fp32, so dS^T takes it unrounded and the results are bit for bit the
//    earlier plan's, fp32 inputs included (no low terms to share), through
//    an exchange tile of 16 KB: float4 jj * 128 + ct holds thread ct's
//    accumulators 4 jj .. 4 jj + 3 (conflict-free; warpgroup 2's thread ct
//    holds the same cells of dP^T). Two named barriers a tile hand it over:
//    warpgroup 1 arrives at X_FULL after its stores (bar.arrive: it does
//    not wait) and warpgroup 2 waits there; warpgroup 2 arrives at X_FREE
//    once it has read the tile, and warpgroup 1 waits there before it
//    writes the tile again. So the exponent and the mask (warpgroup 1)
//    overlap warpgroup 2's products and the other way round, as the two
//    consumers of the other instances overlap. A second exchange tile, so
//    that warpgroup 1 could run a further tile ahead, measured the same
//    (within 1%, kernel_compare.py at Gemma-2-2B's shapes) and was left
//    out. Shared memory: one K/V buffer (2 x 32 KB), two stages of 64-row
//    Q and dO (2 x 64 KB) and the exchange tile (16 KB): 208 KB. The
//    epilogue stages dV through the K buffer and dK through the V buffer,
//    each read by its own warpgroup's products only, so no barrier of the
//    two; a dead tile is dead for both (the same 64 keys);
//  * the instance of D = 512 splits the columns too (256 a consumer), and
//    walks each item's q tiles twice (DkdvPlan's PASSES): dK and dV of 64
//    keys x 256 columns would again take 256 registers a thread, so the
//    first pass accumulates dV (S^T, P^T, dV += P^T dO) and writes it out,
//    the second dK (S^T and dP^T again, dS^T, dK += dS^T Q) in the same
//    128 registers. Its q tiles are 32 rows (halves of the host's 64-row q
//    blocks): K and V of 64 keys x 512 take 128 KB, one stage of 32-row Q
//    and dO 64 KB: 192 KB. Both consumers compute S^T in both passes and
//    dP^T in the second: 20 D FLOPs a pair against the 8 D the bound
//    counts. Each pass's accumulators go out straight from the registers
//    (4-byte stores of column pairs; the K and V buffers are read until
//    the item's last tile).
//
// Replaces the Pallas TPU kernels `_dkdv_kernel` of
// sink_attention_tpu/ops/flash.py and `_pdkdv_kernel` of
// sink_attention_tpu/ops/packed.py. Bound on the H100: 8 D FLOPs per visible
// (query, key) pair and head (four products of depth D) at 989 TFLOP/s, or
// the bytes 2 * |q| + 4 * |kv| + the fp32 rows (q and dO read, k and v read,
// dk and dv written, lse and delta read) at 3.35 TB/s: the full layers are
// bound by operations, the W = 128 layers by bytes. What the design does
// about it: wgmma on TMA-fed shared memory at the tensor cores' rate, the
// mask's cost only on partial tiles, dead half-tiles skipped, K/V read once
// per item and Q/dO once per (item, head, q block), no second pass, no item
// longer than a window block's (the pieces). The
// instances of D <= 256 do the bound's 8 D FLOPs a pair; the 512 instance
// 20 D, the wide one (hopper_wide.cuh) more.

#pragma once

#include <algorithm>
#include <climits>
#include <type_traits>

#include "hopper.cuh"

namespace sinkattn {
namespace hopper {

constexpr int DKDV_BM = 64;    // queries per q block (DkdvPlan's TM a tile)
constexpr int DKDV_BN = 128;   // keys per item, 64 per consumer
constexpr int DKDV_THREADS = 384;
constexpr int DKDV_INFO = 16;  // ints of an item's info in shared memory
constexpr int PIECE_INTS = 8;  // ints of a row of the host's piece table

// The tile plan at instance head dim D: keys per item and K/V buffers
// (SPLIT: 64 keys, one buffer, D = 256 and 512), whether the consumers
// split a tile's products (SHARE, D = 256: one computes S^T, P^T and dV,
// the other dP^T, dS^T and dK, P^T handed over in a shared-memory tile)
// or else, where SPLIT, the item's columns (D = 512), query rows per q
// tile, and passes over an item's tiles (D = 512: dV, then dK; see the
// header). The narrow 80 and 96 take the 128 instance's plan.
template <int D>
struct DkdvPlan {
  static constexpr bool SPLIT = D >= 256;
  static constexpr bool SHARE = D == 256;
  static constexpr int BN = SPLIT ? 64 : DKDV_BN;  // keys per item
  static constexpr int KB = SPLIT ? 1 : 2;         // K/V buffers
  static constexpr int TM = D == 512 ? 32 : DKDV_BM;  // rows per q tile
  static constexpr int PASSES = D == 512 ? 2 : 1;
};

// Keys per work item at instance head dim D (the host's table unit).
__host__ __device__ constexpr int dkdv_bn(int D) {
  return D >= 256 ? DkdvPlan<256>::BN : DKDV_BN;
}

// setmaxnreg's split of the registers (producer warpgroup, consumer
// warpgroups; 128 p + 256 c <= 65536): at D = 128 (and D = 256, whose
// consumers hold dV or dK of all the columns) the consumers' accumulators
// take 128 registers a thread, and 24 keep the producer free of spills;
// at D = 64 the producer's ring of three stages wants more, and at D =
// 512 its walk of the q tiles (two passes of two tiles a q block) spilled
// 4-12 bytes at 24, while the consumers hold one pass's 128 accumulators.
// The narrow instances (80, 96), with 80 or 96 accumulators, take D = 64's
// split.
template <int D>
struct DkdvRegs {
  static constexpr bool WIDE = D == 128 || D == 256;
  static constexpr int PRODUCER = WIDE ? 24 : 40;
  static constexpr int CONSUMER = WIDE ? 240 : 232;
};

// Shared-memory layout of one CTA (byte offsets; every tile 1024-aligned).
template <int D, int STAGES>
struct DkdvSmem {
  static constexpr int KB = DkdvPlan<D>::KB;         // K/V buffers
  static constexpr int BOXES = smem_d(D) / 64;      // 64-column boxes a row
  static constexpr int KV_BYTES = DkdvPlan<D>::BN * BOXES * 128;  // K or V
  static constexpr int QT_BYTES = DkdvPlan<D>::TM * BOXES * 128;  // Q or dO
  static constexpr int K_OFF = 0;                    // KB K tiles
  static constexpr int V_OFF = K_OFF + KB * KV_BYTES;  // KB V tiles
  static constexpr int Q_OFF = V_OFF + KB * KV_BYTES;
  static constexpr int DO_OFF = Q_OFF + STAGES * QT_BYTES;
  static constexpr int ROW_OFF = DO_OFF + STAGES * QT_BYTES;  // [S][2][64] f32
  static constexpr int BAR_OFF = ROW_OFF + STAGES * 2 * DKDV_BM * 4;
  // kv_full[KB], kv_empty[KB], then full, empty [STAGES] each
  static constexpr int N_BARS = 2 * KB + 2 * STAGES;
  static constexpr int INFO_OFF = BAR_OFF + N_BARS * 8;  // int [KB][16]
  static constexpr int SPAN_OFF = INFO_OFF + KB * DKDV_INFO * 4;  // [2][4][2]
  // int [4]: a consumer's merge flag each, the number of work items
  static constexpr int FLAG_OFF = SPAN_OFF + 2 * 4 * 2 * 4;
  // SHARE: the exchange tile of P^T, float4 [TM / 8][128] (a consumer
  // thread's 32 accumulators as 8 float4, thread-fastest)
  static constexpr int X_BYTES = DkdvPlan<D>::BN * DkdvPlan<D>::TM * 4;
  static constexpr int X_OFF = (FLAG_OFF + 4 * 4 + 127) / 128 * 128;
  static constexpr int BYTES =
      DkdvPlan<D>::SHARE ? X_OFF + X_BYTES + 1024
                         : FLAG_OFF + 4 * 4 + 1024;  // + align
};

// Work units per piece: a piece of a key block shared by the batch
// (SinkWindowMask) is an item for every (batch, KV head); where the policy
// keeps a table per batch row (PackedMask), for every KV head of its row.
template <class Mask>
__host__ __device__ __forceinline__ int dkdv_per(int B, int H_kv) {
  return Mask::kBatchTables ? H_kv : B * H_kv;
}

// A work item: one piece of one key block (128 keys, 64 where SPLIT) of one
// (batch, KV head), from row 1 + w / per of the host's piece table
// (ops/flash.py dkdv_pieces; row 0 holds the number of pieces): its unit u,
// its q-block range, the block's piece count np and the piece's index pi,
// and the block's first partial slot; and the first query head of the
// group. Unit u is a key block or, where the policy keeps a table per
// batch row, a (b, block) pair: b * n_kb + block. `part` is the partial
// row of the block's first piece for this (batch, KV head): slot * per + r.
struct DkdvItem {
  int b, kb, bkh, head0, qb0, n_qb, np, pi, part;
  template <class Mask>
  __device__ __forceinline__ DkdvItem(int w, const int* pieces, int B,
                                      int H_q, int H_kv, int n_kb,
                                      const Mask&) {
    const int per = dkdv_per<Mask>(B, H_kv);
    const int p = w / per, r = w - p * per;
    const int* row = pieces + (1 + p) * PIECE_INTS;
    const int u = row[0];
    if (Mask::kBatchTables) {
      b = u / n_kb;
      kb = u - b * n_kb;
      bkh = b * H_kv + r;
    } else {
      kb = u;
      bkh = r;
      b = r / H_kv;
    }
    head0 = b * H_q + (bkh - b * H_kv) * (H_q / H_kv);
    qb0 = row[1];
    n_qb = max(row[2] - qb0, 0);
    np = row[3];
    pi = row[4];
    part = row[5] * per + r;
  }
  __device__ __forceinline__ void store(int* info) const {
    info[0] = b;
    info[1] = kb;
    info[2] = bkh;
    info[3] = head0;
    info[4] = qb0;
    info[5] = n_qb;
    info[6] = np;
    info[7] = pi;
    info[8] = part;
  }
  __device__ __forceinline__ explicit DkdvItem(const int* info)
      : b(info[0]), kb(info[1]), bkh(info[2]), head0(info[3]), qb0(info[4]),
        n_qb(info[5]), np(info[6]), pi(info[7]), part(info[8]) {}
};

// Where the pieces of a split key block meet (built where a warpgroup
// merges, from the kernel's parameters, so that nothing of it holds
// registers across the tile loops): `part` holds, per (piece
// slot, batch row r of the piece) pair, `f` fp32 values (every dK and dV
// accumulator of the block's item: 2 x keys x columns), and `counters` one
// arrival count per (key block, batch x KV head, result), `rmax` results a
// pair. A result is one warpgroup's merge: its dK and dV (D <= 128), its
// dV or dK (SHARE), one pass's (D = 512), one pass of a slice (the wide
// instance).
struct PieceMerge {
  float* part;
  int* counters;
  size_t f;           // floats a (slot, r) pair
  int per, pairs, rmax;
  __device__ __forceinline__ PieceMerge(float* part_, int* counters_,
                                        size_t f_, int per_, int pairs_,
                                        int rmax_)
      : part(part_), counters(counters_), f(f_), per(per_), pairs(pairs_),
        rmax(rmax_) {}
};

// The merge of the dK/dV kernel of instance D over a mask policy: 2 x keys
// x D columns a (slot, r) pair; results: a consumer's dK and dV, or (SHARE)
// its dV or dK, or (PASSES) each pass's.
template <class Mask, int D>
__device__ __forceinline__ PieceMerge dkdv_merge(float* part, int* counters,
                                                 int B, int H_kv) {
  return PieceMerge(part, counters, (size_t)2 * DkdvPlan<D>::BN * D,
                    dkdv_per<Mask>(B, H_kv), B * H_kv, 4);
}

template <int N>
__device__ __forceinline__ void frag_put(float4* p, const float (&a)[N],
                                         int ct) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i)
    __stcg(p + i * 128 + ct,
           make_float4(a[4 * i], a[4 * i + 1], a[4 * i + 2], a[4 * i + 3]));
}

// a = the sum of the np partials at p, p + stride, ... (float4s) in that
// order, in chunks of MERGE_CHUNK float4s a thread: a chunk's first
// partial is loaded into a, then the others are added piece by piece, the
// pieces a loop the compiler does not unroll, so that at most a chunk's
// loads are in flight beside a. Arrays of up to 64 floats (the instances
// of D <= 128) take a piece's whole array at once.
constexpr int MERGE_CHUNK = 8;
template <int N>
__device__ __forceinline__ void frag_sum(float (&a)[N], const float4* p,
                                         size_t stride, int np, int ct) {
  constexpr int CH = N <= 64 ? N / 4 : MERGE_CHUNK;
#pragma unroll
  for (int c0 = 0; c0 < N / 4; c0 += CH) {
#pragma unroll
    for (int i = c0; i < c0 + CH && i < N / 4; ++i) {
      const float4 x = __ldcg(p + i * 128 + ct);
      a[4 * i] = x.x;
      a[4 * i + 1] = x.y;
      a[4 * i + 2] = x.z;
      a[4 * i + 3] = x.w;
    }
#pragma unroll 1
    for (int q = 1; q < np; ++q) {
      const float4* src = p + q * stride;
#pragma unroll
      for (int i = c0; i < c0 + CH && i < N / 4; ++i) {
        const float4 x = __ldcg(src + i * 128 + ct);
        a[4 * i] += x.x;
        a[4 * i + 1] += x.y;
        a[4 * i + 2] += x.z;
        a[4 * i + 3] += x.w;
      }
    }
  }
}

// The end of one warpgroup's piece of `item` for result `rid`: true where
// acc... now holds the block's whole sum. An unsplit block (np == 1) has
// it already. A piece of a split block stores its accumulators as its
// partial (thread ct's values as float4s ct, 128 + ct, ...; plain stores
// through L2), and one thread counts the piece in; the block's last piece
// to arrive loads every piece's partial in piece order (its own from
// memory too), so the sum is bitwise the same whichever piece arrives
// last, resets the count for the next launch and returns true; the others
// return false. `flag` is an int of the warpgroup's in shared memory,
// `bar` its named barrier. No piece waits for another.
template <class... Acc>
__device__ __forceinline__ bool merge_pieces(const PieceMerge& pm,
                                             const DkdvItem& item, int rid,
                                             int* flag, int bar, int ct,
                                             Acc&... acc) {
  if (item.np <= 1) return true;
  constexpr int NT = (0 + ... + int(sizeof(Acc) / sizeof(float)));
  const size_t stride = (size_t)pm.per * pm.f / 4;  // float4s a piece
  const float4* base = reinterpret_cast<const float4*>(
                           pm.part + (size_t)item.part * pm.f) +
                       (size_t)rid * 32 * NT;
  float4* mine = const_cast<float4*>(base) + item.pi * stride;
  ((frag_put(mine, acc, ct), mine += sizeof(acc) / 16 * 128), ...);
  __threadfence();
  named_sync(bar, 128);
  if (ct == 0) {
    int* count =
        pm.counters + ((size_t)item.kb * pm.pairs + item.bkh) * pm.rmax + rid;
    const bool last = atomicAdd(count, 1) == item.np - 1;
    if (last) *count = 0;
    *flag = last;
  }
  named_sync(bar, 128);
  if (!*static_cast<volatile int*>(flag)) return false;
  __threadfence();
  const float4* src = base;
  ((frag_sum(acc, src, stride, item.np, ct), src += sizeof(acc) / 16 * 128),
   ...);
  return true;
}

// A consumer's accumulators of keys r_key and r_key + 8 of `item` and
// its DC columns from c0, times mul, straight from the registers into out
// [B*H_kv, N_kv, Dt] as fp32 (IO::kOut32: 8-byte stores) or 16-bit pairs
// (4-byte stores); keys past N_kv and columns past Dt are not written.
template <class IO, int DC, int OR>
__device__ __forceinline__ void store_key_rows(void* out,
                                               const float (&acc)[OR],
                                               float mul,
                                               const DkdvItem& item, int BN,
                                               int N_kv, int Dt, int r_key,
                                               int c0, int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = item.kb * BN + r_key + 8 * r;
    if (row >= N_kv) continue;
    const size_t o = ((size_t)item.bkh * N_kv + row) * Dt;
#pragma unroll
    for (int jj = 0; jj < DC / 8; ++jj) {
      const int col = c0 + jj * 8 + t4 * 2;
      if (col >= Dt) continue;
      const float x0 = acc[jj * 4 + 2 * r] * mul;
      const float x1 = acc[jj * 4 + 2 * r + 1] * mul;
      if constexpr (IO::kOut32)
        *reinterpret_cast<float2*>(static_cast<float*>(out) + o + col) =
            make_float2(x0, x1);
      else
        *reinterpret_cast<uint32_t*>(static_cast<uint16_t*>(out) + o +
                                     col) = pack2<IO::kF16>(x0, x1);
    }
  }
}

// Arrive at named barrier `id` of `count` threads without waiting (the
// threads that wait on it meet these arrivals with named_sync): releases
// this thread's earlier shared-memory accesses to them.
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Each of keys r_key and r_key + 8 of `item` sees one interval of local
// query rows [lo, lo + cnt); [w_lo, w_hi) is the hull of the warpgroup's 64
// keys' intervals, gathered through span_sm (its four warps', at named
// barrier `bar` of the warpgroup).
template <class Mask>
__device__ __forceinline__ void key_spans(const Mask& mask,
                                          const DkdvItem& item, int BN,
                                          int r_key, int warp, int lane,
                                          int bar, int* span_sm, int (&lo)[2],
                                          unsigned (&cnt)[2], int& w_lo,
                                          int& w_hi) {
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
  named_sync(bar, 128);
  w_lo = INT_MAX;
  w_hi = INT_MIN;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w_lo = min(w_lo, span_sm[i * 2]);
    w_hi = max(w_hi, span_sm[i * 2 + 1]);
  }
}

// D is the instance's head dim, Dt <= D the tensors' (see
// fwd_wgmma_kernel); IO the element types. An item's q tiles are walked
// PASSES times, each pass by query head of the group, 64-row q block of
// the item's range and TM-row tile of the block.
template <int D, int STAGES, class Mask, class IO>
__global__ void __launch_bounds__(DKDV_THREADS, 1)
    dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int* __restrict__ pieces,
                      float* __restrict__ part, int* __restrict__ counters,
                      void* __restrict__ dk, void* __restrict__ dv, int B,
                      int H_q, int H_kv, int N_q, int N_kv, int Dt,
                      float scale_log2, float scale, Mask mask) {
  using L = DkdvSmem<D, STAGES>;
  constexpr bool SPLIT = DkdvPlan<D>::SPLIT;  // consumers split the columns
  constexpr int BN = DkdvPlan<D>::BN;         // keys per item
  constexpr int KB = L::KB;                   // K/V buffers
  // a consumer's columns: SPLIT halves them, SHARE splits the products
  constexpr int DC = SPLIT && !DkdvPlan<D>::SHARE ? D / 2 : D;
  constexpr int OR = DC / 2;  // dK or dV accumulators a thread
  constexpr int TM = DkdvPlan<D>::TM;          // query rows per q tile
  constexpr int SUB = DKDV_BM / TM;            // q tiles per q block
  constexpr int PASSES = DkdvPlan<D>::PASSES;  // walks of an item's tiles
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* kv_full = bars;
  uint64_t* kv_empty = bars + KB;
  uint64_t* full = bars + 2 * KB;
  uint64_t* empty = bars + 2 * KB + STAGES;
  int* info = reinterpret_cast<int*>(smem + L::INFO_OFF);  // [K/V buffer][16]
  float* rows_sm = reinterpret_cast<float*>(smem + L::ROW_OFF);

  const int n_kb = (N_kv + BN - 1) / BN;
  // int [4] of shared memory: a consumer's merge flag each, then the number
  // of work items, counted once and read there at each item (addressed
  // from smem where used: no register holds them across an item)
  const auto flag = [&](int i) {
    return reinterpret_cast<int*>(smem + L::FLAG_OFF) + i;
  };
  const auto n_work = [&] { return *static_cast<volatile int*>(flag(2)); };
  const int group = H_q / H_kv;

  if (threadIdx.x == 0) {
    *flag(2) = pieces[0] * dkdv_per<Mask>(B, H_kv);
    for (int i = 0; i < KB; ++i) {
      mbar_init(kv_full + i, 1);
      mbar_init(kv_empty + i, 2 * 128);  // every consumer thread, per item
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1 + 32);  // the TMA thread and warp 1's lanes
      mbar_init(empty + s, 2);      // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        DkdvRegs<D>::PRODUCER));
    const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
    if (warp == 0 && lane == 0) {
      // ---- one thread issues every TMA load ----
      Ring<STAGES> ring;
      for (int it = 0;; ++it) {
        const int w = snake_item(it, blockIdx.x, gridDim.x);
        if (w >= n_work()) break;
        const DkdvItem item(w, pieces, B, H_q, H_kv, n_kb, mask);
        const int kbuf = buf_of<KB>(it);
        mbar_wait(kv_empty + kbuf, buf_phase<KB>(it) ^ 1);
        item.store(info + kbuf * DKDV_INFO);
        mbar_expect_tx(kv_full + kbuf, 2 * L::KV_BYTES);  // and the info
#pragma unroll
        for (int x = 0; x < L::BOXES; ++x) {
          tma_load_3d(smem + L::K_OFF + kbuf * L::KV_BYTES + x * BN * 128,
                      &tm_k, kv_full + kbuf, x * 64, item.kb * BN,
                      item.bkh);
          tma_load_3d(smem + L::V_OFF + kbuf * L::KV_BYTES + x * BN * 128,
                      &tm_v, kv_full + kbuf, x * 64, item.kb * BN,
                      item.bkh);
        }
        const int n_tiles = PASSES * group * item.n_qb * SUB;
        // tiles: q tile fastest, then the head, then the pass
        int bh = item.head0, qt = item.qb0 * SUB;
        for (int j = 0; j < n_tiles; ++j, ring.next()) {
          const int s = ring.s;
          mbar_wait(empty + s, ring.ph ^ 1);
          const int row = qt * TM, head = bh;
          if (++qt == (item.qb0 + item.n_qb) * SUB) {
            qt = item.qb0 * SUB;
            if (++bh == item.head0 + group && PASSES > 1) bh = item.head0;
          }
          mbar_expect_tx(full + s, 2 * L::QT_BYTES);
#pragma unroll
          for (int x = 0; x < L::BOXES; ++x) {
            tma_load_3d(smem + L::Q_OFF + s * L::QT_BYTES + x * TM * 128,
                        &tm_q, full + s, x * 64, row, head);
            tma_load_3d(smem + L::DO_OFF + s * L::QT_BYTES + x * TM * 128,
                        &tm_do, full + s, x * 64, row, head);
          }
        }
      }
    } else if (warp == 1) {
      // ---- warp 1: each tile's LSE (log2 domain) and delta rows ----
      Ring<STAGES> ring;
      for (int it = 0;; ++it) {
        const int w = snake_item(it, blockIdx.x, gridDim.x);
        if (w >= n_work()) break;
        const DkdvItem item(w, pieces, B, H_q, H_kv, n_kb, mask);
        const int n_tiles = PASSES * group * item.n_qb * SUB;
        int bh = item.head0, qt = item.qb0 * SUB;
        for (int j = 0; j < n_tiles; ++j, ring.next()) {
          const int s = ring.s;
          mbar_wait(empty + s, ring.ph ^ 1);
          const float* lse_row = lse + (size_t)bh * N_q;
          const float* delta_row = delta + (size_t)bh * N_q;
          const int row0 = qt * TM;
          if (++qt == (item.qb0 + item.n_qb) * SUB) {
            qt = item.qb0 * SUB;
            if (++bh == item.head0 + group && PASSES > 1) bh = item.head0;
          }
          float* rs = rows_sm + s * 2 * DKDV_BM;
#pragma unroll
          for (int r = lane; r < TM; r += 32) {
            const int row = row0 + r;
            const bool ok = row < N_q;
            rs[r] = ok ? lse_row[row] * LOG2E : INFINITY;
            rs[DKDV_BM + r] = ok ? delta_row[row] : 0.f;
          }
          mbar_arrive(full + s);  // release: the rows are visible
        }
      }
    }
  } else if constexpr (DkdvPlan<D>::SHARE) {
    // ---- consumers of the 256 instance: both take the item's 64 keys
    // and all D columns; per live q tile warpgroup 1 computes S^T, P^T and
    // dV += P^T dO and hands P^T over in the exchange tile, warpgroup 2
    // dP^T, dS^T and dK += dS^T Q (see the header); one loop compiled for
    // each role ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        DkdvRegs<D>::CONSUMER));
    static_assert(SUB == 1 && PASSES == 1, "one 64-row tile a q block");
    constexpr int X_FULL = 4, X_FREE = 5;  // named barriers, once a tile
    const int ct = threadIdx.x - 128 * wg;
    const int warp = ct >> 5, lane = ct & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int r_key = warp * 16 + g;  // keys r_key, r_key + 8
    float4* xs = reinterpret_cast<float4*>(smem + L::X_OFF);
    const auto consume = [&](auto role) {
      // 0: S^T, P^T, dV; 1: dP^T, dS^T, dK
      constexpr int C = decltype(role)::value;
      int* span_sm = reinterpret_cast<int*>(smem + L::SPAN_OFF) + C * 8;
      // S^T's operands are K and Q, dP^T's V and dO; dV's B operand is dO,
      // dK's Q
      constexpr int A_OFF = C == 0 ? L::K_OFF : L::V_OFF;
      constexpr int B_OFF = C == 0 ? L::Q_OFF : L::DO_OFF;
      constexpr int O_OFF = C == 0 ? L::DO_OFF : L::Q_OFF;
      Ring<STAGES> ring;
      bool handed = false;  // a P^T went over (both see the same tiles)
      for (int it = 0;; ++it) {
        const int w = snake_item(it, blockIdx.x, gridDim.x);
        if (w >= n_work()) break;
        mbar_wait(kv_full, buf_phase<KB>(it));
        const DkdvItem item(info);
        const int n_tiles = group * item.n_qb;
        int lo[2], w_lo, w_hi;
        unsigned cnt[2];
        key_spans(mask, item, BN, r_key, warp, lane, 1 + C, span_sm, lo, cnt,
                  w_lo, w_hi);
        float acc[OR];  // dV (warpgroup 1) or dK (2): 64 keys x D columns
#pragma unroll
        for (int i = 0; i < OR; ++i) acc[i] = 0.f;
        int qt = item.qb0;
        for (int j = 0; j < n_tiles; ++j, ring.next()) {
          const int s = ring.s;
          const int q0 = qt * TM;  // the tile's first local query row
          if (++qt == item.qb0 + item.n_qb) qt = item.qb0;
          mbar_wait(full + s, ring.ph);
          // the same keys, so both warpgroups skip the same tiles
          if (q0 >= w_hi || q0 + TM <= w_lo) {
            named_sync(1 + C, 128);  // every warp has seen the stage's phase
            if (ct == 0) mbar_arrive(empty + s);
            continue;
          }
          // the operands' addresses from a base the compiler cannot hoist
          // out of the tile loop, so that their descriptors are computed
          // where they are used (hoisted, they took 4% more instructions,
          // 8202 against 7869 lines of the bf16 and fp32 instances' SASS)
          const uint8_t* sm = smem;
          asm volatile("" : "+l"(sm));
          const uint8_t* a_sm = sm + A_OFF;
          const uint8_t* b_sm = sm + B_OFF + s * L::QT_BYTES;
          const uint8_t* o_sm = sm + O_OFF + s * L::QT_BYTES;
          const float* rs = rows_sm + s * 2 * DKDV_BM;

          // S^T = K Q^T or dP^T = V dO^T: 64 keys x TM queries, D / 16
          // k-steps
          float x[TM / 2];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const int bx = kk / 4, off = (kk % 4) * 32;
            SsMma<TM / 2, IO::kF16>::run(
                x, desc_sw128(a_sm + bx * BN * 128 + off, 16, 1024),
                desc_sw128(b_sm + bx * TM * 128 + off, 16, 1024), kk > 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(x);

          // accumulator i = jj * 4 + 2 r + e is key r_key + 8 r, query q0 +
          // 8 jj + 2 t4 + e; float4 jj * 128 + ct of the exchange tile
          // holds accumulators 4 jj .. 4 jj + 3 of thread ct
          if constexpr (C == 0) {
            // P^T, the scale folded into the exponent's FMA
#pragma unroll
            for (int jj = 0; jj < TM / 8; ++jj) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float l2 = rs[jj * 8 + 2 * t4 + e];
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                  float& p = x[jj * 4 + 2 * r + e];
                  p = fast_exp2(fmaf(p, scale_log2, -l2));
                }
              }
            }
            // the per-cell mask on partial tiles only (a warp-uniform
            // branch): p = 0 by a select where the query is outside the
            // key's interval
            const bool whole = __all_sync(
                0xffffffffu, lo[0] <= q0 && q0 + TM <= lo[0] + (int)cnt[0] &&
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
                    float& p = x[jj * 4 + 2 * r + e];
                    p = (unsigned)(base + jj * 8 + e) < cnt[r] ? p : 0.f;
                  }
                }
              }
            }
            // warpgroup 2 has read the last P^T
            if (handed) named_sync(X_FREE, 256);
#pragma unroll
            for (int jj = 0; jj < TM / 8; ++jj)
              xs[jj * 128 + ct] = make_float4(x[jj * 4], x[jj * 4 + 1],
                                              x[jj * 4 + 2], x[jj * 4 + 3]);
            __threadfence_block();
            named_arrive(X_FULL, 256);
          } else {
            // dS^T = P^T (dP^T - delta), P^T from warpgroup 1
            named_sync(X_FULL, 256);
#pragma unroll
            for (int jj = 0; jj < TM / 8; ++jj) {
              const float4 p4 = xs[jj * 128 + ct];
              const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float dl = rs[DKDV_BM + jj * 8 + 2 * t4 + e];
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                  float& d = x[jj * 4 + 2 * r + e];
                  d = p[2 * r + e] * (d - dl);
                }
              }
            }
            named_arrive(X_FREE, 256);
          }
          handed = true;

          // dV += P^T dO or dK += dS^T Q over the D columns: P^T or dS^T
          // as 16-bit A fragments (IoF32: two bf16 terms, the low term's
          // product after the high term's), dO or Q read as transposed B
          // operands (box stride TM rows x 128 B)
          constexpr int LO = IO::kOut32 ? TM / 16 : 1;
          uint32_t fa[TM / 16][4];
          [[maybe_unused]] uint32_t fl[LO][4];  // IoF32 only
#pragma unroll
          for (int kk = 0; kk < TM / 16; ++kk) {
#pragma unroll
            for (int h = 0; h < 4; ++h) {
              if constexpr (IO::kOut32)
                fa[kk][h] = pack_bf16_split(x[8 * kk + 2 * h],
                                            x[8 * kk + 2 * h + 1], fl[kk][h]);
              else
                fa[kk][h] = pack2<IO::kF16>(x[8 * kk + 2 * h],
                                            x[8 * kk + 2 * h + 1]);
            }
          }
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < TM / 16; ++kk) {
            rs_mma<OR, IO::kF16>(acc, fa[kk], o_sm + kk * 16 * 128, TM * 128);
            if constexpr (IO::kOut32)
              rs_mma<OR, false>(acc, fl[kk], o_sm + kk * 16 * 128, TM * 128);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc);
          if (ct == 0) mbar_arrive(empty + s);  // the warpgroup is done
        }
        // dV (warpgroup 1) or dK (2, scaled) goes out through the K or V
        // buffer, the one only this warpgroup's products read, in the
        // swizzled layout, then as 16-byte stores of whole rows (Dt / 8
        // chunks a row); as fp32 (IoF32), straight from the accumulators.
        // The item is read again from shared memory (this item's until
        // kv_empty below), so that its fields hold no registers across the
        // tile loop.
        const DkdvItem out(info);
        void* dst = C == 0 ? dv : dk;
        const float mul = C == 0 ? 1.f : scale;
        if (!merge_pieces(dkdv_merge<Mask, D>(part, counters, B, H_kv), out,
                          C, flag(C), 1 + C, ct, acc)) {
          // another piece of the block writes it
        } else if constexpr (IO::kOut32) {
          store_key_rows<IO, D>(dst, acc, mul, out, BN, N_kv, Dt, r_key, 0,
                                t4);
        } else {
          uint8_t* st_sm = smem + (C == 0 ? L::K_OFF : L::V_OFF);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int rb = r_key + 8 * r;  // the key within the item
#pragma unroll
            for (int jj = 0; jj < D / 8; ++jj) {
              const int off = (jj / 8) * BN * 128 + rb * 128 +
                              (((jj % 8) ^ (rb & 7)) * 16) + t4 * 4;
              *reinterpret_cast<uint32_t*>(st_sm + off) = pack2<IO::kF16>(
                  acc[jj * 4 + 2 * r] * mul, acc[jj * 4 + 2 * r + 1] * mul);
            }
          }
          named_sync(1 + C, 128);  // the warpgroup's rows are staged
          constexpr int CH = D / 8;
          for (int i = ct; i < 64 * CH; i += 128) {
            const int rb = i / CH, ch = i % CH;
            const int row = out.kb * BN + rb;
            if (row < N_kv && ch * 8 < Dt) {
              const int off = (ch / 8) * BN * 128 + rb * 128 +
                              (((ch % 8) ^ (rb & 7)) * 16);
              const size_t o = ((size_t)out.bkh * N_kv + row) * Dt + ch * 8;
              *reinterpret_cast<uint4*>(static_cast<uint16_t*>(dst) + o) =
                  *reinterpret_cast<const uint4*>(st_sm + off);
            }
          }
        }
        // The K/V buffer is free once every consumer thread is done with
        // it; the proxy fence orders these generic accesses before the TMA
        // refill.
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(kv_empty);
      }
      // warpgroup 1 meets warpgroup 2's last arrival
      if constexpr (C == 0) {
        if (handed) named_sync(X_FREE, 256);
      }
    };
    // (tested the other way round, wg == 1 first, ptxas compiled the else
    // branch at the launch's 168 registers, not CONSUMER: every wgmma
    // serialised, C7512, and ~700 bytes of spill)
    if (wg == 2)
      consume(std::integral_constant<int, 1>{});
    else
      consume(std::integral_constant<int, 0>{});
  } else {
    // ---- consumers: warpgroup c owns keys [64 c, 64 c + 64) of an item,
    // or (SPLIT) columns [DC c, DC c + DC) of its 64 keys ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        DkdvRegs<D>::CONSUMER));
    const int c = wg - 1;
    const int ct = threadIdx.x - 128 * wg;
    const int warp = ct >> 5, lane = ct & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int k0 = SPLIT ? 0 : c * 64;  // the consumer's first key
    const int r_key = k0 + warp * 16 + g;  // keys r_key, r_key + 8
    const int col_box = SPLIT ? c * (DC / 64) : 0;  // its first column box
    int* span_sm = reinterpret_cast<int*>(smem + L::SPAN_OFF) + c * 8;
    Ring<STAGES> ring;
    for (int it = 0;; ++it) {
      const int w = snake_item(it, blockIdx.x, gridDim.x);
      if (w >= n_work()) break;
      const int kbuf = buf_of<KB>(it);
      mbar_wait(kv_full + kbuf, buf_phase<KB>(it));
      const DkdvItem item(info + kbuf * DKDV_INFO);
      const int n_tiles = group * item.n_qb * SUB;  // q tiles a pass

      // Each key's interval of visible local query rows [lo, lo + n), and
      // the hull of this warpgroup's 64 keys' intervals [w_lo, w_hi).
      int lo[2], w_lo, w_hi;
      unsigned cnt[2];
      key_spans(mask, item, BN, r_key, warp, lane, 1 + c, span_sm, lo, cnt,
                w_lo, w_hi);

      const uint8_t* ksm = smem + L::K_OFF + kbuf * L::KV_BYTES + k0 * 128;
      const uint8_t* vsm = smem + L::V_OFF + kbuf * L::KV_BYTES + k0 * 128;

      // One pass accumulates dK and dV; with two (D = 512), the first dV
      // (written out at its end) and the second dK, each in the same
      // registers (the passes are unrolled: dv_acc is dead in the second).
      float dk_acc[OR], dv_acc[OR];
      int qt = item.qb0 * SUB;
#pragma unroll
      for (int pass = 0; pass < PASSES; ++pass) {
        const bool do_dv = PASSES == 1 || pass == 0;
        const bool do_dk = PASSES == 1 || pass == 1;
#pragma unroll
        for (int i = 0; i < OR; ++i) {
          if (do_dk) dk_acc[i] = 0.f;
          if (do_dv) dv_acc[i] = 0.f;
        }
        for (int j = 0; j < n_tiles; ++j, ring.next()) {
          const int s = ring.s;
          const int q0 = qt * TM;  // the tile's first local query row
          if (++qt == (item.qb0 + item.n_qb) * SUB) qt = item.qb0 * SUB;
          mbar_wait(full + s, ring.ph);
          if (q0 >= w_hi || q0 + TM <= w_lo) {  // no key sees the tile
            named_sync(1 + c, 128);  // every warp has seen the stage's phase
            if (ct == 0) mbar_arrive(empty + s);
            continue;
          }
          const uint8_t* qs = smem + L::Q_OFF + s * L::QT_BYTES;
          const uint8_t* dos = smem + L::DO_OFF + s * L::QT_BYTES;
          const float* rs = rows_sm + s * 2 * DKDV_BM;

          // S^T = K Q^T and dP^T = V dO^T (dP^T where the pass takes dK): 64
          // keys x TM queries, D / 16 k-steps each, one commit group.
          float sacc[TM / 2], dpacc[TM / 2];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const int x = kk / 4, off = (kk % 4) * 32;
            SsMma<TM / 2, IO::kF16>::run(
                sacc, desc_sw128(ksm + x * BN * 128 + off, 16, 1024),
                desc_sw128(qs + x * TM * 128 + off, 16, 1024), kk > 0);
          }
          if (do_dk) {
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
              const int x = kk / 4, off = (kk % 4) * 32;
              SsMma<TM / 2, IO::kF16>::run(
                  dpacc, desc_sw128(vsm + x * BN * 128 + off, 16, 1024),
                  desc_sw128(dos + x * TM * 128 + off, 16, 1024), kk > 0);
            }
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(sacc);
          if (do_dk) fence_regs(dpacc);

          // P^T: accumulator i = jj * 4 + 2 r + e is key r_key + 8 r, query
          // q0 + 8 jj + 2 t4 + e; the scale folded into the exponent's FMA.
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
          // The per-cell mask on partial tiles only (a warp-uniform branch):
          // p = 0 by a select where the query is outside the key's interval.
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
          // dS^T = P^T (dP^T - delta); P^T and dS^T as 16-bit A fragments,
          // for IoF32 each as two bf16 terms (pa + pl, da + dr).
          constexpr int LO = IO::kOut32 ? TM / 16 : 1;
          uint32_t pa[TM / 16][4], da[TM / 16][4];
          uint32_t pl[LO][4], dr[LO][4];
          if (do_dk) {
#pragma unroll
            for (int jj = 0; jj < TM / 8; ++jj) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float dl = rs[DKDV_BM + jj * 8 + 2 * t4 + e];
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                  const int i = jj * 4 + 2 * r + e;
                  dpacc[i] = sacc[i] * (dpacc[i] - dl);
                }
              }
            }
          }
#pragma unroll
          for (int kk = 0; kk < TM / 16; ++kk) {
#pragma unroll
            for (int h = 0; h < 4; ++h) {
              if constexpr (IO::kOut32) {
                if (do_dv)
                  pa[kk][h] = pack_bf16_split(sacc[8 * kk + 2 * h],
                                              sacc[8 * kk + 2 * h + 1],
                                              pl[kk][h]);
                if (do_dk)
                  da[kk][h] = pack_bf16_split(dpacc[8 * kk + 2 * h],
                                              dpacc[8 * kk + 2 * h + 1],
                                              dr[kk][h]);
              } else {
                if (do_dv)
                  pa[kk][h] = pack2<IO::kF16>(sacc[8 * kk + 2 * h],
                                              sacc[8 * kk + 2 * h + 1]);
                if (do_dk)
                  da[kk][h] = pack2<IO::kF16>(dpacc[8 * kk + 2 * h],
                                              dpacc[8 * kk + 2 * h + 1]);
              }
            }
          }

          // dV += P^T dO and dK += dS^T Q: the queries are the depth, dO and
          // Q (the consumer's columns, from box col_box) read as transposed B
          // operands (box stride TM rows x 128 B); IoF32's low terms each
          // after its high term, dV's products waited for before dK's (see
          // the header).
          const int cb = col_box * TM * 128;
          wgmma_fence();
          if (do_dv) {
#pragma unroll
            for (int kk = 0; kk < TM / 16; ++kk) {
              rs_mma<OR, IO::kF16>(dv_acc, pa[kk], dos + cb + kk * 16 * 128,
                                   TM * 128);
              if constexpr (IO::kOut32)
                rs_mma<OR, false>(dv_acc, pl[kk], dos + cb + kk * 16 * 128,
                                  TM * 128);
            }
          }
          if constexpr (IO::kOut32) {
            if (do_dv && do_dk) {
              wgmma_commit();
              wgmma_wait<0>();
              fence_regs(dv_acc);
              wgmma_fence();
            }
          }
          if (do_dk) {
#pragma unroll
            for (int kk = 0; kk < TM / 16; ++kk) {
              rs_mma<OR, IO::kF16>(dk_acc, da[kk], qs + cb + kk * 16 * 128,
                                   TM * 128);
              if constexpr (IO::kOut32)
                rs_mma<OR, false>(dk_acc, dr[kk], qs + cb + kk * 16 * 128,
                                  TM * 128);
            }
          }
          wgmma_commit();
          wgmma_wait<0>();
          if (do_dv) fence_regs(dv_acc);
          if (do_dk) fence_regs(dk_acc);
          if (ct == 0) mbar_arrive(empty + s);  // the warpgroup is done
        }
        if (PASSES == 2 && pass == 0) {  // dV, straight from the registers
          const DkdvItem out(info + kbuf * DKDV_INFO);
          if (merge_pieces(dkdv_merge<Mask, D>(part, counters, B, H_kv),
                           out, 2 * c, flag(c), 1 + c, ct, dv_acc))
            store_key_rows<IO, DC>(dv, dv_acc, 1.f, out, BN, N_kv, Dt, r_key,
                                   col_box * 64, t4);
        }
      }
      if constexpr (PASSES == 2) {
        const DkdvItem out(info + kbuf * DKDV_INFO);
        if (merge_pieces(dkdv_merge<Mask, D>(part, counters, B, H_kv), out,
                         2 * c + 1, flag(c), 1 + c, ct, dk_acc))
          store_key_rows<IO, DC>(dk, dk_acc, scale, out, BN, N_kv, Dt, r_key,
                                 col_box * 64, t4);
      } else if (merge_pieces(dkdv_merge<Mask, D>(part, counters, B, H_kv),
                              DkdvItem(info + kbuf * DKDV_INFO), c,
                              flag(c), 1 + c, ct, dk_acc, dv_acc)) {
        // dK and dV go out through this warpgroup's rows (SPLIT: its column
        // boxes) of the item's K and V buffers (its products, their only
        // readers, are done; SPLIT: once both warpgroups' are), in the
        // swizzled layout, then as 16-byte stores of whole rows (Dt / 8
        // chunks a row); as fp32 (IoF32), straight from the accumulators as
        // 8-byte stores of column pairs. The item is read again from shared
        // memory (this item's until kv_empty below), so that its fields
        // hold no registers across the tile loop.
        const DkdvItem out(info + kbuf * DKDV_INFO);
        const int c0 = col_box * 64;  // the consumer's first column
        const int box0 = col_box * BN * 128;  // and its first box
        uint8_t* kb_sm = smem + L::K_OFF + kbuf * L::KV_BYTES + box0;
        uint8_t* vb_sm = smem + L::V_OFF + kbuf * L::KV_BYTES + box0;
        if constexpr (SPLIT && !IO::kOut32)
          named_sync(3, 256);  // both consumers' products have read K and V
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int rb = r_key + 8 * r;  // the key within the item
          if constexpr (IO::kOut32) {
            const int row = out.kb * BN + rb;
            const size_t o = ((size_t)out.bkh * N_kv + row) * Dt;
#pragma unroll
            for (int jj = 0; jj < DC / 8; ++jj) {
              const int col = c0 + jj * 8 + t4 * 2;
              if (row < N_kv && col < Dt) {
                *reinterpret_cast<float2*>(static_cast<float*>(dk) + o + col) =
                    make_float2(dk_acc[jj * 4 + 2 * r] * scale,
                                dk_acc[jj * 4 + 2 * r + 1] * scale);
                *reinterpret_cast<float2*>(static_cast<float*>(dv) + o + col) =
                    make_float2(dv_acc[jj * 4 + 2 * r],
                                dv_acc[jj * 4 + 2 * r + 1]);
              }
            }
          } else {
#pragma unroll
            for (int jj = 0; jj < DC / 8; ++jj) {
              const int off = (jj / 8) * BN * 128 + rb * 128 +
                              (((jj % 8) ^ (rb & 7)) * 16) + t4 * 4;
              *reinterpret_cast<uint32_t*>(kb_sm + off) =
                  pack2<IO::kF16>(dk_acc[jj * 4 + 2 * r] * scale,
                                  dk_acc[jj * 4 + 2 * r + 1] * scale);
              *reinterpret_cast<uint32_t*>(vb_sm + off) = pack2<IO::kF16>(
                  dv_acc[jj * 4 + 2 * r], dv_acc[jj * 4 + 2 * r + 1]);
            }
          }
        }
        if constexpr (!IO::kOut32) {
          named_sync(1 + c, 128);  // the warpgroup's rows are staged
          // the consumer's DC / 8 chunks a row, those past Dt not stored (see
          // hopper.cuh's forward: a constant count keeps the loop unrolled)
          constexpr int CH = DC / 8;
          for (int i = ct; i < 64 * CH; i += 128) {
            const int rb = k0 + i / CH, ch = i % CH;
            const int row = out.kb * BN + rb;
            if (row < N_kv && c0 + ch * 8 < Dt) {
              const int off = (ch / 8) * BN * 128 + rb * 128 +
                              (((ch % 8) ^ (rb & 7)) * 16);
              const size_t o =
                  ((size_t)out.bkh * N_kv + row) * Dt + c0 + ch * 8;
              *reinterpret_cast<uint4*>(static_cast<uint16_t*>(dk) + o) =
                  *reinterpret_cast<const uint4*>(kb_sm + off);
              *reinterpret_cast<uint4*>(static_cast<uint16_t*>(dv) + o) =
                  *reinterpret_cast<const uint4*>(vb_sm + off);
            }
          }
        }
      }
      // The K/V buffer is free once every consumer thread is done with it;
      // the proxy fence orders these generic accesses before the TMA
      // refill.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(kv_empty + kbuf);
    }
  }
}

// The host's pieces of a dK/dV launch (ops/flash.py dkdv_pieces): the
// piece table on the card (row 0: the number of pieces), the workspace's
// partials (fp32) and counters (int32, zero, left zero by every launch),
// and a bound on the number of pieces, which sizes the grid.
struct DkdvPieces {
  const void* table;
  void* part;
  void* counters;
  int max_pieces;
};

// Launch over a mask policy: q, dout [B*H_q, N_q, Dt], k/v [B*H_kv, N_kv,
// Dt] 16-bit (IO) contiguous, 16-byte aligned, Dt <= D, Dt % 8 == 0; lse,
// delta [B*H_q, N_q] fp32; pc the pieces (see DkdvItem, PieceMerge); dk,
// dv like k (fp32 for IoF32). Returns cudaGetLastError() of the launch.
template <int D, int STAGES, class Mask, class IO>
int launch_dkdv_d(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  const DkdvPieces& pc, void* dk, void* dv, int B, int H_q,
                  int H_kv, int N_q, int N_kv, int Dt, float scale,
                  const Mask& mask, cudaStream_t stream) {
  constexpr int smem = DkdvSmem<D, STAGES>::BYTES;
  constexpr int BN = DkdvPlan<D>::BN;
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      dkdv_wgmma_kernel<D, STAGES, Mask, IO>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);  // once
  if (attr_err != cudaSuccess) return (int)attr_err;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, q, B * H_q, N_q, Dt, DkdvPlan<D>::TM, IO::kF16) ||
      !make_map(&tdo, dout, B * H_q, N_q, Dt, DkdvPlan<D>::TM, IO::kF16) ||
      !make_map(&tk, k, B * H_kv, N_kv, Dt, BN, IO::kF16) ||
      !make_map(&tv, v, B * H_kv, N_kv, Dt, BN, IO::kF16))
    return (int)cudaErrorInvalidValue;
  const long n_work = (long)pc.max_pieces * dkdv_per<Mask>(B, H_kv);
  const int grid = (int)std::min<long>(n_work, sm_count());
  if (grid <= 0) return (int)cudaErrorInvalidValue;
  dkdv_wgmma_kernel<D, STAGES, Mask, IO>
      <<<grid, DKDV_THREADS, smem, stream>>>(
          tq, tk, tv, tdo, static_cast<const float*>(lse),
          static_cast<const float*>(delta),
          static_cast<const int*>(pc.table), static_cast<float*>(pc.part),
          static_cast<int*>(pc.counters), dk, dv, B, H_q, H_kv, N_q, N_kv,
          Dt, scale * LOG2E, scale, mask);
  return (int)cudaGetLastError();
}

// dK/dV over a mask policy at head dim D (attn_instance_d(D)) in the
// element types IO.
template <class Mask, class IO>
int launch_dkdv(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                const DkdvPieces& pc, void* dk, void* dv, int B, int H_q,
                int H_kv, int N_q, int N_kv, int D, float scale,
                const Mask& mask, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N_kv <= 0 || B * H_kv <= 0) return 0;
  if (H_kv <= 0 || H_q % H_kv != 0 || N_q < 0 || instance_d(D) == 0)
    return (int)cudaErrorInvalidValue;
  if (N_q == 0) {  // no query reads any key (and no tensor map of q)
    const size_t bytes = (size_t)B * H_kv * N_kv * D * (IO::kOut32 ? 4 : 2);
    cudaMemsetAsync(dk, 0, bytes, st);
    cudaMemsetAsync(dv, 0, bytes, st);
    return (int)cudaGetLastError();
  }
  const auto run = [&](auto di, auto stages) {
    return launch_dkdv_d<decltype(di)::value, decltype(stages)::value, Mask,
                         IO>(q, k, v, dout, lse, delta, pc, dk, dv, B, H_q,
                             H_kv, N_q, N_kv, D, scale, mask, st);
  };
  using std::integral_constant;
  switch (attn_instance_d(D)) {
    case 64:
      return run(integral_constant<int, 64>(), integral_constant<int, 3>());
    case 80:
      return run(integral_constant<int, 80>(), integral_constant<int, 2>());
    case 96:
      return run(integral_constant<int, 96>(), integral_constant<int, 2>());
    case 128:
      return run(integral_constant<int, 128>(), integral_constant<int, 2>());
    case 256:
      return run(integral_constant<int, 256>(), integral_constant<int, 2>());
  }
  return run(integral_constant<int, 512>(), integral_constant<int, 1>());
}

// dK/dV in the element types of a dtype code (DtypeCode).
template <class Mask>
int launch_dkdv_dtype(int dtype, const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      const DkdvPieces& pc, void* dk, void* dv, int B,
                      int H_q, int H_kv, int N_q, int N_kv, int D,
                      float scale, const Mask& mask, void* stream) {
  switch (dtype) {
    case kDtypeBf16:
      return launch_dkdv<Mask, IoBf16>(q, k, v, dout, lse, delta, pc, dk, dv,
                                       B, H_q, H_kv, N_q, N_kv, D, scale,
                                       mask, stream);
    case kDtypeF16:
      return launch_dkdv<Mask, IoF16>(q, k, v, dout, lse, delta, pc, dk, dv,
                                      B, H_q, H_kv, N_q, N_kv, D, scale,
                                      mask, stream);
    case kDtypeF32:
      return launch_dkdv<Mask, IoF32>(q, k, v, dout, lse, delta, pc, dk, dv,
                                      B, H_q, H_kv, N_q, N_kv, D, scale,
                                      mask, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace hopper
}  // namespace sinkattn
