// Sink attention forward for Hopper: a warp-specialised kernel on wgmma,
// TMA and mbarriers, written once over a mask policy (attention.cuh's
// SinkWindowMask in flash_fwd.cu, packed.cu's PackedMask); and the building
// blocks it shares with the dQ kernel of hopper_dq.cuh and the dK/dV kernel
// of hopper_bwd.cuh (mbarriers, named barriers, TMA loads and tensor maps,
// wgmma descriptors and wrappers, the per-row mask of a partial tile, the
// ring of stages and the snake walk of a persistent grid).
//
// It computes O, the natural-log LSE counting s_aux, and s_aux as a
// value-less logit, for every query row over the keys the policy makes
// visible to it. Its consumers' tile step is a compile-time policy:
// FwdSoftmax below is the forward's; ablation.cu's stages (the forward cut
// to one piece of its softmax) are the others, on the same producer, ring,
// items, Q buffers and O store.
//
// Design:
//  * a persistent grid, one CTA of three warpgroups per SM, walking the
//    work items (b*h_q, 128-row q block), longest first (FwdItem):
//    warpgroup 0 produces (setmaxnreg gives its registers to the
//    consumers: 40 against 232), warpgroups 1 and 2 are consumers, 64
//    query rows each;
//  * one producer thread loads each item's Q once, into one of two Q
//    buffers, and walks the q block's two ranges of KV blocks from the
//    host table (the sink blocks, then the window blocks), 128 keys a tile,
//    into a ring of STAGES (K, V) stages, each with a full barrier for K,
//    one for V (TMA completes them by bytes) and an empty barrier each
//    consumer warpgroup arrives at once (after its wgmma wait, which is
//    warpgroup-wide); it hands each item's table row and the seed of m to
//    the consumers in shared memory beside the Q buffer (released with Q's
//    barrier); it runs ahead into the next item while the consumers finish
//    this one, so an item's prologue and epilogue overlap its neighbours'
//    loads (the short sliding-window items need that);
//  * producer warp 1 writes, beside the Q buffer, each of the item's rows'
//    runs of visible keys from the policy (row_span: a sink run and a
//    window run; none past N_q) and the hull of each consumer's 64 rows'
//    runs, with plain loads (a pack's segment starts); the Q buffer's full
//    barrier counts the TMA bytes and warp 1's 32 arrivals;
//  * Q, K and V land in shared memory in 128-byte-swizzled boxes of 64
//    columns (a D = 128 row is two boxes); TMA zero-fills rows past N_q
//    and N_kv, and the columns past the tensors' head dim Dt where the
//    instance's D is larger, so the products over those zero columns add
//    nothing and only Dt columns are written. Which instance runs a Dt
//    (Dt <= 512, Dt % 8 == 0) differs by kernel: the forward, dQ
//    (hopper_dq.cuh) and dK/dV take the narrow instances of 80 (Dt
//    65-80) and 96 (81-96) columns and otherwise the one of 64, 128, 256
//    or 512 (attn_instance_d); the ablation's stages run 65-128 in the
//    128 instance (instance_d);
//  * the narrow instances keep the 128 instance's tile plan and shared
//    memory (two boxes a row, box 1 zero-filled past Dt) but compute on
//    D columns only: S = Q K^T takes D / 16 = 5 or 6 k-steps, not 8, and
//    O += P V is an m64n64k16 over box 0 beside an m64n16k16 (80) or
//    m64n32k16 (96) over the first columns of box 1 (rs_mma), so O holds
//    40 or 48 fp32 registers a thread, not 64;
//  * the instance of D = 256 has its own tile plan (FwdPlan): two Q
//    buffers of 128 x 256 would take 128 KB and a 128-key K/V stage 128
//    KB more, past the 227 KB a block has; it keeps one Q buffer (64 KB)
//    and two stages of 64-key K and V tiles (2 x 64 KB): 192 KB. Its
//    consumers hold O in 128 fp32 registers a thread (64 rows x 256), S of
//    a 64-key tile in 32 (m64n64) and P in 16, under CONSUMER_REGS; O +=
//    P V is two m64n128k16 products a 16-key step, one per half of V's
//    columns (rs_mma). The next item's Q load waits for this item's end
//    (one buffer): the items are long (a W = 4096 item walks 64 tiles);
//  * the instance of D = 512 (FwdPlan) splits O's columns, not the rows:
//    O of 64 rows x 512 would take 256 fp32 registers a thread, and a
//    128 x 512 Q tile 128 KB. An item is 64 query rows (one half of a
//    128-row q block of the host's tables: the halves are items of their
//    own, so a half walks its block's KV range and skips the tiles its
//    rows' hull leaves out); both consumers compute the same S = Q K^T of
//    the item's 64 rows (depth 512) and the same softmax (bit for bit: the
//    same products in the same order), and consumer c accumulates O's
//    columns [256 c, 256 c + 256) only (128 registers, as at D = 256),
//    reading those columns of V. S is computed twice: 6 D FLOPs a pair
//    against the 4 D the bound counts. Shared memory: one 64 x 512 Q
//    buffer (64 KB) and two stages of 32-key K and V (2 x 64 KB): 192 KB.
//    The epilogue stages each consumer's columns through its own boxes of
//    the Q buffer after both consumers' last S products (a barrier of the
//    two warpgroups), since each read every box;
//  * S = Q K^T is wgmma m64n128k16 with both operands in shared memory;
//    the online softmax runs on the accumulators in the exp2 domain (the
//    scale folded into the exponent's FMA, ex2.approx), seeded with
//    m = s_aux*log2e, l = 1 (exact for every input); P is rounded to the
//    input type (bf16, or fp16: the Io types below) in registers and is
//    the A operand of O += P V (wgmma m64nDk16, V from shared memory as a
//    transposed B operand). The two consumer
//    warpgroups overlap each other's products and softmax. (Overlapping
//    the softmax with the previous tile's P V inside a warpgroup was
//    tried: ptxas then serialises the products, 25% slower at D = 128);
//  * the mask: each warp decides per tile, by one vote over its 16 rows'
//    runs, whether the tile is whole for them, and applies the per-cell
//    mask only on partial tiles (the diagonal, the window and sink edges,
//    a segment start inside the tile, the N edge, slots before the
//    sequence start): one unsigned compare per run and cell, the sink run
//    only where a row's sink run meets the tile (a pack's later segments
//    have their sinks inside the window range); masked cells give p = 0 by
//    a select of the score (exp2 of -inf is 0), so a row that sees nothing
//    gives 0 and not NaN;
//  * a consumer whose 64 rows see no key of a tile (outside the hull of
//    their runs: an earlier segment's tiles, for a 64-row half of an item
//    that lies after a segment start) waits on the stage and releases it
//    without its products: exact, since a wholly masked tile changes
//    neither m, l nor O (where the softmax policy allows it, kSkipDead).
//    Its four warps meet at a named barrier before the release: with no
//    product to hold them together, a warp could otherwise still wait on
//    the stage when the producer refills it, see its parity come round
//    again and wait for a phase that never completes;
//  * the mask, the softmax and P's pack are the consumers' tile step, a
//    compile-time policy (FwdSoftmax below; ablation.cu's stages cut it to
//    one piece of the softmax on this same pipeline);
//  * O goes out in the input type through the warpgroup's rows of the
//    item's Q buffer (then free) as 16-byte stores of whole rows (as fp32
//    for IoF32: straight from the accumulators); the Q buffer is
//    released to the producer after that. The LSE (natural log, -inf for
//    a row that sees nothing and has no s_aux) is written for the backward
//    kernels.

#pragma once

#include <cuda.h>

#include <algorithm>
#include <climits>

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

// Wait until the barrier's phase of parity `parity` has completed. After
// 2^28 failed polls it traps (the launch fails); as try_wait may suspend
// the thread between polls, that bounds no time (hopper_wide.cuh's
// mbar_wait_timed does).
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
// (descriptors), both K-major; fp32 accumulators d[64]; A and B bf16, or
// fp16 where F16.
#define SINK_WGMMA_SS_N128(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "l"(da), "l"(db), "r"(scale_d))
template <bool F16 = false>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  if constexpr (F16)
    SINK_WGMMA_SS_N128("f16");
  else
    SINK_WGMMA_SS_N128("bf16");
}
#undef SINK_WGMMA_SS_N128

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]: A and B from shared memory
// (descriptors), both K-major; fp32 accumulators d[32]; A and B bf16, or
// fp16 where F16.
#define SINK_WGMMA_SS_N64(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "l"(da), "l"(db), "r"(scale_d))
template <bool F16 = false>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  if constexpr (F16)
    SINK_WGMMA_SS_N64("f16");
  else
    SINK_WGMMA_SS_N64("bf16");
}
#undef SINK_WGMMA_SS_N64

// D[64 x 32] (+)= A[64 x 16] B[16 x 32]: A and B from shared memory
// (descriptors), both K-major; fp32 accumulators d[16]; A and B bf16, or
// fp16 where F16.
#define SINK_WGMMA_SS_N32(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
      : "l"(da), "l"(db), "r"(scale_d))
template <bool F16 = false>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  if constexpr (F16)
    SINK_WGMMA_SS_N32("f16");
  else
    SINK_WGMMA_SS_N32("bf16");
}
#undef SINK_WGMMA_SS_N32

// D[64 x 64] += A[64 x 16] B[16 x 64]: A from registers (16-bit
// pairs), B from shared memory, MN-major (transposed); d[32]; A and B bf16, or
// fp16 where F16.
#define SINK_WGMMA_RS_N64(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))
template <bool F16 = false>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  if constexpr (F16)
    SINK_WGMMA_RS_N64("f16");
  else
    SINK_WGMMA_RS_N64("bf16");
}
#undef SINK_WGMMA_RS_N64

// D[64 x 16] += A[64 x 16] B[16 x 16]: A from registers (16-bit pairs), B
// from shared memory, MN-major (transposed); d[8]; A and B bf16, or fp16
// where F16. B is the first 16 columns of a 64-column swizzle atom (a
// narrow instance's second box).
#define SINK_WGMMA_RS_N16(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))
template <bool F16 = false>
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  if constexpr (F16)
    SINK_WGMMA_RS_N16("f16");
  else
    SINK_WGMMA_RS_N16("bf16");
}
#undef SINK_WGMMA_RS_N16

// D[64 x 32] += A[64 x 16] B[16 x 32]: as wgmma_rs_n16, 32 columns; d[16].
#define SINK_WGMMA_RS_N32(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))
template <bool F16 = false>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  if constexpr (F16)
    SINK_WGMMA_RS_N32("f16");
  else
    SINK_WGMMA_RS_N32("bf16");
}
#undef SINK_WGMMA_RS_N32

// D[64 x 128] += A[64 x 16] B[16 x 128]: A from registers (16-bit
// pairs), B from shared memory, MN-major (transposed); d[64]; A and B bf16, or
// fp16 where F16.
#define SINK_WGMMA_RS_N128(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))
template <bool F16 = false>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  if constexpr (F16)
    SINK_WGMMA_RS_N128("f16");
  else
    SINK_WGMMA_RS_N128("bf16");
}
#undef SINK_WGMMA_RS_N128

// D (+)= A B over N / 2 accumulators a thread (N = 32, 64 or 128
// columns), both operands from shared memory, K-major; bf16, or fp16 where
// F16.
template <int N, bool F16 = false>
struct SsMma;
template <bool F16>
struct SsMma<16, F16> {
  __device__ __forceinline__ static void run(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
    wgmma_ss_n32<F16>(d, da, db, scale_d);
  }
};
template <bool F16>
struct SsMma<32, F16> {
  __device__ __forceinline__ static void run(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
    wgmma_ss_n64<F16>(d, da, db, scale_d);
  }
};
template <bool F16>
struct SsMma<64, F16> {
  __device__ __forceinline__ static void run(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
    wgmma_ss_n128<F16>(d, da, db, scale_d);
  }
};

template <int N, bool F16 = false>
struct RsMma;
template <bool F16>
struct RsMma<8, F16> {
  __device__ __forceinline__ static void run(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    wgmma_rs_n16<F16>(d, a, db, 1);
  }
};
template <bool F16>
struct RsMma<16, F16> {
  __device__ __forceinline__ static void run(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    wgmma_rs_n32<F16>(d, a, db, 1);
  }
};
template <bool F16>
struct RsMma<32, F16> {
  __device__ __forceinline__ static void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    wgmma_rs_n64<F16>(d, a, db, 1);
  }
};
template <bool F16>
struct RsMma<64, F16> {
  __device__ __forceinline__ static void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    wgmma_rs_n128<F16>(d, a, db, 1);
  }
};

// D += A B over OR accumulators a thread, A a 16-deep register fragment,
// B from shared memory at `b` as the transposed (MN-major) operand, its
// 64-column boxes `lbo` bytes apart: one wgmma m64n(2 OR)k16 for OR = 32
// or 64; for OR = 128 (256 columns) two m64n128k16, on the accumulators of
// columns [0, 128) and [128, 256) (boxes 0-1 and 2-3); for the narrow
// instances' OR = 40 and 48 (80 and 96 columns) an m64n64k16 over box 0
// and an m64n16k16 or m64n32k16 over the first columns of box 1, split at
// the box boundary (no product's B crosses from a whole swizzle atom into
// a part of one).
template <int OR, bool F16 = false>
__device__ __forceinline__ void rs_mma(float (&d)[OR], const uint32_t (&a)[4],
                                       const uint8_t* b, uint32_t lbo) {
  if constexpr (OR == 128) {
    RsMma<64, F16>::run(*reinterpret_cast<float(*)[64]>(&d[0]), a,
                        desc_sw128(b, lbo, 1024));
    RsMma<64, F16>::run(*reinterpret_cast<float(*)[64]>(&d[64]), a,
                        desc_sw128(b + 2 * lbo, lbo, 1024));
  } else if constexpr (OR == 40 || OR == 48) {
    RsMma<32, F16>::run(*reinterpret_cast<float(*)[32]>(&d[0]), a,
                        desc_sw128(b, lbo, 1024));
    RsMma<OR - 32, F16>::run(*reinterpret_cast<float(*)[OR - 32]>(&d[32]), a,
                             desc_sw128(b + lbo, lbo, 1024));
  } else {
    RsMma<OR, F16>::run(d, a, desc_sw128(b, lbo, 1024));
  }
}

// What an instance reads and writes. Q, K, V (and dO) are 16-bit, the
// wgmma's A and B type: bf16, or fp16 where kF16. The outputs (O, dQ, dK,
// dV) are written in that type from the fp32 accumulators, or where kOut32
// as fp32 (fp32 callers: the host rounds the inputs to bf16 once, as the
// TPU's matrix unit reads fp32 at its default precision, and the
// accumulators are stored unrounded; the backward kernels carry P and dS
// as two bf16 terms, attention.cuh's pack_bf16_split).
struct IoBf16 {
  static constexpr bool kF16 = false, kOut32 = false;
};
struct IoF16 {
  static constexpr bool kF16 = true, kOut32 = false;
};
struct IoF32 {
  static constexpr bool kF16 = false, kOut32 = true;
};

// The kernels' dtype codes (the C entry points' `dtype`): 0 bf16, 1 fp16,
// 2 fp32 (inputs rounded to bf16 by the host, fp32 outputs).
enum DtypeCode { kDtypeBf16 = 0, kDtypeF16 = 1, kDtypeF32 = 2 };

// The instance head dim D_i of a head dim D in the ablation, and the key
// of the host's tile tables (a narrow instance walks the 128 instance's
// tiles): the smallest of 64, 128, 256 and 512 that holds it; 0 (refused)
// for D > 512 or D % 8 != 0 (TMA takes a row stride of whole 16 bytes:
// the host pads such a D).
__host__ __device__ constexpr int instance_d(int D) {
  return (D <= 0 || D % 8 != 0) ? 0
         : D <= 64              ? 64
         : D <= 128             ? 128
         : D <= 256             ? 256
         : D <= 512             ? 512
                                : 0;
}

// The instance head dim of D in the forward, dQ and dK/dV: as
// instance_d, but D 65-80 runs in the narrow instance of 80 columns and
// 81-96 in that of 96 (the 128 instance's tiles computed on fewer
// columns; see the header).
__host__ __device__ constexpr int attn_instance_d(int D) {
  return instance_d(D) != 128 ? instance_d(D)
         : D <= 80            ? 80
         : D <= 96            ? 96
                              : 128;
}

// The width in shared memory of an instance's rows: whole 64-column boxes
// (a narrow instance's rows take two, as the 128 instance's).
__host__ __device__ constexpr int smem_d(int D) { return (D + 63) / 64 * 64; }

// Which of QB buffers holds item `it`, and the parity of that buffer's
// barriers for it (QB = 1 or 2).
template <int QB>
__device__ __forceinline__ int buf_of(int it) {
  return QB == 1 ? 0 : it & 1;
}
template <int QB>
__device__ __forceinline__ int buf_phase(int it) {
  return QB == 1 ? it & 1 : (it >> 1) & 1;
}

// --- host: tensor maps and the persistent grid --------------------------------

// cuTensorMapEncodeTiled's signature (CUDA 12.0 driver API).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint so that a
// library needs no -lcuda; null where the driver does not give it.
inline EncodeTiledFn encode_fn() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &status);
#endif
    return (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A bf16 (fp16 where f16) [heads, n, D] tensor as a 3-D map of boxes
// [1][rows][64] under the 128-byte swizzle; rows past n and columns past D
// read as zeros (so an instance of D_i > D computes on zero columns). D %
// 8 == 0: TMA takes row strides of whole 16 bytes.
inline bool make_map(CUtensorMap* map, const void* base, int heads, int n,
                     int D, int rows, bool f16 = false) {
  const EncodeTiledFn encode = encode_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)n,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)n * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map,
                f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                3,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The SMs of the current device: a persistent grid's size.
inline int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// The forward's tile plan at instance head dim D: keys per K/V tile, Q
// buffers, query rows per item and whether the consumers split O's
// columns. 128 keys, two Q buffers and 128-row items at D = 64 and 128
// (and the narrow 80 and 96);
// at D = 256 (see the header) 64 keys and one Q buffer, so that two K/V
// stages fit; at D = 512 32 keys, one Q buffer and 64-row items (halves of
// the host's 128-row q blocks) whose O columns the consumers split.
template <int D>
struct FwdPlan {
  static constexpr int BN = D == 512 ? 32 : D == 256 ? 64 : FWD_BN;
  static constexpr int QB = D >= 256 ? 1 : 2;
  static constexpr bool SPLIT = D == 512;
  static constexpr int BM = SPLIT ? 64 : FWD_BM;  // query rows per item
  static constexpr int HALVES = FWD_BM / BM;      // items per q block
};

// Keys per K/V tile of the instance of head dim D (the host keys its
// tables on it).
__host__ __device__ constexpr int fwd_bn(int D) {
  return D == 512   ? FwdPlan<512>::BN
         : D == 256 ? FwdPlan<256>::BN
                    : FwdPlan<128>::BN;
}

// Shared-memory layout of one CTA (byte offsets; every tile 1024-aligned).
template <int D, int STAGES>
struct FwdSmem {
  static constexpr int QB = FwdPlan<D>::QB;           // Q buffers
  static constexpr int BOXES = smem_d(D) / 64;       // 64-column boxes a row
  static constexpr int Q_BYTES = FwdPlan<D>::BM * BOXES * 128;  // one Q tile
  static constexpr int KV_BYTES = FwdPlan<D>::BN * BOXES * 128;  // K or V tile
  static constexpr int Q_OFF = 0;                     // QB Q tiles
  static constexpr int K_OFF = Q_OFF + QB * Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  // per Q buffer: RowSpan [128], the two consumers' hulls int [2][2]
  static constexpr int ROWS_BYTES = FWD_BM * 16 + 16;
  static constexpr int ROW_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = ROW_OFF + QB * ROWS_BYTES;
  // q_full[QB], q_empty[QB], then k_full, v_full, empty [STAGES] each
  static constexpr int N_BARS = 2 * QB + 3 * STAGES;
  static constexpr int INFO_OFF = BAR_OFF + N_BARS * 8;  // int [QB][8]
  static constexpr int BYTES = INFO_OFF + QB * 8 * 4 + 1024;  // + alignment
  // a softmax policy's own shared memory (kSmem bytes), if any
  static constexpr int OWN_OFF = (INFO_OFF + QB * 8 * 4 + 1023) / 1024 * 1024;
  template <int OWN>
  static constexpr int bytes() { return OWN ? OWN_OFF + OWN + 1024 : BYTES; }
};

// Keys [c0, c0 + n) lie wholly in one of the row's runs.
__device__ __forceinline__ bool span_covers(const RowSpan& r, int c0, int n) {
  return (c0 >= r.win_lo && c0 + n <= r.win_lo + r.win_n) ||
         (c0 >= r.sink_lo && c0 + n <= r.sink_lo + r.sink_n);
}

// The row's sink run meets keys [c0, c0 + n).
__device__ __forceinline__ bool sink_meets(const RowSpan& r, int c0, int n) {
  return r.sink_n > 0 && r.sink_lo < c0 + n && r.sink_lo + r.sink_n > c0;
}

// One warp writes the runs of rows [row0, row0 + 128) of batch row b (none
// past N_q) into span_sm[128], and into hull_sm[2 c], hull_sm[2 c + 1] the
// hull [lo, hi) of the runs of rows [64 c, 64 c + 64) (lo > hi where they
// see no key).
template <class Mask>
__device__ __forceinline__ void stage_row_spans(const Mask& mask, int b,
                                                int row0, int N_q, int lane,
                                                RowSpan* span_sm,
                                                int* hull_sm) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = c * 64 + h * 32 + lane;
      const RowSpan sp = row0 + r < N_q ? mask.row_span(b, row0 + r)
                                        : RowSpan{0, 0, 0, 0};
      span_sm[r] = sp;
      if (sp.win_n > 0) {
        lo = min(lo, sp.win_lo);
        hi = max(hi, sp.win_lo + sp.win_n);
      }
      if (sp.sink_n > 0) {
        lo = min(lo, sp.sink_lo);
        hi = max(hi, sp.sink_lo + sp.sink_n);
      }
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if (lane == 0) {
      hull_sm[2 * c] = lo;
      hull_sm[2 * c + 1] = hi;
    }
  }
}

// The per-cell mask of a partial tile of N / 4 8-key chunks: the thread's
// keys jl0 + o (o = 8 jj + e, e in {0, 1}) of its two rows (attention.cuh's
// RowSpan); a masked cell becomes `fill` by a select (-inf on a score, 0 on
// a probability). Each run test is one unsigned compare; SINKS adds the
// sink run.
template <bool SINKS, int N>
__device__ __forceinline__ void mask_tile(float (&sacc)[N],
                                          const RowSpan (&rows)[2], int jl0,
                                          float fill) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int wl = rows[r].win_lo - jl0, sl = rows[r].sink_lo - jl0;
    const unsigned wn = rows[r].win_n, sn = rows[r].sink_n;
#pragma unroll
    for (int jj = 0; jj < N / 4; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int o = jj * 8 + e;
        bool vis = (unsigned)(o - wl) < wn;
        if (SINKS) vis = vis || (unsigned)(o - sl) < sn;
        float& x = sacc[jj * 4 + 2 * r + e];
        x = vis ? x : fill;
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

// The per-cell mask of a tile of 2 N keys (N accumulators a thread) on
// the warp's partial tiles only (a warp-uniform branch): unless one vote
// finds the tile whole for every row of the warp, a masked score of the
// thread's two rows becomes -inf by a select (exp2 of -inf is 0), the
// sink run tested only where a row's sink run meets the tile.
template <int N>
__device__ __forceinline__ void mask_partial(float (&sacc)[N],
                                             const RowSpan (&rows)[2],
                                             int col0, int t4) {
  const bool whole =
      __all_sync(0xffffffffu, span_covers(rows[0], col0, 2 * N) &&
                                  span_covers(rows[1], col0, 2 * N));
  if (!whole) {
    if (__any_sync(0xffffffffu, sink_meets(rows[0], col0, 2 * N) ||
                                    sink_meets(rows[1], col0, 2 * N)))
      mask_tile<true>(sacc, rows, col0 + t4 * 2, -INFINITY);
    else
      mask_tile<false>(sacc, rows, col0 + t4 * 2, -INFINITY);
  }
}

// P (S's accumulators, 64 rows x 2 N keys) as bf16 (fp16 where F16)
// wgmma A fragments: the accumulator layout of a 16-key step is the
// register A layout.
template <bool F16 = false, int N>
__device__ __forceinline__ void pack_p(const float (&sacc)[N],
                                       uint32_t (&pa)[N / 8][4]) {
#pragma unroll
  for (int jj = 0; jj < N / 8; ++jj) {
    pa[jj][0] = pack2<F16>(sacc[8 * jj + 0], sacc[8 * jj + 1]);
    pa[jj][1] = pack2<F16>(sacc[8 * jj + 2], sacc[8 * jj + 3]);
    pa[jj][2] = pack2<F16>(sacc[8 * jj + 4], sacc[8 * jj + 5]);
    pa[jj][3] = pack2<F16>(sacc[8 * jj + 6], sacc[8 * jj + 7]);
  }
}

// The forward's tile step, one policy of fwd_wgmma_kernel's consumers (the
// stages of ablation.cu are the others). A policy says whether a consumer
// skips the tiles outside its rows' hull (kSkipDead: exact only where a
// wholly masked tile changes nothing), how many bytes of shared memory of
// its own the CTA keeps for it (kSmem, 1024-aligned: `own` below) and
// whether the kernel writes the LSE (kLse). Every thread calls init() once
// before the CTA's first barrier; per item, begin_item() may rewrite the
// consumer's Q rows before its first product; per tile, tile() masks S,
// updates m, l and O's scale and packs P as A fragments, sum() may issue
// products of its own beside P V's and done() finishes l once they are
// waited for; inv_l() is the output's divisor. The forward: the scale
// folded into the exponent's FMA, m seeded with s_aux*log2e and l with 1
// (the producer's seed), dead tiles skipped, a row that sees nothing
// gives 0. P is packed as the instance's input type (fp16 where F16).
template <bool F16 = false>
struct FwdSoftmax {
  static constexpr bool kSkipDead = true;
  static constexpr int kSmem = 0;
  static constexpr bool kLse = true;
  struct Tile {};  // what a tile keeps from tile() to done(): nothing

  __device__ __forceinline__ void init(uint8_t*, int) const {}
  template <int BOXES>
  __device__ __forceinline__ void begin_item(uint8_t*, int, int) const {}

  // Online softmax in the exp2 domain, rows r_loc (e < 2) and r_loc + 8
  // (e >= 2): m is kept scaled, the scale folded into the exponent's FMA
  // (scale > 0, so the max of raw scores serves).
  template <class Mask, int NS, int OR>
  __device__ __forceinline__ void tile(const Mask&, float (&sacc)[NS],
                                       float (&oacc)[OR],
                                       uint32_t (&pa)[NS / 8][4],
                                       float (&m)[2], float (&l)[2],
                                       const RowSpan (&rows)[2], int col0,
                                       int, int, int t4, float scale_log2,
                                       const uint8_t*, Tile&) const {
    mask_partial(sacc, rows, col0, t4);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < NS / 4; ++jj)
        mx = fmaxf(mx, fmaxf(sacc[jj * 4 + 2 * r], sacc[jj * 4 + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx * scale_log2);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = fast_exp2(m[r] - m_use);  // m = -inf: 0
      m[r] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < NS / 4; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p =
              fast_exp2(fmaf(sacc[jj * 4 + 2 * r + e], scale_log2, -m_use));
          sacc[jj * 4 + 2 * r + e] = p;
          rs += p;
        }
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[r] = l[r] * alpha + rs;
#pragma unroll
      for (int jj = 0; jj < OR / 4; ++jj) {
        oacc[jj * 4 + 2 * r] *= alpha;
        oacc[jj * 4 + 2 * r + 1] *= alpha;
      }
    }
    pack_p<F16>(sacc, pa);
  }

  template <int NP>
  __device__ __forceinline__ void sum(const uint32_t (&)[NP][4],
                                      const uint8_t*, Tile&) const {}
  __device__ __forceinline__ void done(float (&)[2], Tile&) const {}
  __device__ __forceinline__ float inv_l(float l) const {
    return l == 0.f ? 0.f : 1.f / l;
  }
};

// A position in a ring of STAGES stages: the stage and the parity of its
// barriers' phase, stepped tile by tile across items (no division).
template <int STAGES>
struct Ring {
  int s = 0, ph = 0;
  __device__ __forceinline__ void next() {
    if (++s == STAGES) {
      s = 0;
      ph ^= 1;
    }
  }
};

// The i-th item of a CTA among G of a persistent grid, in a snake over the
// items sorted longest first: round i takes items i * G + cta, or
// i * G + G - 1 - cta on odd rounds, so the long and the short items of two
// rounds pair up. Increases with i, so a CTA stops at its first past the
// last item.
__device__ __forceinline__ int snake_item(int i, int cta, int G) {
  return i * G + ((i & 1) ? G - 1 - cta : cta);
}

// A work item: one 128-row q block of one (batch, query head) (at D = 512
// each 64-row half of it is an item: FwdPlan), and the KV blocks it visits
// (the sink range, then the window range) from the policy's table,
// longest first. Where the policy keeps one table for every
// batch row (SinkWindowMask) the order is implicit: the last q blocks,
// across all heads, then the earlier. Where it keeps a table per batch row
// (PackedMask) unit w / H_q of the host's order table is a (b, block) pair
// b * n_qb + block, most KV blocks first (a pack's longest blocks are each
// segment's last, not the pack's), and w % H_q the head, so the heads of a
// KV group run side by side and share their K/V tiles in L2. The producer
// hands the item to the consumers in shared memory beside its Q buffer
// (with the seed of m), so their item starts wait on no global load.
struct FwdItem {
  int b, qb, bh, h, kvh, sb0, wb0, n_sink_blocks, n_blocks;
  int row0;  // the item's first query row (read back from shared memory)
  template <class Mask>
  __device__ __forceinline__ FwdItem(int w, const int* order, int n_qb,
                                     int B, int H_q, int H_kv,
                                     const Mask& mask) {
    if constexpr (Mask::kBatchTables) {
      const int u = order[w / H_q];
      h = w - (w / H_q) * H_q;
      b = u / n_qb;
      qb = u - b * n_qb;
      bh = b * H_q + h;
    } else {
      const int BH = B * H_q;
      qb = n_qb - 1 - w / BH;
      bh = w - (w / BH) * BH;
      b = bh / H_q;
      h = bh - b * H_q;
    }
    kvh = b * H_kv + h / (H_q / H_kv);
    const int* rg = mask.q_block(b, qb);
    sb0 = rg[0];
    wb0 = rg[2];
    n_sink_blocks = max(rg[1] - sb0, 0);
    n_blocks = n_sink_blocks + max(rg[3] - wb0, 0);
    row0 = qb * FWD_BM;
  }
  __device__ __forceinline__ void store(int* info, float m0,
                                        int first_row) const {
    info[0] = qb;
    info[1] = bh;
    info[2] = sb0;
    info[3] = wb0;
    info[4] = n_sink_blocks;
    info[5] = n_blocks;
    info[6] = __float_as_int(m0);
    info[7] = first_row;
  }
  __device__ __forceinline__ explicit FwdItem(const int* info)
      : b(0), qb(info[0]), bh(info[1]), h(0), kvh(0), sb0(info[2]),
        wb0(info[3]), n_sink_blocks(info[4]), n_blocks(info[5]),
        row0(info[7]) {}
  __device__ __forceinline__ int block(int t) const {
    return t < n_sink_blocks ? sb0 + t : wb0 + (t - n_sink_blocks);
  }
};

// Persistent: each CTA walks the work items blockIdx.x, + gridDim.x, ...;
// the producer runs ahead into the next item (its Q into the other Q
// buffer, its K/V tiles into the ring) while the consumers finish this
// one, so one item's epilogue overlaps the next one's loads (with one Q
// buffer, FwdPlan at D = 256 and 512, the next item starts once this
// one's Q buffer is released; at D = 512 work item w is half w % 2 of the
// q block of unit w / 2). `order` is
// the host's order table where Mask::kBatchTables, else unused. The
// consumers' tile step is the policy `softmax` (FwdSoftmax: the forward).
// D is the instance's head dim, Dt <= D the tensors' (their row length):
// the columns past Dt are zeros in shared memory and are not written. IO
// is the element types (IoBf16, IoF16, IoF32).
template <int D, int STAGES, class Mask, class Softmax = FwdSoftmax<>,
          class IO = IoBf16>
__global__ void __launch_bounds__(FWD_THREADS, 1)
    fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const float* __restrict__ s_aux,
                     const int* __restrict__ order, void* __restrict__ o,
                     float* __restrict__ lse, int B, int H_q, int H_kv,
                     int N_q, int Dt, float scale_log2, Mask mask,
                     Softmax softmax) {
  using L = FwdSmem<D, STAGES>;
  constexpr int BN = FwdPlan<D>::BN;  // keys per K/V tile
  constexpr int QB = L::QB;           // Q buffers
  constexpr bool SPLIT = FwdPlan<D>::SPLIT;  // consumers split O's columns
  constexpr int BM = FwdPlan<D>::BM;         // query rows per item
  constexpr int HALVES = FwdPlan<D>::HALVES;  // items per q block
  constexpr int DC = SPLIT ? D / 2 : D;      // a consumer's O columns
  constexpr int OR = DC / 2;                 // O accumulators a thread
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + QB;
  uint64_t* k_full = bars + 2 * QB;
  uint64_t* v_full = bars + 2 * QB + STAGES;
  uint64_t* empty = bars + 2 * QB + 2 * STAGES;
  int* info = reinterpret_cast<int*>(smem + L::INFO_OFF);  // [Q buffer][8]

  const int n_qb = (N_q + FWD_BM - 1) / FWD_BM;
  const int n_work = n_qb * B * H_q * HALVES;

  if (threadIdx.x == 0) {
    for (int i = 0; i < QB; ++i) {
      mbar_init(q_full + i, 1 + 32);     // the TMA thread and warp 1's lanes
      mbar_init(q_empty + i, 2 * 128);   // every consumer thread, per item
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  softmax.init(smem + L::OWN_OFF, threadIdx.x);
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
    if (warp == 0 && lane == 0) {
      // ---- one thread issues every TMA load ----
      Ring<STAGES> ring;
      int it = 0;
      for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++it) {
        const FwdItem item(w / HALVES, order, n_qb, B, H_q, H_kv, mask);
        const int row0 = item.row0 + (w % HALVES) * BM;
        const int qs = buf_of<QB>(it);
        mbar_wait(q_empty + qs, buf_phase<QB>(it) ^ 1);
        item.store(info + qs * 8,
                   s_aux != nullptr ? s_aux[item.h] * LOG2E : -INFINITY,
                   row0);
        mbar_expect_tx(q_full + qs, L::Q_BYTES);  // releases the info too
#pragma unroll
        for (int x = 0; x < L::BOXES; ++x)
          tma_load_3d(smem + L::Q_OFF + qs * L::Q_BYTES + x * BM * 128,
                      &tm_q, q_full + qs, x * 64, row0, item.bh);
        for (int j = 0; j < item.n_blocks; ++j, ring.next()) {
          const int s = ring.s;
          mbar_wait(empty + s, ring.ph ^ 1);
          const int row = item.block(j) * BN;
          mbar_expect_tx(k_full + s, L::KV_BYTES);
#pragma unroll
          for (int x = 0; x < L::BOXES; ++x)
            tma_load_3d(smem + L::K_OFF + s * L::KV_BYTES + x * BN * 128,
                        &tm_k, k_full + s, x * 64, row, item.kvh);
          mbar_expect_tx(v_full + s, L::KV_BYTES);
#pragma unroll
          for (int x = 0; x < L::BOXES; ++x)
            tma_load_3d(smem + L::V_OFF + s * L::KV_BYTES + x * BN * 128,
                        &tm_v, v_full + s, x * 64, row, item.kvh);
        }
      }
    } else if (warp == 1) {
      // ---- warp 1: the item's rows' runs of visible keys ----
      int it = 0;
      for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++it) {
        const FwdItem item(w / HALVES, order, n_qb, B, H_q, H_kv, mask);
        const int qs = buf_of<QB>(it);
        mbar_wait(q_empty + qs, buf_phase<QB>(it) ^ 1);
        RowSpan* span_sm =
            reinterpret_cast<RowSpan*>(smem + L::ROW_OFF + qs * L::ROWS_BYTES);
        // (at D = 512 the item's 64 rows and the 64 after them: hull 0 is
        // the item's)
        stage_row_spans(mask, item.b, item.row0 + (w % HALVES) * BM, N_q,
                        lane, span_sm,
                        reinterpret_cast<int*>(span_sm + FWD_BM));
        __syncwarp();
        mbar_arrive(q_full + qs);  // release: the runs are visible
      }
    }
  } else {
    // ---- consumers: warpgroup c owns rows [64 c, 64 c + 64) of a block,
    // or (SPLIT) O's columns [DC c, DC c + DC) of the item's 64 rows ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int c = wg - 1;
    const int ct = threadIdx.x - 128 * wg;
    const int lane = ct & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int rw0 = SPLIT ? 0 : c * 64;  // the consumer's first row
    const int r_loc = rw0 + (ct >> 5) * 16 + g;  // rows r_loc, r_loc + 8
    const int hc = SPLIT ? 0 : c;  // the hull of the consumer's rows
    const int c0 = SPLIT ? c * DC : 0;  // its first O column
    Ring<STAGES> ring;
    int it = 0;
    const bool use_aux = s_aux != nullptr;
    for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++it) {
      const int qs = buf_of<QB>(it);
      mbar_wait(q_full + qs, buf_phase<QB>(it));
      const FwdItem item(info + qs * 8);
      const RowSpan* span_sm = reinterpret_cast<const RowSpan*>(
          smem + L::ROW_OFF + qs * L::ROWS_BYTES);
      const int* hull_sm = reinterpret_cast<const int*>(span_sm + FWD_BM);
      const RowSpan rows[2] = {span_sm[r_loc], span_sm[r_loc + 8]};
      const int h_lo = hull_sm[2 * hc], h_hi = hull_sm[2 * hc + 1];
      float m[2], l[2];
      m[0] = m[1] = __int_as_float(info[qs * 8 + 6]);
      l[0] = l[1] = use_aux ? 1.f : 0.f;
      float oacc[OR], sacc[BN / 2];
#pragma unroll
      for (int i = 0; i < OR; ++i) oacc[i] = 0.f;

      softmax.template begin_item<L::BOXES>(smem + L::Q_OFF + qs * L::Q_BYTES,
                                            c, ct);
      const uint8_t* qsm = smem + L::Q_OFF + qs * L::Q_BYTES + rw0 * 128;
      for (int j = 0; j < item.n_blocks; ++j, ring.next()) {
        const int s = ring.s;
        const uint8_t* ks = smem + L::K_OFF + s * L::KV_BYTES;
        const uint8_t* vs = smem + L::V_OFF + s * L::KV_BYTES;
        const int col0 = item.block(j) * BN;
        mbar_wait(k_full + s, ring.ph);
        if (Softmax::kSkipDead &&
            (col0 >= h_hi || col0 + BN <= h_lo)) {  // no row sees it
          mbar_wait(v_full + s, ring.ph);
          named_sync(1 + c, 128);  // every warp has seen the stage's phase
          if (ct == 0) mbar_arrive(empty + s);
          continue;
        }

        // S = Q K^T: 64 rows x BN keys, D / 16 k-steps.
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int x = kk / 4, off = (kk % 4) * 32;
          SsMma<BN / 2, IO::kF16>::run(
              sacc, desc_sw128(qsm + x * BM * 128 + off, 16, 1024),
              desc_sw128(ks + x * BN * 128 + off, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sacc);

        // The policy's mask and softmax; P as A fragments.
        uint32_t pa[BN / 16][4];
        typename Softmax::Tile tile;
        softmax.tile(mask, sacc, oacc, pa, m, l, rows, col0, item.row0,
                     r_loc, t4, scale_log2, smem + L::OWN_OFF, tile);
        mbar_wait(v_full + s, ring.ph);
        wgmma_fence();
#pragma unroll
        for (int jj = 0; jj < BN / 16; ++jj)
          rs_mma<OR, IO::kF16>(oacc, pa[jj],
                               vs + (c0 / 64) * BN * 128 + jj * 16 * 128,
                               BN * 128);
        softmax.sum(pa, smem + L::OWN_OFF, tile);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(oacc);
        softmax.done(l, tile);
        if (ct == 0) mbar_arrive(empty + s);  // the warpgroup is done
      }

      // O goes out through this warpgroup's rows (SPLIT: its column
      // boxes) of the item's Q buffer (its S products, the last readers,
      // are done; SPLIT: once both warpgroups' are), in Q's swizzled
      // layout, then as 16-byte stores of whole rows (Dt / 8 chunks a
      // row); as fp32 (IoF32), straight from the accumulators as 8-byte
      // stores of column pairs.
      uint8_t* qbuf = smem + L::Q_OFF + qs * L::Q_BYTES;
      if constexpr (SPLIT && !IO::kOut32)
        named_sync(3, 256);  // both consumers' products have read Q
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rb = r_loc + r * 8;  // the row within the item
        const int row = item.row0 + rb;
        const float inv = softmax.inv_l(l[r]);
        if constexpr (IO::kOut32) {
          float* orow =
              static_cast<float*>(o) + ((size_t)item.bh * N_q + row) * Dt;
#pragma unroll
          for (int jj = 0; jj < DC / 8; ++jj) {
            const int col = c0 + jj * 8 + t4 * 2;
            if (row < N_q && col < Dt)
              *reinterpret_cast<float2*>(orow + col) =
                  make_float2(oacc[jj * 4 + 2 * r] * inv,
                              oacc[jj * 4 + 2 * r + 1] * inv);
          }
        } else {
#pragma unroll
          for (int jj = 0; jj < DC / 8; ++jj) {
            const int jg = c0 / 8 + jj;  // the row's 16-byte chunk
            *reinterpret_cast<uint32_t*>(
                qbuf + (jg / 8) * BM * 128 + rb * 128 +
                (((jg % 8) ^ (rb & 7)) * 16) + t4 * 4) =
                pack2<IO::kF16>(oacc[jj * 4 + 2 * r] * inv,
                                oacc[jj * 4 + 2 * r + 1] * inv);
          }
        }
        if (Softmax::kLse && (!SPLIT || c == 0) && t4 == 0 && row < N_q)
          lse[(size_t)item.bh * N_q + row] =
              l[r] == 0.f ? -INFINITY : m[r] * LN2 + logf(l[r]);
      }
      if constexpr (!IO::kOut32) {
        named_sync(1 + c, 128);  // the warpgroup's rows are staged
        // the consumer's DC / 8 16-byte chunks a row, those past Dt not
        // stored (a constant count: a second loop over Dt / 8 chunks for
        // a narrower Dt made the D = 64 forward 4-6% slower at the main
        // path's shapes, though it never ran there)
        constexpr int CH = DC / 8;
        uint16_t* o16 = static_cast<uint16_t*>(o);
        for (int i = ct; i < 64 * CH; i += 128) {
          const int rb = rw0 + i / CH, ch = c0 / 8 + i % CH;
          const int row = item.row0 + rb;
          if (row < N_q && ch * 8 < Dt)
            *reinterpret_cast<uint4*>(
                o16 + ((size_t)item.bh * N_q + row) * Dt + ch * 8) =
                *reinterpret_cast<const uint4*>(
                    qbuf + (ch / 8) * BM * 128 + rb * 128 +
                    (((ch % 8) ^ (rb & 7)) * 16));
        }
      }
      // The Q buffer (and its rows' runs) is free once every consumer
      // thread is done with it; the proxy fence orders these generic
      // accesses before the TMA refill.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(q_empty + qs);
    }
  }
}

// Launch over a mask policy: q [B*H_q, N_q, Dt], k/v [B*H_kv, N_kv, Dt]
// 16-bit (IO) contiguous, 16-byte aligned, Dt <= D and Dt % 8 == 0;
// s_aux [H_q] fp32 or null; order the host's units longest first where
// Mask::kBatchTables (see FwdItem), else null; o like q (fp32 for IoF32);
// lse [B*H_q, N_q] fp32 (unused where the softmax policy writes none). The
// three TMA descriptors are built per call: rows past N and columns past
// Dt read as zeros, boxes of 64 columns x FwdPlan's BM rows (Q) or BN
// rows (K, V) under the 128-byte swizzle. Returns cudaGetLastError() of
// the launch.
template <int D, int STAGES, class Mask, class Softmax, class IO>
int launch_fwd_d(const void* q, const void* k, const void* v,
                 const void* s_aux, const void* order, void* o, void* lse,
                 int B, int H_q, int H_kv, int N_q, int N_kv, int Dt,
                 float scale, const Mask& mask, const Softmax& softmax,
                 cudaStream_t stream) {
  constexpr int smem =
      FwdSmem<D, STAGES>::template bytes<Softmax::kSmem>();
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      fwd_wgmma_kernel<D, STAGES, Mask, Softmax, IO>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);  // once
  if (attr_err != cudaSuccess) return (int)attr_err;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B * H_q, N_q, Dt, FwdPlan<D>::BM, IO::kF16) ||
      !make_map(&tk, k, B * H_kv, N_kv, Dt, FwdPlan<D>::BN, IO::kF16) ||
      !make_map(&tv, v, B * H_kv, N_kv, Dt, FwdPlan<D>::BN, IO::kF16))
    return (int)cudaErrorInvalidValue;
  const long n_work =
      (long)((N_q + FWD_BM - 1) / FWD_BM) * B * H_q * FwdPlan<D>::HALVES;
  const int grid = (int)std::min<long>(n_work, sm_count());
  if (grid <= 0) return (int)cudaErrorInvalidValue;
  fwd_wgmma_kernel<D, STAGES, Mask, Softmax, IO>
      <<<grid, FWD_THREADS, smem, stream>>>(
          tq, tk, tv, static_cast<const float*>(s_aux),
          static_cast<const int*>(order), o, static_cast<float*>(lse), B,
          H_q, H_kv, N_q, Dt, scale * LOG2E, mask, softmax);
  return (int)cudaGetLastError();
}

// The forward over a mask policy at head dim D (any D <= 512 with D % 8
// == 0, run by the instance of attn_instance_d(D)) in the element
// types IO.
template <class Mask, class Softmax = FwdSoftmax<>, class IO = IoBf16>
int launch_fwd(const void* q, const void* k, const void* v,
               const void* s_aux, const void* order, void* o, void* lse,
               int B, int H_q, int H_kv, int N_q, int N_kv, int D,
               float scale, const Mask& mask, void* stream,
               const Softmax& softmax = Softmax()) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N_q <= 0 || B * H_q <= 0) return 0;
  if (N_kv <= 0 || H_kv <= 0 || H_q % H_kv != 0)
    return (int)cudaErrorInvalidValue;
  const int di = attn_instance_d(D);
  if (di == 64)
    return launch_fwd_d<64, 3, Mask, Softmax, IO>(
        q, k, v, s_aux, order, o, lse, B, H_q, H_kv, N_q, N_kv, D, scale,
        mask, softmax, st);
  if (di == 80)
    return launch_fwd_d<80, 2, Mask, Softmax, IO>(
        q, k, v, s_aux, order, o, lse, B, H_q, H_kv, N_q, N_kv, D, scale,
        mask, softmax, st);
  if (di == 96)
    return launch_fwd_d<96, 2, Mask, Softmax, IO>(
        q, k, v, s_aux, order, o, lse, B, H_q, H_kv, N_q, N_kv, D, scale,
        mask, softmax, st);
  if (di == 128)
    return launch_fwd_d<128, 2, Mask, Softmax, IO>(
        q, k, v, s_aux, order, o, lse, B, H_q, H_kv, N_q, N_kv, D, scale,
        mask, softmax, st);
  if (di == 256)
    return launch_fwd_d<256, 2, Mask, Softmax, IO>(
        q, k, v, s_aux, order, o, lse, B, H_q, H_kv, N_q, N_kv, D, scale,
        mask, softmax, st);
  if (di == 512)
    return launch_fwd_d<512, 2, Mask, Softmax, IO>(
        q, k, v, s_aux, order, o, lse, B, H_q, H_kv, N_q, N_kv, D, scale,
        mask, softmax, st);
  return (int)cudaErrorInvalidValue;
}

// The forward in the element types of a dtype code (DtypeCode).
template <class Mask>
int launch_fwd_dtype(int dtype, const void* q, const void* k, const void* v,
                     const void* s_aux, const void* order, void* o, void* lse,
                     int B, int H_q, int H_kv, int N_q, int N_kv, int D,
                     float scale, const Mask& mask, void* stream) {
  switch (dtype) {
    case kDtypeBf16:
      return launch_fwd<Mask, FwdSoftmax<false>, IoBf16>(
          q, k, v, s_aux, order, o, lse, B, H_q, H_kv, N_q, N_kv, D, scale,
          mask, stream);
    case kDtypeF16:
      return launch_fwd<Mask, FwdSoftmax<true>, IoF16>(
          q, k, v, s_aux, order, o, lse, B, H_q, H_kv, N_q, N_kv, D, scale,
          mask, stream);
    case kDtypeF32:
      return launch_fwd<Mask, FwdSoftmax<false>, IoF32>(
          q, k, v, s_aux, order, o, lse, B, H_q, H_kv, N_q, N_kv, D, scale,
          mask, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace hopper
}  // namespace sinkattn
