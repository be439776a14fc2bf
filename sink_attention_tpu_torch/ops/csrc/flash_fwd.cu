// Sink + sliding-window causal attention forward (prefill) for Hopper.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of
// sink_attention_tpu/ops/flash.py (launched by `_fwd_impl`): for every query
// row i and key j at global positions i = q_offset + row, j = kv_offset +
// col,
//     valid(i, j) = 0 <= j <= i  AND  (j < num_sink  OR  j >= i - window + 1)
// with O, the natural-log LSE and the optional per-head s_aux logit.
//
// What bounds it on the H100: at the main-path shapes (D = 64, bf16,
// GQA 64/8, W = 128 or W = N = 1024) the work is about 110 FLOP per byte of
// Q/K/V/O for W = 128 and about 450 for the full layers, against the card's
// ridge of ~295 FLOP/byte: the sliding layers are bound by memory, the full
// layers and the long headline shape by tensor-core throughput. The
// kernel is hopper.cuh's fwd_wgmma_kernel: the only road to the tensor
// cores' rate is wgmma fed by TMA with the loads in flight while the
// consumers compute (a producer warpgroup, two consumer warpgroups, a ring
// of K/V stages), and the per-cell mask only on the partial tiles.
//
// The entry point builds the three TMA descriptors per call with
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint so the
// library needs no -lcuda: q, k, v as 3-D tensors [B*H, N, D] whose rows
// past N read as zeros, boxes of 64 columns x 128 rows under the 128-byte
// swizzle.

#include <cuda.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

using sinkattn::SinkWindowMask;
using namespace sinkattn::hopper;

// cuTensorMapEncodeTiled's signature (CUDA 12.0 driver API).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_fn() {
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

// A bf16 [heads, n, D] tensor as a 3-D map of boxes [1][rows][64].
bool make_map(CUtensorMap* map, const void* base, int heads, int n, int D,
              int rows) {
  const EncodeTiledFn encode = encode_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)n,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)n * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The SMs of the current device: the persistent grid's size.
int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

template <int D, int STAGES>
int launch(const void* q, const void* k, const void* v, const void* s_aux,
           void* o, void* lse, int B, int H_q, int H_kv, int N_q, int N_kv,
           float scale, const SinkWindowMask& mask, cudaStream_t stream) {
  constexpr int smem = FwdSmem<D, STAGES>::BYTES;
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      fwd_wgmma_kernel<D, STAGES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);  // once
  if (attr_err != cudaSuccess) return (int)attr_err;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B * H_q, N_q, D, FWD_BM) ||
      !make_map(&tk, k, B * H_kv, N_kv, D, FWD_BN) ||
      !make_map(&tv, v, B * H_kv, N_kv, D, FWD_BN))
    return (int)cudaErrorInvalidValue;
  const long n_work = (long)((N_q + FWD_BM - 1) / FWD_BM) * B * H_q;
  const int grid = (int)std::min<long>(n_work, sm_count());
  if (grid <= 0) return (int)cudaErrorInvalidValue;
  fwd_wgmma_kernel<D, STAGES><<<grid, FWD_THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<const float*>(s_aux), static_cast<uint16_t*>(o),
      static_cast<float*>(lse), B, H_q, H_kv, N_q, scale * sinkattn::LOG2E,
      mask);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B*H_q, N_q, D], k/v [B*H_kv, N_kv, D] bf16 contiguous, 16-byte
// aligned; s_aux [H_q] fp32 or null; ranges [ceil(N_q/128), 4] int32 (the
// KV blocks of 128 keys each q block of 128 rows visits); o like q; lse
// [B*H_q, N_q] fp32.
extern "C" int sink_fwd_bf16(const void* q, const void* k, const void* v,
                             const void* s_aux, const void* ranges, void* o,
                             void* lse, int B, int H_q, int H_kv, int N_q,
                             int N_kv, int D, int num_sink, int window,
                             int q_offset, int kv_offset, float scale,
                             void* stream) {
  const SinkWindowMask mask{static_cast<const int*>(ranges), N_q, N_kv,
                            num_sink, window, q_offset, kv_offset};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N_q <= 0 || B * H_q <= 0) return 0;
  if (N_kv <= 0 || H_kv <= 0 || H_q % H_kv != 0)
    return (int)cudaErrorInvalidValue;
  if (D == 64)
    return launch<64, 3>(q, k, v, s_aux, o, lse, B, H_q, H_kv, N_q, N_kv,
                         scale, mask, st);
  if (D == 128)
    return launch<128, 2>(q, k, v, s_aux, o, lse, B, H_q, H_kv, N_q, N_kv,
                          scale, mask, st);
  return (int)cudaErrorInvalidValue;
}

// Tile sizes the host-side range table must use.
extern "C" int sink_fwd_block_m() { return FWD_BM; }
extern "C" int sink_fwd_block_n() { return FWD_BN; }
