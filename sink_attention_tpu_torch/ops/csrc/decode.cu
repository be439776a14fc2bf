// Single-token decode attention over the rolling sink KV cache, for Hopper.
//
// Replaces the Pallas TPU kernel `_decode_kernel` of
// sink_attention_tpu/ops/decode.py (launched by `_decode_call`), in its
// three storage branches: bf16 (`sink_decode_bf16`), int8 codes
// (`sink_decode_int8`) and float8_e4m3fn codes held in int8
// (`sink_decode_fp8`), the codes with one fp32 scale per token and KV
// head. One query token per sequence attends the cache
// buffer [B, H_kv, S_total, D] in place: slots [0, sink_cap) hold the sink
// tokens, slots [sink_cap, sink_cap + window) the circular window. A slot is
// live iff
//     slot < sink_len, or
//     0 <= sw < window and age(sw) < window_len, with sw = slot - sink_cap,
//     age(sw) = (write_pos - 1 - sw) mod window   (the circular-age test).
// The per-sequence state comes from a device table lens[B, 4] =
// (sink_len, window_len, write_pos, hwm); slots at or past hwm are never
// read. The optional s_aux [H_q] enters the softmax as an extra logit with
// no value (natural-log domain).
//
// What bounds it on the H100: memory. Each live K/V byte is used for 2*G
// FLOP (G = GQA group), far below the ~295 FLOP/byte ridge, so the least
// time is the live cache bytes over 3.35 TB/s: 4*D bytes per live slot and
// KV head in bf16, 2*D + 8 (codes and two scales) when quantized.
//
// Quantized storage computes attention over the dequantized cache in fp32:
// score = (q . codes_k) * k_scale, p = exp(score - max), and the partial
// output sums p * v_scale * codes_v (the row sum takes p alone). The codes
// decode exactly: int8 by an int -> float convert, fp8 by Hopper's e4m3
// convert (cvt.rn.f16x2.e4m3x2, exact for every e4m3 value; the quantizer
// flushes subnormal codes to 0). The TPU kernel's shift-add e4m3 decode and
// its int8 rounding of q and p (for the s8 x s8 matrix unit) are not
// carried over. A thread reads its own slot's two scales from device
// memory, coalesced across the CTA.
//
// Design: split-KV in two phases, because one CTA per (b, kv head) gives
// only B*H_kv = 8..32 CTAs for 132 SMs (the TPU kernel walked the slots in
// order on one core and needed no split).
//  1. `decode_partial`: one CTA per (b*h_kv, 128-slot chunk). The chunk's K
//     and V tiles are copied to shared memory (cp.async, coalesced); thread
//     i scores slot i against all G query heads of the KV head (the GQA
//     group as rows, sharing every K/V read); block reductions give each
//     row's max and sum; the P V product reads V from shared memory. Each
//     CTA writes a normalised partial output and its LSE, or LSE = -inf when
//     the chunk holds no live slot.
//  2. `decode_merge`: one CTA per (b, h_q) merges the partials by their LSE,
//     with s_aux as one more partial of LSE s_aux and value 0 (the same sum
//     as merge_partials in ops/flash.py).
// D must be 64 or 128; G at most 16.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 128;  // slots per CTA, one per thread
constexpr int NTHREADS = CHUNK;
constexpr int MAX_G = 16;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ float bf16_to_float(uint16_t x) {
  return __uint_as_float(((uint32_t)x) << 16);
}

// The storage types. Each decodes 16 bytes of a K row to floats, and one
// V element; SCALED types carry per-token scales.
struct Bf16 {
  static constexpr int BYTES = 2;
  static constexpr bool SCALED = false;
  __device__ __forceinline__ static void decode16(uint4 raw, float* out) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      out[2 * e] = __uint_as_float(w[e] << 16);
      out[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static float decode1(const uint8_t* p) {
    return bf16_to_float(*reinterpret_cast<const uint16_t*>(p));
  }
};

struct Int8 {
  static constexpr int BYTES = 1;
  static constexpr bool SCALED = true;
  __device__ __forceinline__ static void decode16(uint4 raw, float* out) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int e = 0; e < 16; ++e)
      out[e] = (float)(int8_t)(w[e >> 2] >> (8 * (e & 3)));
  }
  __device__ __forceinline__ static float decode1(const uint8_t* p) {
    return (float)*reinterpret_cast<const int8_t*>(p);
  }
};

struct Fp8 {
  static constexpr int BYTES = 1;
  static constexpr bool SCALED = true;
  __device__ __forceinline__ static void decode16(uint4 raw, float* out) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) {  // two codes per convert, low byte first
      const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
          (__nv_fp8x2_storage_t)(w[e >> 1] >> (16 * (e & 1))), __NV_E4M3);
      const float2 f = __half22float2(__half2(h));
      out[2 * e] = f.x;
      out[2 * e + 1] = f.y;
    }
  }
  __device__ __forceinline__ static float decode1(const uint8_t* p) {
    const __half_raw h = __nv_cvt_fp8_to_halfraw(*p, __NV_E4M3);
    return __half2float(__half(h));
  }
};

template <class T, int D>
__global__ void __launch_bounds__(NTHREADS)
    decode_partial(const uint16_t* __restrict__ q,
                   const uint8_t* __restrict__ k,
                   const uint8_t* __restrict__ v,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale,
                   const int* __restrict__ lens, float* __restrict__ part_o,
                   float* __restrict__ part_lse, int H_kv, int G, int S_total,
                   int sink_cap, int window, int n_split, float scale) {
  // A padded smem row of D codes (bytes): 16-byte aligned for cp.async,
  // and the 16-byte row reads of 8 neighbouring threads hit 8 distinct
  // 4-bank groups.
  constexpr int ROW = D * T::BYTES + 16;
  constexpr int VECS = D * T::BYTES / 16;  // 16-byte copies per row
  constexpr int PER_VEC = 16 / T::BYTES;   // elements per 16 bytes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* Ks = smem_raw;             // [CHUNK][ROW]
  uint8_t* Vs = Ks + CHUNK * ROW;     // [CHUNK][ROW]
  float* Qs = reinterpret_cast<float*>(Vs + CHUNK * ROW);     // [G][D]
  float* Ps = Qs + MAX_G * D;                                 // [G][CHUNK]
  float* red = Ps + MAX_G * CHUNK;  // [NTHREADS/32][MAX_G]
  float* stat = red + (NTHREADS / 32) * MAX_G;  // [2][MAX_G]: max, sum

  const int bkv = blockIdx.y;
  const int split = blockIdx.x;
  const int b = bkv / H_kv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int sink_len = lens[b * 4 + 0];
  const int window_len = lens[b * 4 + 1];
  const int write_pos = lens[b * 4 + 2];
  const int hwm = lens[b * 4 + 3];
  const int slot0 = split * CHUNK;
  // The (b, kv head)'s query heads are rows bkv*G .. bkv*G + G - 1 of
  // q [B*H_q, D] (H_q = H_kv * G, head h reads KV head h / G).
  const size_t row0 = (size_t)bkv * G;

  if (slot0 >= hwm) {  // nothing live here: an empty partial, which the
                       // merge weighs 0 without reading its output
    for (int i = tid; i < G; i += NTHREADS)
      part_lse[(row0 + i) * n_split + split] = -INFINITY;
    return;
  }

  const size_t base = (size_t)bkv * S_total + slot0;
  const uint8_t* kg = k + base * D * T::BYTES;
  const uint8_t* vg = v + base * D * T::BYTES;
  const int n_slots = min(CHUNK, S_total - slot0);
  for (int c = tid; c < CHUNK * VECS; c += NTHREADS) {
    const int r = c / VECS, cc = c - (c / VECS) * VECS;
    const bool ok = r < n_slots;
    const size_t off = (size_t)(ok ? r : 0) * D * T::BYTES + cc * 16;
    cp_async16(Ks + r * ROW + cc * 16, kg + off, ok);
    cp_async16(Vs + r * ROW + cc * 16, vg + off, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  for (int i = tid; i < G * D; i += NTHREADS)
    Qs[i] = bf16_to_float(q[row0 * D + i]) * scale;
  float k_sc = 1.f, v_sc = 1.f;  // this thread's slot's scales
  if (T::SCALED && tid < n_slots) {
    k_sc = k_scale[base + tid];
    v_sc = v_scale[base + tid];
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // Thread tid scores slot slot0 + tid against every query row.
  const int slot = slot0 + tid;
  const int sw = slot - sink_cap;
  const int age = sw < write_pos ? write_pos - 1 - sw
                                 : write_pos - 1 - sw + window;
  const bool live = tid < n_slots &&
                    (slot < sink_len ||
                     (sw >= 0 && sw < window && age < window_len));
  float s[MAX_G];
#pragma unroll
  for (int gi = 0; gi < MAX_G; ++gi) s[gi] = 0.f;
  const uint8_t* kr = Ks + tid * ROW;
#pragma unroll 4
  for (int d0 = 0; d0 < D; d0 += PER_VEC) {
    const uint4 raw = *reinterpret_cast<const uint4*>(kr + d0 * T::BYTES);
    float kf[PER_VEC];
    T::decode16(raw, kf);
#pragma unroll
    for (int gi = 0; gi < MAX_G; ++gi) {
      if (gi < G) {
        const float* qr = Qs + gi * D + d0;
#pragma unroll
        for (int e = 0; e < PER_VEC; ++e) s[gi] = fmaf(qr[e], kf[e], s[gi]);
      }
    }
  }
  if (T::SCALED) {
#pragma unroll
    for (int gi = 0; gi < MAX_G; ++gi) s[gi] *= k_sc;
  }

  // Row max over the chunk.
#pragma unroll
  for (int gi = 0; gi < MAX_G; ++gi) {
    if (gi < G) {  // G is uniform: every lane takes the shuffles
      float x = live ? s[gi] : -INFINITY;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
      if (lane == 0) red[warp * MAX_G + gi] = x;
    }
  }
  __syncthreads();
  if (tid < G) {
    float x = -INFINITY;
    for (int w = 0; w < NTHREADS / 32; ++w) x = fmaxf(x, red[w * MAX_G + tid]);
    stat[tid] = x;
  }
  __syncthreads();

  // p = exp(s - max), row sums; P V reads p * v_scale.
#pragma unroll
  for (int gi = 0; gi < MAX_G; ++gi) {
    if (gi < G) {
      const float mx = stat[gi];
      const float p = live ? expf(s[gi] - mx) : 0.f;  // live: mx is finite
      Ps[gi * CHUNK + tid] = T::SCALED ? p * v_sc : p;
      float x = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        x += __shfl_xor_sync(0xffffffffu, x, off);
      if (lane == 0) red[warp * MAX_G + gi] = x;
    }
  }
  __syncthreads();
  if (tid < G) {
    float x = 0.f;
    for (int w = 0; w < NTHREADS / 32; ++w) x += red[w * MAX_G + tid];
    stat[MAX_G + tid] = x;
  }
  __syncthreads();

  // Partial output: (sum_slot p * V) / l for each (row, d).
  for (int i = tid; i < G * D; i += NTHREADS) {
    const int gi = i / D, d = i - (i / D) * D;
    const float* pr = Ps + gi * CHUNK;
    float a = 0.f;
#pragma unroll 8
    for (int j = 0; j < CHUNK; ++j)
      a = fmaf(pr[j], T::decode1(Vs + j * ROW + d * T::BYTES), a);
    const float l = stat[MAX_G + gi];
    part_o[((row0 + gi) * n_split + split) * D + d] = l > 0.f ? a / l : 0.f;
  }
  if (tid < G) {
    const float l = stat[MAX_G + tid];
    part_lse[(row0 + tid) * n_split + split] =
        l > 0.f ? stat[tid] + logf(l) : -INFINITY;
  }
}

// One CTA of D threads per query row (b*H_q + h): merge the partials.
template <int D>
__global__ void __launch_bounds__(D)
    decode_merge(const float* __restrict__ part_o,
                 const float* __restrict__ part_lse,
                 const float* __restrict__ s_aux, uint16_t* __restrict__ out,
                 int H_q, int n_split) {
  const int row = blockIdx.x;
  const int h = row % H_q;
  const int d = threadIdx.x;
  const float* lr = part_lse + (size_t)row * n_split;
  float m = s_aux != nullptr ? s_aux[h] : -INFINITY;
  for (int i = 0; i < n_split; ++i) m = fmaxf(m, lr[i]);
  const float m_safe = m == -INFINITY ? 0.f : m;
  float denom = s_aux != nullptr ? expf(s_aux[h] - m_safe) : 0.f;
  float a = 0.f;
  for (int i = 0; i < n_split; ++i) {
    const float w = expf(lr[i] - m_safe);  // lse = -inf: weight 0
    denom += w;
    if (w != 0.f) a = fmaf(w, part_o[((size_t)row * n_split + i) * D + d], a);
  }
  const float o = denom > 0.f ? a / denom : 0.f;
  __nv_bfloat16 ob = __float2bfloat16_rn(o);
  out[(size_t)row * D + d] = *reinterpret_cast<uint16_t*>(&ob);
}

template <class T, int D>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const void* lens, const void* s_aux,
           void* part_o, void* part_lse, void* out, int B, int H_q, int H_kv,
           int S_total, int sink_cap, int window, float scale,
           cudaStream_t stream) {
  const int G = H_q / H_kv;
  const int n_split = (S_total + CHUNK - 1) / CHUNK;
  const size_t smem = 2 * (size_t)CHUNK * (D * T::BYTES + 16) +
                      sizeof(float) * ((size_t)MAX_G * D + MAX_G * CHUNK +
                                       (NTHREADS / 32) * MAX_G + 2 * MAX_G);
  cudaError_t err = cudaFuncSetAttribute(
      decode_partial<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_partial<T, D><<<dim3(n_split, B * H_kv), NTHREADS, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint8_t*>(k),
      static_cast<const uint8_t*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(lens),
      static_cast<float*>(part_o), static_cast<float*>(part_lse), H_kv, G,
      S_total, sink_cap, window, n_split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_merge<D><<<B * H_q, D, 0, stream>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_lse),
      static_cast<const float*>(s_aux), static_cast<uint16_t*>(out), H_q,
      n_split);
  return (int)cudaGetLastError();
}

template <class T>
int dispatch(const void* q, const void* k, const void* v, const void* k_scale,
             const void* v_scale, const void* lens, const void* s_aux,
             void* part_o, void* part_lse, void* out, int B, int H_q,
             int H_kv, int S_total, int D, int sink_cap, int window,
             float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H_kv <= 0 || H_q % H_kv != 0 || H_q / H_kv > MAX_G)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S_total <= 0) return 0;
  if (D == 64)
    return launch<T, 64>(q, k, v, k_scale, v_scale, lens, s_aux, part_o,
                         part_lse, out, B, H_q, H_kv, S_total, sink_cap,
                         window, scale, st);
  if (D == 128)
    return launch<T, 128>(q, k, v, k_scale, v_scale, lens, s_aux, part_o,
                          part_lse, out, B, H_q, H_kv, S_total, sink_cap,
                          window, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [B*H_q, D] bf16; k/v [B*H_kv, S_total, D] bf16; lens [B, 4] int32;
// s_aux [H_q] fp32 or null; part_o [B*H_q, n_split, D] fp32 and
// part_lse [B*H_q, n_split] fp32 scratch (n_split = ceil(S_total / 128));
// out [B*H_q, D] bf16.
extern "C" int sink_decode_bf16(const void* q, const void* k, const void* v,
                                const void* lens, const void* s_aux,
                                void* part_o, void* part_lse, void* out, int B,
                                int H_q, int H_kv, int S_total, int D,
                                int sink_cap, int window, float scale,
                                void* stream) {
  return dispatch<Bf16>(q, k, v, nullptr, nullptr, lens, s_aux, part_o,
                        part_lse, out, B, H_q, H_kv, S_total, D, sink_cap,
                        window, scale, stream);
}

// As sink_decode_bf16, with k/v [B*H_kv, S_total, D] int8 codes and
// k_scale/v_scale [B*H_kv, S_total] fp32.
extern "C" int sink_decode_int8(const void* q, const void* k, const void* v,
                                const void* k_scale, const void* v_scale,
                                const void* lens, const void* s_aux,
                                void* part_o, void* part_lse, void* out, int B,
                                int H_q, int H_kv, int S_total, int D,
                                int sink_cap, int window, float scale,
                                void* stream) {
  return dispatch<Int8>(q, k, v, k_scale, v_scale, lens, s_aux, part_o,
                        part_lse, out, B, H_q, H_kv, S_total, D, sink_cap,
                        window, scale, stream);
}

// As sink_decode_int8, the codes float8_e4m3fn bit patterns.
extern "C" int sink_decode_fp8(const void* q, const void* k, const void* v,
                               const void* k_scale, const void* v_scale,
                               const void* lens, const void* s_aux,
                               void* part_o, void* part_lse, void* out, int B,
                               int H_q, int H_kv, int S_total, int D,
                               int sink_cap, int window, float scale,
                               void* stream) {
  return dispatch<Fp8>(q, k, v, k_scale, v_scale, lens, s_aux, part_o,
                       part_lse, out, B, H_q, H_kv, S_total, D, sink_cap,
                       window, scale, stream);
}

extern "C" int sink_decode_chunk() { return CHUNK; }
extern "C" int sink_decode_max_group() { return MAX_G; }
