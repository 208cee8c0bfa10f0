// Device helpers shared by the sparse-attention kernels
// (sparse_attention_fwd.cu, sparse_attention_bwd.cu): the tile shape, the
// dropout hash of the TPU kernel, tile loads and the 64 x 64 score tile.
// dense_attention.cu takes the block size, the type conversions and the
// 16-lane reductions from here.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace snuffy {

constexpr int kThreads = 256;  // 16 x 16: tx walks slots, ty walks rows
constexpr int kRows = 64;      // rows of q / v per tile
constexpr int kSlots = 64;     // slots of k per chunk
constexpr float kNegBig = -1e30f;
constexpr uint32_t kC1 = 0x9E3779B9u;
constexpr uint32_t kC2 = 0x85EBCA6Bu;
constexpr uint32_t kC3 = 0xC2B2AE35u;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Counter hash of pallas_attention.py::_keep_factor, in uint32: the TPU
// kernel's int32 multiplies wrap and its right shifts are logical.
__device__ __forceinline__ float keep_factor(uint32_t seed, uint32_t hh,
                                             uint32_t row, uint32_t col,
                                             float rate, float inv_keep) {
  uint32_t x = (row * kC1) ^ (col * kC2) ^ (seed + hh * kC3);
  x ^= x >> 16;
  x *= kC2;
  x ^= x >> 13;
  x *= kC3;
  x ^= x >> 16;
  const float u = static_cast<float>(x & 0xFFFFFFu) * (1.0f / 16777216.0f);
  return u >= rate ? inv_keep : 0.0f;
}

__device__ __forceinline__ float reduce16_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float reduce16_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// dst[r * stride + d] = src[r * dk + d] as f32 for r < avail, 0 beyond.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const T* __restrict__ src, int avail,
                                          int dk) {
  for (int idx = threadIdx.x; idx < kRows * dk; idx += kThreads) {
    const int r = idx / dk;
    const int d = idx - r * dk;
    dst[r * stride + d] = r < avail ? to_float(src[(size_t)r * dk + d]) : 0.0f;
  }
}

// 1 live, 0 dead (scored -1e30), -1 past the end of the slots.
__device__ __forceinline__ void load_slot_codes(float* code,
                                                const uint8_t* __restrict__ slot_valid,
                                                int c0, int s) {
  if (threadIdx.x < kSlots) {
    const int j = c0 + threadIdx.x;
    code[threadIdx.x] = j < s ? (slot_valid[j] ? 1.0f : 0.0f) : -1.0f;
  }
}

// sc[a][b] = q_row(ty + 16a) . k_slot(tx + 16b), summed over d in order.
__device__ __forceinline__ void score_tile(float (&sc)[4][4], const float* qs,
                                           const float* ks, int stride, int dk,
                                           int ty, int tx) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) sc[a][b] = 0.0f;
  for (int d = 0; d < dk; ++d) {
    float qa[4], kb[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) qa[a] = qs[(ty + 16 * a) * stride + d];
#pragma unroll
    for (int b = 0; b < 4; ++b) kb[b] = ks[(tx + 16 * b) * stride + d];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) sc[a][b] = fmaf(qa[a], kb[b], sc[a][b]);
  }
}

}  // namespace snuffy
