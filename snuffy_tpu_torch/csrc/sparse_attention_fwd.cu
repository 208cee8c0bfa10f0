// Inverted sparse attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces snuffy_tpu/ops/pallas_attention.py::_fwd_kernel (launched by
// _fwd_call), with its in-kernel dropout hash _keep_factor and its segment
// mode (fused_packed_inverted_sparse_attention, _mask_specs segments > 1).
//
// Per folded head hh = head * segments + segment:
//   p[i, j] = softmax_j(q_i . k_j / sqrt(dk))   over the S slots of hh,
//             dead slots scored -1e30 (never -inf: an all-dead segment
//             softmaxes to a finite uniform row)
//   p[i, j] *= q_valid[i] * keep(seed, hh, i, j) / (1 - rate)
//   out[j]   = sum_i p[i, j] * v_i              accumulated in f32
// q, v are (heads, segments * N, dk); k, out are (heads, segments * S, dk),
// all contiguous and of one type (f32 or bf16); masks are bool bytes.
//
// What bounds it on the H100: the TPU kernel holds a whole (tile_n, S) f32
// score block in 16 MB of VMEM and carries the (S, dk) accumulator across
// its sequential N grid. An SM has at most 227 KB of shared memory and
// blocks run in no order, so the work is split into two passes that keep
// the (N, S) probabilities out of device memory and use no atomics:
//   pass 1 (row_stats_kernel): one block per (64-row tile, hh) streams the
//     S slots in chunks of 64 and keeps an online max and sum per row; it
//     writes the row max and q_valid / sum, 8 bytes per row.
//   pass 2 (slot_accumulate_kernel): one block per (64-slot chunk, hh)
//     keeps its k chunk in shared memory, loops over the N rows in tiles
//     of 64, recomputes the scores, forms p from the row stats and the hash,
//     and accumulates p^T v in registers; the result is written once.
// Both passes compute q.k^T, so the FLOPs are 1.5x the TPU kernel's; the
// bytes read are q twice, k once per row tile in pass 1, v once. At one
// bag (h=4, S=512) pass 2 has only 4 * 512 / 64 = 32 blocks for 132 SMs:
// this first version is bound by pass 2's occupancy and its CUDA-core FMA
// rate, not by memory. dk is handled as it is (96 at the operating point):
// the ragged edges of N, S and dk are masked here, nothing is padded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

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

// Pass 1. Grid (ceil(N / 64), heads * segments).
template <typename T>
__global__ void __launch_bounds__(kThreads)
row_stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const uint8_t* __restrict__ slot_valid,
                 const uint8_t* __restrict__ q_valid,
                 float* __restrict__ row_max, float* __restrict__ row_scale,
                 int segments, int n, int s, int dk, int stride, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kRows * stride;
  float* code = ks + kSlots * stride;

  const int hh = blockIdx.y;
  const int seg = hh % segments;
  const int r0 = blockIdx.x * kRows;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile(qs, stride, q + ((size_t)hh * n + r0) * dk, min(kRows, n - r0), dk);

  float m_run[4], l_run[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m_run[a] = -INFINITY;
    l_run[a] = 0.0f;
  }
  for (int c0 = 0; c0 < s; c0 += kSlots) {
    __syncthreads();
    load_tile(ks, stride, k + ((size_t)hh * s + c0) * dk, min(kSlots, s - c0), dk);
    load_slot_codes(code, slot_valid + (size_t)seg * s, c0, s);
    __syncthreads();

    float sc[4][4];
    score_tile(sc, qs, ks, stride, dk, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float cmax = -INFINITY;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float c = code[tx + 16 * b];
        const float x = c > 0.0f ? sc[a][b] * scale : (c == 0.0f ? kNegBig : -INFINITY);
        sc[a][b] = x;
        cmax = fmaxf(cmax, x);
      }
      // Slot c0 exists, so the chunk max is finite.
      const float new_m = fmaxf(m_run[a], reduce16_max(cmax));
      float csum = 0.0f;
#pragma unroll
      for (int b = 0; b < 4; ++b) csum += expf(sc[a][b] - new_m);
      l_run[a] = l_run[a] * expf(m_run[a] - new_m) + reduce16_sum(csum);
      m_run[a] = new_m;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = r0 + ty + 16 * a;
      if (row < n) {
        const size_t idx = (size_t)hh * n + row;
        row_max[idx] = m_run[a];
        row_scale[idx] = q_valid[(size_t)seg * n + row] ? 1.0f / l_run[a] : 0.0f;
      }
    }
  }
}

// Pass 2. Grid (ceil(S / 64), heads * segments). DM = dims of dk per thread.
template <typename T, int DM>
__global__ void __launch_bounds__(kThreads)
slot_accumulate_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const uint8_t* __restrict__ slot_valid,
                       const float* __restrict__ row_max,
                       const float* __restrict__ row_scale, T* __restrict__ out,
                       int segments, int n, int s, int dk, int stride,
                       float scale, uint32_t seed, float rate, float inv_keep) {
  extern __shared__ float smem[];
  float* ks = smem;
  float* qs = ks + kSlots * stride;
  float* vs = qs + kRows * stride;
  float* ps = vs + kRows * stride;  // (kRows, kSlots + 1)
  float* code = ps + kRows * (kSlots + 1);
  float* rm = code + kSlots;
  float* rs = rm + kRows;

  const int hh = blockIdx.y;
  const int seg = hh % segments;
  const int c0 = blockIdx.x * kSlots;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile(ks, stride, k + ((size_t)hh * s + c0) * dk, min(kSlots, s - c0), dk);
  load_slot_codes(code, slot_valid + (size_t)seg * s, c0, s);

  // acc[b][m]: slot c0 + tx + 16b, dim ty + 16m.
  float acc[4][DM];
#pragma unroll
  for (int b = 0; b < 4; ++b)
#pragma unroll
    for (int m = 0; m < DM; ++m) acc[b][m] = 0.0f;

  for (int r0 = 0; r0 < n; r0 += kRows) {
    const int rows = min(kRows, n - r0);
    __syncthreads();
    load_tile(qs, stride, q + ((size_t)hh * n + r0) * dk, rows, dk);
    load_tile(vs, stride, v + ((size_t)hh * n + r0) * dk, rows, dk);
    if (threadIdx.x < kRows) {
      const bool live = threadIdx.x < rows;
      const size_t idx = (size_t)hh * n + r0 + threadIdx.x;
      rm[threadIdx.x] = live ? row_max[idx] : 0.0f;
      rs[threadIdx.x] = live ? row_scale[idx] : 0.0f;
    }
    __syncthreads();

    float sc[4][4];
    score_tile(sc, qs, ks, stride, dk, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ty + 16 * a;
      const float f = rs[i];
      const float mi = rm[i];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = tx + 16 * b;
        const float c = code[j];
        float p = 0.0f;
        if (f != 0.0f && c >= 0.0f) {
          const float x = c > 0.0f ? sc[a][b] * scale : kNegBig;
          p = expf(x - mi) * f;
          if (rate > 0.0f) {
            p *= keep_factor(seed, (uint32_t)hh, (uint32_t)(r0 + i),
                             (uint32_t)(c0 + j), rate, inv_keep);
          }
        }
        ps[i * (kSlots + 1) + j] = p;
      }
    }
    __syncthreads();

    for (int i = 0; i < rows; ++i) {
      float pv[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) pv[b] = ps[i * (kSlots + 1) + tx + 16 * b];
#pragma unroll
      for (int m = 0; m < DM; ++m) {
        const int d = ty + 16 * m;
        if (d < dk) {
          const float vv = vs[i * stride + d];
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[b][m] = fmaf(pv[b], vv, acc[b][m]);
        }
      }
    }
  }

#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int j = c0 + tx + 16 * b;
    if (j < s) {
#pragma unroll
      for (int m = 0; m < DM; ++m) {
        const int d = ty + 16 * m;
        if (d < dk) store(out + ((size_t)hh * s + j) * dk + d, acc[b][m]);
      }
    }
  }
}

// Dynamic shared memory of each pass for a row stride of `stride` floats.
constexpr size_t smem_pass1(int stride) {
  return sizeof(float) * ((size_t)(kRows + kSlots) * stride + kSlots);
}
constexpr size_t smem_pass2(int stride) {
  return sizeof(float) * ((size_t)(kSlots + 2 * kRows) * stride +
                          (size_t)kRows * (kSlots + 1) + kSlots + 2 * kRows);
}

// Raises both passes' dynamic shared-memory limit to what the largest dk
// of the instance (16 * DM) needs, once per device and template instance.
template <typename T, int DM>
cudaError_t allow_smem() {
  constexpr int kMaxDevices = 64;
  static std::atomic<uint64_t> ready{0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const uint64_t bit = device < kMaxDevices ? uint64_t{1} << device : 0;
  if (ready.load(std::memory_order_acquire) & bit) return cudaSuccess;
  constexpr int max_stride = 16 * DM + 1;
  err = cudaFuncSetAttribute(row_stats_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_pass1(max_stride));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(slot_accumulate_kernel<T, DM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_pass2(max_stride));
  if (err != cudaSuccess) return err;
  ready.fetch_or(bit, std::memory_order_release);
  return cudaSuccess;
}

template <typename T, int DM>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* slot_valid, const void* q_valid, void* out,
                   void* row_max, void* row_scale, int heads, int segments,
                   int n, int s, int dk, float scale, uint32_t seed, float rate,
                   float inv_keep, cudaStream_t stream) {
  const int hh = heads * segments;
  const int stride = dk | 1;  // odd row stride: conflict-free column reads
  const size_t smem1 = smem_pass1(stride);
  const size_t smem2 = smem_pass2(stride);
  const dim3 block(kThreads);
  const dim3 grid1((n + kRows - 1) / kRows, hh);
  const dim3 grid2((s + kSlots - 1) / kSlots, hh);

  cudaError_t err = allow_smem<T, DM>();
  if (err != cudaSuccess) return err;
  row_stats_kernel<T><<<grid1, block, smem1, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const uint8_t*>(slot_valid), static_cast<const uint8_t*>(q_valid),
      static_cast<float*>(row_max), static_cast<float*>(row_scale), segments, n, s,
      dk, stride, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  slot_accumulate_kernel<T, DM><<<grid2, block, smem2, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(slot_valid), static_cast<const float*>(row_max),
      static_cast<const float*>(row_scale), static_cast<T*>(out), segments, n, s, dk,
      stride, scale, seed, rate, inv_keep);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const void* q, const void* k, const void* v,
                         const void* slot_valid, const void* q_valid, void* out,
                         void* row_max, void* row_scale, int heads, int segments,
                         int n, int s, int dk, float scale, uint32_t seed,
                         float rate, float inv_keep, cudaStream_t stream) {
  if (dk <= 64)
    return launch<T, 4>(q, k, v, slot_valid, q_valid, out, row_max, row_scale, heads,
                        segments, n, s, dk, scale, seed, rate, inv_keep, stream);
  if (dk <= 128)
    return launch<T, 8>(q, k, v, slot_valid, q_valid, out, row_max, row_scale, heads,
                        segments, n, s, dk, scale, seed, rate, inv_keep, stream);
  return launch<T, 16>(q, k, v, slot_valid, q_valid, out, row_max, row_scale, heads,
                       segments, n, s, dk, scale, seed, rate, inv_keep, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; scale is 1 / sqrt(dk). row_max and
// row_scale are f32 scratch of heads * segments * n values each. Launches
// on `stream` and returns the cudaError_t of the launches (0 on success);
// it does not synchronise.
extern "C" int snuffy_sparse_attention_fwd(
    const void* q, const void* k, const void* v, const void* slot_valid,
    const void* q_valid, void* out, void* row_max, void* row_scale, int heads,
    int segments, int n, int s, int dk, int dtype, float scale, int seed,
    float rate, float inv_keep, void* stream) {
  if (heads < 1 || segments < 1 || n < 1 || s < 1 || dk < 1 || dk > 256 ||
      heads * segments > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t useed = static_cast<uint32_t>(seed);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_dtype<float>(q, k, v, slot_valid, q_valid, out, row_max, row_scale,
                              heads, segments, n, s, dk, scale, useed, rate, inv_keep, st);
  } else if (dtype == 1) {
    err = launch_dtype<__nv_bfloat16>(q, k, v, slot_valid, q_valid, out, row_max,
                                      row_scale, heads, segments, n, s, dk, scale,
                                      useed, rate, inv_keep, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* snuffy_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
