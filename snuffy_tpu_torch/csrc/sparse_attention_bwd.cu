// Inverted sparse attention backward for Hopper (sm_90a), CUDA C++.
//
// Replaces snuffy_tpu/ops/pallas_attention.py::_bwd_kernel (launched by
// _bwd_call), with the dropout hash _keep_factor regenerated bit for bit
// and the segment mode (hh = head * segments + segment). Given g, the
// gradient of out = (sigma * f)^T v, per hh:
//   f      = q_valid[i] * keep(seed, hh, i, j) / (1 - rate)
//   p~     = sigma * f
//   dv_i   = sum_j p~_ij g_j
//   dsig   = (v_i . g_j) * f_ij
//   ds_ij  = sigma_ij * (dsig_ij - D_i) * slot_valid_j
//   dq_i   = scale * sum_j ds_ij k_j,   dk_j = scale * sum_i ds_ij q_i
// with the row sum D_i = sum_j sigma_ij dsig_ij = sum_j p~_ij (v_i . g_j)
// = v_i . dv_i (the "delta" of flash attention). sigma comes from the
// forward's saved row stats, exp(x - row_max) * row_scale with row_scale
// = q_valid / sum, so no softmax is run again. The slot_valid factor on ds
// follows the einsum oracle (ops/sparse_attention.py): the TPU kernel
// leaves it out, which only matters in a segment with live rows and no
// live slot, where sigma is uniform.
//
// What bounds it on the H100: the TPU kernel accumulates dk across its
// sequential N grid in VMEM. Blocks here run in no order, so the work is
// split into two passes that keep every (N, S) matrix out of device memory
// and use no atomics (the result is deterministic):
//   pass A (row_grad_kernel): one block per (64-row tile, hh). A first
//     sweep over the slots in chunks of 64 forms p~ and accumulates dv in
//     registers; then D = v . dv. A second sweep forms ds and accumulates
//     dq. Writes dv, dq and D (4 bytes a row).
//   pass B (slot_grad_kernel): one block per (64-slot chunk, hh) keeps its
//     k and g chunks in shared memory, loops over the rows in tiles of 64,
//     recomputes the scores, sigma, f and v . g, takes D, and accumulates
//     dk in registers; written once.
// Both passes run every product on CUDA cores in f32: 8 multiply-adds per
// (row, slot, dim) against the TPU kernel's 5, so this first version is
// bound by its CUDA-core FMA rate, and at one bag (h=4, S=512) pass B has
// only 4 * 512 / 64 = 32 blocks for 132 SMs. The ragged edges of N, S and
// dk are masked, nothing is padded; shared memory holds three tiles, so
// dk <= 256 fits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "sparse_attention_common.cuh"

namespace {

using namespace snuffy;

// Loads the row stats of a 64-row tile; rows past n read as dead (scale 0).
__device__ __forceinline__ void load_row_stats(float* rm, float* rs,
                                               const float* __restrict__ row_max,
                                               const float* __restrict__ row_scale,
                                               size_t base, int rows) {
  if (threadIdx.x < kRows) {
    const bool live = threadIdx.x < rows;
    rm[threadIdx.x] = live ? row_max[base + threadIdx.x] : 0.0f;
    rs[threadIdx.x] = live ? row_scale[base + threadIdx.x] : 0.0f;
  }
}

// sigma_ij and f_ij of row i (stats m, r) and slot j (code c); both 0 for a
// dead row and past the last slot.
__device__ __forceinline__ void sigma_factor(float& sigma, float& f, float score,
                                             float m, float r, float c,
                                             uint32_t seed, uint32_t hh,
                                             uint32_t row, uint32_t col,
                                             float rate, float inv_keep) {
  sigma = 0.0f;
  f = 0.0f;
  if (r != 0.0f && c >= 0.0f) {
    sigma = expf((c > 0.0f ? score : kNegBig) - m) * r;
    f = rate > 0.0f ? keep_factor(seed, hh, row, col, rate, inv_keep) : 1.0f;
  }
}

// acc[a][m] += sum_j w[row ty + 16a][j] * x[j][dim tx + 16m] over 64 j.
template <int DM>
__device__ __forceinline__ void accumulate_rows(float (&acc)[4][DM], const float* w,
                                                const float* x, int stride,
                                                int dk, int ty, int tx) {
  for (int j = 0; j < kSlots; ++j) {
    float wa[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) wa[a] = w[(ty + 16 * a) * (kSlots + 1) + j];
#pragma unroll
    for (int m = 0; m < DM; ++m) {
      const int d = tx + 16 * m;
      if (d < dk) {
        const float xv = x[j * stride + d];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][m] = fmaf(wa[a], xv, acc[a][m]);
      }
    }
  }
}

// Pass A. Grid (ceil(N / 64), heads * segments). DM = dims of dk per thread.
template <typename T, int DM>
__global__ void __launch_bounds__(kThreads)
row_grad_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ g,
                const uint8_t* __restrict__ slot_valid,
                const float* __restrict__ row_max,
                const float* __restrict__ row_scale, T* __restrict__ dq,
                T* __restrict__ dv, float* __restrict__ delta, int segments,
                int n, int s, int dk, int stride, float scale, uint32_t seed,
                float rate, float inv_keep) {
  extern __shared__ float smem[];
  float* qs = smem;                 // the block's q rows, all along
  float* cs = qs + kRows * stride;  // a chunk of k or g slots
  float* xs = cs + kSlots * stride; // g slots in sweep 1, v rows after
  float* ws = xs + kRows * stride;  // (kRows, kSlots + 1): p~, then ds
  float* code = ws + kRows * (kSlots + 1);
  float* rm = code + kSlots;
  float* rs = rm + kRows;
  float* dl = rs + kRows;

  const int hh = blockIdx.y;
  const int seg = hh % segments;
  const int r0 = blockIdx.x * kRows;
  const int rows = min(kRows, n - r0);
  const size_t rbase = (size_t)hh * n + r0;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const uint8_t* sv = slot_valid + (size_t)seg * s;

  load_tile(qs, stride, q + rbase * dk, rows, dk);
  load_row_stats(rm, rs, row_max, row_scale, rbase, rows);

  // acc[a][m]: row ty + 16a, dim tx + 16m.
  float acc[4][DM];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int m = 0; m < DM; ++m) acc[a][m] = 0.0f;

  // Sweep 1: dv = p~ g.
  for (int c0 = 0; c0 < s; c0 += kSlots) {
    const int slots = min(kSlots, s - c0);
    const size_t sbase = (size_t)hh * s + c0;
    __syncthreads();
    load_tile(cs, stride, k + sbase * dk, slots, dk);
    load_tile(xs, stride, g + sbase * dk, slots, dk);
    load_slot_codes(code, sv, c0, s);
    __syncthreads();
    float sc[4][4];
    score_tile(sc, qs, cs, stride, dk, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ty + 16 * a;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = tx + 16 * b;
        float sigma, f;
        sigma_factor(sigma, f, sc[a][b] * scale, rm[i], rs[i], code[j], seed,
                     (uint32_t)hh, (uint32_t)(r0 + i), (uint32_t)(c0 + j), rate,
                     inv_keep);
        ws[i * (kSlots + 1) + j] = sigma * f;
      }
    }
    __syncthreads();
    accumulate_rows<DM>(acc, ws, xs, stride, dk, ty, tx);
  }

  // D = v . dv; dv is written as it is.
  __syncthreads();
  load_tile(xs, stride, v + rbase * dk, rows, dk);
  __syncthreads();
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = ty + 16 * a;
    float part = 0.0f;
#pragma unroll
    for (int m = 0; m < DM; ++m) {
      const int d = tx + 16 * m;
      if (d < dk) {
        part = fmaf(xs[i * stride + d], acc[a][m], part);
        if (i < rows) store(dv + (rbase + i) * dk + d, acc[a][m]);
      }
      acc[a][m] = 0.0f;
    }
    part = reduce16_sum(part);
    if (tx == 0) {
      dl[i] = part;
      if (i < rows) delta[rbase + i] = part;
    }
  }

  // Sweep 2: ds, then dq = scale * ds k.
  for (int c0 = 0; c0 < s; c0 += kSlots) {
    const int slots = min(kSlots, s - c0);
    const size_t sbase = (size_t)hh * s + c0;
    __syncthreads();
    load_tile(cs, stride, g + sbase * dk, slots, dk);
    load_slot_codes(code, sv, c0, s);
    __syncthreads();
    float vg[4][4];
    score_tile(vg, xs, cs, stride, dk, ty, tx);
    __syncthreads();
    load_tile(cs, stride, k + sbase * dk, slots, dk);
    __syncthreads();
    float sc[4][4];
    score_tile(sc, qs, cs, stride, dk, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ty + 16 * a;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = tx + 16 * b;
        float sigma, f;
        sigma_factor(sigma, f, sc[a][b] * scale, rm[i], rs[i], code[j], seed,
                     (uint32_t)hh, (uint32_t)(r0 + i), (uint32_t)(c0 + j), rate,
                     inv_keep);
        const float live = code[j] > 0.0f ? 1.0f : 0.0f;
        ws[i * (kSlots + 1) + j] = sigma * (vg[a][b] * f - dl[i]) * live;
      }
    }
    __syncthreads();
    accumulate_rows<DM>(acc, ws, cs, stride, dk, ty, tx);
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = ty + 16 * a;
    if (i < rows) {
#pragma unroll
      for (int m = 0; m < DM; ++m) {
        const int d = tx + 16 * m;
        if (d < dk) store(dq + (rbase + i) * dk + d, scale * acc[a][m]);
      }
    }
  }
}

// Pass B. Grid (ceil(S / 64), heads * segments).
template <typename T, int DM>
__global__ void __launch_bounds__(kThreads)
slot_grad_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ g,
                 const uint8_t* __restrict__ slot_valid,
                 const float* __restrict__ row_max,
                 const float* __restrict__ row_scale,
                 const float* __restrict__ delta, T* __restrict__ dk_out,
                 int segments, int n, int s, int dk, int stride, float scale,
                 uint32_t seed, float rate, float inv_keep) {
  extern __shared__ float smem[];
  float* ks = smem;                  // the block's k slots, all along
  float* gs = ks + kSlots * stride;  // the block's g slots, all along
  float* xs = gs + kSlots * stride;  // v rows, then q rows of a tile
  float* ws = xs + kRows * stride;   // (kRows, kSlots + 1): ds
  float* code = ws + kRows * (kSlots + 1);
  float* rm = code + kSlots;
  float* rs = rm + kRows;
  float* dl = rs + kRows;

  const int hh = blockIdx.y;
  const int seg = hh % segments;
  const int c0 = blockIdx.x * kSlots;
  const int slots = min(kSlots, s - c0);
  const size_t sbase = (size_t)hh * s + c0;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile(ks, stride, k + sbase * dk, slots, dk);
  load_tile(gs, stride, g + sbase * dk, slots, dk);
  load_slot_codes(code, slot_valid + (size_t)seg * s, c0, s);

  // acc[b][m]: slot c0 + tx + 16b, dim ty + 16m.
  float acc[4][DM];
#pragma unroll
  for (int b = 0; b < 4; ++b)
#pragma unroll
    for (int m = 0; m < DM; ++m) acc[b][m] = 0.0f;

  for (int r0 = 0; r0 < n; r0 += kRows) {
    const int rows = min(kRows, n - r0);
    const size_t rbase = (size_t)hh * n + r0;
    __syncthreads();
    load_tile(xs, stride, v + rbase * dk, rows, dk);
    load_row_stats(rm, rs, row_max, row_scale, rbase, rows);
    if (threadIdx.x < kRows) {
      dl[threadIdx.x] = threadIdx.x < rows ? delta[rbase + threadIdx.x] : 0.0f;
    }
    __syncthreads();
    float vg[4][4];
    score_tile(vg, xs, gs, stride, dk, ty, tx);
    __syncthreads();
    load_tile(xs, stride, q + rbase * dk, rows, dk);
    __syncthreads();
    float sc[4][4];
    score_tile(sc, xs, ks, stride, dk, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ty + 16 * a;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = tx + 16 * b;
        float sigma, f;
        sigma_factor(sigma, f, sc[a][b] * scale, rm[i], rs[i], code[j], seed,
                     (uint32_t)hh, (uint32_t)(r0 + i), (uint32_t)(c0 + j), rate,
                     inv_keep);
        const float live = code[j] > 0.0f ? 1.0f : 0.0f;
        ws[i * (kSlots + 1) + j] = sigma * (vg[a][b] * f - dl[i]) * live;
      }
    }
    __syncthreads();
    for (int i = 0; i < rows; ++i) {
      float w[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) w[b] = ws[i * (kSlots + 1) + tx + 16 * b];
#pragma unroll
      for (int m = 0; m < DM; ++m) {
        const int d = ty + 16 * m;
        if (d < dk) {
          const float qd = xs[i * stride + d];
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[b][m] = fmaf(w[b], qd, acc[b][m]);
        }
      }
    }
  }

#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int j = tx + 16 * b;
    if (j < slots) {
#pragma unroll
      for (int m = 0; m < DM; ++m) {
        const int d = ty + 16 * m;
        if (d < dk) store(dk_out + (sbase + j) * dk + d, scale * acc[b][m]);
      }
    }
  }
}

// Dynamic shared memory of either pass: three (64, stride) tiles, the
// (64, 65) weight tile, slot codes and three per-row vectors.
constexpr size_t smem_bytes(int stride) {
  return sizeof(float) * ((size_t)3 * kRows * stride +
                          (size_t)kRows * (kSlots + 1) + kSlots + 3 * kRows);
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
  const int bytes = (int)smem_bytes(16 * DM + 1);
  err = cudaFuncSetAttribute(row_grad_kernel<T, DM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(slot_grad_kernel<T, DM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  ready.fetch_or(bit, std::memory_order_release);
  return cudaSuccess;
}

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* g;
  const void* slot_valid;
  const void* row_max;
  const void* row_scale;
  void* dq;
  void* dk;
  void* dv;
  void* delta;
  int heads, segments, n, s, dk_dim;
  float scale;
  uint32_t seed;
  float rate, inv_keep;
};

template <typename T, int DM>
cudaError_t launch(const BwdArgs& a, cudaStream_t stream) {
  const int hh = a.heads * a.segments;
  const int stride = a.dk_dim | 1;  // odd row stride: conflict-free column reads
  const size_t smem = smem_bytes(stride);
  const dim3 block(kThreads);
  const dim3 grid_a((a.n + kRows - 1) / kRows, hh);
  const dim3 grid_b((a.s + kSlots - 1) / kSlots, hh);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* g = static_cast<const T*>(a.g);
  const uint8_t* sv = static_cast<const uint8_t*>(a.slot_valid);
  const float* rm = static_cast<const float*>(a.row_max);
  const float* rs = static_cast<const float*>(a.row_scale);
  float* delta = static_cast<float*>(a.delta);

  cudaError_t err = allow_smem<T, DM>();
  if (err != cudaSuccess) return err;
  row_grad_kernel<T, DM><<<grid_a, block, smem, stream>>>(
      q, k, v, g, sv, rm, rs, static_cast<T*>(a.dq), static_cast<T*>(a.dv), delta,
      a.segments, a.n, a.s, a.dk_dim, stride, a.scale, a.seed, a.rate, a.inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  slot_grad_kernel<T, DM><<<grid_b, block, smem, stream>>>(
      q, k, v, g, sv, rm, rs, delta, static_cast<T*>(a.dk), a.segments, a.n, a.s,
      a.dk_dim, stride, a.scale, a.seed, a.rate, a.inv_keep);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const BwdArgs& a, cudaStream_t stream) {
  if (a.dk_dim <= 64) return launch<T, 4>(a, stream);
  if (a.dk_dim <= 128) return launch<T, 8>(a, stream);
  return launch<T, 16>(a, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; scale is 1 / sqrt(dk). q, v, dq, dv are
// (heads, segments * n, dk), k, g, dk (heads, segments * s, dk), all
// contiguous and of one type; masks are bool bytes. row_max and row_scale
// are the forward's f32 row stats; delta is f32 scratch; each holds
// heads * segments * n values. Launches both passes on `stream` and
// returns the cudaError_t of the launches (0 on success); it does not
// synchronise.
extern "C" int snuffy_sparse_attention_bwd(
    const void* q, const void* k, const void* v, const void* g,
    const void* slot_valid, const void* row_max, const void* row_scale, void* dq,
    void* dk, void* dv, void* delta, int heads, int segments, int n, int s,
    int dk_dim, int dtype, float scale, int seed, float rate, float inv_keep,
    void* stream) {
  if (heads < 1 || segments < 1 || n < 1 || s < 1 || dk_dim < 1 || dk_dim > 256 ||
      heads * segments > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BwdArgs a{q,  k,  v,  g,     slot_valid, row_max, row_scale,
                  dq, dk, dv, delta, heads,      segments, n,
                  s,  dk_dim, scale, static_cast<uint32_t>(seed),
                  rate, inv_keep};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch_dtype<float>(a, st));
  if (dtype == 1) return static_cast<int>(launch_dtype<__nv_bfloat16>(a, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* snuffy_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
