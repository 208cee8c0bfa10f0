// Dense masked self-attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces snuffy_tpu/ops/experimental/dense_attention.py::_kernel (:40,
// launched by _kernel_call :81) and the TPU probes that compute the same
// function with other blockings:
//   P1 tools/profile_vit_attention3.py:65 fused_attention (one head a loop step)
//   P2 tools/profile_vit_attention4.py:65 fused (heads unrolled)
//   P3 tools/profile_vit_attention5.py:62 fused (one batched dot)
//   P4 tools/profile_vit8_attention2.py:60 fused (ViT-S/8, n=785)
//
// For each z (batch x head) and every query row i < n:
//   s[i, j] = q_i . k_j * scale      in f32, over the keys j < n
//   s[i, j] = -1e30                  for n_valid <= j < n (never -inf)
//   p[i, j] = T(exp(s[i, j] - max_j s[i, j]) / sum_j exp(...))
//             the softmax in f32, rounded once to the input type T
//   out[i]  = T(sum_j p[i, j] * v_j) accumulated in f32
// q, k, v and out are (z, n, dk), contiguous, all f32 or all bf16.
//
// What bounds it on the H100: at ViT-S/16 (n=197, z=1536, dk=64, bf16) the
// bytes, 4 * z * n * dk * 2 B = 155 MB over 3.35 TB/s = 46 us; at ViT-S/8
// (n=785, z=768) the operations, 4 * z * n * n_valid * dk = 121 GFLOP over
// the 989.4 TFLOP/s bf16 tensor-core peak = 122 us. The TPU kernel holds a
// whole (bz, n_pad, n_pad) f32 score block in VMEM and pads n to 128. An SM
// has 227 KB of shared memory and blocks run in no order, so here one block
// owns 64 query rows of one z and sweeps the keys twice in tiles of 64:
//   pass 1 keeps an online max and sum for each row;
//   pass 2 recomputes the scores, forms p exactly as the reference does
//     (divided by the final sum, rounded to T) and accumulates p . v in
//     registers.
// Two passes cost 3 tile products where a one-pass kernel needs 2, and buy
// the reference's rounding of p. The scores never reach device memory,
// nothing is padded in device memory, and the ragged edges of n and dk are
// masked here. Two bodies:
//   bf16 with dk <= 128 (the ViTs): 4 warps, 16 rows each, q . k^T and
//     p . v on the tensor cores (mma.sync m16n8k16, bf16 in, f32 sums;
//     ldmatrix from bf16 tiles, dk padded to 32, 64 or 128 in shared
//     memory); p goes from the score fragment to the A fragment of p . v
//     in registers.
//   f32, or dk > 128: 256 threads, every product on CUDA cores in f32
//     (float4 shared-memory reads, 16 FMAs a read), 4 rows x 4 dims a
//     thread for each 64 dims of dk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <atomic>

#include "sparse_attention_common.cuh"

namespace {

using namespace snuffy;

constexpr int kTile = 64;             // query rows per block, keys per tile
constexpr int kPStride = kTile + 4;   // row stride of the p tile

// ---- The CUDA-core body: f32, or dk > 128. ----

template <typename T>
__device__ __forceinline__ float round_as(float x);
template <>
__device__ __forceinline__ float round_as<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_as<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// dst[r * stride + d] = src[r * dk + d] as f32 for r < avail and d < dk,
// 0 elsewhere, for r < kTile and d < width.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int stride, int width,
                                          const T* __restrict__ src, int avail,
                                          int dk) {
  for (int idx = threadIdx.x; idx < kTile * width; idx += kThreads) {
    const int r = idx / width;
    const int d = idx - r * width;
    dst[r * stride + d] =
        (r < avail && d < dk) ? to_float(src[(size_t)r * dk + d]) : 0.0f;
  }
}

// sc[a][b] = q_row(ty + 16a) . k_row(tx + 16b) over d < dkp, in order of d.
// The row stride is 4 (mod 32) floats, so the 8 lanes of each quarter warp
// read 8 different rows from 8 different groups of 4 banks.
__device__ __forceinline__ void score_tile4(float (&sc)[4][4], const float* qs,
                                            const float* ks, int stride, int dkp,
                                            int ty, int tx) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) sc[a][b] = 0.0f;
  for (int d = 0; d < dkp; d += 4) {
    float4 qa[4], kb[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      qa[a] = *reinterpret_cast<const float4*>(qs + (ty + 16 * a) * stride + d);
#pragma unroll
    for (int b = 0; b < 4; ++b)
      kb[b] = *reinterpret_cast<const float4*>(ks + (tx + 16 * b) * stride + d);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        float s = fmaf(qa[a].x, kb[b].x, sc[a][b]);
        s = fmaf(qa[a].y, kb[b].y, s);
        s = fmaf(qa[a].z, kb[b].z, s);
        sc[a][b] = fmaf(qa[a].w, kb[b].w, s);
      }
  }
}

__device__ __forceinline__ void fma4(float4& acc, float p, const float4& v) {
  acc.x = fmaf(p, v.x, acc.x);
  acc.y = fmaf(p, v.y, acc.y);
  acc.z = fmaf(p, v.z, acc.z);
  acc.w = fmaf(p, v.w, acc.w);
}

// Shared memory of a block: q, k and v tiles of 64 rows, and the p tile.
template <int DV>
__host__ __device__ constexpr int row_stride() {
  return 64 * DV + 4;
}
template <int DV>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)3 * kTile * row_stride<DV>() + (size_t)kTile * kPStride);
}

// Grid: z * row_blocks blocks in one dimension, the 64-row blocks of one z
// adjacent (they read the same k and v). DV = 64-dim groups of dk.
template <typename T, int DV>
__global__ void __launch_bounds__(kThreads)
dense_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int n,
                       int n_valid, int dk, int row_blocks, float scale) {
  extern __shared__ float4 smem4[];
  constexpr int kWidth = 64 * DV;
  constexpr int kStride = row_stride<DV>();
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kTile * kStride;
  float* vs = ks + kTile * kStride;
  float* ps = vs + kTile * kStride;

  const int zi = blockIdx.x / row_blocks;
  const int r0 = (blockIdx.x - zi * row_blocks) * kTile;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t base = (size_t)zi * n * dk;
  const int dkp = (dk + 3) & ~3;

  load_rows(qs, kStride, kWidth, q + base + (size_t)r0 * dk, min(kTile, n - r0), dk);

  // Pass 1: the row max and the sum of exp(s - max).
  float m_run[4], l_run[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m_run[a] = -INFINITY;
    l_run[a] = 0.0f;
  }
  for (int c0 = 0; c0 < n; c0 += kTile) {
    __syncthreads();
    load_rows(ks, kStride, kWidth, k + base + (size_t)c0 * dk, min(kTile, n - c0), dk);
    __syncthreads();
    float sc[4][4];
    score_tile4(sc, qs, ks, kStride, dkp, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float cmax = -INFINITY;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = c0 + tx + 16 * b;
        const float x = j < n_valid ? sc[a][b] * scale : (j < n ? kNegBig : -INFINITY);
        sc[a][b] = x;
        cmax = fmaxf(cmax, x);
      }
      // Key c0 exists, so the tile max is finite.
      const float new_m = fmaxf(m_run[a], reduce16_max(cmax));
      float csum = 0.0f;
#pragma unroll
      for (int b = 0; b < 4; ++b) csum += expf(sc[a][b] - new_m);
      l_run[a] = l_run[a] * expf(m_run[a] - new_m) + reduce16_sum(csum);
      m_run[a] = new_m;
    }
  }

  // Pass 2: p tile by tile, rounded to T, and out += p . v.
  float4 acc[4][DV];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < DV; ++c) acc[a][c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  for (int c0 = 0; c0 < n; c0 += kTile) {
    const int keys = min(kTile, n - c0);
    __syncthreads();
    load_rows(ks, kStride, kWidth, k + base + (size_t)c0 * dk, keys, dk);
    load_rows(vs, kStride, kWidth, v + base + (size_t)c0 * dk, keys, dk);
    __syncthreads();
    float sc[4][4];
    score_tile4(sc, qs, ks, kStride, dkp, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = c0 + tx + 16 * b;
        const float x = j < n_valid ? sc[a][b] * scale : kNegBig;
        ps[(ty + 16 * a) * kPStride + tx + 16 * b] =
            j < n ? round_as<T>(expf(x - m_run[a]) / l_run[a]) : 0.0f;
      }
    }
    __syncthreads();

    // p is 0 and v is 0 past the last key, so the tail rounds up to 4.
    const int kp = (keys + 3) & ~3;
    for (int j = 0; j < kp; j += 4) {
      float4 pa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        pa[a] = *reinterpret_cast<const float4*>(ps + (ty + 16 * a) * kPStride + j);
#pragma unroll
      for (int c = 0; c < DV; ++c) {
        const float* vp = vs + j * kStride + 4 * tx + 64 * c;
        const float4 v0 = *reinterpret_cast<const float4*>(vp);
        const float4 v1 = *reinterpret_cast<const float4*>(vp + kStride);
        const float4 v2 = *reinterpret_cast<const float4*>(vp + 2 * kStride);
        const float4 v3 = *reinterpret_cast<const float4*>(vp + 3 * kStride);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          fma4(acc[a][c], pa[a].x, v0);
          fma4(acc[a][c], pa[a].y, v1);
          fma4(acc[a][c], pa[a].z, v2);
          fma4(acc[a][c], pa[a].w, v3);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = r0 + ty + 16 * a;
    if (row >= n) continue;
    T* orow = out + base + (size_t)row * dk;
#pragma unroll
    for (int c = 0; c < DV; ++c) {
      const int d = 4 * tx + 64 * c;
      const float vals[4] = {acc[a][c].x, acc[a][c].y, acc[a][c].z, acc[a][c].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (d + e < dk) store(orow + d + e, vals[e]);
    }
  }
}

// ---- The tensor-core body: bf16, dk <= DKP in {32, 64, 128}. ----

using bf16 = __nv_bfloat16;
constexpr int kMmaThreads = 128;  // 4 warps x 16 query rows

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// dst[r * (DKP + 8) + d] = src[r * dk + d] for r < avail and d < dk, 0
// elsewhere, for r < kTile and d < DKP. The row stride of DKP + 8 bf16
// puts the 8 rows of an ldmatrix on 8 different groups of 4 banks. `vec`:
// dk % 8 == 0 and 16-byte aligned rows, so 16 bytes a load.
template <int DKP>
__device__ __forceinline__ void load_rows_bf16(bf16* dst, const bf16* __restrict__ src,
                                               int avail, int dk, bool vec) {
  constexpr int kS = DKP + 8;
  if (vec) {
    constexpr int kChunks = DKP / 8;
    for (int idx = threadIdx.x; idx < kTile * kChunks; idx += kMmaThreads) {
      const int r = idx / kChunks;
      const int d = (idx - r * kChunks) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < avail && d < dk)
        val = *reinterpret_cast<const uint4*>(src + (size_t)r * dk + d);
      *reinterpret_cast<uint4*>(dst + r * kS + d) = val;
    }
  } else {
    for (int idx = threadIdx.x; idx < kTile * DKP; idx += kMmaThreads) {
      const int r = idx / DKP;
      const int d = idx - r * DKP;
      dst[r * kS + d] = (r < avail && d < dk) ? src[(size_t)r * dk + d]
                                              : __float2bfloat16_rn(0.0f);
    }
  }
}

// The warp's (16 rows, 64 keys) scores. sc[j][e]: key 8j + 2t + (e & 1),
// row g + 8 (e >> 1), where g = lane / 4 and t = lane % 4.
template <int DKP>
__device__ __forceinline__ void mma_scores(float (&sc)[8][4],
                                           const uint32_t (&qf)[DKP / 16][4],
                                           const bf16* ks, int lane) {
  constexpr int kS = DKP + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < DKP / 16; ++kk) {
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      // matrices: keys 16jp + {0-7, 0-7, 8-15, 8-15} x dims 16kk + {0-7, 8-15, 0-7, 8-15}
      uint32_t b[4];
      ldsm_x4(b, ks + (16 * jp + (lane >> 4) * 8 + (lane & 7)) * kS + 16 * kk +
                     ((lane >> 3) & 1) * 8);
      mma_bf16(sc[2 * jp], qf[kk], b[0], b[1]);
      mma_bf16(sc[2 * jp + 1], qf[kk], b[2], b[3]);
    }
  }
}

template <int DKP>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * (size_t)3 * kTile * (DKP + 8);
}

template <int DKP>
__global__ void __launch_bounds__(kMmaThreads)
dense_attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ out,
                           int n, int n_valid, int dk, int row_blocks, float scale,
                           int vec) {
  extern __shared__ uint4 smem_raw[];
  constexpr int kS = DKP + 8;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kTile * kS;
  bf16* vs = ks + kTile * kS;

  const int zi = blockIdx.x / row_blocks;
  const int r0 = (blockIdx.x - zi * row_blocks) * kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t base = (size_t)zi * n * dk;

  load_rows_bf16<DKP>(qs, q + base + (size_t)r0 * dk, min(kTile, n - r0), dk, vec);
  __syncthreads();
  // The warp's 16 query rows as A fragments, one per 16 dims.
  uint32_t qf[DKP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DKP / 16; ++kk)
    ldsm_x4(qf[kk], qs + (16 * warp + (lane & 15)) * kS + 16 * kk + (lane >> 4) * 8);

  // Pass 1: max and sum of rows g and g + 8, reduced over the quad.
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.0f, 0.0f};
  for (int c0 = 0; c0 < n; c0 += kTile) {
    __syncthreads();
    load_rows_bf16<DKP>(ks, k + base + (size_t)c0 * dk, min(kTile, n - c0), dk, vec);
    __syncthreads();
    float sc[8][4];
    mma_scores<DKP>(sc, qf, ks, lane);
    float cmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = c0 + 8 * j + 2 * t + (e & 1);
        const float x =
            key < n_valid ? sc[j][e] * scale : (key < n ? kNegBig : -INFINITY);
        sc[j][e] = x;
        cmax[e >> 1] = fmaxf(cmax[e >> 1], x);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      cmax[h] = fmaxf(cmax[h], __shfl_xor_sync(0xffffffffu, cmax[h], 1));
      cmax[h] = fmaxf(cmax[h], __shfl_xor_sync(0xffffffffu, cmax[h], 2));
    }
    // Key c0 exists, so the tile max is finite.
    const float new_m[2] = {fmaxf(m_run[0], cmax[0]), fmaxf(m_run[1], cmax[1])};
    float csum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) csum[e >> 1] += expf(sc[j][e] - new_m[e >> 1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      csum[h] += __shfl_xor_sync(0xffffffffu, csum[h], 1);
      csum[h] += __shfl_xor_sync(0xffffffffu, csum[h], 2);
      l_run[h] = l_run[h] * expf(m_run[h] - new_m[h]) + csum[h];
      m_run[h] = new_m[h];
    }
  }

  // Pass 2: p rounded to bf16, out += p . v on the tensor cores.
  float acc[DKP / 8][4];
#pragma unroll
  for (int j = 0; j < DKP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  for (int c0 = 0; c0 < n; c0 += kTile) {
    const int keys = min(kTile, n - c0);
    __syncthreads();
    load_rows_bf16<DKP>(ks, k + base + (size_t)c0 * dk, keys, dk, vec);
    load_rows_bf16<DKP>(vs, v + base + (size_t)c0 * dk, keys, dk, vec);
    __syncthreads();
    float sc[8][4];
    mma_scores<DKP>(sc, qf, ks, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = c0 + 8 * j + 2 * t + (e & 1);
        const float x = key < n_valid ? sc[j][e] * scale : kNegBig;
        sc[j][e] = key < n ? expf(x - m_run[e >> 1]) / l_run[e >> 1] : 0.0f;
      }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // The score fragments of keys 16kk..16kk+15 are the A fragment of p.
      const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int jj = 0; jj < DKP / 16; ++jj) {
        // matrices: keys 16kk + {0-7, 8-15, 0-7, 8-15} x dims 16jj + {0-7, 0-7, 8-15, 8-15}
        uint32_t b[4];
        ldsm_x4_trans(b, vs + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kS +
                             16 * jj + (lane >> 4) * 8);
        mma_bf16(acc[2 * jj], pa, b[0], b[1]);
        mma_bf16(acc[2 * jj + 1], pa, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 16 * warp + g + 8 * h;
    if (row >= n) continue;
    bf16* orow = out + base + (size_t)row * dk;
#pragma unroll
    for (int j = 0; j < DKP / 8; ++j) {
      const int d = 8 * j + 2 * t;
      if (d < dk) orow[d] = __float2bfloat16_rn(acc[j][2 * h]);
      if (d + 1 < dk) orow[d + 1] = __float2bfloat16_rn(acc[j][2 * h + 1]);
    }
  }
}

// ---- Launch. ----

// Raises a kernel's dynamic shared-memory limit to `bytes`, once per
// device and kernel instance (one `ready` per template instance).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, std::atomic<uint64_t>& ready) {
  constexpr int kMaxDevices = 64;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const uint64_t bit = device < kMaxDevices ? uint64_t{1} << device : 0;
  if (ready.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return err;
  ready.fetch_or(bit, std::memory_order_release);
  return cudaSuccess;
}

template <typename T, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int z,
                   int n, int n_valid, int dk, float scale, cudaStream_t stream) {
  static std::atomic<uint64_t> ready{0};
  const int row_blocks = (n + kTile - 1) / kTile;
  cudaError_t err = allow_smem(dense_attention_kernel<T, DV>, smem_bytes<DV>(), ready);
  if (err != cudaSuccess) return err;
  dense_attention_kernel<T, DV><<<z * row_blocks, kThreads, smem_bytes<DV>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), n, n_valid, dk, row_blocks, scale);
  return cudaGetLastError();
}

template <int DKP>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out, int z,
                       int n, int n_valid, int dk, float scale, cudaStream_t stream) {
  static std::atomic<uint64_t> ready{0};
  const int row_blocks = (n + kTile - 1) / kTile;
  const int vec = dk % 8 == 0 &&
                  (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                   reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  cudaError_t err =
      allow_smem(dense_attention_mma_kernel<DKP>, mma_smem_bytes<DKP>(), ready);
  if (err != cudaSuccess) return err;
  dense_attention_mma_kernel<DKP>
      <<<z * row_blocks, kMmaThreads, mma_smem_bytes<DKP>(), stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<bf16*>(out), n, n_valid, dk,
          row_blocks, scale, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const void* q, const void* k, const void* v, void* out,
                         int z, int n, int n_valid, int dk, float scale,
                         cudaStream_t stream) {
  if (sizeof(T) == 2 && dk <= 128) {
    if (dk <= 32) return launch_mma<32>(q, k, v, out, z, n, n_valid, dk, scale, stream);
    if (dk <= 64) return launch_mma<64>(q, k, v, out, z, n, n_valid, dk, scale, stream);
    return launch_mma<128>(q, k, v, out, z, n, n_valid, dk, scale, stream);
  }
  switch ((dk + 63) / 64) {
    case 1:
      return launch<T, 1>(q, k, v, out, z, n, n_valid, dk, scale, stream);
    case 2:
      return launch<T, 2>(q, k, v, out, z, n, n_valid, dk, scale, stream);
    case 3:
      return launch<T, 3>(q, k, v, out, z, n, n_valid, dk, scale, stream);
    default:
      return launch<T, 4>(q, k, v, out, z, n, n_valid, dk, scale, stream);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; scale is 1 / sqrt(dk). Launches on `stream`
// and returns the cudaError_t of the launch (0 on success); it does not
// synchronise.
extern "C" int snuffy_dense_attention(const void* q, const void* k, const void* v,
                                      void* out, int z, int n, int n_valid, int dk,
                                      int dtype, float scale, void* stream) {
  if (z < 1 || n < 1 || n_valid < 1 || n_valid > n || dk < 1 || dk > 256 ||
      (long long)z * ((n + kTile - 1) / kTile) > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_dtype<float>(q, k, v, out, z, n, n_valid, dk, scale, st);
  } else if (dtype == 1) {
    err = launch_dtype<__nv_bfloat16>(q, k, v, out, z, n, n_valid, dk, scale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* snuffy_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
