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
// the 989.4 TFLOP/s bf16 tensor-core peak = 122 us. In f32 (the ROI CLI's
// ViTs, extraction with --compute_dtype float32) the operations over
// 3xTF32's 495 / 3 = 165 TFLOP/s and the bytes weigh about the same: 46
// us at z=768, n=197. The TPU kernel holds a whole (bz, n_pad, n_pad) f32
// score block in VMEM and pads n to 128. An SM has 227 KB of shared memory
// and blocks run in no order, so here a block owns query rows of one z and
// walks the keys in tiles of 64. In bf16 it sweeps them twice:
//   sweep 1 keeps an online max and sum for each row;
//   sweep 2 recomputes the scores, forms p exactly as the reference does
//     (divided by the final sum, rounded to T) and accumulates p . v in
//     registers.
// Two sweeps cost 3 tile products where a one-pass kernel needs 2 (and
// twice the exponentials), and buy the reference's rounding of p: rounded
// against a running max instead, p flips large outputs by a bf16 ulp. In
// f32 that reason is gone: the reference rounds p to f32, which is no
// rounding, so a one-pass (online) softmax, whose p . v sums are rescaled
// by 2^(m_old - m_new) when a row's max moves and divided by the sum once
// at the end, computes the reference's function within f32 rounding (a
// CPU emulation holds it to 1e-5 of max |plain|,
// tests/test_torch_dense_attention.py). The f32 body takes one pass. The
// scores never reach device memory, nothing is padded in device memory,
// and the ragged edges of n and dk are masked here. Three bodies, by dtype
// and dk (and 16-byte aligned bases, which TMA and cp.async need):
//   bf16, dk <= 128, dk % 8 == 0 (the ViTs): two warpgroups of 64 query
//     rows; thread 0 keeps K/V tiles of 64 keys in flight by TMA
//     (mbarriers, a ring of 4 stages; when n <= 256 one block owns the
//     whole z and loads K and V once for both sweeps and all its
//     row tiles). q . k^T is wgmma m64n32k16 from shared memory (q and k
//     K-major, 128-byte swizzle), p . v wgmma with p from registers (the
//     score accumulator repacked to bf16) and v MN-major. Each 64-key tile
//     is two halves: one half's scores run on the tensor cores while the
//     other's softmax runs. exp is 2^x on the special-function unit with
//     scale * log2 e folded into one FMA, one reciprocal a row; the last
//     tile costs whole halves of 32 keys (narrower wgmma tails made ptxas
//     serialise the pipeline, which cost more); warpgroups with no row
//     exit. Bound in practice, far above the bound above, by the
//     exponentials (2 a score) and by the wgmma pipeline, which ptxas
//     still serialises in part (its C7513 note) behind the softmax.
//   f32, dk <= 128, dk % 4 == 0 (dense_attention_tf32_kernel): one pass,
//     8 warps of 16 query rows, K/V tiles double-buffered by cp.async,
//     every product on the tensor cores as 3xTF32 (mma.sync m16n8k8, the
//     machinery of the sparse kernels' f32 bodies,
//     sparse_attention_common.cuh); details at the kernel.
//   otherwise (f32 or bf16 with dk > 128, dk not a multiple of 4 or 8, an
//     unaligned base): 256 threads, every product on CUDA cores in f32
//     (float4 shared-memory reads, 16 FMAs a read), 4 rows x 4 dims a
//     thread for each 64 dims of dk, two sweeps.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "mma_common.cuh"
#include "sparse_attention_common.cuh"

namespace {

using namespace snuffy;

constexpr int kTile = 64;             // query rows per block, keys per tile
constexpr int kPStride = kTile + 4;   // row stride of the p tile

// ---- The CUDA-core body: every call the tensor-core bodies do not take. ----

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

// ---- The tensor-core body: bf16, dk <= 128, dk % 8 == 0. ----
//
// A block is two warpgroups of 64 query rows each. Its thread 0 loads
// 64 x 64 bf16 boxes (128 bytes a row, 128-byte swizzle) by TMA from the
// (z, n, dk) tensors seen as 3-D maps, so rows past n and columns past dk
// arrive as zeros. Q stays in shared memory as wgmma's A operand. When
// n > kResidentN the block owns 128 query rows and K/V tiles stream through
// a ring of kStages stages (full/empty mbarriers) in the order the
// warpgroups use them: sweep 1 K only, sweep 2 K and V. When
// n <= kResidentN the block owns the whole z, every K/V tile is loaded once
// into its own stage, and the warpgroups walk all the z's 64-row query
// tiles over it. No producer warp: with one, ptxas capped the two blocks an
// SM at 96 registers a thread and spilled (PERF.md §6).

constexpr int kWgRows = 64;                    // query rows of a warpgroup
constexpr int kKeys = 64;                      // keys of a K/V tile
constexpr int kHalf = kKeys / 2;               // keys of a half tile
constexpr int kHalfBytes = kHalf * 128;        // its offset in a k or v tile
constexpr int kBox = 64 * 64 * 2;              // one TMA box: 64 rows x 128 bytes
constexpr int kConsumers = 2;                  // warpgroups of a block
constexpr int kWgThreads = 128 * kConsumers;
constexpr int kStages = 4;
constexpr int kResidentN = kStages * kKeys;    // K and V held whole up to here
constexpr float kLog2e = 1.4426950408889634f;

template <int DKP>
struct WgLayout {
  static constexpr int kTileBytes = DKP / 64 * kBox;    // 64 rows of q, k or v
  static constexpr int kStageBytes = 2 * kTileBytes;   // k, then v
  static constexpr int kQTiles = kResidentN / kWgRows;  // q tiles held at most
  static constexpr size_t kSmem = 1024 + (size_t)kQTiles * kTileBytes +
                                  (size_t)kStages * kStageBytes +
                                  (2 * kStages + 1) * sizeof(uint64_t);
};

// Issues (one commit group) the warpgroup's raw scores q . k^T of a half
// tile, 32 keys, over DKP dims: sc[i] is the C fragment of an m64n32 tile.
template <int DKP>
__device__ __forceinline__ void issue_qk(float (&sc)[16], uint32_t qaddr, uint32_t kaddr) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DKP / 16; ++kk) {
    // 16 dims = 32 bytes along the swizzled row; a new box every 64 dims
    const uint32_t off = (kk >> 2) * kBox + (kk & 3) * 32;
    wgmma_ss_n32(sc, wgmma_desc(qaddr + off, 0, 1024), wgmma_desc(kaddr + off, 0, 1024),
                 kk > 0);
  }
  wgmma_commit();
}

// Issues out (64 rows, DKP) += p (64 rows, the half tile's 32 keys, as the
// A fragments of two 16-key steps) . v.
template <int DKP>
__device__ __forceinline__ void issue_pv(float (&acc)[DKP / 2], const uint32_t (&pa)[2][4],
                                         uint32_t vaddr) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    // 16 keys = 2048 bytes of v; a new box every 64 dims
    const uint64_t b = wgmma_desc(vaddr + kk * 2048, kBox, 1024);
    if constexpr (DKP == 64) wgmma_rs_n64(acc, pa[kk], b, 1);
    if constexpr (DKP == 128) wgmma_rs_n128(acc, pa[kk], b, 1);
  }
  wgmma_commit();
}

// Scores of keys at or past `valid` become -inf; c0 is the first key of
// the half tile.
__device__ __forceinline__ void mask_keys(float (&sc)[16], int c0, int valid, int t) {
  if (c0 + kHalf <= valid) return;
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (c0 + 8 * (i >> 2) + 2 * t + (i & 1) >= valid) sc[i] = -INFINITY;
}

// Online max and sum of 2^(s * scale_log2 - m) over a half tile, for rows
// g and g + 8 of the warp, reduced over the quad.
__device__ __forceinline__ void row_stats(const float (&sc)[16], float scale_log2,
                                          float (&m_run)[2], float (&l_run)[2]) {
  float cmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 16; ++i) cmax[(i >> 1) & 1] = fmaxf(cmax[(i >> 1) & 1], sc[i]);
  float new_m[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    cmax[h] = fmaxf(cmax[h], __shfl_xor_sync(0xffffffffu, cmax[h], 1));
    cmax[h] = fmaxf(cmax[h], __shfl_xor_sync(0xffffffffu, cmax[h], 2));
    // key 0 is valid, so the max is finite from the first half tile on
    new_m[h] = fmaxf(m_run[h], cmax[h] * scale_log2);
  }
  float csum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    csum[(i >> 1) & 1] += fast_exp2(fmaf(sc[i], scale_log2, -new_m[(i >> 1) & 1]));
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    csum[h] += __shfl_xor_sync(0xffffffffu, csum[h], 1);
    csum[h] += __shfl_xor_sync(0xffffffffu, csum[h], 2);
    l_run[h] = l_run[h] * fast_exp2(m_run[h] - new_m[h]) + csum[h];
    m_run[h] = new_m[h];
  }
}

// p = bf16(2^(s * scale_log2 - m) / l) as the A fragments of the half
// tile's two 16-key steps.
__device__ __forceinline__ void probs(uint32_t (&pa)[2][4], const float (&sc)[16],
                                      float scale_log2, const float (&m)[2],
                                      const float (&inv_l)[2]) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 8 * kk + 2 * r;
      const int h = r & 1;
      pa[kk][r] = pack_bf16(fast_exp2(fmaf(sc[i], scale_log2, -m[h])) * inv_l[h],
                            fast_exp2(fmaf(sc[i + 1], scale_log2, -m[h])) * inv_l[h]);
    }
}

template <int DKP>
__global__ void __launch_bounds__(kWgThreads, DKP == 64 ? 2 : 1)
dense_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             bf16* __restrict__ out, int n, int n_valid, int dk,
                             int row_blocks, float scale_log2) {
  using L = WgLayout<DKP>;
  extern __shared__ uint8_t smem_raw[];
  // swizzle atoms are 1024-byte aligned
  uint8_t* qs = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* ring = qs + L::kQTiles * L::kTileBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * L::kStageBytes);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int zi = blockIdx.x / row_blocks;
  const int row0 = (blockIdx.x - zi * row_blocks) * kConsumers * kWgRows;
  const bool resident = n <= kResidentN;
  const int tiles = (n + kKeys - 1) / kKeys;
  const int qtiles = min(resident ? L::kQTiles : kConsumers,
                         (n - row0 + kWgRows - 1) / kWgRows);
  const int consumers = min(kConsumers, qtiles);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const int uses = resident ? tiles : 2 * tiles;  // of the K/V stages
  // Use u loads K/V tile u (sweep 1: K only) or u - tiles (sweep 2: K and
  // V) into stage u % kStages; resident, tile u with K and V.
  auto issue = [&](int u) {
    const int st = u % kStages;
    const bool with_v = resident || u >= tiles;
    const int j = u < tiles ? u : u - tiles;
    mbar_expect_tx(&full[st], (with_v ? 2 : 1) * L::kTileBytes);
    uint8_t* dst = ring + st * L::kStageBytes;
    for (int c = 0; c < DKP / 64; ++c) {
      tma_load_3d(dst + c * kBox, &tk, &full[st], 64 * c, kKeys * j, zi);
      if (with_v)
        tma_load_3d(dst + L::kTileBytes + c * kBox, &tv, &full[st], 64 * c, kKeys * j, zi);
    }
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], consumers * 128);
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // q once, and the first kStages uses of the K/V stages
    mbar_expect_tx(qbar, qtiles * L::kTileBytes);
    for (int t = 0; t < qtiles; ++t)
      for (int c = 0; c < DKP / 64; ++c)
        tma_load_3d(qs + t * L::kTileBytes + c * kBox, &tq, qbar, 64 * c,
                    row0 + kWgRows * t, zi);
    for (int u = 0; u < min(uses, kStages); ++u) issue(u);
  }

  const int wg = warp >> 2;
  if (wg >= consumers) return;
  const int g = lane >> 2;
  const int t = lane & 3;
  // K/V stages in the order of use; resident tiles never move. Thread 0
  // refills a stage once both warpgroups have released it.
  int acquired = 0, released = 0;
  auto acquire = [&](int j) {
    if (resident) {
      mbar_wait(&full[j], 0);
      return j;
    }
    const int st = acquired % kStages;
    mbar_wait(&full[st], (acquired / kStages) & 1);
    ++acquired;
    return st;
  };
  auto release = [&](int st) {
    if (resident) return;
    mbar_arrive(&empty[st]);
    const int u = released++;
    if (threadIdx.x == 0 && u + kStages < uses) {
      mbar_wait(&empty[st], (u / kStages) & 1);
      issue(u + kStages);
    }
  };
  auto kv = [&](int st) { return smem_addr(ring + st * L::kStageBytes); };

  // Each 64-key tile is two 32-key halves a and b: the scores of one half
  // are computed on the tensor cores while the other's softmax runs.
  mbar_wait(qbar, 0);
  for (int qt = wg; qt < qtiles; qt += kConsumers) {
    const uint32_t qaddr = smem_addr(qs + qt * L::kTileBytes);
    float sa[16], sb[16];

    // Sweep 1: the row max m (of s * scale * log2 e) and l = sum 2^(. - m).
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.0f, 0.0f};
    int st = acquire(0);
    issue_qk<DKP>(sa, qaddr, kv(st));
    for (int j = 0; j < tiles; ++j) {
      issue_qk<DKP>(sb, qaddr, kv(st) + kHalfBytes);
      wgmma_wait<1>();
      fence_regs(sa);
      mask_keys(sa, kKeys * j, n_valid, t);
      row_stats(sa, scale_log2, m_run, l_run);
      const int next = j + 1 < tiles ? acquire(j + 1) : st;
      if (j + 1 < tiles)
        issue_qk<DKP>(sa, qaddr, kv(next));
      else
        wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sb);
      release(st);
      mask_keys(sb, kKeys * j + kHalf, n_valid, t);
      row_stats(sb, scale_log2, m_run, l_run);
      st = next;
    }
    const float inv_l[2] = {1.0f / l_run[0], 1.0f / l_run[1]};

    // Sweep 2: p = bf16(2^(s * scale * log2 e - m) / l), out += p . v.
    float acc[DKP / 2];
#pragma unroll
    for (int i = 0; i < DKP / 2; ++i) acc[i] = 0.0f;
    uint32_t pa[2][2][4];
    st = acquire(0);
    int prev = -1;
    issue_qk<DKP>(sa, qaddr, kv(st));
    for (int j = 0; j < tiles; ++j) {
      const uint32_t vaddr = kv(st) + L::kTileBytes;
      issue_qk<DKP>(sb, qaddr, kv(st) + kHalfBytes);
      wgmma_wait<1>();  // half a's scores, and the previous tile's p . v
      fence_regs(sa);
      if (prev >= 0) release(prev);
      mask_keys(sa, kKeys * j, n_valid, t);
      probs(pa[0], sa, scale_log2, m_run, inv_l);
      issue_pv<DKP>(acc, pa[0], vaddr);
      const int next = j + 1 < tiles ? acquire(j + 1) : st;
      if (j + 1 < tiles)
        issue_qk<DKP>(sa, qaddr, kv(next));
      else
        wgmma_commit();
      wgmma_wait<2>();  // half b's scores
      fence_regs(sb);
      mask_keys(sb, kKeys * j + kHalf, n_valid, t);
      probs(pa[1], sb, scale_log2, m_run, inv_l);
      issue_pv<DKP>(acc, pa[1], vaddr + kHalfBytes);
      prev = st;
      st = next;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    release(prev);

    const int rbase = row0 + kWgRows * qt + 16 * (warp & 3) + g;
#pragma unroll
    for (int i = 0; i < DKP / 2; i += 2) {
      const int row = rbase + 8 * ((i >> 1) & 1);
      const int col = 8 * (i >> 2) + 2 * t;
      if (row < n && col < dk)
        *reinterpret_cast<uint32_t*>(out + ((size_t)zi * n + row) * dk + col) =
            pack_bf16(acc[i], acc[i + 1]);
    }
  }
}

// ---- The f32 tensor-core body: f32, dk <= 128, dk % 4 == 0. ----
//
// One pass over the keys (the header says why f32 may). 8 warps a block
// (kF32Threads, which tile_async_f32 loads with) own 128 query rows of one
// z, 16 a warp; a warp with no row only helps load. K and V stream through
// two stages of 64-key tiles by cp.async: the copy of tile c + 1 runs
// while tile c is multiplied. A warp takes each tile in two halves of 32
// keys: its 16 x 32 scores s = q . k^T (mma_rows_f32: q's and k's
// fragments by ldmatrix, split as they leave shared memory), masked and
// scaled into the log2 domain; the online max moves and the sums are
// rescaled; then p . v, each C fragment of p relabelled into an A
// fragment against its 8 rows of v (mma_c_rows_f32). Every product is
// 3xTF32 (split_tf32: big.small + small.big + big.big); a score sums 16
// dims at a time in fresh registers, p . v one half tile at a time
// (add_part), because the tensor cores' f32 sums truncate. 8-key columns
// past n are neither multiplied nor summed. At dk <= 64 two blocks share
// an SM (104 KB of shared memory each, at most 128 registers a thread),
// so one block's loads overlap the other's products. Two designs ran
// slower on the card (PERF.md §6): q's fragments split once and held
// in registers for the row tile (more registers than two blocks an SM
// allow), and K and V held whole in shared memory for all of a z's rows
// (one block a z at n <= 256, one block an SM).

constexpr int kTfRows = 2 * kRows;  // query rows of a block, 16 a warp
constexpr int kTfHalf = kKeys / 2;  // keys of a half tile

// Shared memory: 128 q rows (two 64-row tiles), then two stages of a k
// tile and a v tile.
template <int DKP>
constexpr size_t tf32_smem() {
  return (size_t)6 * tf_tile_bytes<DKP>();
}

// Grid: z * row_blocks blocks, the 128-row blocks of one z adjacent (they
// read the same k and v from L2).
template <int DKP>
__global__ void __launch_bounds__(kF32Threads, DKP <= 64 ? 2 : 1)
dense_attention_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, float* __restrict__ out, int n,
                            int n_valid, int dk, int row_blocks, float scale_log2) {
  constexpr int kS = tf_stride<DKP>();
  constexpr int kTileF = kRows * kS;  // floats of a 64-row tile
  extern __shared__ uint4 smem_tf[];
  float* qs = reinterpret_cast<float*>(smem_tf);  // 128 rows
  float* kv = qs + 2 * kTileF;                    // stage b: k at 2b tiles, v after it

  const int zi = blockIdx.x / row_blocks;
  const int r0 = (blockIdx.x - zi * row_blocks) * kTfRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t base = (size_t)zi * n * dk;
  const float* kz = k + base;
  const float* vz = v + base;
  const int tiles = (n + kKeys - 1) / kKeys;
  const bool live = r0 + 16 * warp < n;  // the warp has a query row

  tile_async_f32<DKP>(qs, q + base, r0, n, dk);
  tile_async_f32<DKP>(qs + kTileF, q + base, r0 + kRows, n, dk);
  tile_async_f32<DKP>(kv, kz, 0, n, dk);
  tile_async_f32<DKP>(kv + kTileF, vz, 0, n, dk);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // rows g (h = 0) and g + 8 (h = 1): the running max of s * scale * log2 e,
  // this thread's share of the sum of 2^(. - max), and out's unscaled sums
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.0f, 0.0f};
  float acc[DKP / 8][4], part[DKP / 8][4];
#pragma unroll
  for (int j = 0; j < DKP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = part[j][e] = 0.0f;

  for (int c = 0; c < tiles; ++c) {
    const int st = c & 1;
    if (c + 1 < tiles) {  // the next tile loads while this one is used
      float* next = kv + 2 * (st ^ 1) * kTileF;
      tile_async_f32<DKP>(next, kz, (c + 1) * kKeys, n, dk);
      tile_async_f32<DKP>(next + kTileF, vz, (c + 1) * kKeys, n, dk);
      cp_async_commit();
    }
    for (int c0 = c * kKeys; live && c0 < min(n, (c + 1) * kKeys); c0 += kTfHalf) {
      const float* ks = kv + 2 * st * kTileF + (c0 - c * kKeys) * kS;
      const int cols = min(4, (n - c0 + 7) / 8);  // 8-key columns with a key
      float sc[4][4];
      mma_rows_f32<DKP, 4>(sc, qs, 16 * warp, ks, 0, lane, cols);
      // the reference's mask: -1e30 from n_valid on (2^(-1e30 - m) is 0
      // as e^(-1e30 - m) is), nothing past n
      float cmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = c0 + 8 * j + 2 * t + (e & 1);
          const float x =
              key < n_valid ? sc[j][e] * scale_log2 : (key < n ? kNegBig : -INFINITY);
          sc[j][e] = x;
          cmax[e >> 1] = fmaxf(cmax[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        cmax[h] = fmaxf(cmax[h], __shfl_xor_sync(0xffffffffu, cmax[h], 1));
        cmax[h] = fmaxf(cmax[h], __shfl_xor_sync(0xffffffffu, cmax[h], 2));
        // key c0 exists, so the new max is finite; 2^-inf = 0 at key 0
        const float m_new = fmaxf(m_run[h], cmax[h]);
        alpha[h] = fast_exp2(m_run[h] - m_new);
        m_run[h] = m_new;
        l_run[h] *= alpha[h];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[j][e] = fast_exp2(sc[j][e] - m_run[e >> 1]);
          l_run[e >> 1] += sc[j][e];
        }
#pragma unroll
      for (int j = 0; j < DKP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
      const float* vs = ks + kTileF;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < cols) mma_c_rows_f32<DKP>(part, sc[j], vs + 8 * j * kS, lane);
      add_part<DKP>(acc, part);
    }
    cp_async_wait<0>();
    __syncthreads();
  }
  if (!live) return;

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv_l = 1.0f / l;
    const int row = r0 + 16 * warp + g + 8 * h;
    if (row >= n) continue;
    float* orow = out + base + (size_t)row * dk;
#pragma unroll
    for (int j = 0; j < DKP / 8; ++j) {
      const int d = 8 * j + 2 * t;  // dk % 4 == 0: d < dk puts d + 1 there too
      if (d < dk)
        *reinterpret_cast<float2*>(orow + d) =
            make_float2(acc[j][2 * h] * inv_l, acc[j][2 * h + 1] * inv_l);
    }
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (nothing
// more to link).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                : nullptr;
  }();
  return fn;
}

// (z, n, dk) bf16 as a 3-D map of 64 x 64 boxes, 128-byte swizzle; reads
// past n or dk give zeros.
bool tensor_map(CUtensorMap* map, const void* ptr, int z, int n, int dk) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)dk, (cuuint64_t)n, (cuuint64_t)z};
  const cuuint64_t strides[2] = {(cuuint64_t)dk * 2, (cuuint64_t)n * dk * 2};
  const cuuint32_t box[3] = {64, kKeys, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---- Launch. ----

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
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, int z,
                         int n, int n_valid, int dk, float scale, cudaStream_t stream) {
  static std::atomic<uint64_t> ready{0};
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, z, n, dk) || !tensor_map(&tk, k, z, n, dk) ||
      !tensor_map(&tv, v, z, n, dk))
    return cudaErrorInvalidValue;
  const size_t smem = WgLayout<DKP>::kSmem;
  cudaError_t err = allow_smem(dense_attention_wgmma_kernel<DKP>, smem, ready);
  if (err != cudaSuccess) return err;
  const int rows = kConsumers * kWgRows;
  const int row_blocks = n <= kResidentN ? 1 : (n + rows - 1) / rows;
  dense_attention_wgmma_kernel<DKP><<<z * row_blocks, kWgThreads, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(out), n, n_valid, dk, row_blocks, scale * kLog2e);
  return cudaGetLastError();
}

template <int DKP>
cudaError_t launch_tf32(const void* q, const void* k, const void* v, void* out, int z,
                        int n, int n_valid, int dk, float scale, cudaStream_t stream) {
  static std::atomic<uint64_t> ready{0};
  cudaError_t err = allow_smem(dense_attention_tf32_kernel<DKP>, tf32_smem<DKP>(), ready);
  if (err != cudaSuccess) return err;
  const int row_blocks = (n + kTfRows - 1) / kTfRows;
  dense_attention_tf32_kernel<DKP><<<z * row_blocks, kF32Threads, tf32_smem<DKP>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), n, n_valid, dk, row_blocks, scale * kLog2e);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const void* q, const void* k, const void* v, void* out,
                         int z, int n, int n_valid, int dk, float scale,
                         cudaStream_t stream) {
  // TMA and cp.async move 16 bytes: whole 16-byte chunks a row (dk % 8 ==
  // 0 in bf16, dk % 4 == 0 in f32) and 16-byte aligned bases
  const bool tc = dk <= 128 && dk % (16 / sizeof(T)) == 0 &&
                  (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                   reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
                          16 == 0;
  if (tc && sizeof(T) == 4) {
    if (dk <= 32) return launch_tf32<32>(q, k, v, out, z, n, n_valid, dk, scale, stream);
    if (dk <= 64) return launch_tf32<64>(q, k, v, out, z, n, n_valid, dk, scale, stream);
    if (dk <= 96) return launch_tf32<96>(q, k, v, out, z, n, n_valid, dk, scale, stream);
    return launch_tf32<128>(q, k, v, out, z, n, n_valid, dk, scale, stream);
  }
  if (tc) {
    if (dk <= 64) return launch_wgmma<64>(q, k, v, out, z, n, n_valid, dk, scale, stream);
    return launch_wgmma<128>(q, k, v, out, z, n, n_valid, dk, scale, stream);
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
