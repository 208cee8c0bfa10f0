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
// What bounds it on the H100: at one bag (h=4, N=10240, S=512, dk=96,
// bf16) the operations, 4 * h * dk * live pairs ≈ 7.2 GFLOP over the
// 989.4 TFLOP/s bf16 tensor-core peak ≈ 7 us, about the bytes' time. The
// TPU kernel holds a whole (tile_n, S) f32 score block in 16 MB of VMEM
// and carries the (S, dk) accumulator across its sequential N grid. An SM
// has at most 227 KB of shared memory and blocks run in no order, so the
// work is split into passes that keep the (N, S) probabilities out of
// device memory and use no atomics:
//   pass 1 (row stats): one block per (64-row tile, hh) streams the S slots
//     in chunks of 64 and keeps an online max and sum per row; it writes
//     the row max and q_valid / sum, 8 bytes per row (the backward kernel
//     reads them).
//   pass 2 (slot accumulate): one block per (64-slot chunk, hh, split of
//     N) keeps its k chunk, loops over its rows in tiles of 64,
//     recomputes the scores, forms p from the row stats, the slot codes,
//     the row mask and the hash, and accumulates p^T v in registers. N is
//     split until the grid has 256 blocks (8 splits at one bag, 1 at 8
//     bags); each split writes an f32 partial,
//   split reduce: sums the partials in split order and casts (several
//     splits only).
// Both passes compute q.k^T (and the bf16 body p^T v twice, below), so
// the FLOPs are 1.5x (2x) the TPU kernel's. Three bodies, by dtype and dk
// (and 16-byte aligned bases, which the tensor-core bodies' cp.async
// needs):
//   bf16, dk <= 128, dk % 8 == 0: 4 warps, 16 rows (pass 1) or 16 slots
//     (pass 2) each, every product on the tensor cores (mma.sync m16n8k16,
//     bf16 in, f32 sums), tiles double-buffered by 16-byte cp.async and
//     read by ldmatrix. Pass 2 is transposed: s^T = k q^T with the warp's
//     slots of k as A fragments for the whole row loop, and the C fragment
//     of p^T becomes the A fragment of p^T v (v by ldmatrix.trans). That
//     product takes p as hi = bf16(p) plus lo = bf16(p - hi), two bf16
//     products, so p enters it within 2^-16 of its f32 value as in the
//     plain version: p rounded once to bf16 (as the TPU's MXU takes it at
//     JAX's default precision) moved out by ~2^-9 of max |out| before its
//     rounding to bf16, enough for two-ulp flips near the 2^-7 tolerance.
//   f32, dk <= 128, dk % 4 == 0 (the training CLI's dtype): the bf16
//     body's passes on f32 tiles, 8 warps a block (4 groups of 16 rows or
//     slots, each split in two halves over the other axis, their sums
//     merged once at the end), every product on the tensor cores as
//     3xTF32: each f32 operand split as it leaves shared memory into big
//     = tf32(x) (to nearest, as cvt.rna) and small = x - big, of which the
//     tensor cores read the leading 11 bits (split_tf32), and a . b as
//     big.small + small.big + big.big, three mma.sync m16n8k8 (tf32 in,
//     f32 sums), about 2^-20 of |a b|, at 495 / 3 = 165 TFLOP/s of f32
//     work. The C fragment of p^T holds columns (2t, 2t + 1) where the
//     tf32 A fragment wants (t, t + 4): the summed row index is relabelled
//     instead, and v's rows are loaded in the same order (mma_c_rows_f32).
//     The split was chosen by emulating it on the CPU at the training CLI's
//     widths (h=4, dk=96, S=500 and 1000, segments 1 and 4, rates 0 and 0.1;
//     tests/test_torch_sparse_attention.py): 3xTF32 keeps out, dq, dk and
//     dv within 1.1e-6-1.8e-6 of max |plain|, 50x inside the f32 tolerance
//     of 1e-4; one TF32 product moves them by 4.6e-4-8.6e-4, past it; hi +
//     lo bf16 parts in three products (twice the tensor rate) by
//     5.2e-6-1.6e-5, inside 1e-4 but past the 1e-5 that the card's tests
//     hold f32 to. A 64-row tile with no valid row costs nothing but its
//     stats: pass 1 writes (0, 0) for it, pass 2 neither loads nor
//     multiplies it (a packed chunk's dummy bags). ptxas (-v, sm_90a):
//     row_stats_tf32_kernel 94 / 120 / 120 / 120 registers at DKP 32 / 64
//     / 96 / 128 (two blocks an SM allow 128), slot_accumulate_tf32_kernel
//     130 / 158 / 181 / 209; no spills.
//   f32 or bf16 otherwise (musk1's dk=83, dk > 128): 256 threads, every
//     product on CUDA cores in f32; pass 1 loads its tiles 16 bytes at a
//     time where dk allows (in pass 2 that pushed ptxas past 128 registers
//     into spills).
// The ragged edges of N, S and dk are masked here, nothing is padded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "mma_common.cuh"
#include "sparse_attention_common.cuh"

namespace {

using namespace snuffy;

// load_tile, with 16-byte global loads when `vec`: dk a multiple of
// 16 / sizeof(T) and 16-byte aligned bases (the launch checks).
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int stride, const T* __restrict__ src,
                                          int avail, int dk, bool vec) {
  if (!vec) {
    load_tile(dst, stride, src, avail, dk);
    return;
  }
  constexpr int kVec = 16 / sizeof(T);
  const int chunks = dk / kVec;
#pragma unroll 1
  for (int idx = threadIdx.x; idx < kRows * chunks; idx += kThreads) {
    const int r = idx / chunks;
    const int d = (idx - r * chunks) * kVec;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r < avail) raw = *reinterpret_cast<const uint4*>(src + (size_t)r * dk + d);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    float* out = dst + r * stride + d;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (sizeof(T) == 4) {
        out[e] = __uint_as_float(w[e]);
      } else {  // two bf16, the first in the low half
        out[2 * e] = __uint_as_float(w[e] << 16);
        out[2 * e + 1] = __uint_as_float(w[e] & 0xFFFF0000u);
      }
    }
  }
}

// Pass 1. Grid (ceil(N / 64), heads * segments).
template <typename T>
__global__ void __launch_bounds__(kThreads)
row_stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const uint8_t* __restrict__ slot_valid,
                 const uint8_t* __restrict__ q_valid,
                 float* __restrict__ row_max, float* __restrict__ row_scale,
                 int segments, int n, int s, int dk, int stride, float scale, int vec) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kRows * stride;
  float* code = ks + kSlots * stride;

  const int hh = blockIdx.y;
  const int seg = hh % segments;
  const int r0 = blockIdx.x * kRows;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_rows(qs, stride, q + ((size_t)hh * n + r0) * dk, min(kRows, n - r0), dk, vec);

  float m_run[4], l_run[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m_run[a] = -INFINITY;
    l_run[a] = 0.0f;
  }
  for (int c0 = 0; c0 < s; c0 += kSlots) {
    __syncthreads();
    load_rows(ks, stride, k + ((size_t)hh * s + c0) * dk, min(kSlots, s - c0), dk, vec);
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

// Pass 2. Grid (ceil(S / 64), heads * segments, splits): rows
// [split * rows_per_split, ...) of N. DM = dims of dk per thread. One split
// writes the output; several write f32 partials for split_reduce_kernel.
template <typename T, int DM>
__global__ void __launch_bounds__(kThreads)
slot_accumulate_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const uint8_t* __restrict__ slot_valid,
                       const float* __restrict__ row_max,
                       const float* __restrict__ row_scale, T* __restrict__ out,
                       float* __restrict__ partial, int segments, int n, int s, int dk,
                       int stride, int rows_per_split, float scale, uint32_t seed,
                       float rate, float inv_keep) {
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

  const int row_end = min(n, (int)blockIdx.z * rows_per_split + rows_per_split);
  for (int r0 = blockIdx.z * rows_per_split; r0 < row_end; r0 += kRows) {
    const int rows = min(kRows, row_end - r0);
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
        if (d >= dk) continue;
        const size_t idx = ((size_t)hh * s + j) * dk + d;
        if (partial != nullptr)
          partial[(size_t)blockIdx.z * gridDim.y * s * dk + idx] = acc[b][m];
        else
          store(out + idx, acc[b][m]);
      }
    }
  }
}

// ---- The tensor-core body: bf16, dk <= 128, dk % 8 == 0. ----
//
// 4 warps a block on the tiles of sparse_attention_common.cuh.

// The warp's (16 rows, 64 columns) products a . b^T, a from registers (A
// fragments of 16 rows), b the 64 rows of a tile: sc[j][e] is row
// g + 8 (e >> 1), column 8j + 2t + (e & 1) (g = lane / 4, t = lane % 4).
template <int DKP>
__device__ __forceinline__ void mma_tile(float (&sc)[8][4], const uint32_t (&af)[DKP / 16][4],
                                         const bf16* bs, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < DKP / 16; ++kk) {
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      // matrices: rows 16jp + {0-7, 0-7, 8-15, 8-15} x dims 16kk + {0-7, 8-15, 0-7, 8-15}
      uint32_t b[4];
      ldsm_x4(b, bs + (16 * jp + (lane >> 4) * 8 + (lane & 7)) * tc_stride<DKP>() +
                     16 * kk + ((lane >> 3) & 1) * 8);
      mma_bf16(sc[2 * jp], af[kk], b[0], b[1]);
      mma_bf16(sc[2 * jp + 1], af[kk], b[2], b[3]);
    }
  }
}

// Pass 1. Grid (ceil(N / 64), heads * segments). Each warp keeps its 16
// query rows as A fragments and streams the S slots in chunks of 64 (two
// cp.async buffers) for an online max and sum.
template <int DKP>
__global__ void __launch_bounds__(kTcThreads)
row_stats_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const uint8_t* __restrict__ slot_valid,
                    const uint8_t* __restrict__ q_valid, float* __restrict__ row_max,
                    float* __restrict__ row_scale, int segments, int n, int s, int dk,
                    float scale) {
  extern __shared__ uint4 smem_tc[];
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);
  bf16* ks = qs + kRows * tc_stride<DKP>();  // two chunk buffers
  float* code = reinterpret_cast<float*>(ks + 2 * kSlots * tc_stride<DKP>());  // 2 x 64

  const int hh = blockIdx.y;
  const int seg = hh % segments;
  const int r0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const bf16* kh = k + (size_t)hh * s * dk;
  const uint8_t* sv = slot_valid + (size_t)seg * s;
  const int chunks = (s + kSlots - 1) / kSlots;

  tile_async<DKP>(qs, q + (size_t)hh * n * dk, r0, n, dk);
  tile_async<DKP>(ks, kh, 0, s, dk);
  cp_async_commit();
  if (threadIdx.x < kSlots) {
    const int j = threadIdx.x;
    code[j] = j < s ? (sv[j] ? 1.0f : 0.0f) : -1.0f;
  }
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[DKP / 16][4];
  load_frags<DKP>(qf, qs, warp, lane);

  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.0f, 0.0f};
  for (int c = 0; c < chunks; ++c) {
    const int buf = c & 1;
    if (c + 1 < chunks) {  // the next chunk loads while this one is used
      tile_async<DKP>(ks + (buf ^ 1) * kSlots * tc_stride<DKP>(), kh, (c + 1) * kSlots, s, dk);
      cp_async_commit();
      if (threadIdx.x < kSlots) {
        const int j = (c + 1) * kSlots + threadIdx.x;
        code[(buf ^ 1) * kSlots + threadIdx.x] = j < s ? (sv[j] ? 1.0f : 0.0f) : -1.0f;
      }
    }
    float sc[8][4];
    mma_tile<DKP>(sc, qf, ks + buf * kSlots * tc_stride<DKP>(), lane);
    const float* cb = code + buf * kSlots;
    float cmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float cd = cb[8 * j + 2 * t + (e & 1)];
        const float x = cd > 0.0f ? sc[j][e] * scale : (cd == 0.0f ? kNegBig : -INFINITY);
        sc[j][e] = x;
        cmax[e >> 1] = fmaxf(cmax[e >> 1], x);
      }
    float new_m[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      cmax[h] = fmaxf(cmax[h], __shfl_xor_sync(0xffffffffu, cmax[h], 1));
      cmax[h] = fmaxf(cmax[h], __shfl_xor_sync(0xffffffffu, cmax[h], 2));
      // slot 64c exists, so the chunk max is finite
      new_m[h] = fmaxf(m_run[h], cmax[h]);
    }
    float csum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) csum[e >> 1] += __expf(sc[j][e] - new_m[e >> 1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      csum[h] += __shfl_xor_sync(0xffffffffu, csum[h], 1);
      csum[h] += __shfl_xor_sync(0xffffffffu, csum[h], 2);
      l_run[h] = l_run[h] * __expf(m_run[h] - new_m[h]) + csum[h];
      m_run[h] = new_m[h];
    }
    cp_async_wait<0>();
    __syncthreads();
  }
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 16 * warp + (lane >> 2) + 8 * h;
      if (row < n) {
        const size_t idx = (size_t)hh * n + row;
        row_max[idx] = m_run[h];
        row_scale[idx] = q_valid[(size_t)seg * n + row] ? 1.0f / l_run[h] : 0.0f;
      }
    }
  }
}

// Pass 2. Grid (ceil(S / 64), heads * segments, splits): rows
// [split * rows_per_split, ...) of N. Each warp keeps its 16 slots of k as
// A fragments; per 64-row tile (q, v and the row stats in two cp.async
// buffers) it computes s^T = k q^T, forms p^T in the fragments, splits it
// into two bf16 parts and accumulates p^T v (16 slots x DKP, f32) in
// registers. One split writes the output; several write f32 partials for
// split_reduce_kernel.
template <int DKP>
__global__ void __launch_bounds__(kTcThreads)
slot_accumulate_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const uint8_t* __restrict__ slot_valid,
                          const float* __restrict__ row_max,
                          const float* __restrict__ row_scale, bf16* __restrict__ out,
                          float* __restrict__ partial, int segments, int n, int s, int dk,
                          int rows_per_split, float scale, uint32_t seed, float rate,
                          float inv_keep) {
  extern __shared__ uint4 smem_tc[];
  constexpr int kS = tc_stride<DKP>();
  constexpr int kTile = kRows * kS;  // bf16 elements of a tile
  bf16* ks = reinterpret_cast<bf16*>(smem_tc);
  bf16* qs = ks + kTile;          // two buffers
  bf16* vs = qs + 2 * kTile;      // two buffers
  float* stats = reinterpret_cast<float*>(vs + 2 * kTile);  // 2 x (max, scale) x 64

  const int hh = blockIdx.y;
  const int seg = hh % segments;
  const int c0 = blockIdx.x * kSlots;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row_begin = blockIdx.z * rows_per_split;
  const int row_end = min(n, row_begin + rows_per_split);
  const int tiles = (row_end - row_begin + kRows - 1) / kRows;
  const bf16* qh = q + (size_t)hh * n * dk;
  const bf16* vh = v + (size_t)hh * n * dk;
  const float* rmh = row_max + (size_t)hh * n;
  const float* rsh = row_scale + (size_t)hh * n;

  // Rows [r0, r0 + 64) of q, v and the row stats into buffer b; rows at or
  // past row_end are zeros (so their p is e^0 * 0 = 0).
  auto prefetch = [&](int r0, int b) {
    tile_async<DKP>(qs + b * kTile, qh, r0, row_end, dk);
    tile_async<DKP>(vs + b * kTile, vh, r0, row_end, dk);
    const int i = threadIdx.x & (kRows - 1);
    const bool live = r0 + i < row_end;
    const float* src = threadIdx.x < kRows ? rmh : rsh;
    cp_async4(stats + b * 2 * kRows + threadIdx.x, live ? src + r0 + i : src, live ? 4 : 0);
    cp_async_commit();
  };

  tile_async<DKP>(ks, k + (size_t)hh * s * dk, c0, s, dk);
  if (tiles > 0) prefetch(row_begin, 0);
  else cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t kf[DKP / 16][4];
  load_frags<DKP>(kf, ks, warp, lane);

  // slots c0 + 16 warp + g + 8h: live (scored), dead (-1e30) or past S (p = 0)
  bool live[2], exists[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = c0 + 16 * warp + g + 8 * h;
    exists[h] = j < s;
    live[h] = exists[h] && slot_valid[(size_t)seg * s + j];
  }

  float acc[DKP / 8][4];
#pragma unroll
  for (int j = 0; j < DKP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  for (int it = 0; it < tiles; ++it) {
    const int b = it & 1;
    const int r0 = row_begin + it * kRows;
    if (it + 1 < tiles) prefetch(r0 + kRows, b ^ 1);
    const bf16* qb = qs + b * kTile;
    const bf16* vb = vs + b * kTile;
    const float* rm = stats + b * 2 * kRows;
    const float* rs = rm + kRows;

    // s^T (16 slots, 64 rows): sc[j][e] is slot g + 8 (e >> 1), row 8j + 2t + (e & 1)
    float sc[8][4];
    mma_tile<DKP>(sc, kf, qb, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int i = 8 * j + 2 * t + (e & 1);
        const float x = live[h] ? sc[j][e] * scale : kNegBig;
        float p = exists[h] ? __expf(x - rm[i]) * rs[i] : 0.0f;
        if (rate > 0.0f)
          p *= keep_factor(seed, (uint32_t)hh, (uint32_t)(r0 + i),
                           (uint32_t)(c0 + 16 * warp + g + 8 * h), rate, inv_keep);
        sc[j][e] = p;
      }
    // p^T . v: the C fragments of rows 16kk..16kk+15 are the A fragment,
    // p = hi + lo in two bf16 products
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pack_bf16_split(sc[2 * kk + (r >> 1)][2 * (r & 1)], sc[2 * kk + (r >> 1)][2 * (r & 1) + 1],
                        hi[r], lo[r]);
      mma_split_rows<DKP>(acc, hi, lo, vb + 16 * kk * kS, lane);
    }
    cp_async_wait<0>();
    __syncthreads();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = c0 + 16 * warp + g + 8 * h;
    if (!exists[h]) continue;
    const size_t row = (size_t)hh * s + j;
#pragma unroll
    for (int jn = 0; jn < DKP / 8; ++jn) {
      const int d = 8 * jn + 2 * t;
      if (d >= dk) continue;
      if (partial != nullptr) {
        float2* dst = reinterpret_cast<float2*>(
            partial + ((size_t)blockIdx.z * gridDim.y * s + row) * dk + d);
        *dst = make_float2(acc[jn][2 * h], acc[jn][2 * h + 1]);
      } else {
        *reinterpret_cast<uint32_t*>(out + row * dk + d) =
            pack_bf16(acc[jn][2 * h], acc[jn][2 * h + 1]);
      }
    }
  }
}

// ---- The f32 tensor-core body: f32, dk <= 128, dk % 4 == 0. ----
//
// The bf16 body's passes on the f32 tiles of sparse_attention_common.cuh,
// every product as 3xTF32, 8 warps a block. Operands are read from shared
// memory and split as they are used, so no fragment stays in registers
// across a loop. A 64-row tile with no live row (a padded chunk's dummy
// bag, a bag's padding) issues no products.

// Pass 1. Grid (ceil(N / 64), heads * segments). Warp w takes rows 16 (w &
// 3) .. + 15 of the block's 64 and, of each chunk of 64 slots (two
// cp.async buffers), the half 32 (w >> 2) .. + 31, for an online max and
// sum; the halves merge at the end. A tile with no valid row loads nothing
// and writes max 0, scale 0 (every reader of this body skips such a tile,
// and the CUDA-core backward takes a row of scale 0 as dead whatever its
// max).
template <int DKP>
__global__ void __launch_bounds__(kF32Threads, 2)
row_stats_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const uint8_t* __restrict__ slot_valid,
                      const uint8_t* __restrict__ q_valid, float* __restrict__ row_max,
                      float* __restrict__ row_scale, int segments, int n, int s, int dk,
                      float scale) {
  extern __shared__ uint4 smem_tc[];
  constexpr int kTile = kRows * tf_stride<DKP>();  // floats of a tile
  float* qs = reinterpret_cast<float*>(smem_tc);
  float* ks = qs + kTile;          // two chunk buffers
  float* code = ks + 2 * kTile;    // 2 x 64
  float* upper = code + 2 * kSlots;  // (max, sum) x 64 of the upper halves

  const int hh = blockIdx.y;
  const int seg = hh % segments;
  const int r0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int half = warp >> 2;
  const float* kh = k + (size_t)hh * s * dk;
  const uint8_t* sv = slot_valid + (size_t)seg * s;
  const uint8_t* qv = q_valid + (size_t)seg * n;
  const int chunks = (s + kSlots - 1) / kSlots;

  const bool mine = threadIdx.x < kRows && r0 + threadIdx.x < n;
  if (!__syncthreads_or(mine && qv[r0 + threadIdx.x])) {
    if (mine) {
      row_max[(size_t)hh * n + r0 + threadIdx.x] = 0.0f;
      row_scale[(size_t)hh * n + r0 + threadIdx.x] = 0.0f;
    }
    return;
  }

  tile_async_f32<DKP>(qs, q + (size_t)hh * n * dk, r0, n, dk);
  tile_async_f32<DKP>(ks, kh, 0, s, dk);
  cp_async_commit();
  if (threadIdx.x < kSlots) {
    const int j = threadIdx.x;
    code[j] = j < s ? (sv[j] ? 1.0f : 0.0f) : -1.0f;
  }
  cp_async_wait<0>();
  __syncthreads();

  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.0f, 0.0f};
  for (int c = 0; c < chunks; ++c) {
    const int buf = c & 1;
    if (c + 1 < chunks) {  // the next chunk loads while this one is used
      tile_async_f32<DKP>(ks + (buf ^ 1) * kTile, kh, (c + 1) * kSlots, s, dk);
      cp_async_commit();
      if (threadIdx.x < kSlots) {
        const int j = (c + 1) * kSlots + threadIdx.x;
        code[(buf ^ 1) * kSlots + threadIdx.x] = j < s ? (sv[j] ? 1.0f : 0.0f) : -1.0f;
      }
    }
    float sc[4][4];
    mma_rows_f32<DKP, 4>(sc, qs, 16 * (warp & 3), ks + buf * kTile, 32 * half, lane);
    const float* cb = code + buf * kSlots + 32 * half;
    float cmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float cd = cb[8 * j + 2 * t + (e & 1)];
        const float x = cd > 0.0f ? sc[j][e] * scale : (cd == 0.0f ? kNegBig : -INFINITY);
        sc[j][e] = x;
        cmax[e >> 1] = fmaxf(cmax[e >> 1], x);
      }
    float new_m[2], base[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      cmax[h] = fmaxf(cmax[h], __shfl_xor_sync(0xffffffffu, cmax[h], 1));
      cmax[h] = fmaxf(cmax[h], __shfl_xor_sync(0xffffffffu, cmax[h], 2));
      new_m[h] = fmaxf(m_run[h], cmax[h]);
      // -inf while the half has met no slot (its slots of the first chunk
      // past S): it then sums nothing
      base[h] = new_m[h] == -INFINITY ? 0.0f : new_m[h];
    }
    float csum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) csum[e >> 1] += __expf(sc[j][e] - base[e >> 1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      csum[h] += __shfl_xor_sync(0xffffffffu, csum[h], 1);
      csum[h] += __shfl_xor_sync(0xffffffffu, csum[h], 2);
      l_run[h] = l_run[h] * __expf(m_run[h] - base[h]) + csum[h];
      m_run[h] = new_m[h];
    }
    cp_async_wait<0>();
    __syncthreads();
  }
  // the upper halves hand over; the lower ones (which hold slot 0, so a
  // finite max) merge and write
  const int i = 16 * (warp & 3) + (lane >> 2);
  if (half == 1 && t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      upper[2 * (i + 8 * h)] = m_run[h];
      upper[2 * (i + 8 * h) + 1] = l_run[h];
    }
  }
  __syncthreads();
  if (half == 0 && t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + i + 8 * h;
      if (row < n) {
        const float m2 = upper[2 * (i + 8 * h)], l2 = upper[2 * (i + 8 * h) + 1];
        const float m = fmaxf(m_run[h], m2);
        const float l = l_run[h] * __expf(m_run[h] - m) + l2 * __expf(m2 - m);
        const size_t idx = (size_t)hh * n + row;
        row_max[idx] = m;
        row_scale[idx] = qv[row] ? 1.0f / l : 0.0f;
      }
    }
  }
}

// Pass 2. Grid (ceil(S / 64), heads * segments, splits): rows
// [split * rows_per_split, ...) of N. Warp w takes slots 16 (w & 3) .. +
// 15 of the block's k tile and, of each 64-row tile (q, v and the row
// stats in two cp.async buffers), the half 32 (w >> 2) .. + 31: s^T = k
// q^T, p^T formed in the C fragments, then out^T += p^T v with the C
// fragments as A fragments (mma_c_rows_f32); the halves' sums merge at
// the end. Whether the next tile has a live row is read from row_scale
// while this tile's scores are formed; a tile with none is neither loaded
// nor multiplied. One split writes the output; several write f32
// partials for split_reduce_kernel.
template <int DKP>
__global__ void __launch_bounds__(kF32Threads, 1)
slot_accumulate_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const uint8_t* __restrict__ slot_valid,
                            const float* __restrict__ row_max,
                            const float* __restrict__ row_scale, float* __restrict__ out,
                            float* __restrict__ partial, int segments, int n, int s, int dk,
                            int rows_per_split, float scale, uint32_t seed, float rate,
                            float inv_keep) {
  extern __shared__ uint4 smem_tc[];
  constexpr int kS = tf_stride<DKP>();
  constexpr int kTile = kRows * kS;  // floats of a tile
  float* ks = reinterpret_cast<float*>(smem_tc);
  float* qs = ks + kTile;      // two buffers
  float* vs = qs + 2 * kTile;  // two buffers
  float* stats = vs + 2 * kTile;  // 2 x (max, scale) x 64

  const int hh = blockIdx.y;
  const int seg = hh % segments;
  const int c0 = blockIdx.x * kSlots;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int slot0 = 16 * (warp & 3);  // the warp's slots in the block
  const int row0 = 32 * (warp >> 2);  // the warp's rows in a tile
  const int row_begin = blockIdx.z * rows_per_split;
  const int row_end = min(n, row_begin + rows_per_split);
  const int tiles = (row_end - row_begin + kRows - 1) / kRows;
  const float* qh = q + (size_t)hh * n * dk;
  const float* vh = v + (size_t)hh * n * dk;
  const float* rmh = row_max + (size_t)hh * n;
  const float* rsh = row_scale + (size_t)hh * n;

  // Rows [r0, r0 + 64) of q, v and the row stats into buffer b; rows at or
  // past row_end are zeros (so their p is e^0 * 0 = 0).
  auto prefetch = [&](int r0, int b) {
    tile_async_f32<DKP>(qs + b * kTile, qh, r0, row_end, dk);
    tile_async_f32<DKP>(vs + b * kTile, vh, r0, row_end, dk);
    if (threadIdx.x < 2 * kRows) {
      const int i = threadIdx.x & (kRows - 1);
      const bool live = r0 + i < row_end;
      const float* src = threadIdx.x < kRows ? rmh : rsh;
      cp_async4(stats + b * 2 * kRows + threadIdx.x, live ? src + r0 + i : src, live ? 4 : 0);
    }
  };
  // the scale of row r0 + threadIdx.x (0 for threads past 64 and rows past row_end)
  auto scale_of = [&](int r0) {
    return threadIdx.x < kRows && r0 + (int)threadIdx.x < row_end ? rsh[r0 + threadIdx.x] : 0.0f;
  };

  tile_async_f32<DKP>(ks, k + (size_t)hh * s * dk, c0, s, dk);
  bool live_tile = tiles > 0 && __syncthreads_or(scale_of(row_begin) != 0.0f);
  if (live_tile) prefetch(row_begin, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // slots c0 + slot0 + g + 8h: live (scored), dead (-1e30) or past S (p = 0)
  bool live[2], exists[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = c0 + slot0 + g + 8 * h;
    exists[h] = j < s;
    live[h] = exists[h] && slot_valid[(size_t)seg * s + j];
  }

  // acc: the sum over the tiles; part: one tile's
  float acc[DKP / 8][4], part[DKP / 8][4];
#pragma unroll
  for (int j = 0; j < DKP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = part[j][e] = 0.0f;

  for (int it = 0; it < tiles; ++it) {
    const int b = it & 1;
    const int r0 = row_begin + it * kRows;
    const float next_scale = it + 1 < tiles ? scale_of(r0 + kRows) : 0.0f;
    const float* qb = qs + b * kTile;
    const float* vb = vs + b * kTile;
    const float* rm = stats + b * 2 * kRows;
    const float* rs = rm + kRows;

    // s^T (16 slots, 32 rows): sc[j][e] is slot g + 8 (e >> 1), row
    // row0 + 8j + 2t + (e & 1)
    float sc[4][4];
    if (live_tile) {
      mma_rows_f32<DKP, 4>(sc, ks, slot0, qb, row0, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int i = row0 + 8 * j + 2 * t + (e & 1);
          const float x = live[h] ? sc[j][e] * scale : kNegBig;
          float p = exists[h] ? __expf(x - rm[i]) * rs[i] : 0.0f;
          if (rate > 0.0f)
            p *= keep_factor(seed, (uint32_t)hh, (uint32_t)(r0 + i),
                             (uint32_t)(c0 + slot0 + g + 8 * h), rate, inv_keep);
          sc[j][e] = p;
        }
    }
    // the other buffer was released by the last iteration's barrier
    const bool live_next = __syncthreads_or(next_scale != 0.0f);
    if (live_next) prefetch(r0 + kRows, b ^ 1);
    cp_async_commit();
    if (live_tile) {
      // p^T . v: the C fragment of rows row0 + 8j .. + 7 is the A fragment
      // of one 8-deep step
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma_c_rows_f32<DKP>(part, sc[j], vb + (row0 + 8 * j) * kS, lane);
      add_part<DKP>(acc, part);
    }
    cp_async_wait<0>();
    __syncthreads();
    live_tile = live_next;
  }
  merge_halves<DKP>(acc, qs, warp, lane);
  if (warp >= 4) return;

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = c0 + slot0 + g + 8 * h;
    if (!exists[h]) continue;
    const size_t row = (size_t)hh * s + j;
#pragma unroll
    for (int jn = 0; jn < DKP / 8; ++jn) {
      const int d = 8 * jn + 2 * t;
      if (d >= dk) continue;
      float* dst = partial != nullptr ? partial + ((size_t)blockIdx.z * gridDim.y * s + row) * dk + d
                                      : out + row * dk + d;
      *reinterpret_cast<float2*>(dst) = make_float2(acc[jn][2 * h], acc[jn][2 * h + 1]);
    }
  }
}

template <int DKP>
constexpr size_t smem_tf32_pass1() {
  return (size_t)3 * tf_tile_bytes<DKP>() + 4 * kSlots * sizeof(float);
}
template <int DKP>
constexpr size_t smem_tf32_pass2() {
  return (size_t)5 * tf_tile_bytes<DKP>() + 4 * kRows * sizeof(float);
}

template <int DKP>
constexpr size_t smem_tc_pass1() {
  return (size_t)3 * tc_tile_bytes<DKP>() + 2 * kSlots * sizeof(float);
}
template <int DKP>
constexpr size_t smem_tc_pass2() {
  return (size_t)5 * tc_tile_bytes<DKP>() + 4 * kRows * sizeof(float);
}

// out = T(sum over the splits of the f32 partials), in split order.
template <typename T>
__global__ void __launch_bounds__(256)
split_reduce_kernel(const float* __restrict__ partial, T* __restrict__ out, size_t total,
                    int splits) {
  sum_splits(partial, out, total, splits);
}

// Dynamic shared memory of each pass for a row stride of `stride` floats.
constexpr size_t smem_pass1(int stride) {
  return sizeof(float) * ((size_t)(kRows + kSlots) * stride + kSlots);
}
constexpr size_t smem_pass2(int stride) {
  return sizeof(float) * ((size_t)(kSlots + 2 * kRows) * stride +
                          (size_t)kRows * (kSlots + 1) + kSlots + 2 * kRows);
}

struct Args {
  const void *q, *k, *v, *slot_valid, *q_valid;
  void *out, *row_max, *row_scale, *partial;
  int heads, segments, n, s, dk, splits;
  float scale;
  uint32_t seed;
  float rate, inv_keep;
  cudaStream_t stream;

  int rows_per_split() const { return (n + kRows * splits - 1) / (kRows * splits) * kRows; }
  dim3 grid1() const { return dim3((n + kRows - 1) / kRows, heads * segments); }
  dim3 grid2() const { return dim3((s + kSlots - 1) / kSlots, heads * segments, splits); }
  float* part() const { return splits > 1 ? static_cast<float*>(partial) : nullptr; }
  // 16 bytes a load: whole 16-byte chunks a row and 16-byte aligned bases
  template <typename T>
  bool vec() const {
    return dk % (16 / sizeof(T)) == 0 &&
           (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
            reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  }
};

// The splits' sum, when there are several.
template <typename T>
cudaError_t launch_reduce(const Args& a) {
  if (a.splits == 1) return cudaSuccess;
  const size_t total = (size_t)a.heads * a.segments * a.s * a.dk;
  const int blocks = (int)std::min<size_t>((total + 255) / 256, 4 * 132);
  split_reduce_kernel<T><<<blocks, 256, 0, a.stream>>>(static_cast<const float*>(a.partial),
                                                 static_cast<T*>(a.out), total, a.splits);
  return cudaGetLastError();
}

// The CUDA-core body, DM = dims of dk per thread: the limits are raised to
// what the largest dk of the kernel needs (pass 1 serves every DM).
template <typename T, int DM>
cudaError_t launch(const Args& a) {
  static std::atomic<uint64_t> ready1{0}, ready2{0};
  const int stride = a.dk | 1;  // odd row stride: conflict-free column reads
  const size_t smem1 = smem_pass1(stride);
  const size_t smem2 = smem_pass2(stride);
  cudaError_t err = allow_smem(row_stats_kernel<T>, smem_pass1(256 + 1), ready1);
  if (err != cudaSuccess) return err;
  err = allow_smem(slot_accumulate_kernel<T, DM>, smem_pass2(16 * DM + 1), ready2);
  if (err != cudaSuccess) return err;
  row_stats_kernel<T><<<a.grid1(), kThreads, smem1, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const uint8_t*>(a.slot_valid), static_cast<const uint8_t*>(a.q_valid),
      static_cast<float*>(a.row_max), static_cast<float*>(a.row_scale), a.segments, a.n,
      a.s, a.dk, stride, a.scale, a.vec<T>());
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  slot_accumulate_kernel<T, DM><<<a.grid2(), kThreads, smem2, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const uint8_t*>(a.slot_valid), static_cast<const float*>(a.row_max),
      static_cast<const float*>(a.row_scale), static_cast<T*>(a.out), a.part(), a.segments,
      a.n, a.s, a.dk, stride, a.rows_per_split(), a.scale, a.seed, a.rate, a.inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce<T>(a);
}

// The tensor-core body, dk <= DKP.
template <int DKP>
cudaError_t launch_tc(const Args& a) {
  static std::atomic<uint64_t> ready1{0}, ready2{0};
  cudaError_t err = allow_smem(row_stats_tc_kernel<DKP>, smem_tc_pass1<DKP>(), ready1);
  if (err != cudaSuccess) return err;
  err = allow_smem(slot_accumulate_tc_kernel<DKP>, smem_tc_pass2<DKP>(), ready2);
  if (err != cudaSuccess) return err;
  row_stats_tc_kernel<DKP><<<a.grid1(), kTcThreads, smem_tc_pass1<DKP>(), a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const uint8_t*>(a.slot_valid), static_cast<const uint8_t*>(a.q_valid),
      static_cast<float*>(a.row_max), static_cast<float*>(a.row_scale), a.segments, a.n,
      a.s, a.dk, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  slot_accumulate_tc_kernel<DKP><<<a.grid2(), kTcThreads, smem_tc_pass2<DKP>(), a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const uint8_t*>(a.slot_valid),
      static_cast<const float*>(a.row_max), static_cast<const float*>(a.row_scale),
      static_cast<bf16*>(a.out), a.part(), a.segments, a.n, a.s, a.dk, a.rows_per_split(),
      a.scale, a.seed, a.rate, a.inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce<bf16>(a);
}

// The f32 tensor-core body, dk <= DKP.
template <int DKP>
cudaError_t launch_tf32(const Args& a) {
  static std::atomic<uint64_t> ready1{0}, ready2{0};
  cudaError_t err = allow_smem(row_stats_tf32_kernel<DKP>, smem_tf32_pass1<DKP>(), ready1);
  if (err != cudaSuccess) return err;
  err = allow_smem(slot_accumulate_tf32_kernel<DKP>, smem_tf32_pass2<DKP>(), ready2);
  if (err != cudaSuccess) return err;
  row_stats_tf32_kernel<DKP><<<a.grid1(), kF32Threads, smem_tf32_pass1<DKP>(), a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const uint8_t*>(a.slot_valid), static_cast<const uint8_t*>(a.q_valid),
      static_cast<float*>(a.row_max), static_cast<float*>(a.row_scale), a.segments, a.n,
      a.s, a.dk, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  slot_accumulate_tf32_kernel<DKP>
      <<<a.grid2(), kF32Threads, smem_tf32_pass2<DKP>(), a.stream>>>(
          static_cast<const float*>(a.q), static_cast<const float*>(a.k),
          static_cast<const float*>(a.v), static_cast<const uint8_t*>(a.slot_valid),
          static_cast<const float*>(a.row_max), static_cast<const float*>(a.row_scale),
          static_cast<float*>(a.out), a.part(), a.segments, a.n, a.s, a.dk, a.rows_per_split(),
          a.scale, a.seed, a.rate, a.inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce<float>(a);
}

template <typename T>
cudaError_t launch_dtype(const Args& a) {
  // cp.async moves 16 bytes: whole 16-byte chunks a row (dk % 8 == 0 in
  // bf16, dk % 4 == 0 in f32) and 16-byte aligned bases
  if (a.dk <= 128 && a.vec<T>()) {
    if (sizeof(T) == 4) {
      if (a.dk <= 32) return launch_tf32<32>(a);
      if (a.dk <= 64) return launch_tf32<64>(a);
      if (a.dk <= 96) return launch_tf32<96>(a);
      return launch_tf32<128>(a);
    }
    if (a.dk <= 32) return launch_tc<32>(a);
    if (a.dk <= 64) return launch_tc<64>(a);
    if (a.dk <= 96) return launch_tc<96>(a);
    return launch_tc<128>(a);
  }
  if (a.dk <= 64) return launch<T, 4>(a);
  if (a.dk <= 128) return launch<T, 8>(a);
  return launch<T, 16>(a);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; scale is 1 / sqrt(dk). row_max and
// row_scale are f32 scratch of heads * segments * n values each; with
// splits > 1, partial is f32 scratch of splits * heads * segments * s * dk
// values (unused with one split). Launches on `stream` and returns the
// cudaError_t of the launches (0 on success); it does not synchronise.
extern "C" int snuffy_sparse_attention_fwd(
    const void* q, const void* k, const void* v, const void* slot_valid,
    const void* q_valid, void* out, void* row_max, void* row_scale, void* partial,
    int heads, int segments, int n, int s, int dk, int dtype, int splits, float scale,
    int seed, float rate, float inv_keep, void* stream) {
  if (heads < 1 || segments < 1 || n < 1 || s < 1 || dk < 1 || dk > 256 ||
      heads * segments > 65535 || splits < 1 || splits > 65535 ||
      (splits > 1 && partial == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, slot_valid, q_valid, out, row_max, row_scale, partial,
               heads, segments, n, s, dk, splits, scale, static_cast<uint32_t>(seed),
               rate, inv_keep, static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (dtype == 0) {
    err = launch_dtype<float>(a);
  } else if (dtype == 1) {
    err = launch_dtype<__nv_bfloat16>(a);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* snuffy_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
