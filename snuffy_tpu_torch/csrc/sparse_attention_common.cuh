// Device helpers shared by the sparse-attention kernels
// (sparse_attention_fwd.cu, sparse_attention_bwd.cu): the tile shape, the
// dropout hash of the TPU kernel, tile loads, the 64 x 64 score tile, the
// sum of N splits, and the tensor-core tiles and products of their bf16
// and f32 bodies. dense_attention.cu takes the block size, the type
// conversions and the 16-lane reductions from here, and its f32 body the
// f32 tiles and products.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

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

// out[i] = T(sum over the splits of partial[split * total + i]), in split
// order (a grid-stride loop).
template <typename T>
__device__ __forceinline__ void sum_splits(const float* __restrict__ partial,
                                           T* __restrict__ out, size_t total,
                                           int splits) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float sum = 0.0f;
    for (int sp = 0; sp < splits; ++sp) sum += partial[(size_t)sp * total + i];
    store(out + i, sum);
  }
}

// ---- Tensor-core tiles: bf16, dk <= 128, dk % 8 == 0. ----
//
// 4 warps a block, mma.sync m16n8k16 (bf16 in, f32 sums). A tile is 64
// rows of DKP bf16 (dk padded with zeros to a multiple of 32) at a row
// stride of DKP + 8, so the 8 rows of an ldmatrix hit 8 different bank
// groups, filled by 16-byte cp.async (zero-filled past the rows or dk).
// Fragments (g = lane / 4, t = lane % 4): C element c[e] of a 16 x 8 tile
// is row g + 8 (e >> 1), column 2t + (e & 1).

constexpr int kTcThreads = 128;

template <int DKP>
__host__ __device__ constexpr int tc_stride() {
  return DKP + 8;
}
template <int DKP>
__host__ __device__ constexpr int tc_tile_bytes() {
  return kRows * tc_stride<DKP>() * 2;
}

// Starts the copy of rows [r0, r0 + 64) of a (rows, dk) bf16 matrix into a
// tile: zeros past `rows` and past dk.
template <int DKP>
__device__ __forceinline__ void tile_async(bf16* dst, const bf16* __restrict__ src, int r0,
                                           int rows, int dk) {
  constexpr int kChunks = DKP / 8;
  for (int idx = threadIdx.x; idx < kRows * kChunks; idx += kTcThreads) {
    const int r = idx / kChunks;
    const int d = (idx - r * kChunks) * 8;
    const bool live = r0 + r < rows && d < dk;
    cp_async16(dst + r * tc_stride<DKP>() + d, live ? src + (size_t)(r0 + r) * dk + d : src,
               live ? 16 : 0);
  }
}

// A fragments of the warp's 16 rows of a tile.
template <int DKP>
__device__ __forceinline__ void load_frags(uint32_t (&af)[DKP / 16][4], const bf16* tile,
                                           int warp, int lane) {
#pragma unroll
  for (int kk = 0; kk < DKP / 16; ++kk)
    ldsm_x4(af[kk], tile + (16 * warp + (lane & 15)) * tc_stride<DKP>() + 16 * kk +
                        (lane >> 4) * 8);
}

// c = a . b^T over DKP for the warp's 16 rows of a (A fragments) and rows
// 16jp .. 16jp + 15 of the tile b: c[jn][e] pairs row g + 8 (e >> 1) of a
// with row 16jp + 8jn + 2t + (e & 1) of b.
template <int DKP>
__device__ __forceinline__ void mma_cols16(float (&c)[2][4], const uint32_t (&af)[DKP / 16][4],
                                           const bf16* bs, int jp, int lane) {
#pragma unroll
  for (int jn = 0; jn < 2; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[jn][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < DKP / 16; ++kk) {
    // matrices: rows 16jp + {0-7, 0-7, 8-15, 8-15} x dims 16kk + {0-7, 8-15, 0-7, 8-15}
    uint32_t b[4];
    ldsm_x4(b, bs + (16 * jp + (lane >> 4) * 8 + (lane & 7)) * tc_stride<DKP>() + 16 * kk +
                   ((lane >> 3) & 1) * 8);
    mma_bf16(c[0], af[kk], b[0], b[1]);
    mma_bf16(c[1], af[kk], b[2], b[3]);
  }
}

// The C fragments of a 16 x 16 tile (c[0] columns 0-7, c[1] columns 8-15)
// as the A fragment of one 16-deep step, split into two bf16 parts.
__device__ __forceinline__ void split_frag(const float (&c)[2][4], uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
    pack_bf16_split(c[r >> 1][2 * (r & 1)], c[r >> 1][2 * (r & 1) + 1], hi[r], lo[r]);
}

// acc (the warp's 16 rows x DKP, C fragments) += (hi + lo) . x: the A
// fragments hi and lo are 16 x 16, x the 16 rows of a tile it points at
// (by ldmatrix.trans), two bf16 products.
template <int DKP>
__device__ __forceinline__ void mma_split_rows(float (&acc)[DKP / 8][4], const uint32_t (&hi)[4],
                                               const uint32_t (&lo)[4], const bf16* x,
                                               int lane) {
#pragma unroll
  for (int jj = 0; jj < DKP / 16; ++jj) {
    // matrices: rows {0-7, 8-15, 0-7, 8-15} x dims 16jj + {0-7, 0-7, 8-15, 8-15}
    uint32_t bx[4];
    ldsm_x4_trans(bx, x + ((lane & 7) + ((lane >> 3) & 1) * 8) * tc_stride<DKP>() + 16 * jj +
                          (lane >> 4) * 8);
    mma_bf16(acc[2 * jj], hi, bx[0], bx[1]);
    mma_bf16(acc[2 * jj + 1], hi, bx[2], bx[3]);
    mma_bf16(acc[2 * jj], lo, bx[0], bx[1]);
    mma_bf16(acc[2 * jj + 1], lo, bx[2], bx[3]);
  }
}

// ---- Tensor-core tiles: f32, dk <= 128, dk % 4 == 0. ----
//
// mma.sync m16n8k8 (tf32 in, f32 sums), every product as 3xTF32: each
// f32 operand is split into big + small tf32 parts as it leaves shared
// memory (split_tf32), and a . b is formed as big.small + small.big +
// big.big, small.small (2^-22 of the product) left out. The tensor cores'
// f32 sums do not round to nearest: chained over a whole split of N they
// drifted by up to 7.5e-5 of max |out| on the card. So no sum is chained
// for long: a score sums 16 dims at a time in fresh registers, a sum over
// N or S one 64-row tile (or one 64-slot chunk) at a time, and each part
// is added to its total with an f32 add. A tile is 64 rows of DKP floats
// (dk padded with zeros to a multiple of 32) at a row stride of DKP + 4,
// filled by 16-byte cp.async (zero-filled past the rows or dk). The stride
// is 4 words past a multiple of 32 banks, so ldmatrix's 8 rows of 16 bytes
// and the loads of mma_c_rows_f32 (rows 2t, 2t + 1, column g) are free of
// bank conflicts. ldmatrix is a 16-bit instruction; on f32 it hands lane
// (g, t) the float at row g, column t of an 8 x 4 block, which is where
// the tf32 A and B fragments want it.

// 8 warps a block: 4 groups of 16 rows (or slots), each split in two
// halves over the other axis of the products; the halves' sums meet once,
// in shared memory, at the end.
constexpr int kF32Threads = 256;

template <int DKP>
__host__ __device__ constexpr int tf_stride() {
  return DKP + 4;
}
template <int DKP>
__host__ __device__ constexpr int tf_tile_bytes() {
  return kRows * tf_stride<DKP>() * 4;
}

// Starts the copy of rows [r0, r0 + 64) of a (rows, dk) f32 matrix into a
// tile: zeros past `rows` and past dk.
template <int DKP>
__device__ __forceinline__ void tile_async_f32(float* dst, const float* __restrict__ src, int r0,
                                               int rows, int dk) {
  constexpr int kChunks = DKP / 4;
  for (int idx = threadIdx.x; idx < kRows * kChunks; idx += kF32Threads) {
    const int r = idx / kChunks;
    const int d = (idx - r * kChunks) * 4;
    const bool live = r0 + r < rows && d < dk;
    cp_async16(dst + r * tf_stride<DKP>() + d, live ? src + (size_t)(r0 + r) * dk + d : src,
               live ? 16 : 0);
  }
}

// The four registers of an ldmatrix.x4, split into big and small parts.
__device__ __forceinline__ void ldsm_x4_split(uint32_t (&big)[4], uint32_t (&small)[4],
                                              const float* p) {
  uint32_t r[4];
  ldsm_x4(r, p);
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(r[i]), big[i], small[i]);
}

// c = a . b^T over DKP for rows a0 .. a0 + 15 of the tile a and rows b0 ..
// b0 + 8 NB - 1 of the tile b: c[j][e] pairs row g + 8 (e >> 1) of a with
// row b0 + 8j + 2t + (e & 1) of b. Per 8 dims, A and B are loaded and
// split first, then each term runs over the NB products in turn; every 16
// dims are summed in fresh registers and added to c. Only the first
// `cols` groups of 8 b rows are multiplied (the rest of c stays 0).
template <int DKP, int NB>
__device__ __forceinline__ void mma_rows_f32(float (&c)[NB][4], const float* as, int a0,
                                             const float* bs, int b0, int lane,
                                             int cols = NB) {
  constexpr int kS = tf_stride<DKP>();
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.0f;
  const float* ap = as + (a0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kS + (lane >> 4) * 4;
  const float* bp = bs + (b0 + (lane & 7) + (lane >> 4) * 8) * kS + ((lane >> 3) & 1) * 4;
#pragma unroll 2
  for (int k2 = 0; k2 < DKP / 16; ++k2) {
    float d[NB][4] = {};
#pragma unroll
    for (int kk = 2 * k2; kk < 2 * k2 + 2; ++kk) {
      // a: rows a0 + {0-7, 8-15, 0-7, 8-15} x dims 8kk + {0-3, 0-3, 4-7, 4-7}
      uint32_t ab[4], as_[4];
      ldsm_x4_split(ab, as_, ap + 8 * kk);
      // b, two blocks of 8 rows an ldmatrix: rows b0 + 16jp + {0-7, 0-7,
      // 8-15, 8-15} x dims 8kk + {0-3, 4-7, 0-3, 4-7}
      uint32_t bb[NB / 2][4], bs_[NB / 2][4];
#pragma unroll
      for (int jp = 0; jp < NB / 2; ++jp)
        if (2 * jp < cols) ldsm_x4_split(bb[jp], bs_[jp], bp + 16 * jp * kS + 8 * kk);
#pragma unroll
      for (int j = 0; j < NB; ++j)
        if (j < cols) mma_tf32(d[j], ab, bs_[j >> 1][2 * (j & 1)], bs_[j >> 1][2 * (j & 1) + 1]);
#pragma unroll
      for (int j = 0; j < NB; ++j)
        if (j < cols) mma_tf32(d[j], as_, bb[j >> 1][2 * (j & 1)], bb[j >> 1][2 * (j & 1) + 1]);
#pragma unroll
      for (int j = 0; j < NB; ++j)
        if (j < cols) mma_tf32(d[j], ab, bb[j >> 1][2 * (j & 1)], bb[j >> 1][2 * (j & 1) + 1]);
    }
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[j][e] += d[j][e];
  }
}

// part (16 rows x DKP, C fragments) += c . x, where c is the C fragment of
// a 16 x 8 tile whose 8 columns are the summed index and x points at the 8
// matching rows of a tile. The C fragment holds columns 2t and 2t + 1;
// they are taken as the A fragment's k = t and t + 4, and x's rows 2t and
// 2t + 1 as B's rows t and t + 4. The sum runs over the same 8 pairs in
// another order, with no shuffle. `part` is a tile's (or a chunk's) part
// of a long sum: the caller adds it to the total (add_part).
template <int DKP>
__device__ __forceinline__ void mma_c_rows_f32(float (&part)[DKP / 8][4], const float (&c)[4],
                                               const float* x, int lane) {
  constexpr int kS = tf_stride<DKP>();
  uint32_t ab[4], as_[4];
  split_tf32(c[0], ab[0], as_[0]);  // (g, k = t)         <- (g, 2t)
  split_tf32(c[2], ab[1], as_[1]);  // (g + 8, k = t)     <- (g + 8, 2t)
  split_tf32(c[1], ab[2], as_[2]);  // (g, k = t + 4)     <- (g, 2t + 1)
  split_tf32(c[3], ab[3], as_[3]);  // (g + 8, k = t + 4) <- (g + 8, 2t + 1)
  const float* x0 = x + 2 * (lane & 3) * kS + (lane >> 2);
#pragma unroll
  for (int j4 = 0; j4 < DKP / 32; ++j4) {
    // B (t, g) is row 2t, dim 8jn + g; B (t + 4, g) row 2t + 1
    uint32_t bb[4][2], bs_[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      split_tf32(x0[8 * (4 * j4 + i)], bb[i][0], bs_[i][0]);
      split_tf32(x0[kS + 8 * (4 * j4 + i)], bb[i][1], bs_[i][1]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) mma_tf32(part[4 * j4 + i], ab, bs_[i][0], bs_[i][1]);
#pragma unroll
    for (int i = 0; i < 4; ++i) mma_tf32(part[4 * j4 + i], as_, bb[i][0], bb[i][1]);
#pragma unroll
    for (int i = 0; i < 4; ++i) mma_tf32(part[4 * j4 + i], ab, bb[i][0], bb[i][1]);
  }
}

// acc += part, and part = 0 for the next one.
template <int DKP>
__device__ __forceinline__ void add_part(float (&acc)[DKP / 8][4], float (&part)[DKP / 8][4]) {
#pragma unroll
  for (int j = 0; j < DKP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[j][e] += part[j][e];
      part[j][e] = 0.0f;
    }
}

// The two halves' sums of a 16 x DKP C-fragment accumulator meet: warps
// 4-7 leave theirs in `scratch` (64 DKP floats), warps 0-3 add them to
// their own. Ends with a barrier; only warps 0-3 then hold the sum.
template <int DKP>
__device__ __forceinline__ void merge_halves(float (&acc)[DKP / 8][4], float* scratch,
                                             int warp, int lane) {
  float* mine = scratch + (warp & 3) * (DKP / 8) * 4 * 32 + lane;
  if (warp >= 4) {
#pragma unroll
    for (int j = 0; j < DKP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[(4 * j + e) * 32] = acc[j][e];
  }
  __syncthreads();
  if (warp < 4) {
#pragma unroll
    for (int j = 0; j < DKP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += mine[(4 * j + e) * 32];
  }
  __syncthreads();
}

}  // namespace snuffy
