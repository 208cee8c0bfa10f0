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
// What bounds it on the H100: at one bag (h=4, N=10240 with 10000 valid,
// S=512 with ~10 % dead, dk=96, bf16) the TPU kernel's five products,
// 10 * h * dk * live pairs ~ 17.7 GFLOP, take 18.09 us at the 989.4 TFLOP/s
// bf16 tensor-core peak; the bytes (q, k, v, g, the row stats, dq, dk, dv,
// each once), ~ 33 MB over 3.35 TB/s, take ~ 10 us. The TPU kernel carries
// dk across its sequential N grid in VMEM. Blocks here run in no order, so
// the work is split into passes that keep every (N, S) matrix out of
// device memory and use no atomics (two launches give the same bits):
//   pass A (row_grad): one block per (64-row tile, hh). Sweep 1 over the
//     slots in chunks of 64 forms p~ and accumulates dv = p~ g; then D =
//     v . dv from the f32 sums, before any rounding, and dv is written.
//     Sweep 2 forms the scores and v . g^T again, then ds, and accumulates
//     dq = ds k. Writes dv, dq and D (4 bytes a row, for pass B).
//   pass B (slot_grad): one block per (64-slot chunk, hh, split of N) keeps
//     its k and g slots, loops over its rows in tiles of 64, recomputes the
//     scores and v . g^T, forms ds from the row stats and D, and
//     accumulates dk = ds^T q. N is split as the forward splits it, until
//     the grid has 256 blocks (8 splits at one bag, 1 at 8 bags); each
//     split writes an f32 partial, and
//   dk_reduce sums the partials in split order and casts (several splits
//     only).
// Per (row, slot, dim) pass A runs q.k^T and p~ g, then q.k^T, v.g^T and
// ds k; pass B k.q^T, g.v^T and ds^T q: 8 products against the TPU
// kernel's 5. Three bodies, by dtype and dk (and 16-byte aligned bases,
// which the tensor-core bodies' cp.async needs):
//   bf16, dk <= 128, dk % 8 == 0: 4 warps of 16 rows (pass A) or 16 slots
//     (pass B), every product on the tensor cores (mma.sync m16n8k16, bf16
//     in, f32 sums), tiles double-buffered by 16-byte cp.async and read by
//     ldmatrix. The score-shaped C fragments (p~, ds) become the A
//     fragments of the next product; pass B is transposed as the forward's
//     pass 2: with the warp's slots of k and g as A fragments for the whole
//     row loop, s^T = k q^T and g v^T give ds^T, then ds^T q takes q by
//     ldmatrix.trans. p~ and ds are f32 and enter p~ g, ds k and ds^T q as
//     hi = bf16(x) plus lo = bf16(x - hi): two bf16 products each, so 11
//     products' worth of tensor-core work. Emulated at the operating widths
//     (tests/test_torch_sparse_attention.py), one rounding of p~ or ds
//     moves dv, dq and dk by 1.5e-3-2.8e-3 of their largest value and
//     flips outputs near 2^-8 of it by up to 73 bf16 ulps; hi + lo keeps
//     them within 4.4e-6, one ulp after the cast.
//   f32, dk <= 128, dk % 4 == 0 (the training CLI's dtype): the bf16
//     body's passes and steps on f32 tiles, 8 warps a block (4 groups of
//     16 rows or slots, each taking half of every chunk's or tile's
//     16-wide steps, their sums merged in shared memory), every product on
//     the tensor
//     cores as 3xTF32 (sparse_attention_fwd.cu says how, and why this
//     split: emulated at the CLI's widths it keeps dq, dk and dv within
//     1.1e-6-1.8e-6 of max |plain|). p~ and ds are f32 already and are
//     split like any other operand; their C fragments become A fragments
//     with the summed index relabelled (mma_c_rows_f32). A 64-row tile
//     whose rows all have scale 0 issues no products: pass A writes its
//     zero dq, dv and D, pass B neither loads nor multiplies it. ptxas
//     (-v, sm_90a): row_grad_tf32_kernel 173 / 167 / 211 / 243 registers
//     at DKP 32 / 64 / 96 / 128, slot_grad_tf32_kernel 162 / 166 / 198 /
//     230; no spills.
//   f32 or bf16 otherwise (musk1's dk=83, dk > 128): 256 threads, every
//     product on CUDA cores in f32 (8 multiply-adds per (row, slot, dim));
//     pass B split over N as above.
// The ragged edges of N, S and dk are masked here, nothing is padded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

#include "mma_common.cuh"
#include "sparse_attention_common.cuh"

namespace {

using namespace snuffy;

// ---- The CUDA-core body: f32, or other dk. ----

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

// Pass B. Grid (ceil(S / 64), heads * segments, splits): rows
// [split * rows_per_split, ...) of N. One split writes dk; several write
// f32 partials for dk_reduce_kernel.
template <typename T, int DM>
__global__ void __launch_bounds__(kThreads)
slot_grad_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ g,
                 const uint8_t* __restrict__ slot_valid,
                 const float* __restrict__ row_max,
                 const float* __restrict__ row_scale,
                 const float* __restrict__ delta, T* __restrict__ dk_out,
                 float* __restrict__ partial, int segments, int n, int s, int dk,
                 int stride, int rows_per_split, float scale, uint32_t seed,
                 float rate, float inv_keep) {
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

  const int row_end = min(n, (int)blockIdx.z * rows_per_split + rows_per_split);
  for (int r0 = blockIdx.z * rows_per_split; r0 < row_end; r0 += kRows) {
    const int rows = min(kRows, row_end - r0);
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
        if (d >= dk) continue;
        const size_t idx = (sbase + j) * dk + d;
        if (partial != nullptr)
          partial[(size_t)blockIdx.z * gridDim.y * s * dk + idx] = scale * acc[b][m];
        else
          store(dk_out + idx, scale * acc[b][m]);
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

// ---- The tensor-core body: bf16, dk <= 128, dk % 8 == 0. ----
//
// 4 warps a block on the tiles of sparse_attention_common.cuh. p~ and ds
// are formed in C fragments of 16 x 16 and enter their next product as
// hi + lo A fragments (split_frag, mma_split_rows). Both passes ask for
// two blocks an SM (at most 255 registers a thread; 80 KB of shared
// memory a block at dk = 96): without it ptxas spilled at dk <= 32.

// Pass A. Grid (ceil(N / 64), heads * segments). Each warp keeps its 16
// rows of q (both sweeps) and of v (sweep 2) as A fragments; the slots
// stream in chunks of 64 (k, g and the slot codes in two cp.async
// buffers), 16 slots a step.
template <int DKP>
__global__ void __launch_bounds__(kTcThreads, 2)
row_grad_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ g,
                   const uint8_t* __restrict__ slot_valid,
                   const float* __restrict__ row_max, const float* __restrict__ row_scale,
                   bf16* __restrict__ dq, bf16* __restrict__ dv, float* __restrict__ delta,
                   int segments, int n, int s, int dk, float scale, uint32_t seed,
                   float rate, float inv_keep) {
  extern __shared__ uint4 smem_tc[];
  constexpr int kS = tc_stride<DKP>();
  constexpr int kTile = kRows * kS;  // bf16 elements of a tile
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);
  bf16* vs = qs + kTile;
  bf16* ks = vs + kTile;      // two buffers
  bf16* gs = ks + 2 * kTile;  // two buffers
  float* code = reinterpret_cast<float*>(gs + 2 * kTile);  // 2 x 64

  const int hh = blockIdx.y;
  const int seg = hh % segments;
  const int r0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const size_t rbase = (size_t)hh * n;
  const bf16* kh = k + (size_t)hh * s * dk;
  const bf16* gh = g + (size_t)hh * s * dk;
  const uint8_t* sv = slot_valid + (size_t)seg * s;
  const int chunks = (s + kSlots - 1) / kSlots;

  // Chunk c of k and g into buffer b (one commit group), and its slot
  // codes: 1 live, 0 dead (scored -1e30), -1 past S.
  auto prefetch = [&](int c, int b) {
    tile_async<DKP>(ks + b * kTile, kh, c * kSlots, s, dk);
    tile_async<DKP>(gs + b * kTile, gh, c * kSlots, s, dk);
    cp_async_commit();
    if (threadIdx.x < kSlots) {
      const int j = c * kSlots + threadIdx.x;
      code[b * kSlots + threadIdx.x] = j < s ? (sv[j] ? 1.0f : 0.0f) : -1.0f;
    }
  };

  // the thread's rows r0 + 16 warp + g + 8h; past n they are dead (scale 0)
  int row[2];
  float rm[2], rs[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = r0 + 16 * warp + (lane >> 2) + 8 * h;
    rm[h] = row[h] < n ? row_max[rbase + row[h]] : 0.0f;
    rs[h] = row[h] < n ? row_scale[rbase + row[h]] : 0.0f;
  }

  tile_async<DKP>(qs, q + rbase * dk, r0, n, dk);
  tile_async<DKP>(vs, v + rbase * dk, r0, n, dk);
  prefetch(0, 0);
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[DKP / 16][4];
  load_frags<DKP>(qf, qs, warp, lane);

  // acc: the sum over the chunks; part: one chunk's
  float acc[DKP / 8][4], part[DKP / 8][4];
#pragma unroll
  for (int j = 0; j < DKP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = part[j][e] = 0.0f;

  // Sweep 1: dv = p~ g, 16 slots a step.
  for (int c = 0; c < chunks; ++c) {
    const int b = c & 1;
    if (c + 1 < chunks) prefetch(c + 1, b ^ 1);
    const bf16* kb = ks + b * kTile;
    const bf16* gb = gs + b * kTile;
    const float* cb = code + b * kSlots;
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      float sc[2][4];
      mma_cols16<DKP>(sc, qf, kb, jp, lane);
#pragma unroll
      for (int jn = 0; jn < 2; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int j = 16 * jp + 8 * jn + 2 * t + (e & 1);
          const float cd = cb[j];
          float p = 0.0f;
          if (cd >= 0.0f) {
            p = __expf((cd > 0.0f ? sc[jn][e] * scale : kNegBig) - rm[h]) * rs[h];
            if (rate > 0.0f)
              p *= keep_factor(seed, (uint32_t)hh, (uint32_t)row[h],
                               (uint32_t)(c * kSlots + j), rate, inv_keep);
          }
          sc[jn][e] = p;
        }
      uint32_t hi[4], lo[4];
      split_frag(sc, hi, lo);
      mma_split_rows<DKP>(acc, hi, lo, gb + 16 * jp * kS, lane);
    }
    cp_async_wait<0>();
    __syncthreads();
  }

  // Sweep 2 loads its first chunk while D = v . dv is formed from the f32
  // sums (vf[kk][r] holds the row and columns of acc[2kk + (r >> 1)][2 (r
  // & 1) + {0, 1}]) and dv is written.
  prefetch(0, 0);
  uint32_t vf[DKP / 16][4];
  load_frags<DKP>(vf, vs, warp, lane);
  float dl[2] = {0.0f, 0.0f};
#pragma unroll
  for (int kk = 0; kk < DKP / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float2 vv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&vf[kk][r]));
      const float* a = acc[2 * kk + (r >> 1)] + 2 * (r & 1);
      dl[r & 1] = fmaf(vv.x, a[0], fmaf(vv.y, a[1], dl[r & 1]));
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    dl[h] += __shfl_xor_sync(0xffffffffu, dl[h], 1);
    dl[h] += __shfl_xor_sync(0xffffffffu, dl[h], 2);
    if (row[h] < n) {
      const size_t base = (rbase + row[h]) * dk;
#pragma unroll
      for (int jn = 0; jn < DKP / 8; ++jn) {
        const int d = 8 * jn + 2 * t;
        if (d < dk)
          *reinterpret_cast<uint32_t*>(dv + base + d) = pack_bf16(acc[jn][2 * h], acc[jn][2 * h + 1]);
      }
      if (t == 0) delta[rbase + row[h]] = dl[h];
    }
  }
#pragma unroll
  for (int j = 0; j < DKP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  cp_async_wait<0>();
  __syncthreads();

  // Sweep 2: ds, then dq = scale * ds k.
  for (int c = 0; c < chunks; ++c) {
    const int b = c & 1;
    if (c + 1 < chunks) prefetch(c + 1, b ^ 1);
    const bf16* kb = ks + b * kTile;
    const bf16* gb = gs + b * kTile;
    const float* cb = code + b * kSlots;
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      float sc[2][4], vg[2][4];
      mma_cols16<DKP>(sc, qf, kb, jp, lane);
      mma_cols16<DKP>(vg, vf, gb, jp, lane);
#pragma unroll
      for (int jn = 0; jn < 2; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int j = 16 * jp + 8 * jn + 2 * t + (e & 1);
          float ds = 0.0f;
          if (cb[j] > 0.0f) {  // ds is 0 at dead slots and past S
            const float sigma = __expf(sc[jn][e] * scale - rm[h]) * rs[h];
            const float f = rate > 0.0f ? keep_factor(seed, (uint32_t)hh, (uint32_t)row[h],
                                                      (uint32_t)(c * kSlots + j), rate, inv_keep)
                                        : 1.0f;
            ds = sigma * (vg[jn][e] * f - dl[h]);
          }
          sc[jn][e] = ds;
        }
      uint32_t hi[4], lo[4];
      split_frag(sc, hi, lo);
      mma_split_rows<DKP>(acc, hi, lo, kb + 16 * jp * kS, lane);
    }
    cp_async_wait<0>();
    __syncthreads();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= n) continue;
    const size_t base = (rbase + row[h]) * dk;
#pragma unroll
    for (int jn = 0; jn < DKP / 8; ++jn) {
      const int d = 8 * jn + 2 * t;
      if (d < dk)
        *reinterpret_cast<uint32_t*>(dq + base + d) =
            pack_bf16(scale * acc[jn][2 * h], scale * acc[jn][2 * h + 1]);
    }
  }
}

// Pass B. Grid (ceil(S / 64), heads * segments, splits): rows
// [split * rows_per_split, ...) of N. Each warp keeps its 16 slots of k
// and of g as A fragments; per 64-row tile (q, v, the row stats and D in
// two cp.async buffers), 16 rows a step, it computes s^T = k q^T and
// (v g^T)^T = g v^T, forms ds^T in the fragments and accumulates ds^T q
// (16 slots x DKP, f32) in registers. One split writes dk; several write
// f32 partials for dk_reduce_kernel.
template <int DKP>
__global__ void __launch_bounds__(kTcThreads, 2)
slot_grad_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ g,
                    const uint8_t* __restrict__ slot_valid,
                    const float* __restrict__ row_max, const float* __restrict__ row_scale,
                    const float* __restrict__ delta, bf16* __restrict__ dk_out,
                    float* __restrict__ partial, int segments, int n, int s, int dk,
                    int rows_per_split, float scale, uint32_t seed, float rate,
                    float inv_keep) {
  extern __shared__ uint4 smem_tc[];
  constexpr int kS = tc_stride<DKP>();
  constexpr int kTile = kRows * kS;  // bf16 elements of a tile
  bf16* ks = reinterpret_cast<bf16*>(smem_tc);
  bf16* gs = ks + kTile;
  bf16* qs = gs + kTile;      // two buffers
  bf16* vs = qs + 2 * kTile;  // two buffers
  float* stats = reinterpret_cast<float*>(vs + 2 * kTile);  // 2 x (max, scale, D) x 64

  const int hh = blockIdx.y;
  const int seg = hh % segments;
  const int c0 = blockIdx.x * kSlots;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int row_begin = blockIdx.z * rows_per_split;
  const int row_end = min(n, row_begin + rows_per_split);
  const int tiles = (row_end - row_begin + kRows - 1) / kRows;
  const bf16* qh = q + (size_t)hh * n * dk;
  const bf16* vh = v + (size_t)hh * n * dk;
  const float* rmh = row_max + (size_t)hh * n;
  const float* rsh = row_scale + (size_t)hh * n;
  const float* dlh = delta + (size_t)hh * n;

  // Rows [r0, r0 + 64) of q, v, the row stats and D into buffer b; rows at
  // or past row_end are zeros (scale 0, so their ds is 0).
  auto prefetch = [&](int r0, int b) {
    tile_async<DKP>(qs + b * kTile, qh, r0, row_end, dk);
    tile_async<DKP>(vs + b * kTile, vh, r0, row_end, dk);
    for (int idx = threadIdx.x; idx < 3 * kRows; idx += kTcThreads) {
      const int i = idx % kRows;
      const bool live = r0 + i < row_end;
      const float* src = idx < kRows ? rmh : (idx < 2 * kRows ? rsh : dlh);
      cp_async4(stats + b * 3 * kRows + idx, live ? src + r0 + i : src, live ? 4 : 0);
    }
    cp_async_commit();
  };

  tile_async<DKP>(ks, k + (size_t)hh * s * dk, c0, s, dk);
  tile_async<DKP>(gs, g + (size_t)hh * s * dk, c0, s, dk);
  if (tiles > 0) prefetch(row_begin, 0);
  else cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t kf[DKP / 16][4], gf[DKP / 16][4];
  load_frags<DKP>(kf, ks, warp, lane);
  load_frags<DKP>(gf, gs, warp, lane);

  // slots c0 + 16 warp + g + 8h: ds is 0 unless live
  int slot[2];
  bool live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    slot[h] = c0 + 16 * warp + (lane >> 2) + 8 * h;
    live[h] = slot[h] < s && slot_valid[(size_t)seg * s + slot[h]];
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
    if (it + 1 < tiles) prefetch(r0 + kRows, b ^ 1);
    const bf16* qb = qs + b * kTile;
    const bf16* vb = vs + b * kTile;
    const float* rm = stats + b * 3 * kRows;
    const float* rs = rm + kRows;
    const float* dl = rs + kRows;
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      // sc[jn][e], vg[jn][e]: slot g + 8 (e >> 1), row 16jp + 8jn + 2t + (e & 1)
      float sc[2][4], vg[2][4];
      mma_cols16<DKP>(sc, kf, qb, jp, lane);
      mma_cols16<DKP>(vg, gf, vb, jp, lane);
#pragma unroll
      for (int jn = 0; jn < 2; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int i = 16 * jp + 8 * jn + 2 * t + (e & 1);
          float ds = 0.0f;
          if (live[h]) {
            const float sigma = __expf(sc[jn][e] * scale - rm[i]) * rs[i];
            const float f = rate > 0.0f ? keep_factor(seed, (uint32_t)hh, (uint32_t)(r0 + i),
                                                      (uint32_t)slot[h], rate, inv_keep)
                                        : 1.0f;
            ds = sigma * (vg[jn][e] * f - dl[i]);
          }
          sc[jn][e] = ds;
        }
      uint32_t hi[4], lo[4];
      split_frag(sc, hi, lo);
      mma_split_rows<DKP>(acc, hi, lo, qb + 16 * jp * kS, lane);
    }
    cp_async_wait<0>();
    __syncthreads();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (slot[h] >= s) continue;
    const size_t row = (size_t)hh * s + slot[h];
#pragma unroll
    for (int jn = 0; jn < DKP / 8; ++jn) {
      const int d = 8 * jn + 2 * t;
      if (d >= dk) continue;
      const float x0 = scale * acc[jn][2 * h], x1 = scale * acc[jn][2 * h + 1];
      if (partial != nullptr)
        *reinterpret_cast<float2*>(partial + ((size_t)blockIdx.z * gridDim.y * s + row) * dk + d) =
            make_float2(x0, x1);
      else
        *reinterpret_cast<uint32_t*>(dk_out + row * dk + d) = pack_bf16(x0, x1);
    }
  }
}

// ---- The f32 tensor-core body: f32, dk <= 128, dk % 4 == 0. ----
//
// The bf16 body's passes and steps on the f32 tiles of
// sparse_attention_common.cuh, every product as 3xTF32, 8 warps a block:
// operands are split into big + small tf32 parts as they leave shared
// memory, and p~ and ds, f32 in the C fragments, enter the next product as
// A fragments (mma_c_rows_f32), the slot (or row) index relabelled. A
// 64-row tile whose rows all have scale 0 (a padded chunk's dummy bag, a
// bag's padding) issues no products: pass A writes its zeros, pass B
// neither loads nor multiplies it.

// Pass A. Grid (ceil(N / 64), heads * segments). Warp w takes rows 16 (w &
// 3) .. + 15 of the block's q and v tiles and, of each chunk of 64 slots
// (k, g and the slot codes in two cp.async buffers), the 16-slot steps
// 2 (w >> 2) and 2 (w >> 2) + 1. The halves' dv meet before D = v . dv,
// their dq at the end.
template <int DKP>
__global__ void __launch_bounds__(kF32Threads, 1)
row_grad_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ g,
                     const uint8_t* __restrict__ slot_valid,
                     const float* __restrict__ row_max, const float* __restrict__ row_scale,
                     float* __restrict__ dq, float* __restrict__ dv, float* __restrict__ delta,
                     int segments, int n, int s, int dk, float scale, uint32_t seed,
                     float rate, float inv_keep) {
  extern __shared__ uint4 smem_tc[];
  constexpr int kS = tf_stride<DKP>();
  constexpr int kTile = kRows * kS;  // floats of a tile
  float* qs = reinterpret_cast<float*>(smem_tc);
  float* vs = qs + kTile;
  float* ks = vs + kTile;      // two buffers
  float* gs = ks + 2 * kTile;  // two buffers
  float* code = gs + 2 * kTile;  // 2 x 64
  float* dls = code + 2 * kSlots;  // D of the block's 64 rows

  const int hh = blockIdx.y;
  const int seg = hh % segments;
  const int r0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int row0 = 16 * (warp & 3);  // the warp's rows in the tile
  const int half = warp >> 2;        // its 16-slot steps: 2 half, 2 half + 1
  const size_t rbase = (size_t)hh * n;
  const float* kh = k + (size_t)hh * s * dk;
  const float* gh = g + (size_t)hh * s * dk;
  const uint8_t* sv = slot_valid + (size_t)seg * s;
  const int chunks = (s + kSlots - 1) / kSlots;

  // the thread's rows r0 + row0 + g + 8h; past n they are dead (scale 0)
  int row[2];
  float rm[2], rs[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = r0 + row0 + (lane >> 2) + 8 * h;
    rm[h] = row[h] < n ? row_max[rbase + row[h]] : 0.0f;
    rs[h] = row[h] < n ? row_scale[rbase + row[h]] : 0.0f;
  }

  // A tile with no live row: dq, dv and D are 0.
  if (!__syncthreads_or(rs[0] != 0.0f || rs[1] != 0.0f)) {
    if (half == 1) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row[h] >= n) continue;
      const size_t base = (rbase + row[h]) * dk;
      for (int d = 4 * t; d < dk; d += 16) {
        *reinterpret_cast<float4*>(dq + base + d) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        *reinterpret_cast<float4*>(dv + base + d) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
      if (t == 0) delta[rbase + row[h]] = 0.0f;
    }
    return;
  }

  // Chunk c of k and g into buffer b (one commit group), and its slot
  // codes: 1 live, 0 dead (scored -1e30), -1 past S.
  auto prefetch = [&](int c, int b) {
    tile_async_f32<DKP>(ks + b * kTile, kh, c * kSlots, s, dk);
    tile_async_f32<DKP>(gs + b * kTile, gh, c * kSlots, s, dk);
    cp_async_commit();
    if (threadIdx.x < kSlots) {
      const int j = c * kSlots + threadIdx.x;
      code[b * kSlots + threadIdx.x] = j < s ? (sv[j] ? 1.0f : 0.0f) : -1.0f;
    }
  };

  tile_async_f32<DKP>(qs, q + rbase * dk, r0, n, dk);
  tile_async_f32<DKP>(vs, v + rbase * dk, r0, n, dk);
  prefetch(0, 0);
  cp_async_wait<0>();
  __syncthreads();

  // acc: the sum over the chunks; part: one chunk's
  float acc[DKP / 8][4], part[DKP / 8][4];
#pragma unroll
  for (int j = 0; j < DKP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = part[j][e] = 0.0f;

  // Sweep 1: dv = p~ g, 16 slots a step.
  for (int c = 0; c < chunks; ++c) {
    const int b = c & 1;
    if (c + 1 < chunks) prefetch(c + 1, b ^ 1);
    const float* kb = ks + b * kTile;
    const float* gb = gs + b * kTile;
    const float* cb = code + b * kSlots;
#pragma unroll 1
    for (int jp = 2 * half; jp < 2 * half + 2; ++jp) {
      float sc[2][4];
      mma_rows_f32<DKP, 2>(sc, qs, row0, kb, 16 * jp, lane);
#pragma unroll
      for (int jn = 0; jn < 2; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int j = 16 * jp + 8 * jn + 2 * t + (e & 1);
          const float cd = cb[j];
          float p = 0.0f;
          if (cd >= 0.0f) {
            p = __expf((cd > 0.0f ? sc[jn][e] * scale : kNegBig) - rm[h]) * rs[h];
            if (rate > 0.0f)
              p *= keep_factor(seed, (uint32_t)hh, (uint32_t)row[h],
                               (uint32_t)(c * kSlots + j), rate, inv_keep);
          }
          sc[jn][e] = p;
        }
      mma_c_rows_f32<DKP>(part, sc[0], gb + 16 * jp * kS, lane);
      mma_c_rows_f32<DKP>(part, sc[1], gb + (16 * jp + 8) * kS, lane);
    }
    add_part<DKP>(acc, part);
    cp_async_wait<0>();
    __syncthreads();
  }

  // Sweep 2 loads its first chunk into buffer 0 while the halves' dv meet
  // in buffer 1 and D = v . dv is formed from the f32 sums; dv and D are
  // written.
  prefetch(0, 0);
  merge_halves<DKP>(acc, ks + kTile, warp, lane);
  if (half == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* vrow = vs + (row0 + (lane >> 2) + 8 * h) * kS + 2 * t;
      float dl = 0.0f;
#pragma unroll
      for (int jn = 0; jn < DKP / 8; ++jn) {
        const float2 vv = *reinterpret_cast<const float2*>(vrow + 8 * jn);
        dl = fmaf(vv.x, acc[jn][2 * h], fmaf(vv.y, acc[jn][2 * h + 1], dl));
      }
      dl += __shfl_xor_sync(0xffffffffu, dl, 1);
      dl += __shfl_xor_sync(0xffffffffu, dl, 2);
      if (t == 0) dls[row0 + (lane >> 2) + 8 * h] = dl;
      if (row[h] < n) {
        const size_t base = (rbase + row[h]) * dk;
#pragma unroll
        for (int jn = 0; jn < DKP / 8; ++jn) {
          const int d = 8 * jn + 2 * t;
          if (d < dk)
            *reinterpret_cast<float2*>(dv + base + d) =
                make_float2(acc[jn][2 * h], acc[jn][2 * h + 1]);
        }
        if (t == 0) delta[rbase + row[h]] = dl;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < DKP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  cp_async_wait<0>();
  __syncthreads();
  float dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) dl[h] = dls[row0 + (lane >> 2) + 8 * h];

  // Sweep 2: ds, then dq = scale * ds k.
  for (int c = 0; c < chunks; ++c) {
    const int b = c & 1;
    if (c + 1 < chunks) prefetch(c + 1, b ^ 1);
    const float* kb = ks + b * kTile;
    const float* gb = gs + b * kTile;
    const float* cb = code + b * kSlots;
#pragma unroll 1
    for (int jp = 2 * half; jp < 2 * half + 2; ++jp) {
      float sc[2][4], vg[2][4];
      mma_rows_f32<DKP, 2>(sc, qs, row0, kb, 16 * jp, lane);
      mma_rows_f32<DKP, 2>(vg, vs, row0, gb, 16 * jp, lane);
#pragma unroll
      for (int jn = 0; jn < 2; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int j = 16 * jp + 8 * jn + 2 * t + (e & 1);
          float ds = 0.0f;
          if (cb[j] > 0.0f) {  // ds is 0 at dead slots and past S
            const float sigma = __expf(sc[jn][e] * scale - rm[h]) * rs[h];
            const float f = rate > 0.0f ? keep_factor(seed, (uint32_t)hh, (uint32_t)row[h],
                                                      (uint32_t)(c * kSlots + j), rate, inv_keep)
                                        : 1.0f;
            ds = sigma * (vg[jn][e] * f - dl[h]);
          }
          sc[jn][e] = ds;
        }
      mma_c_rows_f32<DKP>(part, sc[0], kb + 16 * jp * kS, lane);
      mma_c_rows_f32<DKP>(part, sc[1], kb + (16 * jp + 8) * kS, lane);
    }
    add_part<DKP>(acc, part);
    cp_async_wait<0>();
    __syncthreads();
  }

  merge_halves<DKP>(acc, ks, warp, lane);
  if (half == 1) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= n) continue;
    const size_t base = (rbase + row[h]) * dk;
#pragma unroll
    for (int jn = 0; jn < DKP / 8; ++jn) {
      const int d = 8 * jn + 2 * t;
      if (d < dk)
        *reinterpret_cast<float2*>(dq + base + d) =
            make_float2(scale * acc[jn][2 * h], scale * acc[jn][2 * h + 1]);
    }
  }
}

// Pass B. Grid (ceil(S / 64), heads * segments, splits): rows
// [split * rows_per_split, ...) of N. Warp w takes slots 16 (w & 3) .. +
// 15 of the block's k and g tiles and, of each 64-row tile (q, v, the row
// stats and D in two cp.async buffers), the 16-row steps 2 (w >> 2) and
// 2 (w >> 2) + 1: s^T = k q^T and g v^T give ds^T in the C fragments, and
// dk^T += ds^T q (mma_c_rows_f32); the halves' sums merge at the end.
// Whether the next tile has a live row is read from row_scale between the
// two steps; a tile with none is neither loaded nor multiplied. One split
// writes dk; several write f32 partials for dk_reduce_kernel.
template <int DKP>
__global__ void __launch_bounds__(kF32Threads, 1)
slot_grad_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ g,
                      const uint8_t* __restrict__ slot_valid,
                      const float* __restrict__ row_max, const float* __restrict__ row_scale,
                      const float* __restrict__ delta, float* __restrict__ dk_out,
                      float* __restrict__ partial, int segments, int n, int s, int dk,
                      int rows_per_split, float scale, uint32_t seed, float rate,
                      float inv_keep) {
  extern __shared__ uint4 smem_tc[];
  constexpr int kS = tf_stride<DKP>();
  constexpr int kTile = kRows * kS;  // floats of a tile
  float* ks = reinterpret_cast<float*>(smem_tc);
  float* gs = ks + kTile;
  float* qs = gs + kTile;      // two buffers
  float* vs = qs + 2 * kTile;  // two buffers
  float* stats = vs + 2 * kTile;  // 2 x (max, scale, D) x 64

  const int hh = blockIdx.y;
  const int seg = hh % segments;
  const int c0 = blockIdx.x * kSlots;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int slot0 = 16 * (warp & 3);  // the warp's slots in the block
  const int half = warp >> 2;         // its 16-row steps: 2 half, 2 half + 1
  const int row_begin = blockIdx.z * rows_per_split;
  const int row_end = min(n, row_begin + rows_per_split);
  const int tiles = (row_end - row_begin + kRows - 1) / kRows;
  const float* qh = q + (size_t)hh * n * dk;
  const float* vh = v + (size_t)hh * n * dk;
  const float* rmh = row_max + (size_t)hh * n;
  const float* rsh = row_scale + (size_t)hh * n;
  const float* dlh = delta + (size_t)hh * n;

  // Rows [r0, r0 + 64) of q, v, the row stats and D into buffer b; rows at
  // or past row_end are zeros (scale 0, so their ds is 0).
  auto prefetch = [&](int r0, int b) {
    tile_async_f32<DKP>(qs + b * kTile, qh, r0, row_end, dk);
    tile_async_f32<DKP>(vs + b * kTile, vh, r0, row_end, dk);
    if (threadIdx.x < 3 * kRows) {
      const int idx = threadIdx.x;
      const int i = idx % kRows;
      const bool live = r0 + i < row_end;
      const float* src = idx < kRows ? rmh : (idx < 2 * kRows ? rsh : dlh);
      cp_async4(stats + b * 3 * kRows + idx, live ? src + r0 + i : src, live ? 4 : 0);
    }
  };
  // the scale of row r0 + threadIdx.x (0 for threads past 64 and rows past row_end)
  auto scale_of = [&](int r0) {
    return threadIdx.x < kRows && r0 + (int)threadIdx.x < row_end ? rsh[r0 + threadIdx.x] : 0.0f;
  };

  tile_async_f32<DKP>(ks, k + (size_t)hh * s * dk, c0, s, dk);
  tile_async_f32<DKP>(gs, g + (size_t)hh * s * dk, c0, s, dk);
  bool live_tile = tiles > 0 && __syncthreads_or(scale_of(row_begin) != 0.0f);
  if (live_tile) prefetch(row_begin, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // slots c0 + slot0 + g + 8h: ds is 0 unless live
  int slot[2];
  bool live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    slot[h] = c0 + slot0 + (lane >> 2) + 8 * h;
    live[h] = slot[h] < s && slot_valid[(size_t)seg * s + slot[h]];
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
    const float* rm = stats + b * 3 * kRows;
    const float* rs = rm + kRows;
    const float* dl = rs + kRows;
    // rows 16jp .. 16jp + 15 of the tile
    auto step = [&](int jp) {
      // sc[jn][e], vg[jn][e]: slot g + 8 (e >> 1), row 16jp + 8jn + 2t + (e & 1)
      float sc[2][4], vg[2][4];
      mma_rows_f32<DKP, 2>(sc, ks, slot0, qb, 16 * jp, lane);
      mma_rows_f32<DKP, 2>(vg, gs, slot0, vb, 16 * jp, lane);
#pragma unroll
      for (int jn = 0; jn < 2; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int i = 16 * jp + 8 * jn + 2 * t + (e & 1);
          float ds = 0.0f;
          if (live[h]) {
            const float sigma = __expf(sc[jn][e] * scale - rm[i]) * rs[i];
            const float f = rate > 0.0f ? keep_factor(seed, (uint32_t)hh, (uint32_t)(r0 + i),
                                                      (uint32_t)slot[h], rate, inv_keep)
                                        : 1.0f;
            ds = sigma * (vg[jn][e] * f - dl[i]);
          }
          sc[jn][e] = ds;
        }
      mma_c_rows_f32<DKP>(part, sc[0], qb + 16 * jp * kS, lane);
      mma_c_rows_f32<DKP>(part, sc[1], qb + (16 * jp + 8) * kS, lane);
    };
    if (live_tile) step(2 * half);
    // the other buffer was released by the last iteration's barrier
    const bool live_next = __syncthreads_or(next_scale != 0.0f);
    if (live_next) prefetch(r0 + kRows, b ^ 1);
    cp_async_commit();
    if (live_tile) {
      step(2 * half + 1);
      add_part<DKP>(acc, part);
    }
    cp_async_wait<0>();
    __syncthreads();
    live_tile = live_next;
  }
  merge_halves<DKP>(acc, qs, warp, lane);
  if (half == 1) return;

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (slot[h] >= s) continue;
    const size_t row = (size_t)hh * s + slot[h];
#pragma unroll
    for (int jn = 0; jn < DKP / 8; ++jn) {
      const int d = 8 * jn + 2 * t;
      if (d >= dk) continue;
      float* dst = partial != nullptr
                       ? partial + ((size_t)blockIdx.z * gridDim.y * s + row) * dk + d
                       : dk_out + row * dk + d;
      *reinterpret_cast<float2*>(dst) =
          make_float2(scale * acc[jn][2 * h], scale * acc[jn][2 * h + 1]);
    }
  }
}

template <int DKP>
constexpr size_t smem_tf32_rows() {
  return (size_t)6 * tf_tile_bytes<DKP>() + 3 * kSlots * sizeof(float);
}
template <int DKP>
constexpr size_t smem_tf32_slots() {
  return (size_t)6 * tf_tile_bytes<DKP>() + 2 * 3 * kRows * sizeof(float);
}

template <int DKP>
constexpr size_t smem_tc_rows() {
  return (size_t)6 * tc_tile_bytes<DKP>() + 2 * kSlots * sizeof(float);
}
template <int DKP>
constexpr size_t smem_tc_slots() {
  return (size_t)6 * tc_tile_bytes<DKP>() + 2 * 3 * kRows * sizeof(float);
}

// dk = T(sum over the splits of the f32 partials), in split order.
template <typename T>
__global__ void __launch_bounds__(256)
dk_reduce_kernel(const float* __restrict__ partial, T* __restrict__ out, size_t total,
                 int splits) {
  sum_splits(partial, out, total, splits);
}

struct BwdArgs {
  const void *q, *k, *v, *g, *slot_valid, *row_max, *row_scale;
  void *dq, *dk, *dv, *delta, *partial;
  int heads, segments, n, s, dk_dim, splits;
  float scale;
  uint32_t seed;
  float rate, inv_keep;
  cudaStream_t stream;

  int rows_per_split() const { return (n + kRows * splits - 1) / (kRows * splits) * kRows; }
  dim3 grid_rows() const { return dim3((n + kRows - 1) / kRows, heads * segments); }
  dim3 grid_slots() const { return dim3((s + kSlots - 1) / kSlots, heads * segments, splits); }
  float* part() const { return splits > 1 ? static_cast<float*>(partial) : nullptr; }
  // the tensor-core bodies' 16-byte copies: whole 16-byte chunks a row
  // (dk % 8 == 0 in bf16, dk % 4 == 0 in f32) and 16-byte aligned bases
  template <typename T>
  bool aligned16() const {
    return dk_dim % (16 / sizeof(T)) == 0 &&
           (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
            reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(g) |
            reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
            reinterpret_cast<uintptr_t>(dv)) % 16 == 0;
  }
};

// The splits' sum, when there are several.
template <typename T>
cudaError_t launch_reduce(const BwdArgs& a) {
  if (a.splits == 1) return cudaSuccess;
  const size_t total = (size_t)a.heads * a.segments * a.s * a.dk_dim;
  const int blocks = (int)std::min<size_t>((total + 255) / 256, 4 * 132);
  dk_reduce_kernel<T><<<blocks, 256, 0, a.stream>>>(static_cast<const float*>(a.partial),
                                                   static_cast<T*>(a.dk), total, a.splits);
  return cudaGetLastError();
}

// The CUDA-core body, DM = dims of dk per thread: the limits are raised to
// what the largest dk of the instance (16 * DM) needs.
template <typename T, int DM>
cudaError_t launch(const BwdArgs& a) {
  static std::atomic<uint64_t> ready_rows{0}, ready_slots{0};
  const int stride = a.dk_dim | 1;  // odd row stride: conflict-free column reads
  const size_t smem = smem_bytes(stride);
  cudaError_t err = allow_smem(row_grad_kernel<T, DM>, smem_bytes(16 * DM + 1), ready_rows);
  if (err != cudaSuccess) return err;
  err = allow_smem(slot_grad_kernel<T, DM>, smem_bytes(16 * DM + 1), ready_slots);
  if (err != cudaSuccess) return err;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* g = static_cast<const T*>(a.g);
  const uint8_t* sv = static_cast<const uint8_t*>(a.slot_valid);
  const float* rm = static_cast<const float*>(a.row_max);
  const float* rs = static_cast<const float*>(a.row_scale);
  float* delta = static_cast<float*>(a.delta);
  row_grad_kernel<T, DM><<<a.grid_rows(), kThreads, smem, a.stream>>>(
      q, k, v, g, sv, rm, rs, static_cast<T*>(a.dq), static_cast<T*>(a.dv), delta,
      a.segments, a.n, a.s, a.dk_dim, stride, a.scale, a.seed, a.rate, a.inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  slot_grad_kernel<T, DM><<<a.grid_slots(), kThreads, smem, a.stream>>>(
      q, k, v, g, sv, rm, rs, delta, static_cast<T*>(a.dk), a.part(), a.segments, a.n, a.s,
      a.dk_dim, stride, a.rows_per_split(), a.scale, a.seed, a.rate, a.inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce<T>(a);
}

// The tensor-core body, dk <= DKP.
template <int DKP>
cudaError_t launch_tc(const BwdArgs& a) {
  static std::atomic<uint64_t> ready_rows{0}, ready_slots{0};
  cudaError_t err = allow_smem(row_grad_tc_kernel<DKP>, smem_tc_rows<DKP>(), ready_rows);
  if (err != cudaSuccess) return err;
  err = allow_smem(slot_grad_tc_kernel<DKP>, smem_tc_slots<DKP>(), ready_slots);
  if (err != cudaSuccess) return err;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* g = static_cast<const bf16*>(a.g);
  const uint8_t* sv = static_cast<const uint8_t*>(a.slot_valid);
  const float* rm = static_cast<const float*>(a.row_max);
  const float* rs = static_cast<const float*>(a.row_scale);
  float* delta = static_cast<float*>(a.delta);
  row_grad_tc_kernel<DKP><<<a.grid_rows(), kTcThreads, smem_tc_rows<DKP>(), a.stream>>>(
      q, k, v, g, sv, rm, rs, static_cast<bf16*>(a.dq), static_cast<bf16*>(a.dv), delta,
      a.segments, a.n, a.s, a.dk_dim, a.scale, a.seed, a.rate, a.inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  slot_grad_tc_kernel<DKP><<<a.grid_slots(), kTcThreads, smem_tc_slots<DKP>(), a.stream>>>(
      q, k, v, g, sv, rm, rs, delta, static_cast<bf16*>(a.dk), a.part(), a.segments, a.n,
      a.s, a.dk_dim, a.rows_per_split(), a.scale, a.seed, a.rate, a.inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce<bf16>(a);
}

// The f32 tensor-core body, dk <= DKP.
template <int DKP>
cudaError_t launch_tf32(const BwdArgs& a) {
  static std::atomic<uint64_t> ready_rows{0}, ready_slots{0};
  cudaError_t err = allow_smem(row_grad_tf32_kernel<DKP>, smem_tf32_rows<DKP>(), ready_rows);
  if (err != cudaSuccess) return err;
  err = allow_smem(slot_grad_tf32_kernel<DKP>, smem_tf32_slots<DKP>(), ready_slots);
  if (err != cudaSuccess) return err;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* g = static_cast<const float*>(a.g);
  const uint8_t* sv = static_cast<const uint8_t*>(a.slot_valid);
  const float* rm = static_cast<const float*>(a.row_max);
  const float* rs = static_cast<const float*>(a.row_scale);
  float* delta = static_cast<float*>(a.delta);
  row_grad_tf32_kernel<DKP><<<a.grid_rows(), kF32Threads, smem_tf32_rows<DKP>(), a.stream>>>(
      q, k, v, g, sv, rm, rs, static_cast<float*>(a.dq), static_cast<float*>(a.dv), delta,
      a.segments, a.n, a.s, a.dk_dim, a.scale, a.seed, a.rate, a.inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  slot_grad_tf32_kernel<DKP><<<a.grid_slots(), kF32Threads, smem_tf32_slots<DKP>(), a.stream>>>(
      q, k, v, g, sv, rm, rs, delta, static_cast<float*>(a.dk), a.part(), a.segments, a.n,
      a.s, a.dk_dim, a.rows_per_split(), a.scale, a.seed, a.rate, a.inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce<float>(a);
}

template <typename T>
cudaError_t launch_dtype(const BwdArgs& a) {
  if (a.dk_dim <= 128 && a.aligned16<T>()) {
    if (sizeof(T) == 4) {
      if (a.dk_dim <= 32) return launch_tf32<32>(a);
      if (a.dk_dim <= 64) return launch_tf32<64>(a);
      if (a.dk_dim <= 96) return launch_tf32<96>(a);
      return launch_tf32<128>(a);
    }
    if (a.dk_dim <= 32) return launch_tc<32>(a);
    if (a.dk_dim <= 64) return launch_tc<64>(a);
    if (a.dk_dim <= 96) return launch_tc<96>(a);
    return launch_tc<128>(a);
  }
  if (a.dk_dim <= 64) return launch<T, 4>(a);
  if (a.dk_dim <= 128) return launch<T, 8>(a);
  return launch<T, 16>(a);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; scale is 1 / sqrt(dk). q, v, dq, dv are
// (heads, segments * n, dk), k, g, dk (heads, segments * s, dk), all
// contiguous and of one type; masks are bool bytes. row_max and row_scale
// are the forward's f32 row stats; delta is f32 scratch of heads *
// segments * n values; with splits > 1, partial is f32 scratch of splits *
// heads * segments * s * dk values (unused with one split). Launches on
// `stream` and returns the cudaError_t of the launches (0 on success); it
// does not synchronise.
extern "C" int snuffy_sparse_attention_bwd(
    const void* q, const void* k, const void* v, const void* g,
    const void* slot_valid, const void* row_max, const void* row_scale, void* dq,
    void* dk, void* dv, void* delta, void* partial, int heads, int segments, int n, int s,
    int dk_dim, int dtype, int splits, float scale, int seed, float rate, float inv_keep,
    void* stream) {
  if (heads < 1 || segments < 1 || n < 1 || s < 1 || dk_dim < 1 || dk_dim > 256 ||
      heads * segments > 65535 || splits < 1 || splits > 65535 ||
      (splits > 1 && partial == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BwdArgs a{q, k, v, g, slot_valid, row_max, row_scale, dq, dk, dv, delta, partial,
                  heads, segments, n, s, dk_dim, splits, scale, static_cast<uint32_t>(seed),
                  rate, inv_keep, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return static_cast<int>(launch_dtype<float>(a));
  if (dtype == 1) return static_cast<int>(launch_dtype<__nv_bfloat16>(a));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* snuffy_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
