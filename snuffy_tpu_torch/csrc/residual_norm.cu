// Residual add, LayerScale and LayerNorm of a ViT block's rows, fused, for
// Hopper (sm_90a), CUDA C++.
//
// Replaces no TPU kernel: the JAX block leaves its residual sums and its
// nn.LayerNorm to XLA, which fuses them (snuffy_tpu/models/vit.py:202 norm1,
// :211-212 the attention's residual sum, :229 norm2, :235-236 the closing
// sum, :368-374 the final norm). The port's ViT composed the same function
// from five PyTorch ops around each norm (LayerScale's multiply, the add,
// x.float(), F.layer_norm in f32, .to(dtype)); this kernel is that
// function in one pass.
//
// For each row r of x (rows, d): x and s in the stream's type S, b, gamma
// and y in the compute type C (S = C, f32 or bf16; or S f32 and C bf16,
// where an adapter's learnable f32 scale has promoted the stream):
//   t = C(gamma . b)          in f32, rounded once (gamma absent: t = b)
//   s = S(x + t)              in f32, rounded once; stored when b is given
//   y = C((s - mean) * rstd * w + bias)
//       mean and the biased variance of f32(s) in f32, rstd = 1/sqrt(var +
//       eps), w and bias the norm's f32 parameters, rounded once
// So s is bit for bit the composed ops' residual (each product and sum is
// formed in f32 and rounded to its result's type, as PyTorch's elementwise
// kernels do; __fmul_rn/__fadd_rn keep nvcc from contracting them into an
// FMA), and y
// differs from F.layer_norm's only by the order of the f32 sums.
//
// What bounds it on the H100: the bytes. It reads x and b and writes s and
// y, 8 bytes an element in bf16 (4 with no b), against 20-28 for the
// composed ops; at Virchow2's (66816, 1280) that is 684 MB a call, 204 us
// at 3.35 TB/s. Its arithmetic (~10 operations an element) is far below
// the card's 295 operations a byte. The design follows: one read of each
// input and one write of each output, 16 bytes a load or store, and
// enough rows in flight to cover the memory's latency.
//   - A group of tpr threads owns a row; tpr is the smallest power of two
//     for which each thread holds at most kMaxChunks chunks of 16 bytes of
//     the wider type (1280 bf16: 32 threads of 5 chunks; 384 bf16: 8 of
//     6; an f32 stream with bf16 branches: 4 elements a chunk, 8 bytes of
//     b and y). A thread's chunks lie tpr chunks apart, so neighbouring
//     threads read neighbouring bytes.
//   - A thread loads all its chunks of x and b first, then forms s in
//     registers: the statistics' two passes (the mean, then the sum of
//     squared deviations) and y read registers, never memory again.
//   - Sums across the group are shuffles; a row held by more than a warp
//     (16-byte chunks: bf16 past 2048, f32 past 1024; one-element chunks
//     past 256) adds its warps' sums through 32 floats of shared memory.
//   - d % (elements a chunk) != 0 or a base not 16-byte aligned: the same
//     kernel with chunks of one element (the rows do not start on 16-byte
//     boundaries then, so no row could be read in 16-byte chunks).
// Any d from 1 to 8192. Launches on the given stream, allocates nothing and
// returns the launch's cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kMaxChunks = 8;     // chunks a thread holds
constexpr int kThreads = 256;     // a block's threads, or tpr where larger
constexpr int kMaxD = 8192;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T, as f32
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// E values of T: 16 bytes of the wider of S and C, or one element
template <typename T, int E>
struct alignas(sizeof(T) * E) Pack {
  T v[E];
};

// E f32 values of the norm's parameters, in 16-byte pieces where E > 1
template <int E>
struct alignas(E > 1 ? 16 : 4) Floats {
  float v[E];
};

// t = C(gamma . b): LayerScale's product, in f32, rounded once
template <typename T>
__device__ __forceinline__ float scaled(float g, float b) {
  return round_to<T>(__fmul_rn(g, b));
}

// the f32 sums of the statistics
__device__ __forceinline__ float accumulate(float acc, float v) { return __fadd_rn(acc, v); }

// The sum of v over the tpr threads of a row (tpr a power of two): shuffles
// inside a warp, then, where a row spans warps, its warps' sums through
// `red` (one float a warp). tpr is uniform over the block, so every thread
// reaches the barrier.
__device__ __forceinline__ float row_sum(float v, int tpr, float* red) {
  const int width = tpr < 32 ? tpr : 32;
  for (int o = width / 2; o > 0; o >>= 1) v = accumulate(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (tpr <= 32) return v;
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) red[warp] = v;
  __syncthreads();
  const int per_row = tpr / 32;
  const int first = warp / per_row * per_row;
  float total = 0.0f;
  for (int i = 0; i < per_row; ++i) total = accumulate(total, red[first + i]);
  return total;
}

// The one-element chunks of a row past 2048 take up to 1024 threads a row;
// the 16-byte chunks at most 256 (bf16 8192: 128 threads; f32: 256), which
// leaves the vector bodies the registers of 256-thread blocks.
template <typename S, typename C, int E, int CPL>
__global__ void __launch_bounds__(E == 1 ? 1024 : kThreads)
    residual_norm_kernel(const S* __restrict__ x, const C* __restrict__ b,
                         const C* __restrict__ gamma, const float* __restrict__ w,
                         const float* __restrict__ bias, S* __restrict__ s_out,
                         C* __restrict__ y_out, int rows, int d, int tpr, float eps) {
  using PS = Pack<S, E>;
  using PC = Pack<C, E>;
  using F = Floats<E>;
  __shared__ float red[2][32];
  const int sub = threadIdx.x % tpr;
  const int row = blockIdx.x * (blockDim.x / tpr) + threadIdx.x / tpr;
  const int chunks = d / E;
  const size_t base = static_cast<size_t>(row < rows ? row : 0) * d;
  bool live[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) live[j] = row < rows && sub + j * tpr < chunks;

  // every load of the row first: x and b
  PS xs[CPL];
  PC bs[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    if (!live[j]) continue;
    const size_t at = base + static_cast<size_t>(sub + j * tpr) * E;
    xs[j] = *reinterpret_cast<const PS*>(x + at);
    if (b != nullptr) bs[j] = *reinterpret_cast<const PC*>(b + at);
  }

  // s in registers, stored where b is given; its sum
  float s[CPL][E];
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    if (!live[j]) continue;
    const int col = (sub + j * tpr) * E;
    PC g;
    if (gamma != nullptr) g = *reinterpret_cast<const PC*>(gamma + col);
    PS out;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      float v = to_f32(xs[j].v[e]);
      if (b != nullptr) {
        const float bv = to_f32(bs[j].v[e]);
        const float t = gamma != nullptr ? scaled<C>(to_f32(g.v[e]), bv) : bv;
        v = round_to<S>(__fadd_rn(v, t));
        out.v[e] = from_f32<S>(v);
      }
      s[j][e] = v;
      sum = accumulate(sum, v);
    }
    if (b != nullptr) *reinterpret_cast<PS*>(s_out + base + col) = out;
  }
  const float mean = row_sum(sum, tpr, red[0]) / static_cast<float>(d);

  float sq = 0.0f;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    if (!live[j]) continue;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float dev = __fsub_rn(s[j][e], mean);
      sq = accumulate(sq, __fmul_rn(dev, dev));
    }
  }
  const float var = row_sum(sq, tpr, red[1]) / static_cast<float>(d);
  const float rstd = 1.0f / sqrtf(var + eps);

#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    if (!live[j]) continue;
    const int col = (sub + j * tpr) * E;
    const F wv = *reinterpret_cast<const F*>(w + col);
    const F bv = *reinterpret_cast<const F*>(bias + col);
    PC out;
#pragma unroll
    for (int e = 0; e < E; ++e)
      out.v[e] = from_f32<C>((s[j][e] - mean) * rstd * wv.v[e] + bv.v[e]);
    *reinterpret_cast<PC*>(y_out + base + col) = out;
  }
}

template <typename S, typename C, int E, int CPL>
cudaError_t launch_cpl(const void* x, const void* b, const void* gamma, const void* w,
                       const void* bias, void* s_out, void* y_out, int rows, int d, int tpr,
                       float eps, cudaStream_t stream) {
  const int threads = tpr > kThreads ? tpr : kThreads;
  const int rows_per_block = threads / tpr;
  const long long blocks = (static_cast<long long>(rows) + rows_per_block - 1) / rows_per_block;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  residual_norm_kernel<S, C, E, CPL><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const S*>(x), static_cast<const C*>(b), static_cast<const C*>(gamma),
      static_cast<const float*>(w), static_cast<const float*>(bias), static_cast<S*>(s_out),
      static_cast<C*>(y_out), rows, d, tpr, eps);
  return cudaGetLastError();
}

template <typename S, typename C, int E>
cudaError_t launch_chunks(const void* x, const void* b, const void* gamma, const void* w,
                          const void* bias, void* s_out, void* y_out, int rows, int d,
                          float eps, cudaStream_t stream) {
  const int chunks = d / E;
  int tpr = 1;
  while (tpr * kMaxChunks < chunks) tpr *= 2;
  const int cpl = (chunks + tpr - 1) / tpr;
#define SNUFFY_CPL(n)                                                                    \
  case n:                                                                                \
    return launch_cpl<S, C, E, n>(x, b, gamma, w, bias, s_out, y_out, rows, d, tpr, eps, \
                               stream)
  switch (cpl) {
    SNUFFY_CPL(1);
    SNUFFY_CPL(2);
    SNUFFY_CPL(3);
    SNUFFY_CPL(4);
    SNUFFY_CPL(5);
    SNUFFY_CPL(6);
    SNUFFY_CPL(7);
    SNUFFY_CPL(8);
  }
#undef SNUFFY_CPL
  return cudaErrorInvalidValue;
}

template <typename S, typename C>
cudaError_t launch_types(const void* x, const void* b, const void* gamma, const void* w,
                         const void* bias, void* s_out, void* y_out, int rows, int d,
                         float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / (sizeof(S) > sizeof(C) ? sizeof(S) : sizeof(C));
  const uintptr_t bases =
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(b) |
      reinterpret_cast<uintptr_t>(gamma) | reinterpret_cast<uintptr_t>(w) |
      reinterpret_cast<uintptr_t>(bias) | reinterpret_cast<uintptr_t>(s_out) |
      reinterpret_cast<uintptr_t>(y_out);
  if (d % kVec == 0 && bases % 16 == 0)
    return launch_chunks<S, C, kVec>(x, b, gamma, w, bias, s_out, y_out, rows, d, eps, stream);
  return launch_chunks<S, C, 1>(x, b, gamma, w, bias, s_out, y_out, rows, d, eps, stream);
}

}  // namespace

// x and s_out (rows, d) in the stream's type (x_dtype), b, y_out (rows, d)
// and gamma (d) in the compute type (dtype; 0 float32, 1 bfloat16; x_dtype
// is dtype or float32), w and bias (d) float32, all contiguous. b may be
// null (then s_out must be: s is x); gamma may be null (t = b) and needs b.
// Launches on `stream` and returns the cudaError_t of the launch (0 on
// success); it does not synchronise.
extern "C" int snuffy_residual_norm(const void* x, const void* b, const void* gamma,
                                    const void* w, const void* bias, void* s_out,
                                    void* y_out, int rows, int d, int x_dtype, int dtype,
                                    float eps, void* stream) {
  if (rows < 1 || d < 1 || d > kMaxD || x == nullptr || w == nullptr || bias == nullptr ||
      y_out == nullptr || (b == nullptr) != (s_out == nullptr) ||
      (gamma != nullptr && b == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_dtype == 0 && dtype == 0) {
    err = launch_types<float, float>(x, b, gamma, w, bias, s_out, y_out, rows, d, eps, st);
  } else if (x_dtype == 1 && dtype == 1) {
    err = launch_types<__nv_bfloat16, __nv_bfloat16>(x, b, gamma, w, bias, s_out, y_out, rows,
                                                     d, eps, st);
  } else if (x_dtype == 0 && dtype == 1) {
    err = launch_types<float, __nv_bfloat16>(x, b, gamma, w, bias, s_out, y_out, rows, d, eps,
                                             st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* snuffy_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
