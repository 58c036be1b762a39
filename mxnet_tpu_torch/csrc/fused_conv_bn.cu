// Fused 1x1 convolution (a matrix product) + BatchNorm statistics for Hopper
// (sm_90a), fp32 or bf16 in, fp32 math.
//
// Replaces the TPU kernel mxnet_tpu/ops/fused_conv_bn.py:_mm_stats_kernel
// (called through fused_matmul_bn_stats).  Same function:
//   y[M, N] = act(scale * x + shift)[M, K] @ w[K, N]
// accumulated in fp32 and rounded once to x's dtype, where act is an
// optional ReLU and the affine is optional (scale == nullptr: none), plus
// the per-column sum(y) and sum(y^2) taken from the fp32 accumulator, never
// from the rounded y.  The statistics come out as fp32 partials, one row per
// 128-row tile of M ([ceil(M/128), N]); the caller sums them over tiles, as
// the JAX package sums its per-tile partials outside its kernel.
//
// What bounds it on this card: on ResNet-50's bottleneck shapes
// (K, N of 64..2048, M of 12,544..802,816 at batch 256) the product is
// 2*M*K*N flops against (M*K + K*N + M*N) elements moved, so with fp32 on
// the CUDA cores (67 TFLOP/s, no tensor cores, against 3.35 TB/s) it is
// bound by bytes at K = N = 64 and by operations at every other shape
// (2KN / (4(K + N)) flops per byte against the card's 20).  This first
// version keeps the conv output's statistics out of device memory (no
// second pass over y) and otherwise is a plain tiled product:
//   * one 256-thread block per 128 x 64 output tile (blockIdx.x walks M, so
//     M can exceed 65,535 tiles; blockIdx.y walks N); a loop over K in
//     16-deep slices staged through shared memory as fp32, the input affine
//     and ReLU applied while staging;
//   * each thread owns an 8 x 4 patch of the accumulator in registers and
//     reads its A and B operands from shared memory as float4;
//   * the statistics epilogue reduces the patch's 8 rows in registers, the
//     two thread rows of a warp with a shuffle, and the 8 warps through
//     shared memory in a fixed order: no atomics, so a rerun gives the same
//     bits;
//   * ragged M, N and K are masked while staging, so rows >= M stage zeros
//     and add nothing to the statistics even where the affine would turn a
//     zero into `shift`; no padding copy, any M, K, N >= 1;
//   * row offsets are 64-bit (M*K reaches 2^31 at batch 256).
// The affine is rounded as two operations (__fmul_rn, __fadd_rn) so the
// staged operand is bit-equal to the plain PyTorch version's.
// mma.sync, wgmma and TMA are later work; tensor cores in TF32 would also
// change fp32 numerics against the JAX package.
//
// Interface: plain C, bound from Python with ctypes (mxnet_tpu_torch/ops/
// fused_conv_bn.py).  x [M, K] and y [M, N] contiguous in the same dtype;
// w in that dtype as a contiguous [N, K] (the conv weight's own layout, so
// the model hands it over without a copy); scale/shift fp32 [K] or both
// null; psum/psumsq
// fp32 [ceil(M/128), N].  Launches on the given stream, returns the
// cudaError_t of the launch.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Shared rows are padded by 4 floats: float4 reads stay 16-byte aligned and
// the staging stores spread over the banks.
constexpr int kLdA = kBM + 4;
constexpr int kLdB = kBN + 4;

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, bool AFFINE, bool RELU>
__global__ void __launch_bounds__(kThreads)
mm_bn_stats_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const float* __restrict__ scale,
                   const float* __restrict__ shift, T* __restrict__ y,
                   float* __restrict__ psum, float* __restrict__ psumsq,
                   int64_t m, int k, int n) {
  __shared__ __align__(16) float as[kBK][kLdA];
  __shared__ __align__(16) float bs[kBK][kLdB];
  __shared__ float red_s[kWarps][kBN];
  __shared__ float red_q[kWarps][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // accumulator columns 4*tx .. 4*tx+3
  const int ty = tid / 16;  // accumulator rows 8*ty .. 8*ty+7
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  // staging: column sk of A rows sr + 16*i and of w rows sr + 16*j
  const int sk = tid % kBK;
  const int sr = tid / kBK;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    const int kg = k0 + sk;
    float sc = 1.f, sh = 0.f;
    if (AFFINE && kg < k) {
      sc = scale[kg];
      sh = shift[kg];
    }
#pragma unroll
    for (int i = 0; i < kBM / 16; ++i) {
      const int r = sr + 16 * i;
      const int64_t row = m0 + r;
      float v = 0.f;
      if (row < m && kg < k) {
        v = to_float(x[row * k + kg]);
        if (AFFINE) v = __fadd_rn(__fmul_rn(v, sc), sh);
        if (RELU) v = fmaxf(v, 0.f);
      }
      as[sk][r] = v;
    }
#pragma unroll
    for (int j = 0; j < kBN / 16; ++j) {
      const int c = sr + 16 * j;
      const int col = n0 + c;
      bs[sk][c] = (col < n && kg < k)
                      ? to_float(w[static_cast<int64_t>(col) * k + kg])
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][8 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[kk][8 * ty + 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&bs[kk][4 * tx]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // y, rounded once from the fp32 accumulator
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t row = m0 + 8 * ty + i;
    if (row < m) {
      T* yrow = y + row * n;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + 4 * tx + j;
        if (col < n) yrow[col] = from_float<T>(acc[i][j]);
      }
    }
  }

  // statistics of the accumulator: this thread's rows, then the warp's two
  // thread rows (lanes l and l ^ 16 share tx), then the 8 warps in order
  float s[4], q[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s[j] = 0.f;
    q[j] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (m0 + 8 * ty + i < m) {
        s[j] += acc[i][j];
        q[j] = fmaf(acc[i][j], acc[i][j], q[j]);
      }
    }
    s[j] += __shfl_xor_sync(0xffffffffu, s[j], 16);
    q[j] += __shfl_xor_sync(0xffffffffu, q[j], 16);
  }
  const int warp = tid / 32;
  if (tid % 32 < 16) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      red_s[warp][4 * tx + j] = s[j];
      red_q[warp][4 * tx + j] = q[j];
    }
  }
  __syncthreads();
  if (tid < kBN && n0 + tid < n) {
    float ss = 0.f, qq = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      ss += red_s[v][tid];
      qq += red_q[v][tid];
    }
    const int64_t at = static_cast<int64_t>(blockIdx.x) * n + n0 + tid;
    psum[at] = ss;
    psumsq[at] = qq;
  }
}

template <typename T, bool AFFINE, bool RELU>
int launch(const void* x, const void* w, const float* scale,
           const float* shift, void* y, float* psum, float* psumsq,
           int64_t m, int k, int n, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((m + kBM - 1) / kBM),
                  static_cast<unsigned>((n + kBN - 1) / kBN));
  mm_bn_stats_kernel<T, AFFINE, RELU><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), scale, shift,
      static_cast<T*>(y), psum, psumsq, m, k, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_mode(int affine, int relu_in, const void* x, const void* w,
                const float* scale, const float* shift, void* y, float* psum,
                float* psumsq, int64_t m, int k, int n, cudaStream_t stream) {
  if (affine)
    return relu_in ? launch<T, true, true>(x, w, scale, shift, y, psum,
                                           psumsq, m, k, n, stream)
                   : launch<T, true, false>(x, w, scale, shift, y, psum,
                                            psumsq, m, k, n, stream);
  return relu_in ? launch<T, false, true>(x, w, scale, shift, y, psum, psumsq,
                                          m, k, n, stream)
                 : launch<T, false, false>(x, w, scale, shift, y, psum,
                                           psumsq, m, k, n, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 on success).
extern "C" int fused_conv_bn_stats(const void* x, const void* w,
                                   const float* scale, const float* shift,
                                   void* y, float* psum, float* psumsq,
                                   long long m, int k, int n, int relu_in,
                                   int dtype, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || (m + kBM - 1) / kBM > 0x7fffffffLL ||
      (scale == nullptr) != (shift == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int affine = scale != nullptr;
  switch (dtype) {
    case 0:
      return launch_mode<float>(affine, relu_in, x, w, scale, shift, y, psum,
                                psumsq, m, k, n, st);
    case 1:
      return launch_mode<__nv_bfloat16>(affine, relu_in, x, w, scale, shift,
                                        y, psum, psumsq, m, k, n, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* fused_conv_bn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Tile height of the statistics partials: psum/psumsq have
// ceil(M / fused_conv_bn_tile_m()) rows.
extern "C" int fused_conv_bn_tile_m() { return kBM; }
