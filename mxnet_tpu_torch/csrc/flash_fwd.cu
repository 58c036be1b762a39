// Flash-attention forward for Hopper (sm_90a), fp32, bf16 or fp16 in, fp32
// math, on the CUDA cores.
//
// Replaces the TPU kernel mxnet_tpu/ops/attention.py:_flash_fwd_kernel (called
// through _flash_forward_pallas) for the inputs the tensor-core kernels do
// not take: fp32 whose head dim D is not a multiple of 4 (flash_fwd_tf32.cu
// takes the rest of fp32) and bf16 or fp16 whose D is not a multiple of 8
// (flash_fwd_wgmma.cu takes the rest of bf16 and fp16), all because TMA needs
// 16-byte row strides.  ops/attention.py's variant="simt" still forces it
// for any input, to time it beside them.  Same function: for every
// (batch*head, query row) an online softmax over the keys, running max and
// sum kept in fp32, O = softmax(q k^T * sm_scale) v in the input dtype and
// lse = m + log(l) in fp32.  Masked scores are -1e30 as in the TPU kernel, and in causal mode the
// key tiles entirely above the diagonal of a query tile are skipped.
//
// What bounds it on this card: at the serving shapes (S of 16..2048, D 128)
// the work is compute, 4*S_q*S_k*D flops per head (half that when causal)
// against 3*S*D input elements.  It computes on the CUDA cores in fp32 (no
// tensor cores, no TMA), so it sits far below the tensor-core bounds; its
// design only keeps the S x S score matrix out of device memory:
//   * one 256-thread block per (b*h, 64-row query tile); a loop over 64-row
//     key/value tiles staged in shared memory as fp32 (the TPU grid's
//     sequential k axis becomes this in-block loop);
//   * each thread owns a 4 x 4 patch of the score tile and a 4 x (D/16)
//     patch of the output accumulator, so the row max / row sum reductions
//     are shuffles inside one 16-lane half warp and the accumulator rescale
//     stays in registers;
//   * tiles are padded by one float per row, which keeps the strided
//     shared-memory reads free of bank conflicts;
//   * any S_q, S_k (ragged edges are zero-filled and masked) and any
//     D <= 128 (instantiated for D padded to 16, 32, 64 or 128).
//
// Interface: plain C, bound from Python with ctypes (mxnet_tpu_torch/ops/
// attention.py).  q [BH, S_q, D], k/v [BH, S_k, D], o [BH, S_q, D], all
// contiguous; lse [BH, S_q] fp32.  Launches on the given stream, returns the
// cudaError_t of the launch.
#include <atomic>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr float kMask = -1e30f;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}

// Stage rows [row0, row0 + kRows) of a [S, d] slice into shared memory as
// fp32 [kRows][DMAX + 1]; rows past `valid_rows` and columns past d are 0.
template <typename T, int DMAX, int kRows>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int row0, int valid_rows, int d) {
  constexpr int ld = DMAX + 1;
  for (int i = threadIdx.x; i < kRows * DMAX; i += kThreads) {
    const int r = i / DMAX;
    const int c = i % DMAX;
    float x = 0.f;
    if (r < valid_rows && c < d) x = to_float(src[(size_t)(row0 + r) * d + c]);
    dst[r * ld + c] = x;
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int s_q, int s_k, int d,
                     int causal, float sm_scale) {
  constexpr int ld = DMAX + 1;      // row stride of the Q/K/V tiles
  constexpr int ldp = kBlockK + 1;  // row stride of the P tile
  constexpr int dc = DMAX / 16;     // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBlockQ * ld;
  float* vs = ks + kBlockK * ld;
  float* ps = vs + kBlockK * ld;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int tx = threadIdx.x % 16;  // score columns tx + 16 j, output columns tx + 16 j
  const int ty = threadIdx.x / 16;  // rows 4 ty .. 4 ty + 3 of the tile
  const T* qb = q + (size_t)bh * s_q * d;
  const T* kb = k + (size_t)bh * s_k * d;
  const T* vb = v + (size_t)bh * s_k * d;

  load_tile<T, DMAX, kBlockQ>(qs, qb, q0, min(kBlockQ, s_q - q0), d);

  float acc[4][dc];
  float m[4];
  float l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMask;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < dc; ++c) acc[i][c] = 0.f;
  }

  // causal: keys past the tile's last query row are masked for every row
  const int k_end = causal ? min(s_k, q0 + kBlockQ) : s_k;
  const int n_tiles = (k_end + kBlockK - 1) / kBlockK;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the previous tile's K/V/P reads are done
    load_tile<T, DMAX, kBlockK>(ks, kb, k0, min(kBlockK, s_k - k0), d);
    load_tile<T, DMAX, kBlockK>(vs, vb, k0, min(kBlockK, s_k - k0), d);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < DMAX; ++c) {
      float qa[4];
      float kr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = qs[(4 * ty + i) * ld + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kr[j] = ks[(tx + 16 * j) * ld + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kr[j], s[i][j]);
    }

    const bool edge = (k0 + kBlockK > s_k) || (causal && k0 + kBlockK - 1 > q0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mx = kMask;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * sm_scale;
        if (edge) {
          const int col = k0 + tx + 16 * j;
          if (col >= s_k || (causal && col > row)) x = kMask;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(4 * ty + i) * ldp + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < dc; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // P tile complete

#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      float pa[4];
      float vr[dc];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = ps[(4 * ty + i) * ldp + c];
#pragma unroll
      for (int j = 0; j < dc; ++j) vr[j] = vs[c * ld + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < dc; ++j) acc[i][j] = fmaf(pa[i], vr[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= s_q) continue;
    const float inv = 1.f / l[i];
    T* orow = o + ((size_t)bh * s_q + row) * d;
#pragma unroll
    for (int j = 0; j < dc; ++j) {
      const int col = tx + 16 * j;
      if (col < d) orow[col] = from_float<T>(acc[i][j] * inv);
    }
    if (tx == 0) lse[(size_t)bh * s_q + row] = m[i] + logf(l[i]);
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int bh, int s_q, int s_k, int d, int causal, float sm_scale,
           cudaStream_t stream) {
  constexpr size_t smem =
      sizeof(float) * ((kBlockQ + 2 * kBlockK) * (DMAX + 1) + kBlockQ * (kBlockK + 1));
  // The shared-memory limit is a per-device attribute of each
  // instantiation: set it once per device, not on every launch.  Two
  // threads racing here both set the same value, which is harmless.
  static std::atomic<bool> attr_set[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!attr_set[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr_set[dev].store(true, std::memory_order_release);
  }
  const dim3 grid((s_q + kBlockQ - 1) / kBlockQ, bh);
  flash_fwd_kernel<T, DMAX><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, s_q, s_k, d, causal,
      sm_scale);
  return (int)cudaGetLastError();
}

template <int DMAX>
int launch_dtype(int dtype, const void* q, const void* k, const void* v,
                 void* o, float* lse, int bh, int s_q, int s_k, int d,
                 int causal, float sm_scale, cudaStream_t stream) {
  switch (dtype) {
    case 0:
      return launch<float, DMAX>(q, k, v, o, lse, bh, s_q, s_k, d, causal,
                                 sm_scale, stream);
    case 1:
      return launch<__nv_bfloat16, DMAX>(q, k, v, o, lse, bh, s_q, s_k, d,
                                         causal, sm_scale, stream);
    case 2:
      return launch<__half, DMAX>(q, k, v, o, lse, bh, s_q, s_k, d, causal,
                                  sm_scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  Returns a cudaError_t (0 on success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         float* lse, int bh, int s_q, int s_k, int d,
                         int causal, float sm_scale, int dtype, void* stream) {
  if (bh <= 0 || bh > 65535 || s_q <= 0 || s_k <= 0 || d <= 0 || d > 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 16)
    return launch_dtype<16>(dtype, q, k, v, o, lse, bh, s_q, s_k, d, causal, sm_scale, st);
  if (d <= 32)
    return launch_dtype<32>(dtype, q, k, v, o, lse, bh, s_q, s_k, d, causal, sm_scale, st);
  if (d <= 64)
    return launch_dtype<64>(dtype, q, k, v, o, lse, bh, s_q, s_k, d, causal, sm_scale, st);
  return launch_dtype<128>(dtype, q, k, v, o, lse, bh, s_q, s_k, d, causal, sm_scale, st);
}

extern "C" const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
