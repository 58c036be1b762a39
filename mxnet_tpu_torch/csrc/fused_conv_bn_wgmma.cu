// Fused 1x1 convolution (a matrix product) + BatchNorm statistics for Hopper
// (sm_90a) on the tensor cores: fp32 or bf16 in, fp32 kept through a
// three-product TF32 split, fp32 accumulation.
//
// Replaces the TPU kernel mxnet_tpu/ops/fused_conv_bn.py:_mm_stats_kernel
// (called through fused_matmul_bn_stats) wherever TMA can describe x: fp32
// with K % 4 == 0, bf16 with K % 8 == 0 (16-byte row strides), 16-byte
// aligned bases; every other input stays on the CUDA-core kernel in
// fused_conv_bn.cu.  Same function and output contract as that kernel:
//   y[M, N] = act(scale * x + shift)[M, K] @ w[K, N]
// accumulated in fp32 and rounded once to x's dtype (act an optional ReLU,
// the affine optional), plus per-column sum(y) and sum(y^2) of the fp32
// accumulator as fp32 partials, one row per 128-row tile of M; the caller
// sums them over tiles.
//
// What bounds it: the tensor cores take fp32 operands only as TF32 (the top
// 19 bits), which alone misses chip_smoke.py's fp32 gates 2.5-150x (the CPU
// emulation in tests/test_torch_fused_conv_bn.py).  So each
// operand is split, a = a_hi + a_lo with a_hi = tf32(a) and a_lo =
// tf32(a - a_hi), and y accumulates a_lo.b_hi + a_hi.b_lo + a_hi.b_hi: three
// TF32 products, 6MKN operations at 495 TFLOP/s.  On ResNet-50's stage-1
// shapes (M = 802,816 at batch 256, K or N = 64..256) that is below the
// bytes of x and y at 3.35 TB/s, so they are bound by bytes; the deeper
// stages (K, N up to 2048 at M = 12,544) are bound by the tensor cores.
// bf16 inputs convert to fp32 exactly and have no lo part: a bf16 call runs
// a_hi.b_hi alone, plus a_lo.b_hi when the input affine leaves TF32.
//
// Design:
//   * w is split once per call by a small pre-kernel into fp32 w_hi and
//     w_lo, each [N, K] (the conv weight's own layout, K-major as TF32 wgmma
//     requires; bf16 w needs w_hi alone);
//   * one block per 128 x BN output tile (BN = 64 for N <= 64, else 128), a
//     1-D grid with the N tiles of one M tile adjacent, so a tile of x is
//     read from device memory once and from L2 by its neighbours;
//   * three warpgroups: a producer, whose one thread starts TMA loads, and
//     two consumers of 64 rows each; setmaxnreg moves registers from the
//     producer (24) to the consumers (240);
//   * TMA brings 128-byte-wide slices of K (32 fp32 or 64 bf16 columns) of
//     x ([128 rows]) and of w_hi and w_lo ([BN rows]) into a ring of stages
//     with the 128-byte swizzle, each stage with a full and an empty
//     mbarrier; rows >= M and columns >= K read as zero;
//   * each consumer reads its 64 rows of the x slice from shared memory
//     straight into wgmma's A-fragment layout, applies the affine (rounded
//     as two operations, __fmul_rn and __fadd_rn, as the plain version
//     does) and the ReLU, zeroes rows >= M (the affine would turn TMA's
//     zeros into `shift`), splits with cvt.rna.tf32.f32, and issues
//     wgmma m64nBNk8 with A from registers and B from shared memory;
//   * the tensor core adds into its fp32 accumulator with truncation, not
//     rounding to nearest: over K = 1024-2048 (384-768 accumulating
//     wgmmas) that biased y toward zero by up to 1.6e-5 of max |y| and
//     missed the statistics gates 1-4x on the card.  So each stage's
//     products start a fresh tensor-core sum, and the stages are added in
//     fp32 rounded to nearest on the CUDA cores (one add per accumulator
//     per stage);
//   * the epilogue stores y from the accumulator and takes the statistics
//     of the accumulator: the eight lanes that share a column with
//     shuffles, then the eight consumer warps through shared memory in a
//     fixed order.  No atomics, so a rerun gives the same bits.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, chip_smoke.py):
// 0.512 ms at (802816, 256, 64) fp32 against 0.307 ms for its bytes, 0.868
// ms on the CUDA cores and 0.695 ms for torch.matmul; 14.8 ms over the 36
// launches of a batch-256 training step against 6.8 ms of bounds.  At one
// block per SM each tile's first loads and its y stores are bare (about
// 5.7 us a tile), which holds the K = 64-256 shapes to 32-46% of their
// bound; a persistent grid is later work.
//
// Interface: plain C, bound from Python with ctypes (mxnet_tpu_torch/ops/
// fused_conv_bn.py).  x [M, K] and y [M, N] contiguous in the same dtype,
// x 16-byte aligned; w in that dtype as a contiguous [N, K]; w_hi (and, for
// fp32, w_lo) fp32 [N, K] scratch of the caller's, 16-byte aligned;
// scale/shift fp32 [K] or both null; psum/psumsq fp32 [ceil(M/128), N].
// The tensor maps are encoded at each call with cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint, so the library links only the
// CUDA runtime.  Launches on the given stream and returns a cudaError_t, or
// kEncodeError + the CUresult when a tensor map cannot be encoded.
#include <atomic>
#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kBM = 128;               // rows per block, 64 per consumer
constexpr int kThreads = 384;          // producer + two consumer warpgroups
constexpr int kConsumerThreads = 256;
constexpr int kConsumerWarps = kConsumerThreads / 32;
constexpr int kRowBytes = 128;         // the swizzle width: one box row
constexpr int kABytes = kBM * kRowBytes;   // one x box, [128 rows, 128 B]
constexpr int kRingBytes = 196608;     // shared memory for the stages
constexpr int kMaxDevices = 64;

// ---------------------------------------------------------------- PTX
// TMA: one box at element coordinates (c0 = column, c1 = row) into shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

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

// Element (r, c) of a [rows, 128 B] box written by TMA with the 128-byte
// swizzle: the 16-byte chunk index is XORed with r % 8.
template <typename T>
__device__ __forceinline__ float swizzled(const uint8_t* box, int r, int c) {
  constexpr int kPerChunk = 16 / sizeof(T);
  const int off = r * kRowBytes + (((c / kPerChunk) ^ (r & 7)) << 4) +
                  (c % kPerChunk) * static_cast<int>(sizeof(T));
  return to_float(*reinterpret_cast<const T*>(box + off));
}

// Per-stage layout: the x box, then two [BN, 128 B] w boxes (fp32: w_hi
// and w_lo over the same 32 columns; bf16: w_hi over columns 0-31 and
// 32-63 of the stage's 64).
template <typename T, int BN>
struct Cfg {
  static constexpr int kKS = kRowBytes / sizeof(T);  // K columns per stage
  static constexpr int kSteps = kKS / 8;              // k8 steps per stage
  static constexpr int kBBytes = BN * kRowBytes;
  static constexpr int kStageBytes = kABytes + 2 * kBBytes;
  static constexpr int kStages = kRingBytes / kStageBytes;
  static constexpr int kRed = kRingBytes;                  // [8][BN] x 2
  static constexpr int kBars = kRed + 2 * kConsumerWarps * BN * 4;
  // full, then empty barrier of each stage; 1024 bytes of slack align the
  // base for the swizzle
  static constexpr int kBytes = kBars + 16 * kStages + 1024;
};

// A_LO: issue a_lo . b_hi (fp32 x, or an affine that leaves TF32).  fp32
// also issues a_hi . b_lo; bf16 w has no lo part.
template <typename T, int BN, bool A_LO>
__global__ void __launch_bounds__(kThreads, 1)
    mm_bn_stats_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                             const __grid_constant__ CUtensorMap tm_whi,
                             const __grid_constant__ CUtensorMap tm_wlo,
                             const float* __restrict__ scale,
                             const float* __restrict__ shift,
                             T* __restrict__ y, float* __restrict__ psum,
                             float* __restrict__ psumsq, int64_t m, int k,
                             int n, int relu_in) {
  using C = Cfg<T, BN>;
  constexpr bool kFp32 = std::is_same<T, float>::value;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* base_ptr = smem_raw + (base - raw);
  const uint32_t full = base + C::kBars;  // + 8 * stage
  const uint32_t empty = full + 8 * C::kStages;

  const int n_tiles = (n + BN - 1) / BN;
  const int64_t m_tile = blockIdx.x / n_tiles;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int64_t m0 = m_tile * kBM;
  const int nk = (k + C::kKS - 1) / C::kKS;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % C::kStages;
        const uint32_t phase = (kt / C::kStages) & 1;
        const uint32_t a = base + s * C::kStageBytes;
        const uint32_t b = a + kABytes;
        mbar_wait(empty + 8 * s, phase ^ 1);
        mbar_expect_tx(full + 8 * s, C::kStageBytes);
        tma_load_2d(a, &tm_x, full + 8 * s, kt * C::kKS,
                    static_cast<int>(m0));
        if constexpr (kFp32) {
          tma_load_2d(b, &tm_whi, full + 8 * s, kt * 32, n0);
          tma_load_2d(b + C::kBBytes, &tm_wlo, full + 8 * s, kt * 32, n0);
        } else {
          tma_load_2d(b, &tm_whi, full + 8 * s, kt * 64, n0);
          tma_load_2d(b + C::kBBytes, &tm_whi, full + 8 * s, kt * 64 + 32,
                      n0);
        }
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int ct = threadIdx.x - 128;        // 0 .. 255
  const int warp = ct / 32;                // 0 .. 7, 16 rows each
  const int lane = threadIdx.x % 32;
  const int row_lane = 16 * warp + lane / 4;  // and row_lane + 8
  const int col_lane = lane % 4;               // and col_lane + 4
  const bool ok[2] = {m0 + row_lane < m, m0 + row_lane + 8 < m};
  const bool affine = scale != nullptr;

  // The tensor core adds into its fp32 accumulator with truncation, which
  // over K = 1024-2048 biases y and the statistics past the fp32 gates; so
  // each stage's products go into `part`, and `acc` sums the stages with
  // fp32 adds rounded to nearest.
  float acc[BN / 2], part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.f;
  uint32_t hi[C::kSteps][4];
  uint32_t lo[C::kSteps][4];

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % C::kStages;
    const uint32_t a_addr = base + s * C::kStageBytes;
    const uint8_t* a_box = base_ptr + s * C::kStageBytes;
    mbar_wait(full + 8 * s, (kt / C::kStages) & 1);
    // x slice -> act(scale x + shift), rows >= M zeroed -> hi + lo, in the
    // A-fragment layout: register r holds row row_lane + 8 (r % 2), column
    // 8 kk + col_lane + 4 (r / 2)
#pragma unroll
    for (int kk = 0; kk < C::kSteps; ++kk) {
      float sc[2] = {1.f, 1.f}, sh[2] = {0.f, 0.f};
      if (affine) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kg = kt * C::kKS + 8 * kk + col_lane + 4 * h;
          sc[h] = kg < k ? __ldg(scale + kg) : 0.f;
          sh[h] = kg < k ? __ldg(shift + kg) : 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float v = swizzled<T>(a_box, row_lane + 8 * (r & 1),
                              8 * kk + col_lane + 4 * (r >> 1));
        if (affine) v = __fadd_rn(__fmul_rn(v, sc[r >> 1]), sh[r >> 1]);
        if (relu_in) v = fmaxf(v, 0.f);
        v = ok[r & 1] ? v : 0.f;
        hi[kk][r] = tf32_rna(v);
        if constexpr (A_LO)
          lo[kk][r] = tf32_rna(__fsub_rn(v, __uint_as_float(hi[kk][r])));
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::kSteps; ++kk) {
      // fp32: w_hi box, w_lo box; bf16: the w_hi box of this k8 step
      const uint32_t b = a_addr + kABytes +
                         (kFp32 ? 0 : (kk / 4) * C::kBBytes) + (kk % 4) * 32;
      const uint64_t b_hi = sw128_desc(b, 1, 64);
      // the stage's first product overwrites part
      if constexpr (A_LO) wgmma_tf32<BN>(part, lo[kk], b_hi, kk > 0);
      if constexpr (kFp32)
        wgmma_tf32<BN>(part, hi[kk], sw128_desc(b + C::kBBytes, 1, 64), 1);
      wgmma_tf32<BN>(part, hi[kk], b_hi, A_LO || kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
    fence_regs(hi);
    if constexpr (A_LO) fence_regs(lo);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  // epilogue.  acc[4 j + e] holds row row_lane + 8 (e / 2), column
  // n0 + 8 j + 2 col_lane + e % 2.  y, rounded once from the accumulator:
  const int c_lane = 2 * col_lane;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!ok[h]) continue;
    T* yrow = y + (m0 + row_lane + 8 * h) * n;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + c_lane;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (col + 1 < n && n % 2 == 0) {
        if constexpr (kFp32) {
          *reinterpret_cast<float2*>(yrow + col) = make_float2(v0, v1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(yrow + col) =
              __floats2bfloat162_rn(v0, v1);
        }
      } else {
        if (col < n) yrow[col] = from_float<T>(v0);
        if (col + 1 < n) yrow[col + 1] = from_float<T>(v1);
      }
    }
  }

  // statistics of the accumulator (rows >= M hold exact zeros): the two
  // rows of this thread, the 8 lanes of the warp that share the column,
  // then the 8 consumer warps in order
  float* red_s = reinterpret_cast<float*>(base_ptr + C::kRed);
  float* red_q = red_s + kConsumerWarps * BN;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float a0 = acc[4 * j + e], a1 = acc[4 * j + 2 + e];
      float s = a0 + a1;
      float q = fmaf(a1, a1, a0 * a0);
#pragma unroll
      for (int o = 4; o < 32; o *= 2) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
        q += __shfl_xor_sync(0xffffffffu, q, o);
      }
      if (lane < 4) {
        red_s[warp * BN + 8 * j + c_lane + e] = s;
        red_q[warp * BN + 8 * j + c_lane + e] = q;
      }
    }
  }
  named_sync(1, kConsumerThreads);
  if (ct < BN && n0 + ct < n) {
    float ss = 0.f, qq = 0.f;
#pragma unroll
    for (int w = 0; w < kConsumerWarps; ++w) {
      ss += red_s[w * BN + ct];
      qq += red_q[w * BN + ct];
    }
    const int64_t at = m_tile * n + n0 + ct;
    psum[at] = ss;
    psumsq[at] = qq;
  }
}

// w [N, K] -> w_hi = tf32(w) and, for fp32, w_lo = tf32(w - w_hi).
template <typename T>
__global__ void mm_bn_stats_split_w_kernel(const T* __restrict__ w,
                                           float* __restrict__ w_hi,
                                           float* __restrict__ w_lo,
                                           int64_t count) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < count; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float v = to_float(w[i]);
    const float h = __uint_as_float(tf32_rna(v));
    w_hi[i] = h;
    if (w_lo != nullptr) w_lo[i] = __uint_as_float(tf32_rna(v - h));
  }
}

// ---------------------------------------------------------------- host
// A row-major [rows, cols] tensor as a 2-D map read in [box_rows, 128 B]
// boxes with the 128-byte swizzle; out-of-bounds elements read as zero.
int encode_map(CUtensorMap* map, const void* ptr, bool bf16, int64_t rows,
               int cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int elem = bf16 ? 2 : 4;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kRowBytes / elem),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r =
      fn(map,
         bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
              : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
         2, const_cast<void*>(ptr), dims, strides, box, estr,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(r);
}

template <typename T, int BN, bool A_LO>
int launch(const void* x, const float* w_hi, const float* w_lo,
           const float* scale, const float* shift, void* y, float* psum,
           float* psumsq, int64_t m, int k, int n, int relu_in,
           cudaStream_t stream) {
  constexpr int smem = Cfg<T, BN>::kBytes;
  static std::atomic<bool> attr_set[kMaxDevices];
  auto kernel = mm_bn_stats_wgmma_kernel<T, BN, A_LO>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!attr_set[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set[dev].store(true, std::memory_order_release);
  }
  constexpr bool bf16 = !std::is_same<T, float>::value;
  CUtensorMap tx, thi, tlo;
  int rc = encode_map(&tx, x, bf16, m, k, kBM);
  if (!rc) rc = encode_map(&thi, w_hi, false, n, k, BN);
  if (!rc) rc = encode_map(&tlo, bf16 ? w_hi : w_lo, false, n, k, BN);
  if (rc) return rc;
  const int64_t blocks = (m + kBM - 1) / kBM * ((n + BN - 1) / BN);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      tx, thi, tlo, scale, shift, static_cast<T*>(y), psum, psumsq, m, k, n,
      relu_in);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run(const void* x, const void* w, float* w_hi, float* w_lo,
        const float* scale, const float* shift, void* y, float* psum,
        float* psumsq, int64_t m, int k, int n, int relu_in,
        cudaStream_t stream) {
  const int64_t count = static_cast<int64_t>(n) * k;
  const int64_t blocks = (count + 255) / 256;
  mm_bn_stats_split_w_kernel<T>
      <<<static_cast<unsigned>(blocks < 1056 ? blocks : 1056), 256, 0,
         stream>>>(static_cast<const T*>(w), w_hi, w_lo, count);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr bool kFp32 = std::is_same<T, float>::value;
  // bf16 inputs are TF32 already; only an affine makes a lo part
  const bool a_lo = kFp32 || scale != nullptr;
  if (n <= 64)
    return a_lo ? launch<T, 64, true>(x, w_hi, w_lo, scale, shift, y, psum,
                                      psumsq, m, k, n, relu_in, stream)
                : launch<T, 64, kFp32>(x, w_hi, w_lo, scale, shift, y, psum,
                                       psumsq, m, k, n, relu_in, stream);
  return a_lo ? launch<T, 128, true>(x, w_hi, w_lo, scale, shift, y, psum,
                                     psumsq, m, k, n, relu_in, stream)
              : launch<T, 128, kFp32>(x, w_hi, w_lo, scale, shift, y, psum,
                                      psumsq, m, k, n, relu_in, stream);
}

}  // namespace

// dtype: 0 = float32 (K % 4 == 0, w_lo required), 1 = bfloat16 (K % 8 == 0,
// w_lo unused).  x, w_hi and w_lo 16-byte aligned.  Returns a cudaError_t
// (0 on success) or kEncodeError + a CUresult.
extern "C" int fused_conv_bn_wgmma(const void* x, const void* w, float* w_hi,
                                   float* w_lo, const float* scale,
                                   const float* shift, void* y, float* psum,
                                   float* psumsq, long long m, int k, int n,
                                   int relu_in, int dtype, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || m > 0x7fffffffLL ||
      (scale == nullptr) != (shift == nullptr) || dtype < 0 || dtype > 1 ||
      k % (dtype == 0 ? 4 : 8) || (dtype == 0 && w_lo == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : {x, static_cast<const void*>(w_hi),
                        static_cast<const void*>(w_lo)})
    if (reinterpret_cast<uintptr_t>(p) % 16)
      return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(x, w, w_hi, w_lo, scale, shift, y, psum, psumsq, m, k,
                      n, relu_in, st);
  return run<__nv_bfloat16>(x, w, w_hi, nullptr, scale, shift, y, psum,
                            psumsq, m, k, n, relu_in, st);
}

extern "C" const char* fused_conv_bn_wgmma_error_string(int err) {
  return error_string(err);
}

// Tile height of the statistics partials: psum/psumsq have
// ceil(M / fused_conv_bn_wgmma_tile_m()) rows.
extern "C" int fused_conv_bn_wgmma_tile_m() { return kBM; }
