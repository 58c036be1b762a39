// Flash-attention forward for Hopper (sm_90a) on the tensor cores: bf16 in,
// fp32 softmax and accumulation, bf16 O and fp32 lse out.
//
// Replaces the TPU kernel mxnet_tpu/ops/attention.py:_flash_fwd_kernel (called
// through _flash_forward_pallas) for bf16 inputs whose head dim D is a
// multiple of 8 (TMA needs 16-byte row strides) and at most 128; every other
// input stays on the CUDA-core kernel in flash_fwd.cu.  Same function: for
// every (batch*head, query row) O = softmax(q k^T * sm_scale) v and
// lse = m + log(l), masked scores at -1e30, and in causal mode the key tiles
// entirely above a query tile's diagonal skipped.
//
// What bounds it: 4*S_q*S_k*D flops per head (half that when causal) against
// 3*S*D bf16 inputs, so at the serving shapes (S 16..2048, D 128) it is
// compute: at [4, 32, 2048, 128] causal the function's 137 GFLOP take at
// least 0.139 ms at the 989 TFLOP/s bf16 tensor-core peak.  This kernel
// runs 1.5x those operations (below), so its own ceiling is 0.208 ms.
//
// Why P is split.  The TPU kernel keeps P in fp32 for its second product
// (jnp.dot(p, vj, preferred_element_type=jnp.float32) with vj widened to
// fp32, mxnet_tpu/ops/attention.py:77), and chip_smoke.py holds the bf16
// output to within half a bf16 ulp of that fp32 function.  The usual
// tensor-core flash kernel rounds P to bf16 before P.V, which misses that
// bound by one to two orders of magnitude.  Here P is written as
// P_hi = bf16(P) plus P_lo = bf16(P - P_hi) (about 16 significant bits) and
// O accumulates P_hi.V + P_lo.V in fp32: a third product per tile instead
// of the second.  q.k^T on bf16 inputs is exact per product with an fp32
// accumulator, as the TPU kernel's fp32 dot is.
//
// Design:
//   * one block per (128-row query tile, b*h); causal grids launch the
//     heaviest query tiles (the last ones) first;
//   * three warpgroups: a producer, whose one thread starts TMA loads, and
//     two consumers of 64 query rows each; setmaxnreg moves registers from
//     the producer (24) to the consumers (240);
//   * TMA loads from 3-D tensor maps over [BH, S, D] (boxes [1, 128, 64],
//     128-byte swizzle), so a ragged sequence end reads zeros and never the
//     next head's rows, and D < 64 or 64 < D < 128 is zero-padded to 64 or
//     128 columns; Q is loaded once, K and V go through rings of kStages
//     stages, each stage with its own full / empty mbarriers;
//   * S = Q.K^T by wgmma m64n128k16 with both operands in shared memory;
//     scale (log2 e folded in), mask only on diagonal or ragged tiles, row
//     max by shuffles inside each accumulator quad, ex2;
//   * P_hi and P_lo are built in registers straight in wgmma's A-fragment
//     layout (the fp32 accumulator's layout, paired), and O += P_hi.V +
//     P_lo.V by wgmma with A from registers and V read N-major (trans-b) in
//     its natural [keys, D] layout; l is summed from the fp32 P;
//   * each consumer starts S_t and P_{t-1} V_{t-1} together, and the two
//     consumers take turns to start them (named barriers), so the tensor
//     cores run one consumer's products while the other computes its
//     softmax;
//   * a K stage goes back to the producer once S_t is done and a V stage
//     once wgmma.wait_group shows P_{t-1} V_{t-1} done;
//   * O / l is rounded once to bf16 and stored with rows >= S_q and columns
//     >= D masked; lse is stored in fp32.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, chip_smoke.py):
// at [4, 32, 2048, 128] causal a first version took 0.533 ms, because
// ptxas serialises every wgmma of the kernel (C7512) once any code spills,
// which a timer in the 24-register producer's wait loop did; without it
// 0.445 ms, and with the consumers taking turns 0.40 ms.  ptxas schedules
// wgmma.wait_group as early as it may, so most of a consumer's softmax
// still runs after its own P.V has finished: the overlap comes from the
// turns.
//
// Interface: plain C, bound from Python with ctypes (mxnet_tpu_torch/ops/
// attention.py).  q [BH, S_q, D], k/v [BH, S_k, D], o [BH, S_q, D] bf16,
// contiguous, 16-byte aligned; lse [BH, S_q] fp32.  The tensor maps are
// encoded at each call with cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint, so the library links only the CUDA runtime.
// Launches on the given stream and returns a cudaError_t, or
// kEncodeError + the CUresult when a tensor map cannot be encoded.
#include <atomic>
#include <cstdint>
#include <initializer_list>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kBlockQ = 128;      // query rows per block, 64 per consumer
constexpr int kBlockK = 128;      // keys per tile
constexpr int kStages = 2;        // K/V ring depth
constexpr int kThreads = 384;     // producer + two consumer warpgroups
constexpr int kConsumerThreads = 256;
constexpr int kBoxCols = 64;      // 128 bytes of bf16: the swizzle width
constexpr int kSubTileBytes = 128 * kBoxCols * 2;  // one [128, 64] box
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kMaxDevices = 64;

// ---------------------------------------------------------------- PTX
// D[64 x 128] (+)= A[64 x 16] * B[16 x 128], A and B from shared memory
// (both K-major), fp32 accumulator; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 128] += A[64 x 16] * B[16 x 128], A from registers (bf16 pairs in
// the accumulator's row layout), B from shared memory N-major (trans-b).
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], A from registers (bf16 pairs in
// the accumulator's row layout), B from shared memory N-major (trans-b).
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Named barriers 1 and 2 order when the two consumers start their products
// (bar.sync by the warpgroup whose turn it is, bar.arrive by the other).
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kConsumerThreads)
               : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kConsumerThreads)
               : "memory");
}

template <int DP>
struct Smem {
  static constexpr int kTile = DP / kBoxCols * kSubTileBytes;  // one Q/K/V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kTile;                    // + stage * kTile
  static constexpr int kV = (1 + kStages) * kTile;    // + stage * kTile
  static constexpr int kBars = (1 + 2 * kStages) * kTile;
  // q_full, then full and empty barriers of each K and V stage; 1024 bytes
  // of slack align the base
  static constexpr int kBytes = kBars + 8 * (1 + 4 * kStages) + 1024;
};

// S = Q K^T for one 64-row slice of Q: K-major operands, 8-row groups
// 1024 bytes apart; each k16 step is 32 bytes further along the 128-byte
// swizzled row, and the next 64 columns are the next box.
template <int DP>
__device__ __forceinline__ void start_s(float (&s)[64], uint32_t q_rows,
                                        uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = (kk / 4) * kSubTileBytes + (kk % 4) * 32;
    wgmma_ss_m64n128(s, sw128_desc(q_rows + off, 1, 64),
                     sw128_desc(k_tile + off, 1, 64), kk > 0);
  }
  wgmma_commit();
}

// O += P_hi V + P_lo V: V read N-major, 8-key groups 1024 bytes apart
// (stride), 64-column boxes kSubTileBytes apart (leading); each k16 step is
// 16 keys (2048 bytes) further.
template <int DP>
__device__ __forceinline__ void start_pv(float (&acc)[DP / 2],
                                         const uint32_t (&hi)[8][4],
                                         const uint32_t (&lo)[8][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint64_t dv = sw128_desc(v_tile + kk * 2048, kSubTileBytes / 16, 64);
    if constexpr (DP == 128) {
      wgmma_rs_m64n128(acc, hi[kk], dv);
      wgmma_rs_m64n128(acc, lo[kk], dv);
    } else {
      wgmma_rs_m64n64(acc, hi[kk], dv);
      wgmma_rs_m64n64(acc, lo[kk], dv);
    }
  }
  wgmma_commit();
}

// P = P_hi + P_lo in the A-fragment layout of k16 step kk: registers
// (row, keys 16kk + col_lane + {0,1}), (row + 8, same), (row, +8),
// (row + 8, +8) are accumulator entries 8kk + {0,1}, {2,3}, {4,5}, {6,7}.
__device__ __forceinline__ void split_p(const float (&p)[64],
                                        uint32_t (&hi)[8][4],
                                        uint32_t (&lo)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = p[8 * kk + 2 * r];
      const float b = p[8 * kk + 2 * r + 1];
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(a, b);
      const float2 hf = __bfloat1622float2(h2);
      hi[kk][r] = *reinterpret_cast<const uint32_t*>(&h2);
      lo[kk][r] = pack_bf16(a - hf.x, b - hf.y);
    }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int s_q, int s_k, int d,
                           int causal, float scale_log2) {
  using L = Smem<DP>;
  constexpr int kSub = DP / kBoxCols;  // [128, 64] boxes per tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_bar = base + L::kBars;
  const uint32_t full_k = q_bar + 8;  // + 8 * stage, and so on
  const uint32_t full_v = full_k + 8 * kStages;
  const uint32_t empty_k = full_v + 8 * kStages;
  const uint32_t empty_v = empty_k + 8 * kStages;

  const int q_tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = q_tile * kBlockQ;
  const int bh = blockIdx.y;
  const int k_end = causal ? min(s_k, q0 + kBlockQ) : s_k;
  const int n_tiles = (k_end + kBlockK - 1) / kBlockK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, kConsumerThreads);
      mbar_init(empty_v + 8 * s, kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_bar, L::kTile);
      for (int c = 0; c < kSub; ++c)
        tma_load_3d(base + L::kQ + c * kSubTileBytes, &tm_q, q_bar,
                    c * kBoxCols, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int stage = t % kStages;
        const uint32_t phase = (t / kStages) & 1;
        const uint32_t ks = base + L::kK + stage * L::kTile;
        const uint32_t vs = base + L::kV + stage * L::kTile;
        mbar_wait(empty_k + 8 * stage, phase ^ 1);
        mbar_expect_tx(full_k + 8 * stage, L::kTile);
        for (int c = 0; c < kSub; ++c)
          tma_load_3d(ks + c * kSubTileBytes, &tm_k, full_k + 8 * stage,
                      c * kBoxCols, t * kBlockK, bh);
        mbar_wait(empty_v + 8 * stage, phase ^ 1);
        mbar_expect_tx(full_v + 8 * stage, L::kTile);
        for (int c = 0; c < kSub; ++c)
          tma_load_3d(vs + c * kSubTileBytes, &tm_v, full_v + 8 * stage,
                      c * kBoxCols, t * kBlockK, bh);
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    // Step t starts S_t = Q K_t^T and O += P_{t-1} V_{t-1} in one turn,
    // then computes the softmax of S_t once S_t is done.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int g = wg - 1;                 // rows q0 + 64 g .. + 63
    const int lane = threadIdx.x % 32;
    const int warp = (threadIdx.x / 32) % 4;
    const int row0 = q0 + 64 * g + 16 * warp + lane / 4;  // and row0 + 8
    const int col_lane = 2 * (lane % 4);
    const uint32_t q_rows = base + L::kQ + g * 64 * 128;
    const int row_min = q0 + 64 * g;
    auto edge = [&](int k0) {
      return (k0 + kBlockK > s_k) || (causal && k0 + kBlockK - 1 > row_min);
    };
    // The two consumers take turns to start their products (named barriers
    // 1 and 2), so one computes its softmax while the other's run.
    const int my_turn = 1 + g, other_turn = 2 - g;
    if (g == 1) named_arrive(other_turn);

    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    float m2[2] = {kMask, kMask};  // running max of the base-2 scores
    float l[2];                    // this thread's share of the row sums
    float alpha[2];
    float s[64];
    uint32_t hi[8][4];
    uint32_t lo[8][4];

    mbar_wait(q_bar, 0);
    mbar_wait(full_k, 0);
    __syncwarp();
    named_sync(my_turn);
    wgmma_fence();
    start_s<DP>(s, q_rows, base + L::kK);
    named_arrive(other_turn);
    wgmma_wait<0>();
    fence_regs(s);
    mbar_arrive(empty_k);
    softmax_tile(s, m2, alpha, l, scale_log2, edge(0), 0, row0, col_lane, s_k,
                 causal);
    split_p(s, hi, lo);

    for (int t = 1; t < n_tiles; ++t) {
      const int stage = t % kStages;
      const int prev = (t - 1) % kStages;
      const uint32_t phase = (t / kStages) & 1;
      mbar_wait(full_k + 8 * stage, phase);
      mbar_wait(full_v + 8 * prev, ((t - 1) / kStages) & 1);
      __syncwarp();
      named_sync(my_turn);
      fence_regs(acc);
      fence_regs(hi);
      fence_regs(lo);
      wgmma_fence();
      start_s<DP>(s, q_rows, base + L::kK + stage * L::kTile);
      start_pv<DP>(acc, hi, lo, base + L::kV + prev * L::kTile);
      named_arrive(other_turn);
      wgmma_wait<1>();
      fence_regs(s);
      mbar_arrive(empty_k + 8 * stage);
      float rs[2];
      softmax_tile(s, m2, alpha, rs, scale_log2, edge(t * kBlockK),
                   t * kBlockK, row0, col_lane, s_k, causal);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(hi);
      fence_regs(lo);
      mbar_arrive(empty_v + 8 * prev);
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      split_p(s, hi, lo);
    }

    const int last = n_tiles - 1;
    mbar_wait(full_v + 8 * (last % kStages), (last / kStages) & 1);
    __syncwarp();
    named_sync(my_turn);
    fence_regs(acc);
    fence_regs(hi);
    fence_regs(lo);
    wgmma_fence();
    start_pv<DP>(acc, hi, lo, base + L::kV + (last % kStages) * L::kTile);
    named_arrive(other_turn);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(hi);
    fence_regs(lo);
    if (g == 0) named_sync(my_turn);  // the other consumer's last turn

    // epilogue: O / l rounded once to bf16; lse = (m2 + log2 l) ln 2
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
    const size_t bh_row = static_cast<size_t>(bh) * s_q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= s_q) continue;
      const float inv = 1.f / l[h];
      __nv_bfloat16* orow = o + (bh_row + row) * d;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + col_lane;
        if (col < d)
          *reinterpret_cast<uint32_t*>(orow + col) =
              pack_bf16(acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
      }
      if (lane % 4 == 0) lse[bh_row + row] = m2[h] * kLn2 + logf(l[h]);
    }
  }
}

// ---------------------------------------------------------------- host
// A [BH, S, D] bf16 tensor as a 3-D map read in [1, 128, 64] boxes with the
// 128-byte swizzle; out-of-bounds elements read as zero.
int encode_map(CUtensorMap* map, const void* ptr, int bh, int s, int d) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)s * d * 2};
  const cuuint32_t box[3] = {kBoxCols, 128, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int bh, int s_q, int s_k, int d, int causal, float sm_scale,
           cudaStream_t stream) {
  constexpr int smem = Smem<DP>::kBytes;
  static std::atomic<bool> attr_set[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!attr_set[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    attr_set[dev].store(true, std::memory_order_release);
  }
  CUtensorMap tq, tk, tv;
  int rc = encode_map(&tq, q, bh, s_q, d);
  if (!rc) rc = encode_map(&tk, k, bh, s_k, d);
  if (!rc) rc = encode_map(&tv, v, bh, s_k, d);
  if (rc) return rc;
  const dim3 grid((s_q + kBlockQ - 1) / kBlockQ, bh);
  flash_fwd_wgmma_kernel<DP><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, s_q, s_k, d, causal,
      sm_scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 only; d a multiple of 8 in 8..128; pointers 16-byte aligned.
// Returns a cudaError_t (0 on success) or kEncodeError + a CUresult.
extern "C" int flash_fwd_wgmma(const void* q, const void* k, const void* v,
                               void* o, float* lse, int bh, int s_q, int s_k,
                               int d, int causal, float sm_scale,
                               void* stream) {
  if (bh <= 0 || bh > 65535 || s_q <= 0 || s_k <= 0 || d <= 0 || d > 128 ||
      d % 8)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k, v})
    if (reinterpret_cast<uintptr_t>(p) % 16)
      return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 64)
    return launch<64>(q, k, v, o, lse, bh, s_q, s_k, d, causal, sm_scale, st);
  return launch<128>(q, k, v, o, lse, bh, s_q, s_k, d, causal, sm_scale, st);
}

extern "C" const char* flash_fwd_wgmma_error_string(int err) {
  return error_string(err);
}
