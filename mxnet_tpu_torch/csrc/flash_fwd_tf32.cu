// Flash-attention forward for Hopper (sm_90a) on the tensor cores in fp32:
// fp32 q, k, v in, fp32 O and lse out, every product kept to fp32 accuracy
// by a three-product TF32 split.
//
// Replaces the TPU kernel mxnet_tpu/ops/attention.py:_flash_fwd_kernel (called
// through _flash_forward_pallas) for fp32 inputs whose head dim D is a
// multiple of 4 (TMA needs 16-byte row strides) and at most 128; fp32 with
// any other D stays on the CUDA-core kernel in flash_fwd.cu, and bf16 goes to
// flash_fwd_wgmma.cu.  Same function: for every (batch*head, query row)
// O = softmax(q k^T * sm_scale) v and lse = m + log(l), masked scores at
// -1e30, and in causal mode the key tiles entirely above a query tile's
// diagonal skipped.
//
// What bounds it: 4*S_q*S_k*D flops per head (half that when causal) against
// 16*S*D bytes of q, k, v and O.  At BERT-base's attention shape
// [64, 12, 128, 64] non-causal the function's 3.22 GFLOP become 9.66 GFLOP of
// TF32 products here (0.0195 ms at 495 TFLOP/s), while its 101 MB take
// 0.0301 ms at 3.35 TB/s: it is bound by bytes.  On the CUDA cores the same
// operations take at least 0.048 ms at 67 TFLOP/s.
//
// Why three products.  The TPU kernel computes both products in fp32
// (jnp.dot with preferred_element_type=float32 on fp32 operands), and
// chip_smoke.py holds O and lse to 1e-4.  The tensor cores take fp32 only as
// TF32 (the top 19 bits), and one TF32 product misses that gate (the CPU
// emulation in tests/test_torch_attention.py).  So every operand is split,
// a = a_hi + a_lo with a_hi = tf32(a) and a_lo = tf32(a - a_hi), both rounded
// by cvt.rna.tf32.f32 and so exact TF32 values (whatever the tensor core
// does with the low 13 bits of an fp32 word, it finds zeros), and every
// product sums a_lo.b_hi + a_hi.b_lo + a_hi.b_hi.
//
// Design:
//   * persistent: one block per SM walks over the work items (128-row query
//     tile, b*h), heaviest causal tiles first, so the next item's loads land
//     while this one computes (at S = 128 an item is all of one head: two
//     key tiles);
//   * three warpgroups: the first holds the producer, one thread that
//     starts TMA loads, and the splitter (its warps 1-3, below); the other
//     two are consumers of 64 query rows each, which run on their own
//     (mbarriers, no barrier between them), so one's softmax overlaps the
//     other's products; setmaxnreg moves registers from the first (80) to
//     the consumers (208): an increase draws only on what the block's own
//     decreases gave back, 128 * (168 - 80) of the 168 a thread starts
//     with, and asking for more waits for ever;
//   * TMA loads from 3-D tensor maps over [BH, S, D] in boxes of 32 columns
//     (128 bytes of fp32, the swizzle width) with the 128-byte swizzle, so a
//     ragged sequence end reads zeros and never the next head's rows, and D
//     is zero-padded to DP = 64 or 128 columns.  Q goes through kQStages
//     stages (two at DP = 64, so the next item's Q lands while this one
//     computes), K and V through one stage of BK keys (64 at DP = 64, 32 at
//     DP = 128), and an item's first K/V tile is loaded before its Q;
//   * the block's K/V tiles form one stream across its work items, and the
//     splitter splits tile t + 1 into the other of two sets of buffers
//     while the consumers compute tile t (set_full / set_empty mbarriers
//     hand the sets over); the stage then goes back to the producer.  A
//     set is k_hi and k_lo in K's own layout (elementwise), and v_hi^T and
//     v_lo^T transposed to [D, keys], because a TF32 wgmma reads B only
//     K-major and the contraction of P.V runs over keys.  Within each group
//     of 8 keys the transposed columns are permuted (column c holds key 2c
//     for c < 4 and key 2(c - 4) + 1 otherwise): the accumulator of S holds
//     keys 2t and 2t + 1 of each group of 8 where a TF32 A fragment holds
//     columns t and t + 4 (t = lane % 4), so with this order P goes from
//     S's accumulator into A fragments without a shuffle.  Each splitter
//     thread moves a 4 x 4 block of V per step, chosen so that neither its
//     16-byte reads nor its transposed 16-byte writes meet a bank conflict.
//     Shared memory: the Q stages, the K/V stage and the two sets, 224 KB
//     at either DP;
//   * S = Q.K^T by wgmma m64nBKk8: Q read from its stage straight into A
//     fragments and split in registers, 64 columns at a time; B from k_hi
//     and k_lo;
//   * online softmax in base 2 on the CUDA cores (shared with
//     flash_fwd_wgmma.cu, hopper.cuh), P split in registers;
//   * O += P.V by wgmma m64nDPk8 with B from v_hi^T and v_lo^T.  The tensor
//     core adds into its fp32 accumulator with truncation, which biased long
//     sums past fp32 gates in fused_conv_bn_wgmma.cu, so each tile's P.V
//     starts a fresh accumulator and O = alpha O + PV is taken in fp32
//     rounded to nearest;
//   * O / l and lse are stored from registers, rows >= S_q and columns >= D
//     masked.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md; chip_smoke.py,
// chip_flash_variants.py --kernel tf32): 0.055-0.056 ms at BERT-base's
// shape, 54% of its bytes bound, against 0.133 ms for SDPA in fp32 and
// 0.163 ms on the CUDA cores.  With the consumers splitting each tile
// themselves between two barriers it took 0.062 ms; splitting the next
// tile alongside (two sets, the splitter) and no barrier between the
// consumers brought it to 0.055.  Without the split, or with one product
// in place of three, it would take 0.048 and 0.046 ms.
//
// Interface: plain C, bound from Python with ctypes (mxnet_tpu_torch/ops/
// attention.py).  q [BH, S_q, D], k/v [BH, S_k, D], o [BH, S_q, D] fp32,
// contiguous, q, k, v 16-byte aligned; lse [BH, S_q] fp32.  The tensor maps
// are encoded at each call with cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint, so the library links only the CUDA runtime.
// Launches on the given stream and returns a cudaError_t, or kEncodeError +
// the CUresult when a tensor map cannot be encoded.
#include <atomic>
#include <cstdint>
#include <initializer_list>

#include <cuda.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kBlockQ = 128;      // query rows per work item, 64 per consumer
constexpr int kThreads = 384;     // producer + splitter, two consumers
constexpr int kConsumerThreads = 256;
constexpr int kSplitThreads = 96;  // warps 1-3 of the first warpgroup
constexpr int kBoxCols = 32;      // 128 bytes of fp32: the swizzle width
constexpr int kRowBytes = 128;    // one box row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kMaxDevices = 64;

// Tiles and shared-memory layout for a head dim padded to DP (64 or 128).
// A tile of R rows and DP columns is DP / 32 boxes of [R rows, 128 B], each
// 1024-byte aligned for the swizzle; v_hi^T and v_lo^T are BK / 32 boxes of
// [DP rows, 128 B].
template <int DP>
struct Cfg {
  static constexpr int kBK = DP == 64 ? 64 : 32;      // keys per tile
  static constexpr int kQStages = DP == 64 ? 2 : 1;
  static constexpr int kStages = 1;                   // K/V ring depth
  static constexpr int kQBytes = kBlockQ * DP * 4;    // one Q tile
  static constexpr int kKVBytes = kBK * DP * 4;       // one K, V or split tile
  static constexpr int kQ = 0;                        // + stage * kQBytes
  static constexpr int kK = kQStages * kQBytes;       // + stage * 2 kKVBytes
  // two sets of split buffers (+ set * kSplitBytes), each k_hi, k_lo,
  // v_hi^T, v_lo^T; V at kK + kKVBytes
  static constexpr int kSplit = kK + kStages * 2 * kKVBytes;
  static constexpr int kSplitBytes = 4 * kKVBytes;
  static constexpr int kBars = kSplit + 2 * kSplitBytes;
  // q_full and q_empty of each Q stage, full and empty of each K/V stage,
  // set_full and set_empty of each split set; 1024 bytes of slack align
  // the base
  static constexpr int kBytes = kBars + 16 * (kQStages + kStages + 2) + 1024;
};

__device__ __forceinline__ float4 tf32_split(float4 a, float4& lo) {
  float4 hi;
  hi.x = __uint_as_float(tf32_rna(a.x));
  hi.y = __uint_as_float(tf32_rna(a.y));
  hi.z = __uint_as_float(tf32_rna(a.z));
  hi.w = __uint_as_float(tf32_rna(a.w));
  lo.x = __uint_as_float(tf32_rna(a.x - hi.x));
  lo.y = __uint_as_float(tf32_rna(a.y - hi.y));
  lo.z = __uint_as_float(tf32_rna(a.z - hi.z));
  lo.w = __uint_as_float(tf32_rna(a.w - hi.w));
  return hi;
}

// Split one K/V stage (K at kv, V at kv + BK * DP * 4) into a set of split
// buffers: k_hi, k_lo, v_hi^T and v_lo^T, each BK * DP * 4 bytes, in that
// order from `out`; `st` is the thread's index among the splitters.  Ends
// with the fence that lets the wgmma read them.
template <int DP, int BK>
__device__ __forceinline__ void split_kv(const uint8_t* kv, uint8_t* out,
                                         int st) {
  constexpr int kTile = BK * DP * 4;
  uint8_t* k_hi = out;
  uint8_t* k_lo = out + kTile;
  uint8_t* vt_hi = out + 2 * kTile;
  uint8_t* vt_lo = out + 3 * kTile;
  // K keeps its layout: 16 bytes at a time, neighbours on neighbours.
#pragma unroll
  for (int i = st; i < BK * DP / 4; i += kSplitThreads) {
    float4 lo;
    const float4 hi = tf32_split(reinterpret_cast<const float4*>(kv)[i], lo);
    reinterpret_cast<float4*>(k_hi)[i] = hi;
    reinterpret_cast<float4*>(k_lo)[i] = lo;
  }
  // V: each step moves keys 8 grp + h + 2m (m = 0..3) of columns 4c .. 4c+3,
  // which land in transposed row 4c + e at columns 8 grp + 4h + m (the
  // permuted order), one 16-byte write per row.  The bits of i pick (h, grp,
  // c) so that the 8 lanes of each 16-byte phase read 8 different swizzled
  // chunks and write 8 different ones.
  const uint8_t* v = kv + kTile;
#pragma unroll
  for (int i = st; i < BK * DP / 16; i += kSplitThreads) {
    const int h = i & 1, y = (i >> 1) & 1, x = (i >> 2) & 1, z = (i >> 3) & 1;
    const int a = (i >> 4) & 1, b = (i >> 5) & 1, r = i >> 6;
    const int grp = 4 * (r % (BK / 32)) + 2 * x + y;
    const int c = 8 * (r / (BK / 32)) + 4 * (x ^ a) + 2 * (y ^ b) + z;
    float4 w[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int key = 8 * grp + h + 2 * m;
      w[m] = *reinterpret_cast<const float4*>(
          v + (c / 8) * BK * kRowBytes + key * kRowBytes +
          (((c % 8) ^ (key & 7)) << 4));
    }
    const float4 col[4] = {make_float4(w[0].x, w[1].x, w[2].x, w[3].x),
                           make_float4(w[0].y, w[1].y, w[2].y, w[3].y),
                           make_float4(w[0].z, w[1].z, w[2].z, w[3].z),
                           make_float4(w[0].w, w[1].w, w[2].w, w[3].w)};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 4 * c + e;
      const int off = (grp / 4) * DP * kRowBytes + row * kRowBytes +
                      (((2 * (grp % 4) + h) ^ (row & 7)) << 4);
      float4 lo;
      const float4 hi = tf32_split(col[e], lo);
      *reinterpret_cast<float4*>(vt_hi + off) = hi;
      *reinterpret_cast<float4*>(vt_lo + off) = lo;
    }
  }
  fence_proxy_async();
}

// Element (r, c) of a Q tile: box c / 32, row r, 16-byte chunk (c % 32) / 4
// XOR r % 8.
__device__ __forceinline__ float q_elem(const uint8_t* q, int r, int c) {
  return *reinterpret_cast<const float*>(
      q + (c / kBoxCols) * kBlockQ * kRowBytes + r * kRowBytes +
      ((((c % kBoxCols) / 4) ^ (r & 7)) << 4) + (c % 4) * 4);
}

// S = Q K^T for this consumer's 64 rows (r_lane is the thread's first row
// in the Q tile): Q 64 columns at a time into split A fragments, K from
// k_hi and k_lo (K-major, 8-row groups 1024 bytes apart; each k8 step is 32
// bytes further along the 128-byte row, the next 32 columns the next box).
template <int DP, int BK>
__device__ __forceinline__ void start_s(float (&s)[BK / 2], const uint8_t* q,
                                        uint32_t k_hi, uint32_t k_lo,
                                        int r_lane, int t4) {
#pragma unroll
  for (int c64 = 0; c64 < DP / 64; ++c64) {
    uint32_t hi[8][4], lo[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float v = q_elem(q, r_lane + 8 * (r & 1),
                               64 * c64 + 8 * kk + t4 + 4 * (r >> 1));
        hi[kk][r] = tf32_rna(v);
        lo[kk][r] = tf32_rna(v - __uint_as_float(hi[kk][r]));
      }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int k8 = 8 * c64 + kk;
      const uint32_t off = (k8 / 4) * BK * kRowBytes + (k8 % 4) * 32;
      const uint64_t b_hi = sw128_desc(k_hi + off, 1, 64);
      wgmma_tf32<BK>(s, lo[kk], b_hi, k8 > 0);
      wgmma_tf32<BK>(s, hi[kk], sw128_desc(k_lo + off, 1, 64), 1);
      wgmma_tf32<BK>(s, hi[kk], b_hi, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(hi);
    fence_regs(lo);
  }
}

// P = P_hi + P_lo in the A-fragment layout of k8 step kk: register r holds
// row + 8 (r % 2), column t + 4 (r / 2), which is key 2t + r / 2 of the
// group (the permuted order), accumulator entry 4 kk + 2 (r % 2) + r / 2.
template <int BK>
__device__ __forceinline__ void split_p(const float (&p)[BK / 2],
                                        uint32_t (&hi)[BK / 8][4],
                                        uint32_t (&lo)[BK / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float v = p[4 * kk + 2 * (r & 1) + (r >> 1)];
      hi[kk][r] = tf32_rna(v);
      lo[kk][r] = tf32_rna(v - __uint_as_float(hi[kk][r]));
    }
}

// Start pv = P V for one key tile in a fresh accumulator, B from v_hi^T and
// v_lo^T (K-major over keys, 8-row groups 1024 bytes apart; each k8 step is
// 32 bytes further, the next 32 keys the next box); the caller waits.
template <int DP, int BK>
__device__ __forceinline__ void start_pv(float (&pv)[DP / 2],
                                         const uint32_t (&hi)[BK / 8][4],
                                         const uint32_t (&lo)[BK / 8][4],
                                         uint32_t vt_hi, uint32_t vt_lo) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    const uint32_t off = (kk / 4) * DP * kRowBytes + (kk % 4) * 32;
    const uint64_t b_hi = sw128_desc(vt_hi + off, 1, 64);
    wgmma_tf32<DP>(pv, lo[kk], b_hi, kk > 0);
    wgmma_tf32<DP>(pv, hi[kk], sw128_desc(vt_lo + off, 1, 64), 1);
    wgmma_tf32<DP>(pv, hi[kk], b_hi, 1);
  }
  wgmma_commit();
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_tf32_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          float* __restrict__ o, float* __restrict__ lse,
                          int bh_count, int s_q, int s_k, int d, int causal,
                          float scale_log2) {
  using C = Cfg<DP>;
  constexpr int BK = C::kBK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* base_ptr = smem_raw + (base - raw);
  const uint32_t q_full = base + C::kBars;  // + 8 * stage, and so on
  const uint32_t q_empty = q_full + 8 * C::kQStages;
  const uint32_t full = q_empty + 8 * C::kQStages;
  const uint32_t empty = full + 8 * C::kStages;
  const uint32_t set_full = empty + 8 * C::kStages;  // + 8 * set
  const uint32_t set_empty = set_full + 16;

  const int n_qt = (s_q + kBlockQ - 1) / kBlockQ;
  const int items = n_qt * bh_count;
  // work item i: its query tile (the last ones first when causal) and its
  // number of key tiles; its b*h is i % bh_count
  auto item_q0 = [&](int i) {
    const int rank = i / bh_count;
    return (causal ? n_qt - 1 - rank : rank) * kBlockQ;
  };
  auto item_tiles = [&](int q0) {
    const int k_end = causal ? min(s_k, q0 + kBlockQ) : s_k;
    return (k_end + BK - 1) / BK;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kQStages; ++s) {
      mbar_init(q_full + 8 * s, 1);
      mbar_init(q_empty + 8 * s, kConsumerThreads);
    }
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kSplitThreads);
    }
    for (int set = 0; set < 2; ++set) {
      mbar_init(set_full + 8 * set, kSplitThreads);
      mbar_init(set_empty + 8 * set, kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 80;\n");
    if (threadIdx.x == 0) {
      // ---------------------------------------------------------- producer
      int kv = 0;  // K/V tiles loaded by this block
      auto load_kv = [&](int t, int bh) {
        const int s = kv % C::kStages;
        const uint32_t kd = base + C::kK + s * 2 * C::kKVBytes;
        mbar_wait(empty + 8 * s, ((kv / C::kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * C::kKVBytes);
        for (int c = 0; c < DP / kBoxCols; ++c) {
          tma_load_3d(kd + c * BK * kRowBytes, &tm_k, full + 8 * s,
                      c * kBoxCols, t * BK, bh);
          tma_load_3d(kd + C::kKVBytes + c * BK * kRowBytes, &tm_v,
                      full + 8 * s, c * kBoxCols, t * BK, bh);
        }
        ++kv;
      };
      for (int i = blockIdx.x, n = 0; i < items; i += gridDim.x, ++n) {
        const int q0 = item_q0(i), bh = i % bh_count;
        const int qs = n % C::kQStages;
        const uint32_t qd = base + C::kQ + qs * C::kQBytes;
        // an item's first K/V tile goes before its Q: the consumers split
        // it while they still hold the previous item's Q
        load_kv(0, bh);
        mbar_wait(q_empty + 8 * qs, ((n / C::kQStages) & 1) ^ 1);
        mbar_expect_tx(q_full + 8 * qs, C::kQBytes);
        for (int c = 0; c < DP / kBoxCols; ++c)
          tma_load_3d(qd + c * kBlockQ * kRowBytes, &tm_q, q_full + 8 * qs,
                      c * kBoxCols, q0, bh);
        for (int t = 1, nt = item_tiles(q0); t < nt; ++t) load_kv(t, bh);
      }
    } else if (threadIdx.x >= 32) {
      // ---------------------------------------------------------- splitter
      // The block's K/V tiles form one stream across its work items; tile
      // kv goes into set kv % 2 once the consumers are done with tile
      // kv - 2, and its stage goes back to the producer.
      const int st = threadIdx.x - 32;
      int kv = 0;
      for (int i = blockIdx.x; i < items; i += gridDim.x)
        for (int t = 0, nt = item_tiles(item_q0(i)); t < nt; ++t, ++kv) {
          const int s = kv % C::kStages, set = kv & 1;
          mbar_wait(set_empty + 8 * set, ((kv >> 1) & 1) ^ 1);
          mbar_wait(full + 8 * s, (kv / C::kStages) & 1);
          split_kv<DP, BK>(base_ptr + C::kK + s * 2 * C::kKVBytes,
                           base_ptr + C::kSplit + set * C::kSplitBytes, st);
          mbar_arrive(set_full + 8 * set);
          mbar_arrive(empty + 8 * s);
        }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 208;\n");
  const int ct = threadIdx.x - 128;       // 0 .. 255
  const int g = ct / 128;                 // rows 64 g .. 64 g + 63 of a tile
  const int lane = threadIdx.x % 32;
  const int warp = (ct / 32) % 4;
  const int r_lane = 64 * g + 16 * warp + lane / 4;  // and r_lane + 8
  const int t4 = lane % 4;

  int kv = 0;  // K/V tiles consumed by this block
  for (int i = blockIdx.x, n = 0; i < items; i += gridDim.x, ++n) {
    const int q0 = item_q0(i), bh = i % bh_count;
    const int nt = item_tiles(q0);
    const int qs = n % C::kQStages;
    const uint8_t* q = base_ptr + C::kQ + qs * C::kQBytes;
    const int row0 = q0 + r_lane;
    const int row_min = q0 + 64 * g;

    float acc[DP / 2];
#pragma unroll
    for (int j = 0; j < DP / 2; ++j) acc[j] = 0.f;
    float m2[2] = {kMask, kMask};  // running max of the base-2 scores
    float l[2] = {0.f, 0.f};       // this thread's share of the row sums

    mbar_wait(q_full + 8 * qs, (n / C::kQStages) & 1);
    for (int t = 0; t < nt; ++t, ++kv) {
      const int k0 = t * BK;
      const uint32_t set = base + C::kSplit + (kv & 1) * C::kSplitBytes;
      mbar_wait(set_full + 8 * (kv & 1), (kv >> 1) & 1);
      float sc[BK / 2];
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) sc[j] = 0.f;
      start_s<DP, BK>(sc, q, set, set + C::kKVBytes, r_lane, t4);
      const bool edge =
          (k0 + BK > s_k) || (causal && k0 + BK - 1 > row_min);
      float alpha[2], rs[2];
      softmax_tile(sc, m2, alpha, rs, scale_log2, edge, k0, row0, 2 * t4,
                   s_k, causal);
      uint32_t hi[BK / 8][4], lo[BK / 8][4];
      split_p<BK>(sc, hi, lo);
      float pv[DP / 2];
#pragma unroll
      for (int j = 0; j < DP / 2; ++j) pv[j] = 0.f;
      start_pv<DP, BK>(pv, hi, lo, set + 2 * C::kKVBytes,
                       set + 3 * C::kKVBytes);
      wgmma_wait<0>();
      fence_regs(pv);
      fence_regs(hi);
      fence_regs(lo);
      mbar_arrive(set_empty + 8 * (kv & 1));
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
#pragma unroll
      for (int j = 0; j < DP / 2; ++j)
        acc[j] = fmaf(acc[j], alpha[(j >> 1) & 1], pv[j]);
    }
    mbar_arrive(q_empty + 8 * qs);

    // epilogue: O / l and lse = (m2 + log2 l) ln 2
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
      float* orow = o + (bh_row + row) * d;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + 2 * t4;
        if (col < d)  // d % 4 == 0: col + 1 < d too
          *reinterpret_cast<float2*>(orow + col) = make_float2(
              acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
      }
      if (t4 == 0) lse[bh_row + row] = m2[h] * kLn2 + logf(l[h]);
    }
  }
}

// ---------------------------------------------------------------- host
// A [BH, S, D] fp32 tensor as a 3-D map read in [1, box_rows, 32] boxes with
// the 128-byte swizzle; out-of-bounds elements read as zero.
int encode_map(CUtensorMap* map, const void* ptr, int bh, int s, int d,
               int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 4,
                                 static_cast<cuuint64_t>(s) * d * 4};
  const cuuint32_t box[3] = {kBoxCols, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(r);
}

template <int DP>
int launch(const void* q, const void* k, const void* v, float* o, float* lse,
           int bh, int s_q, int s_k, int d, int causal, float sm_scale,
           cudaStream_t stream) {
  constexpr int smem = Cfg<DP>::kBytes;
  static std::atomic<int> sm_count[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  int sms = sm_count[dev].load(std::memory_order_acquire);
  if (sms == 0) {
    err = cudaFuncSetAttribute(flash_fwd_tf32_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    sm_count[dev].store(sms, std::memory_order_release);
  }
  CUtensorMap tq, tk, tv;
  int rc = encode_map(&tq, q, bh, s_q, d, kBlockQ);
  if (!rc) rc = encode_map(&tk, k, bh, s_k, d, Cfg<DP>::kBK);
  if (!rc) rc = encode_map(&tv, v, bh, s_k, d, Cfg<DP>::kBK);
  if (rc) return rc;
  const long long items =
      static_cast<long long>((s_q + kBlockQ - 1) / kBlockQ) * bh;
  const int grid = static_cast<int>(items < sms ? items : sms);
  flash_fwd_tf32_kernel<DP><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, o, lse, bh, s_q, s_k, d, causal, sm_scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// fp32 only; d a multiple of 4 in 4..128; q, k, v 16-byte aligned.
// Returns a cudaError_t (0 on success) or kEncodeError + a CUresult.
extern "C" int flash_fwd_tf32(const void* q, const void* k, const void* v,
                              void* o, float* lse, int bh, int s_q, int s_k,
                              int d, int causal, float sm_scale,
                              void* stream) {
  if (bh <= 0 || s_q <= 0 || s_k <= 0 || d <= 0 || d > 128 || d % 4 ||
      static_cast<long long>((s_q + kBlockQ - 1) / kBlockQ) * bh >
          0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : {q, k, v, static_cast<const void*>(o)})
    if (reinterpret_cast<uintptr_t>(p) % 16)
      return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(o);
  if (d <= 64)
    return launch<64>(q, k, v, out, lse, bh, s_q, s_k, d, causal, sm_scale,
                      st);
  return launch<128>(q, k, v, out, lse, bh, s_q, s_k, d, causal, sm_scale,
                     st);
}

extern "C" const char* flash_fwd_tf32_error_string(int err) {
  return error_string(err);
}
