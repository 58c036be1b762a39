// Deterministic Embedding backward for Hopper (sm_90a): the gradient of a
// row lookup out = weight[ids], a dense scatter-add of the output gradient
// into the table's shape,
//   dw[v, :] = sum over the positions i with ids[i] == v of dy[i, :],
// added in an order fixed by the ids alone, so a rerun gives the same bits.
// The JAX package's backward is XLA's scatter-add, which repeats bit for bit
// on the TPU; PyTorch's CUDA embedding backward does not.  This is the
// port's own kernel: no Pallas kernel of the JAX package computes it.
//
// The ids follow the forward's rules (mxnet_tpu_torch/ops/nn.py:embedding,
// the JAX package's jnp.take): an id in [-V, 0) counts from the end, any
// other id outside [0, V) adds nothing.  dy is [n, D] (fp32 or bf16), dw is
// [V, D] in dy's dtype; every sum runs in fp32 and is rounded once.
//
// Steps, all on the caller's stream and with no host synchronisation, so a
// CUDA graph can capture them:
//   1. zero dw (cudaMemsetAsync) and build keys[i] = (id << 32) | i, with
//      invalid ids and the padding up to P = the next power of two (at least
//      2) set to all ones, so they sort last;
//   2. sort the keys with a bitonic network.  The keys are unique (the
//      position is in the low half), so the order is one and the same on
//      every run, and equal ids keep their positions' order: a stable sort
//      by id.  Chunks of kChunk keys sort in shared memory in one launch;
//      each later merge level runs its strides >= kChunk as one global
//      launch each and the strides below kChunk in shared memory, in one
//      launch (for n = 8192: 6 launches);
//   3. a grid of (position blocks) x (32-column tiles): a block takes the
//      positions p = blockIdx.x, + gridDim.x, ...; where p starts a run of
//      equal ids (a segment), its 8 warps sum the segment's rows of their
//      32 columns, warp w the rows p + w, p + w + 8, ... in sorted order,
//      and warp 0 adds the 8 partial sums in warp order and writes the row
//      once.  One segment may hold all n ids (BERT's token_type_embed: 8192
//      ids, all 0); the column tiles spread it over D / 32 blocks and the
//      warps over 8 row strides.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 2048;        // keys sorted per shared-memory block
constexpr int kSortThreads = 1024;  // kChunk / 2 compare-exchanges per pass
constexpr int kCols = 32;           // columns per segment-sum block
constexpr int kWarps = 8;           // row strides per segment-sum block
constexpr unsigned long long kInvalid = ~0ull;

__global__ void make_keys(const long long* __restrict__ ids, long long n,
                          long long vocab, long long p,
                          unsigned long long* __restrict__ keys) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < p; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    unsigned long long key = kInvalid;
    if (i < n) {
      long long id = ids[i];
      if (id < 0) id += vocab;
      if (id >= 0 && id < vocab)
        key = (static_cast<unsigned long long>(id) << 32) |
              static_cast<unsigned long long>(i);
    }
    keys[i] = key;
  }
}

__device__ __forceinline__ void exchange(unsigned long long* a, int i, int l,
                                         bool up) {
  const unsigned long long x = a[i], y = a[l];
  if ((x > y) == up) {
    a[i] = y;
    a[l] = x;
  }
}

// Sort each chunk of `chunk` keys (chunk = min(P, kChunk)); the direction
// test uses the global index, so chunks alternate for the merges above.
__global__ void __launch_bounds__(kSortThreads)
sort_chunks(unsigned long long* __restrict__ keys, int chunk) {
  __shared__ unsigned long long s[kChunk];
  const long long base = static_cast<long long>(blockIdx.x) * chunk;
  for (int i = threadIdx.x; i < chunk; i += blockDim.x) s[i] = keys[base + i];
  __syncthreads();
  for (int k = 2; k <= chunk; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < chunk / 2; t += blockDim.x) {
        const int i = 2 * j * (t / j) + (t % j);
        exchange(s, i, i + j, ((base + i) & k) == 0);
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < chunk; i += blockDim.x) keys[base + i] = s[i];
}

// One compare-exchange pass of stride j >= kChunk at merge level k.
__global__ void merge_global(unsigned long long* __restrict__ keys,
                             long long p, long long k, long long j) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (t >= p / 2) return;
  const long long i = 2 * j * (t / j) + (t % j);
  const long long l = i + j;
  const bool up = (i & k) == 0;
  const unsigned long long x = keys[i], y = keys[l];
  if ((x > y) == up) {
    keys[i] = y;
    keys[l] = x;
  }
}

// The strides kChunk / 2 .. 1 of merge level k, each chunk in shared memory.
__global__ void __launch_bounds__(kSortThreads)
merge_chunks(unsigned long long* __restrict__ keys, long long k) {
  __shared__ unsigned long long s[kChunk];
  const long long base = static_cast<long long>(blockIdx.x) * kChunk;
  for (int i = threadIdx.x; i < kChunk; i += blockDim.x) s[i] = keys[base + i];
  __syncthreads();
  for (int j = kChunk >> 1; j > 0; j >>= 1) {
    for (int t = threadIdx.x; t < kChunk / 2; t += blockDim.x) {
      const int i = 2 * j * (t / j) + (t % j);
      exchange(s, i, i + j, ((base + i) & k) == 0);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < kChunk; i += blockDim.x) keys[base + i] = s[i];
}

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kCols * kWarps)
segment_sum(const unsigned long long* __restrict__ keys, long long n,
            const T* __restrict__ dy, T* __restrict__ dw, int d) {
  __shared__ float part[kWarps][kCols];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int col = blockIdx.y * kCols + lane;
  for (long long p = blockIdx.x; p < n; p += gridDim.x) {
    const unsigned long long key = keys[p];
    if (key == kInvalid) break;  // sorted: the rest are invalid or padding
    const unsigned long long id = key >> 32;
    if (p > 0 && (keys[p - 1] >> 32) == id) continue;  // not a run's start
    float acc = 0.f;
    for (long long r = p + warp; r < n; r += kWarps) {
      const unsigned long long kr = keys[r];
      if ((kr >> 32) != id) break;
      if (col < d) acc += load(dy + (kr & 0xffffffffull) * d + col);
    }
    part[warp][lane] = acc;
    __syncthreads();
    if (warp == 0 && col < d) {
      float sum = part[0][lane];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) sum += part[w][lane];
      store(dw + id * d + col, sum);
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const long long* ids, long long n, const void* dy, void* dw,
           long long vocab, int d, unsigned long long* keys, long long p,
           cudaStream_t st) {
  cudaError_t err = cudaMemsetAsync(
      dw, 0, static_cast<size_t>(vocab) * d * sizeof(T), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long key_blocks = (p + 255) / 256;
  make_keys<<<static_cast<unsigned>(key_blocks < 65535 ? key_blocks : 65535),
              256, 0, st>>>(ids, n, vocab, p, keys);
  const int chunk = static_cast<int>(p < kChunk ? p : kChunk);
  sort_chunks<<<static_cast<unsigned>(p / chunk), kSortThreads, 0, st>>>(
      keys, chunk);
  for (long long k = 2LL * kChunk; k <= p; k <<= 1) {
    for (long long j = k >> 1; j >= kChunk; j >>= 1)
      merge_global<<<static_cast<unsigned>((p / 2 + 255) / 256), 256, 0,
                     st>>>(keys, p, k, j);
    merge_chunks<<<static_cast<unsigned>(p / kChunk), kSortThreads, 0, st>>>(
        keys, k);
  }
  const long long pos_blocks = n < 4096 ? n : 4096;
  const dim3 grid(static_cast<unsigned>(pos_blocks),
                  static_cast<unsigned>((d + kCols - 1) / kCols));
  segment_sum<T><<<grid, dim3(kCols, kWarps), 0, st>>>(
      keys, n, static_cast<const T*>(dy), static_cast<T*>(dw), d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ids: int64 [n]; dy: [n, d]; dw: [vocab, d]; keys: uint64 workspace of
// p = embedding_bwd_keys(n) entries.  dtype 0 = fp32, 1 = bf16.
extern "C" int embedding_bwd(const long long* ids, long long n,
                             const void* dy, void* dw, long long vocab, int d,
                             int dtype, unsigned long long* keys, long long p,
                             void* stream) {
  if (n <= 0 || d <= 0 || vocab <= 0 || vocab >= 0xffffffffLL ||
      n > 0xffffffffLL || p < n || p < 2 || (p & (p - 1)) ||
      (d + kCols - 1) / kCols > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(ids, n, dy, dw, vocab, d, keys, p, st);
    case 1:
      return launch<__nv_bfloat16>(ids, n, dy, dw, vocab, d, keys, p, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The key workspace's length for n ids: the next power of two, at least 2.
extern "C" long long embedding_bwd_keys(long long n) {
  long long p = 2;
  while (p < n) p <<= 1;
  return p;
}

extern "C" const char* embedding_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
