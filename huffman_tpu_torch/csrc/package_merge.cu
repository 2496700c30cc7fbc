// K7 package_merge: optimal length-limited code lengths by boundary
// package-merge, from the dense histogram to lengths by leaf rank.
//
// Replaces: huffman_tpu/ops/device_codebook.py, _pm_kernel (reached
// through _pm_pallas and device_code_lengths). Same outputs for the same
// (freqs, n, max_len, K): lengths_by_rank (K,) and leaf_sym (K,) int32.
//
// Three stages, several launches on one stream (one C call, one count):
//  1. Stable leaf sort of the whole histogram by (weight, symbol), absent
//     symbols at weight kInf. The keys (w << 16 | sym) are unique, so any
//     correct sort is the stable one: tiles of 2,048 keys are bitonic-
//     sorted in shared memory, then merged pairwise in global memory, where
//     each key's output position is its index in its run plus the count of
//     smaller keys in the partner run (a binary search).
//  2. max_len - 1 rounds of package + merge over a 2K list of u32 keys
//     w << 1 | is_package. A package is the (saturating) sum of a pair of
//     adjacent items of the previous list, so packages arrive sorted. Leaf
//     keys are even and package keys odd, so no key is shared across the
//     two lists and the same rank-by-binary-search merge places every item
//     at a fixed position: the level flags (key LSBs) are deterministic.
//     Leaves precede packages of equal weight, as in the JAX package.
//  3. The backward counting pass, one block: per level from the deepest,
//     p = packages among the first c items, m = c - p leaves taken,
//     c = 2p one level down; length(rank r) = #levels with r < m.
//
// The TPU kernel's bitonic merge network, sign-biased keys and XOR-roll
// partners worked around Mosaic's lack of unsigned vector min/max and of
// cheap lane gathers; none of them is needed here.
//
// What bounds it on an H100: latency, not bytes or operations. The data
// is small (256 KiB of histogram, lists of 2K u32), but each round depends
// on the previous one, so the work is ~25 short dependent launches whose
// binary searches hit L2. The full K = 65536 tier's flags ((max_len-1) *
// 2K bytes) and lists do not fit one block's shared memory, hence the
// global-memory rounds.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kInf = 1u << 30;  // weight of absent symbols and padding
constexpr int kTile = 2048;
constexpr int kSortThreads = 1024;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kSortThreads)
leaf_tile_sort(const int32_t* __restrict__ freqs, int tile,
               uint64_t* __restrict__ keys) {
  __shared__ uint64_t sk[kTile];
  const int base = blockIdx.x * tile;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int s = base + i;
    const int32_t f = freqs[s];
    const uint64_t w = f > 0 ? (uint64_t)f : (uint64_t)kInf;
    sk[i] = (w << 16) | (uint64_t)s;
  }
  __syncthreads();
  for (int k = 2; k <= tile; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < tile; i += blockDim.x) {
        const int p = i ^ j;
        if (p > i) {
          const uint64_t a = sk[i], b = sk[p];
          const bool ascending = (i & k) == 0;
          if ((a > b) == ascending) {
            sk[i] = b;
            sk[p] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < tile; i += blockDim.x) keys[base + i] = sk[i];
}

// Merge sorted runs of length `run` pairwise: n and run are powers of two.
__global__ void leaf_merge_pass(const uint64_t* __restrict__ in,
                                uint64_t* __restrict__ out, int n, int run) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint64_t key = in[i];
  const int r = i / run;
  const int pair0 = (r & ~1) * run;
  const uint64_t* other = in + ((r & 1) ? pair0 : pair0 + run);
  int lo = 0, hi = run;  // count of partner keys below key
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (other[mid] < key) lo = mid + 1; else hi = mid;
  }
  out[pair0 + (i - r * run) + lo] = key;
}

// The first K sorted leaves: merge keys, symbols, and the round-1 list
// (leaves ++ kInf padding).
__global__ void leaves_init(const uint64_t* __restrict__ sorted, int K,
                            uint32_t* __restrict__ leaf_keys,
                            int32_t* __restrict__ leaf_sym,
                            uint32_t* __restrict__ list) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= K) return;
  const uint64_t key = sorted[i];
  const uint32_t lk = (uint32_t)(key >> 16) << 1;
  leaf_keys[i] = lk;
  leaf_sym[i] = (int32_t)(key & 0xFFFFu);
  list[i] = lk;
  list[K + i] = kInf << 1;
}

__device__ __forceinline__ uint32_t package_key(const uint32_t* prev, int j) {
  const uint32_t a = prev[2 * j] >> 1, b = prev[2 * j + 1] >> 1;
  const uint32_t w = (a >= kInf || b >= kInf) ? kInf : min(a + b, kInf);
  return (w << 1) | 1u;  // a + b <= 2^31: exact in u32
}

__global__ void pm_round(const uint32_t* __restrict__ leaf_keys,
                         const uint32_t* __restrict__ prev,
                         uint32_t* __restrict__ next,
                         uint8_t* __restrict__ flags, int K) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 2 * K) return;
  uint32_t key;
  int own, lo = 0, hi = K;
  if (t < K) {  // leaf t: count the packages below it
    own = t;
    key = leaf_keys[t];
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (package_key(prev, mid) < key) lo = mid + 1; else hi = mid;
    }
  } else {  // package own: count the leaves below it
    own = t - K;
    key = package_key(prev, own);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (leaf_keys[mid] < key) lo = mid + 1; else hi = mid;
    }
  }
  next[own + lo] = key;
  flags[own + lo] = (uint8_t)(key & 1u);
}

__device__ int block_sum(int v, int* warp_sums) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // earlier readers of warp_sums are done
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += warp_sums[w];
  return total;
}

__global__ void __launch_bounds__(kSortThreads)
pm_backward(const uint8_t* __restrict__ flags, int K, int n, int max_len,
            int32_t* __restrict__ lengths) {
  __shared__ int m_level[33];
  __shared__ int warp_sums[32];
  int c = max(2 * n - 2, 0);
  for (int l = max_len - 1; l >= 1; --l) {
    const uint8_t* f = flags + (size_t)(l - 1) * (2 * K);
    int p = 0;
    for (int k = threadIdx.x; k < c; k += blockDim.x) p += f[k];
    p = block_sum(p, warp_sums);
    if (threadIdx.x == 0) m_level[l] = c - p;
    c = 2 * p;
  }
  if (threadIdx.x == 0) m_level[0] = c;  // the leaves' level: no packages
  __syncthreads();
  for (int r = threadIdx.x; r < K; r += blockDim.x) {
    int len = 0;
    for (int l = 0; l < max_len; ++l) len += r < m_level[l];
    lengths[r] = len;
  }
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// freqs: (n_sym,) int32, n_sym a power of two <= 65536; K a power of two
// <= n_sym; 1 <= max_len <= 32; n = present symbols. Scratch: keys_a and
// keys_b (n_sym,) u64, leaf_keys (K,) u32, list_a and list_b (2K,) u32,
// flags ((max_len - 1) * 2K,) u8. Outputs: lengths (K,), leaf_sym (K,).
extern "C" int htpu_package_merge(const void* freqs, int n_sym, int n, int K,
                                  int max_len, void* keys_a, void* keys_b,
                                  void* leaf_keys, void* list_a, void* list_b,
                                  void* flags, void* lengths, void* leaf_sym,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  const int tile = n_sym < kTile ? n_sym : kTile;
  leaf_tile_sort<<<n_sym / tile, kSortThreads, 0, st>>>(
      (const int32_t*)freqs, tile, (uint64_t*)keys_a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  uint64_t* cur = (uint64_t*)keys_a;
  uint64_t* alt = (uint64_t*)keys_b;
  for (int run = tile; run < n_sym; run <<= 1) {
    leaf_merge_pass<<<blocks_for(n_sym), kThreads, 0, st>>>(cur, alt, n_sym, run);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    uint64_t* t = cur; cur = alt; alt = t;
  }
  leaves_init<<<blocks_for(K), kThreads, 0, st>>>(
      cur, K, (uint32_t*)leaf_keys, (int32_t*)leaf_sym, (uint32_t*)list_a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  uint32_t* prev = (uint32_t*)list_a;
  uint32_t* next = (uint32_t*)list_b;
  for (int r = 0; r < max_len - 1; ++r) {
    pm_round<<<blocks_for(2 * K), kThreads, 0, st>>>(
        (const uint32_t*)leaf_keys, prev, next,
        (uint8_t*)flags + (size_t)r * (2 * K), K);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    uint32_t* t = prev; prev = next; next = t;
  }
  pm_backward<<<1, kSortThreads, 0, st>>>((const uint8_t*)flags, K, n,
                                          max_len, (int32_t*)lengths);
  return (int)cudaGetLastError();
}
