// K7 package_merge: optimal length-limited code lengths by boundary
// package-merge, from the dense histogram to lengths by leaf rank.
//
// Replaces: huffman_tpu/ops/device_codebook.py, _pm_kernel (reached
// through _pm_pallas and device_code_lengths). Same outputs for the same
// (freqs, n, max_len, K): lengths_by_rank (K,) and leaf_sym (K,) int32.
// n is the count of bins with f > 0 and every weight is below kInf (a
// histogram of fewer than 2^30 pairs).
//
// The function has three stages:
//  1. The first K leaves of the stable sort of the whole histogram by
//     (weight, symbol), absent symbols at weight kInf. The keys
//     (w << 16 | sym) are unique, so any correct sort is the stable one.
//  2. max_len - 1 rounds of package + merge over a 2K list of u32 keys
//     w << 1 | is_package. A package is the (saturating) sum of a pair of
//     adjacent items of the previous list, so packages arrive sorted. Leaf
//     keys are even and package keys odd, so no key is shared across the
//     two lists and the merged order is unique: leaf t lands at
//     pos(t) = t + #(packages below it), strictly increasing in t. Leaves
//     precede packages of equal weight, as in the JAX package.
//  3. The backward counting pass, one block: per level from the deepest,
//     the first c items hold m = #{t : pos(t) < c} leaves and p = c - m
//     packages; c = 2p one level down; length(rank r) = #levels with
//     r < m. m is read from the leaves' merge positions, never from a scan
//     of the c items.
//
// Two routes through them, chosen here from the arguments:
//  - K <= kOneBlockMaxK and n <= K: one kernel of one block does it all.
//    The n present keys are gathered into shared memory by one sweep of
//    the histogram and merge-sorted there; ranks n .. K - 1 are the first
//    K - n absent symbols in index order (their keys kInf << 16 | s sort
//    by symbol), all in bins [0, K): exactly the first K keys of the full
//    sort. A round reads the leaf keys and its package keys from shared
//    memory, each thread merging its run of outputs after one merge-path
//    search, and writes the next round's package keys (pairs of adjacent
//    outputs), with one barrier a round; the merged list itself is never
//    stored. Each run's merge-path split is m at the run's first output,
//    so a round keeps the splits and a bit mask of its leaf outputs a run
//    (3 bytes a thread) and the count reads m from them. This is the tier
//    of every input with at most 4096 distinct pairs.
//  - Otherwise: several launches on one stream (one C call, one count):
//    tiles of 2,048 keys bitonic-sorted in shared memory, merged pairwise
//    in global memory (each key's output position is its index in its run
//    plus the count of smaller keys in the partner run), then one launch a
//    round, whose lists (2 x 512 KiB at K = 65536) do not fit a block's
//    shared memory, writing the K leaf positions pos(t) to a
//    (max_len - 1, K) int32 scratch, then the count: pos is increasing, so
//    m is one search over t, two dependent probes of 1024 threads a level.
//
// The TPU kernel's bitonic merge network, sign-biased keys and XOR-roll
// partners worked around Mosaic's lack of unsigned vector min/max and of
// cheap lane gathers; none of them is needed here.
//
// What bounds it on an H100: latency, not bytes or operations. The data
// is small (256 KiB of histogram, lists of 2K u32) and every round depends
// on the one before. The one-block route pays one launch and a barrier a
// round (the sweep keeps 8 loads a thread in flight, the sort is 4-key
// runs in registers and ten merge passes, and padded key arrays keep the
// runs' shared accesses free of bank conflicts); the other route pays a
// launch a round.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kInf = 1u << 30;  // weight of absent symbols and padding
constexpr int kTile = 2048;
constexpr int kBlock = 1024;  // threads of the tile sort, the count and the one-block kernel
constexpr int kThreads = 256;
// The one-block kernel's shared memory (one_block_bytes) is 215 KiB at
// K = 4096 and max_len 32; a block may use 227 KiB.
constexpr int kOneBlockMaxK = 4096;

__global__ void __launch_bounds__(kBlock)
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

// The package of two adjacent items x, y of the previous list.
__device__ __forceinline__ uint32_t package_of(uint32_t x, uint32_t y) {
  const uint32_t a = x >> 1, b = y >> 1;
  const uint32_t w = (a >= kInf || b >= kInf) ? kInf : min(a + b, kInf);
  return (w << 1) | 1u;  // a + b <= 2^31: exact in u32
}

__device__ __forceinline__ uint32_t package_key(const uint32_t* prev, int j) {
  return package_of(prev[2 * j], prev[2 * j + 1]);
}

// One round: every item of the merged list placed by a binary-search rank
// in the other list; leaf t's position goes to pos[t].
__global__ void pm_round(const uint32_t* __restrict__ leaf_keys,
                         const uint32_t* __restrict__ prev,
                         uint32_t* __restrict__ next,
                         int32_t* __restrict__ pos, int K) {
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
    pos[t] = t + lo;
  } else {  // package own: count the leaves below it
    own = t - K;
    key = package_key(prev, own);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (leaf_keys[mid] < key) lo = mid + 1; else hi = mid;
    }
  }
  next[own + lo] = key;
}

// #{t < K : pos[t] < c} for strictly increasing pos, K a power of two.
// Every thread of the block calls it and gets the count. Each pass probes
// the last position of 1024 equal slices of the range still open; the
// count of probes below c locates the slice holding the boundary. Two
// passes for K <= 2^20.
__device__ int count_below(const int32_t* pos, int K, int c) {
  int base = 0, len = K;
  while (true) {
    const int stride = len > kBlock ? len / kBlock : 1;
    const int probes = len / stride;
    const int t = threadIdx.x;
    const int below = __syncthreads_count(
        t < probes && pos[base + (t + 1) * stride - 1] < c);
    base += below * stride;
    if (stride == 1 || below == probes) return base;
    len = stride;
  }
}

// The backward counting pass: m_level[l], the leaves taken at level l,
// written by thread 0. leaves_below(r, items): the leaves among the first
// items (< 2K) of round r's merged list, the same in every calling thread.
template <typename LeavesBelow>
__device__ void count_levels(LeavesBelow leaves_below, int K, int n,
                             int max_len, int* m_level) {
  int c = max(2 * n - 2, 0);
  for (int l = max_len - 1; l >= 1; --l) {
    // The list has 2K items: past them nothing is a package.
    const int items = min(c, 2 * K);
    const int p = items - (items == 2 * K ? K : leaves_below(l - 1, items));
    if (threadIdx.x == 0) m_level[l] = c - p;
    c = 2 * p;
  }
  if (threadIdx.x == 0) m_level[0] = c;  // the leaves' level: no packages
}

// length(rank r) = #levels with r < m_level, after a block barrier.
__device__ void write_lengths(const int* m_level, int K, int max_len,
                              int32_t* __restrict__ lengths) {
  for (int r = threadIdx.x; r < K; r += blockDim.x) {
    int len = 0;
    for (int l = 0; l < max_len; ++l) len += r < m_level[l];
    lengths[r] = len;
  }
}

__global__ void __launch_bounds__(kBlock)
pm_count(const int32_t* __restrict__ pos, int K, int n, int max_len,
         int32_t* __restrict__ lengths) {
  __shared__ int m_level[32];
  count_levels([&](int r, int items) { return count_below(pos + (size_t)r * K, K, items); },
               K, n, max_len, m_level);
  __syncthreads();
  write_lengths(m_level, K, max_len, lengths);
}

// Shared-memory index of item e of the leaf or package keys: one word of
// padding every 32, so that the runs of 4 consecutive words the threads
// of a warp read and write fall in 32 different banks.
__device__ __forceinline__ int padded(int e) { return e + (e >> 5); }

// Dynamic shared memory of the one-block kernel, in this order: the
// present keys and the sort's second buffer (max(K, 4) u64 each), the
// leaf keys and two rounds' package keys (K u32 each, padded, and a
// sentinel), the first absent symbols (K u16), and per round each
// thread's merge-path split (u16) and mask of leaf outputs (u8).
int one_block_bytes(int K, int max_len) {
  const int key_words = K + (K >> 5) + 1;
  return 2 * 8 * max(K, 4) + 4 * 3 * key_words + 2 * K + 3 * kBlock * (max_len - 1);
}

// Compare-exchange of two keys held by one thread: the smaller to a.
__device__ __forceinline__ void exchange(uint64_t& a, uint64_t& b) {
  const uint64_t lo = min(a, b);
  b = max(a, b);
  a = lo;
}

// The whole function in one block, for K <= kOneBlockMaxK and n <= K.
__global__ void __launch_bounds__(kBlock)
pm_one_block(const int32_t* __restrict__ freqs, int n_sym, int n, int K,
             int max_len, int32_t* __restrict__ lengths,
             int32_t* __restrict__ leaf_sym) {
  extern __shared__ uint64_t smem[];
  const int key_words = K + (K >> 5) + 1;
  uint64_t* sk = smem;
  uint64_t* sort_buf = sk + max(K, 4);
  uint32_t* lk = (uint32_t*)(sort_buf + max(K, 4));
  uint32_t* pk = lk + key_words;  // this round's package keys
  uint32_t* pk_next = pk + key_words;  // the next round's
  uint16_t* absent = (uint16_t*)(pk_next + key_words);
  uint16_t* splits = absent + K;
  uint8_t* masks = (uint8_t*)(splits + kBlock * (max_len - 1));
  __shared__ int n_present;
  __shared__ int warp_sums[kBlock / 32];
  __shared__ int m_level[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t lanes_below = (1u << lane) - 1u;

  // 1. Leaves. The present keys go to sk in any order (the sort orders
  // them): one shared atomic a warp and batch gives the warp its slots.
  // One coalesced sweep, kSweep loads in flight a thread.
  constexpr int kSweep = 8;
  if (threadIdx.x == 0) n_present = 0;
  __syncthreads();
  for (int s0 = 0; s0 < n_sym; s0 += kBlock * kSweep) {
    int32_t f[kSweep];
#pragma unroll
    for (int u = 0; u < kSweep; ++u) {
      const int s = s0 + u * kBlock + threadIdx.x;
      f[u] = s < n_sym ? freqs[s] : 0;
    }
    uint32_t hit[kSweep];
    int hits = 0;
#pragma unroll
    for (int u = 0; u < kSweep; ++u) {
      hit[u] = __ballot_sync(~0u, f[u] > 0);
      hits += __popc(hit[u]);
    }
    if (hits) {
      int slot = 0;
      if (lane == 0) slot = atomicAdd(&n_present, hits);
      slot = __shfl_sync(~0u, slot, 0);
#pragma unroll
      for (int u = 0; u < kSweep; ++u) {
        const int r = slot + __popc(hit[u] & lanes_below);
        if (f[u] > 0 && r < K)
          sk[r] = ((uint64_t)f[u] << 16) | (uint64_t)(s0 + u * kBlock + threadIdx.x);
        slot += __popc(hit[u]);
      }
    }
  }
  // The first K - n absent symbols lie in bins [0, K), which hold at most
  // n present ones: a block scan of their absent flags in index order,
  // 4 bins a thread (K <= 4 * kBlock).
  int32_t g[4];
  int absent_here = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int s = 4 * threadIdx.x + b;
    g[b] = s < K ? freqs[s] : 1;
    absent_here += g[b] <= 0;
  }
  int rank = absent_here;  // inclusive scan over the warp, then the block
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(~0u, rank, o);
    if (lane >= o) rank += v;
  }
  if (lane == 31) warp_sums[warp] = rank;
  __syncthreads();
  for (int w = 0; w < warp; ++w) rank += warp_sums[w];
  rank -= absent_here;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (g[b] <= 0) absent[rank++] = (uint16_t)(4 * threadIdx.x + b);
  const int n_leaf = min(n_present, K);  // n_present == n <= K for a histogram

  // Merge sort of the n_leaf keys padded with ~0 to size, a power of two
  // of at least 4 (size <= max(K, 4)). Thread t sorts keys [4t, 4t + 4)
  // in registers; then each pass merges pairs of runs from one buffer to
  // the other, thread t writing outputs [4t, 4t + 4) of its pair after a
  // merge-path search (the keys are unique but for the ~0 padding, whose
  // order does not matter), one block barrier a pass.
  int size = 4;
  while (size < n_leaf) size <<= 1;
  const int e0 = 4 * threadIdx.x;
  if (e0 < size) {
    uint64_t x[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = e0 + r < n_leaf ? sk[e0 + r] : ~0ull;
    exchange(x[0], x[1]);
    exchange(x[2], x[3]);
    exchange(x[0], x[2]);
    exchange(x[1], x[3]);
    exchange(x[1], x[2]);
#pragma unroll
    for (int r = 0; r < 4; ++r) sk[e0 + r] = x[r];
  }
  __syncthreads();
  uint64_t* sorted = sk;
  uint64_t* other = sort_buf;
  for (int run = 4; run < size; run <<= 1) {
    if (e0 < size) {
      const int pair = e0 & ~(2 * run - 1), d = e0 - pair;
      const uint64_t* a = sorted + pair;
      const uint64_t* b = a + run;
      int lo = max(d - run, 0), hi = min(d, run);
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (a[mid] < b[d - 1 - mid]) lo = mid + 1; else hi = mid;
      }
      int i = lo, j = d - lo;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const uint64_t va = i < run ? a[i] : ~0ull, vb = j < run ? b[j] : ~0ull;
        const bool take_a = va < vb;
        other[e0 + m] = take_a ? va : vb;
        i += take_a;
        j += !take_a;
      }
    }
    __syncthreads();
    uint64_t* t = sorted; sorted = other; other = t;
  }
  // Ranks n_leaf .. K - 1 are the absent symbols.
  for (int r = threadIdx.x; r < K; r += kBlock) {
    uint32_t key = kInf << 1;
    int32_t sym;
    if (r < n_leaf) {
      key = (uint32_t)(sorted[r] >> 16) << 1;
      sym = (int32_t)(sorted[r] & 0xFFFFu);
    } else {
      sym = absent[r - n_leaf];
    }
    lk[padded(r)] = key;
    leaf_sym[r] = sym;
  }
  if (threadIdx.x == 0) lk[padded(K)] = pk[padded(K)] = pk_next[padded(K)] = ~0u;  // sentinels
  __syncthreads();
  // Round 1's packages: pairs of leaves, then of kInf padding.
  for (int j = threadIdx.x; j < K; j += kBlock)
    pk[padded(j)] = 2 * j + 1 < K ? package_of(lk[padded(2 * j)], lk[padded(2 * j + 1)])
                                  : (kInf << 1) | 1u;
  __syncthreads();

  // 2. Rounds. Thread t merges outputs [d0, d0 + per) of the round's list
  // (the leaves and the packages pk). Merge path: the leaves among the
  // first d0 outputs are the count of mid with lk[mid] < pk[d0 - 1 - mid],
  // a predicate true then false in mid (no key is shared across the
  // lists); from there a serial merge. The list itself is never stored:
  // the next round needs only its packages, pairs of adjacent outputs,
  // which lie in one thread (per >= 2) or in two neighbouring lanes. That
  // count (the split) and the mask of the run's leaf outputs are all the
  // count below needs of the round.
  const int per = max(2 * K / kBlock, 1), per_shift = __ffs(per) - 1;
  const int d0 = threadIdx.x * per;
  for (int round = 0; round < max_len - 1; ++round) {
    uint32_t out[8];
    if (d0 < 2 * K) {
      int lo = max(d0 - K, 0), hi = min(d0, K);
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (lk[padded(mid)] < pk[padded(d0 - 1 - mid)]) lo = mid + 1; else hi = mid;
      }
      int i = lo, j = d0 - lo;  // i, j <= K: past the last key, a sentinel
      uint32_t leaf = lk[padded(i)], pkg = pk[padded(j)], mask = 0;
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        if (d < per) {
          const bool take = leaf < pkg;
          out[d] = take ? leaf : pkg;
          mask |= (uint32_t)take << d;
          i += take;
          j += !take;
          leaf = lk[padded(i)];
          pkg = pk[padded(j)];
        }
      }
#pragma unroll
      for (int m = 0; m < 4; ++m)
        if (2 * m + 1 < per) pk_next[padded((d0 >> 1) + m)] = package_of(out[2 * m], out[2 * m + 1]);
      splits[round * kBlock + threadIdx.x] = (uint16_t)lo;
      masks[round * kBlock + threadIdx.x] = (uint8_t)mask;
    }
    if (per == 1) {  // K <= 512: outputs 2m and 2m + 1 are lanes' neighbours
      const uint32_t other = __shfl_xor_sync(~0u, out[0], 1);
      if (d0 < 2 * K && (threadIdx.x & 1) == 0)
        pk_next[padded(threadIdx.x >> 1)] = package_of(out[0], other);
    }
    __syncthreads();
    uint32_t* t = pk; pk = pk_next; pk_next = t;
  }

  // 3. Count, by one warp: the leaves among the first `items` outputs of
  // round r are the split of the run holding output `items` plus its leaf
  // outputs before it.
  if (warp == 0)
    count_levels(
        [&](int r, int items) {
          const int run = r * kBlock + (items >> per_shift);
          return (int)splits[run] + __popc(masks[run] & ((1u << (items & (per - 1))) - 1u));
        },
        K, n, max_len, m_level);
  __syncthreads();
  write_lengths(m_level, K, max_len, lengths);
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// freqs: (n_sym,) int32, n_sym a power of two <= 65536; K a power of two
// <= n_sym; 1 <= max_len <= 32; n = bins with f > 0. Scratch, read only
// when the call is not one block: keys_a and keys_b (n_sym,) u64,
// leaf_keys (K,) u32, list_a and list_b (2K,) u32, positions
// ((max_len - 1) * K,) int32. Outputs: lengths (K,), leaf_sym (K,).
extern "C" int htpu_package_merge(const void* freqs, int n_sym, int n, int K,
                                  int max_len, void* keys_a, void* keys_b,
                                  void* leaf_keys, void* list_a, void* list_b,
                                  void* positions, void* lengths, void* leaf_sym,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (K <= kOneBlockMaxK && n <= K) {
    const int smem = one_block_bytes(K, max_len);
    err = cudaFuncSetAttribute(pm_one_block,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    pm_one_block<<<1, kBlock, smem, st>>>((const int32_t*)freqs, n_sym, n, K,
                                          max_len, (int32_t*)lengths,
                                          (int32_t*)leaf_sym);
    return (int)cudaGetLastError();
  }
  int32_t* pos = (int32_t*)positions;
  const int tile = n_sym < kTile ? n_sym : kTile;
  leaf_tile_sort<<<n_sym / tile, kBlock, 0, st>>>(
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
        (const uint32_t*)leaf_keys, prev, next, pos + (size_t)r * K, K);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    uint32_t* t = prev; prev = next; next = t;
  }
  pm_count<<<1, kBlock, 0, st>>>(pos, K, n, max_len, (int32_t*)lengths);
  return (int)cudaGetLastError();
}
