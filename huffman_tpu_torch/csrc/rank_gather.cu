// K8 gather_rank_select and K9 gather_rank_canonical: symbol -> (code,
// length) through the fused encoder's succinct tables.
//
// K8 replaces huffman_tpu/ops/pallas_gather.py, _rank_gather_kernel
// (reached through gather_rank_select): the packed len << 26 | code of the
// present symbol s is dense[rank], rank = cums[s >> 5] + popc(mask[s >> 5]
// & below(s & 31)), clipped to the table.
//
// K9 replaces _rank_canon_kernel (through gather_rank_canonical): the
// dense table holds 16-bit canonical ranks two to a word (canon16). The
// rank stage is the same popcount, or the symbol itself at the full-
// alphabet tier (identity_rank). Then len = 1 + #{l in 2..max_len : canon
// >= start[l]} and code = canon - base[len] mod 2^32, in uint32_t.
//
// Both fold in the encoder's valid mask, as K3 does: positions at or past
// n_valid give code 0 and length 0. Both read the input bytes as u16
// symbols.
//
// What bounds them on an H100: memory traffic, two bytes in and eight out
// per symbol, with every table lookup in shared memory. The TPU needed
// select-tree lane gathers over VMEM rows; here a block loads the tables
// once into shared memory (mask and cum words 16 KiB, K8's dense table at
// most 128 KiB, K9's canon16 at most 128 KiB at the full-alphabet tier),
// then walks a grid-stride share of the symbols, one block of 1,024
// threads an SM. Shared memory rather than L2 for the tables: random
// 4-byte lookups into a 128 KiB table would otherwise depend on L1 hits.
//
// K8 walks one symbol a thread an iteration. K9 is laid out so that the
// loads and stores, not the lookups, set its time: it runs as fast as a
// copy with the same loads and stores and no lookup (PERF.md §6):
// - Bytes in flight. A thread takes kVecs = 8 vectors of 4 consecutive
//   symbols a step (8-byte loads at any 2-byte phase of the symbols
//   pointer; two or three 4-byte loads and a funnel shift when it is not
//   8-byte aligned), writes each vector's codes and lengths with one
//   16-byte evict-first store each (a warp's store covers 512 contiguous
//   bytes), and issues the next step's loads before it computes this one.
//   The last n % 4 symbols go one a thread. The outputs must be 16-byte
//   aligned (the wrapper allocates them).
// - No shared loads in the length search. Lane j of every warp holds
//   start[j + 2] (INT32_MAX past max_len) and base[j] in registers; the
//   length is a 5-step binary search over the non-decreasing boundaries by
//   __shfl_sync, and base[len] one more shuffle. A symbol costs one shared
//   load (the canon16 pair), three in the rank stage (mask and cum words).
// - The table prologue off the critical path. One thread copies canon16
//   (and mask and cums) into shared memory with cp.async.bulk behind an
//   mbarrier; every thread issues its first step's loads before it waits.
//   Tables that are not 16-byte aligned are copied by the threads.
// Every loop that shuffles runs while its warp's first element is in
// range, so the warp stays converged; lanes past the end load a clamped
// element and store nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kRankWords = 2048;
constexpr uint32_t kCodeMask = (1u << 26) - 1u;

int grid_for(int64_t n) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  return (int)(blocks < sms ? blocks : sms);
}

__device__ __forceinline__ int32_t select_rank(const uint32_t* mask,
                                               const int32_t* cums,
                                               uint32_t s) {
  const uint32_t w = s >> 5;
  const uint32_t below = (1u << (s & 31u)) - 1u;
  return cums[w] + __popc(mask[w] & below);
}

__global__ void __launch_bounds__(kThreads)
rank_select_kernel(const uint16_t* __restrict__ symbols, int64_t n,
                   int64_t n_valid, const uint32_t* __restrict__ mask,
                   const int32_t* __restrict__ cums,
                   const uint32_t* __restrict__ dense, int cap,
                   uint32_t* __restrict__ codes, int32_t* __restrict__ lens) {
  extern __shared__ uint32_t smem[];
  uint32_t* s_mask = smem;
  int32_t* s_cums = (int32_t*)(smem + kRankWords);
  uint32_t* s_dense = smem + 2 * kRankWords;
  for (int i = threadIdx.x; i < kRankWords; i += kThreads) {
    s_mask[i] = mask[i];
    s_cums[i] = cums[i];
  }
  for (int i = threadIdx.x; i < cap; i += kThreads) s_dense[i] = dense[i];
  __syncthreads();
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * kThreads) {
    uint32_t packed = 0u;
    if (i < n_valid) {
      const int32_t rank = select_rank(s_mask, s_cums, __ldg(symbols + i));
      packed = s_dense[min(max(rank, 0), cap - 1)];
    }
    codes[i] = packed & kCodeMask;
    lens[i] = (int32_t)(packed >> 26);
  }
}

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kCanonThreads = 1024;  // K9's block
constexpr int kVecs = 8;             // K9: 4-symbol vectors a thread a step
constexpr int kBulkChunk = 32768;   // bytes a cp.async.bulk copy

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Copies bytes (a multiple of 16) from 16-byte aligned global memory to
// shared memory; completion lands on the mbarrier at bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  for (uint32_t o = 0; o < bytes; o += kBulkChunk) {
    const uint32_t size = bytes - o < kBulkChunk ? bytes - o : kBulkChunk;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr((char*)dst + o)),
        "l"((uint64_t)((const char*)src + o)), "r"(size), "r"(bar)
        : "memory");
  }
}

__device__ __forceinline__ void wait_tables(uint32_t bar) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(0u) : "memory");
  }
}

// The 4 symbols at s as two words. phase = s's address mod 8, the same for
// every vector of a launch.
__device__ __forceinline__ uint2 load4(const uint16_t* s, uint32_t phase) {
  if (phase == 0) return __ldg(reinterpret_cast<const uint2*>(s));
  const uint32_t* w =
      reinterpret_cast<const uint32_t*>((uintptr_t)s & ~(uintptr_t)3);
  if ((phase & 2u) == 0) return make_uint2(__ldg(w), __ldg(w + 1));
  const uint32_t a = __ldg(w), b = __ldg(w + 1), c = __ldg(w + 2);
  return make_uint2(__funnelshift_r(a, b, 16), __funnelshift_r(b, c, 16));
}

// len << 26 | code of symbol s. bound and base_l are lane j's start[j + 2]
// (INT32_MAX past max_len) and base[j]; every lane of the warp calls it.
template <bool kIdentity>
__device__ __forceinline__ uint32_t canonical(uint32_t s,
                                              const uint32_t* s_canon,
                                              const uint32_t* s_mask,
                                              const int32_t* s_cums, int cap2,
                                              int32_t bound, uint32_t base_l) {
  const int32_t rank =
      kIdentity ? (int32_t)s : select_rank(s_mask, s_cums, s);
  const uint32_t pair = s_canon[min(max(rank >> 1, 0), cap2 - 1)];
  const int32_t canon = (int32_t)((pair >> ((uint32_t)(rank & 1) << 4)) & 0xFFFFu);
  // #{j : start[j + 2] <= canon}: the boundaries are non-decreasing and
  // lane 31's is INT32_MAX, so the count is at most 31.
  int pos = 0;
#pragma unroll
  for (int step = 16; step > 0; step >>= 1) {
    if (canon >= __shfl_sync(kFull, bound, pos + step - 1)) pos += step;
  }
  const uint32_t len = (uint32_t)pos + 1u;
  const uint32_t code = (uint32_t)canon - __shfl_sync(kFull, base_l, len);
  return (len << 26) | code;
}

template <bool kIdentity>
__global__ void __launch_bounds__(kCanonThreads)
rank_canonical_kernel(const uint16_t* __restrict__ symbols, int64_t n,
                      int64_t n_valid, const uint32_t* __restrict__ mask,
                      const int32_t* __restrict__ cums,
                      const uint32_t* __restrict__ canon16, int cap2,
                      const int32_t* __restrict__ start,
                      const uint32_t* __restrict__ base, int max_len,
                      int bulk, uint32_t* __restrict__ codes,
                      int32_t* __restrict__ lens) {
  extern __shared__ __align__(16) uint32_t k9_smem[];
  const int cap2_pad = (cap2 + 3) & ~3;
  uint32_t* s_canon = k9_smem;
  uint32_t* s_mask = k9_smem + cap2_pad;
  int32_t* s_cums = (int32_t*)(s_mask + kRankWords);
  const uint32_t bar =
      smem_addr(k9_smem + cap2_pad + (kIdentity ? 0 : 2 * kRankWords));

  // 1. The tables: one bulk copy of each behind the mbarrier (the words
  // past canon16's last 16-byte chunk by the threads), or, unaligned, by
  // the threads alone.
  const int bulk_words = bulk ? cap2 & ~3 : 0;
  if (bulk && threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = bulk_words + threadIdx.x; i < cap2; i += kCanonThreads) s_canon[i] = canon16[i];
  if (!kIdentity && !bulk) {
    for (int i = threadIdx.x; i < kRankWords; i += kCanonThreads) {
      s_mask[i] = mask[i];
      s_cums[i] = cums[i];
    }
  }
  __syncthreads();
  if (bulk && threadIdx.x == 0) {
    const uint32_t rank_bytes = kIdentity ? 0u : 2u * kRankWords * 4u;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar), "r"((uint32_t)bulk_words * 4u + rank_bytes) : "memory");
    bulk_copy(s_canon, canon16, (uint32_t)bulk_words * 4u, bar);
    if (!kIdentity) {
      bulk_copy(s_mask, mask, kRankWords * 4u, bar);
      bulk_copy(s_cums, cums, kRankWords * 4u, bar);
    }
  }

  // 2. Lane j's boundary and base, and the first step's loads, while the
  // copies run.
  const int lane = threadIdx.x & 31;
  const int32_t bound = lane + 2 <= max_len ? __ldg(start + lane + 2) : INT32_MAX;
  const uint32_t base_l = __ldg(base + lane);
  const uint32_t phase = (uint32_t)((uintptr_t)symbols & 7);
  const int64_t n_vec = n / 4;
  const int64_t stride = (int64_t)gridDim.x * kCanonThreads;
  const int64_t first = (int64_t)blockIdx.x * kCanonThreads + threadIdx.x;
  uint2 v[kVecs];
  const auto load_step = [&](uint2* out, int64_t i) {
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int64_t k = min(i + u * stride, n_vec - 1);
      out[u] = load4(symbols + 4 * k, phase);
    }
  };
  if (first - lane < n_vec) load_step(v, first);
  if (bulk) wait_tables(bar);

  // 3. The vectors, kVecs a thread a step, the next step's loads in flight.
  uint4* codes4 = reinterpret_cast<uint4*>(codes);
  int4* lens4 = reinterpret_cast<int4*>(lens);
  for (int64_t i = first; i - lane < n_vec; i += kVecs * stride) {
    uint2 next[kVecs];
    if (i - lane + kVecs * stride < n_vec) load_step(next, i + kVecs * stride);
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int64_t k = i + u * stride;
      const uint32_t w[4] = {v[u].x & 0xFFFFu, v[u].x >> 16, v[u].y & 0xFFFFu, v[u].y >> 16};
      // Symbols of this vector before n_valid: 0 to 4.
      const int valid = (int)max(min(n_valid - 4 * k, (int64_t)4), (int64_t)0);
      uint32_t packed[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        packed[e] = canonical<kIdentity>(w[e], s_canon, s_mask, s_cums, cap2, bound, base_l);
        if (e >= valid) packed[e] = 0u;
      }
      if (k < n_vec) {
        __stcs(codes4 + k, make_uint4(packed[0] & kCodeMask, packed[1] & kCodeMask,
                                      packed[2] & kCodeMask, packed[3] & kCodeMask));
        __stcs(lens4 + k, make_int4((int32_t)(packed[0] >> 26), (int32_t)(packed[1] >> 26),
                                    (int32_t)(packed[2] >> 26), (int32_t)(packed[3] >> 26)));
      }
    }
#pragma unroll
    for (int u = 0; u < kVecs; ++u) v[u] = next[u];
  }

  // 4. The tail past the last whole vector (fewer than 4 symbols), one a
  // thread.
  for (int64_t i = 4 * n_vec + first; i - lane < n; i += stride) {
    const uint32_t s = __ldg(symbols + min(i, n - 1));
    uint32_t packed = canonical<kIdentity>(s, s_canon, s_mask, s_cums, cap2, bound, base_l);
    if (i >= n_valid) packed = 0u;
    if (i < n) {
      codes[i] = packed & kCodeMask;
      lens[i] = (int32_t)(packed >> 26);
    }
  }
}

}  // namespace

// symbols (n,) u16; mask/cums (2048,); dense (cap,) u32, cap <= 32768.
extern "C" int htpu_gather_rank_select(const void* symbols, int64_t n,
                                       int64_t n_valid, const void* mask,
                                       const void* cums, const void* dense,
                                       int cap, void* codes, void* lens,
                                       void* stream) {
  const int smem = (2 * kRankWords + cap) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      rank_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    rank_select_kernel<<<grid_for(n), kThreads, smem, (cudaStream_t)stream>>>(
        (const uint16_t*)symbols, n, n_valid, (const uint32_t*)mask,
        (const int32_t*)cums, (const uint32_t*)dense, cap, (uint32_t*)codes,
        (int32_t*)lens);
  }
  return (int)cudaGetLastError();
}

// canon16 (cap2,) u32 packed-16 ranks, cap2 <= 32768; start (33,) int32,
// non-decreasing over 2..max_len (start[l] counts the codes shorter than
// l); base (33,) u32; 1 <= max_len <= 26; codes and lens 16-byte aligned
// (symbols need only be 2-byte aligned).
extern "C" int htpu_gather_rank_canonical(
    const void* symbols, int64_t n, int64_t n_valid, const void* mask,
    const void* cums, const void* canon16, int cap2, const void* start,
    const void* base, int max_len, int identity_rank, void* codes, void* lens,
    void* stream) {
  auto kernel = identity_rank ? rank_canonical_kernel<true>
                              : rank_canonical_kernel<false>;
  // The tables, then the mbarrier (8 bytes, padded to 16).
  const int smem =
      (((cap2 + 3) & ~3) + (identity_rank ? 0 : 2 * kRankWords)) * 4 + 16;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if ((uintptr_t)codes % 16 != 0 || (uintptr_t)lens % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kCanonThreads, smem);
    if (err != cudaSuccess) return (int)err;
    const int64_t per_block = (int64_t)kCanonThreads * kVecs * 4;
    const int64_t blocks = (n + per_block - 1) / per_block;
    const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
    const int bulk = ((uintptr_t)canon16 % 16 == 0) &&
                     (identity_rank || ((uintptr_t)mask % 16 == 0 &&
                                        (uintptr_t)cums % 16 == 0));
    kernel<<<(int)(blocks < resident ? blocks : resident), kCanonThreads,
             smem, (cudaStream_t)stream>>>(
        (const uint16_t*)symbols, n, n_valid, (const uint32_t*)mask,
        (const int32_t*)cums, (const uint32_t*)canon16, cap2,
        (const int32_t*)start, (const uint32_t*)base, max_len, bulk,
        (uint32_t*)codes, (int32_t*)lens);
  }
  return (int)cudaGetLastError();
}
