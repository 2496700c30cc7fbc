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
// then walks a grid-stride share of the symbols. Shared memory rather
// than L2 for canon16: random 4-byte lookups into a 128 KiB table would
// otherwise depend on L1 hit rates; with one block of 1,024 threads per
// SM the one-time table load (~17 MB from L2 over the grid) is small
// beside the 16.7M lookups of a 32 MiB input.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kRankWords = 2048;
constexpr int kTableLens = 33;  // start[] and base[]: MAX_CODE_LEN + 1
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

__global__ void __launch_bounds__(kThreads)
rank_canonical_kernel(const uint16_t* __restrict__ symbols, int64_t n,
                      int64_t n_valid, const uint32_t* __restrict__ mask,
                      const int32_t* __restrict__ cums,
                      const uint32_t* __restrict__ canon16, int cap2,
                      const int32_t* __restrict__ start,
                      const uint32_t* __restrict__ base, int max_len,
                      int identity_rank, uint32_t* __restrict__ codes,
                      int32_t* __restrict__ lens) {
  extern __shared__ uint32_t smem[];
  uint32_t* s_mask = smem;
  int32_t* s_cums = (int32_t*)(smem + kRankWords);
  int32_t* s_start = (int32_t*)(smem + 2 * kRankWords);
  uint32_t* s_base = smem + 2 * kRankWords + kTableLens;
  uint32_t* s_canon = smem + 2 * kRankWords + 2 * kTableLens;
  if (!identity_rank) {
    for (int i = threadIdx.x; i < kRankWords; i += kThreads) {
      s_mask[i] = mask[i];
      s_cums[i] = cums[i];
    }
  }
  for (int i = threadIdx.x; i < kTableLens; i += kThreads) {
    s_start[i] = start[i];
    s_base[i] = base[i];
  }
  for (int i = threadIdx.x; i < cap2; i += kThreads) s_canon[i] = canon16[i];
  __syncthreads();
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * kThreads) {
    uint32_t packed = 0u;
    if (i < n_valid) {
      const uint32_t s = __ldg(symbols + i);
      const int32_t rank =
          identity_rank ? (int32_t)s : select_rank(s_mask, s_cums, s);
      const uint32_t pair = s_canon[min(max(rank >> 1, 0), cap2 - 1)];
      const uint32_t canon = (pair >> ((uint32_t)(rank & 1) << 4)) & 0xFFFFu;
      int len = 1;
      for (int l = 2; l <= max_len; ++l) len += (int32_t)canon >= s_start[l];
      const uint32_t code = canon - s_base[len];
      packed = ((uint32_t)len << 26) | code;
    }
    codes[i] = packed & kCodeMask;
    lens[i] = (int32_t)(packed >> 26);
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

// canon16 (cap2,) u32 packed-16 ranks, cap2 <= 32768; start (33,) int32;
// base (33,) u32; 1 <= max_len <= 26.
extern "C" int htpu_gather_rank_canonical(
    const void* symbols, int64_t n, int64_t n_valid, const void* mask,
    const void* cums, const void* canon16, int cap2, const void* start,
    const void* base, int max_len, int identity_rank, void* codes, void* lens,
    void* stream) {
  const int smem = (2 * kRankWords + 2 * kTableLens + cap2) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      rank_canonical_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    rank_canonical_kernel<<<grid_for(n), kThreads, smem,
                            (cudaStream_t)stream>>>(
        (const uint16_t*)symbols, n, n_valid, (const uint32_t*)mask,
        (const int32_t*)cums, (const uint32_t*)canon16, cap2,
        (const int32_t*)start, (const uint32_t*)base, max_len, identity_rank,
        (uint32_t*)codes, (int32_t*)lens);
  }
  return (int)cudaGetLastError();
}
