// K2 gather_u16_pairs, K3 gather_codes and K5 gather_u16: dense table
// lookups.
//
// K2 replaces huffman_tpu/ops/pallas_gather.py, _u16_pair_gather_kernel
// (reached through gather_u16_pairs_pallas): both 16-bit halves of each
// packed rank word from the decoder's rank mode look up the canonical
// symbol table sym_order, giving packed symbol pairs. An index past the
// table reads its last entry (the clip of the JAX reference path).
//
// K3 replaces huffman_tpu/ops/pallas_gather.py, _gather_kernel (through
// gather_table_pallas, row-displacement table) and _u16_gather_kernel in
// its gather_packed32_dense role: both compute symbol -> len<<26 | code
// and differ only in how the TPU had to lay out the table. Here the table
// is the dense 65,536-entry u32 table. It also applies the valid mask of
// the container encoder: positions at or past n_valid give code 0, len 0.
//
// K5 replaces _u16_gather_kernel (through gather_u16_pallas) in its
// decode role: the unpacked rank-mode output of decode_groups
// (packed_out=False), one rank per int32, looks up the canonical symbol
// table: out[i] = table[clamp(idx[i], 0, n - 1)], zero-extended. The TPU
// packed the table two entries to a word and walked a lane-gather tree;
// here the whole u16 table (at most 128 KiB) sits in dynamic shared
// memory, as K9's canon16 does, and the indices stream through in 16-byte
// loads (four per thread) when both pointers allow it.
//
// What bounds them on an H100: memory traffic. K2 reads and writes one
// word per two symbols; K3 reads two bytes and writes eight per symbol.
// The tables (128 KiB and 256 KiB) stay in the 50 MB L2, so the random
// lookups cost L2 hits, not device memory. The design is one thread per
// word with a grid-stride loop and read-only loads; nothing is staged in
// shared memory yet.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

int grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  return (int)(blocks < 132 * 32 ? blocks : 132 * 32);
}

__global__ void gather_u16_pairs_kernel(const uint32_t* __restrict__ idx,
                                        int64_t n,
                                        const uint16_t* __restrict__ table,
                                        int n_table,
                                        uint32_t* __restrict__ out) {
  const uint32_t last = (uint32_t)(n_table - 1);
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const uint32_t u = __ldg(idx + i);
    const uint32_t lo = min(u & 0xFFFFu, last);
    const uint32_t hi = min(u >> 16, last);
    out[i] = (uint32_t)__ldg(table + lo) | ((uint32_t)__ldg(table + hi) << 16);
  }
}

__global__ void gather_codes_kernel(const uint16_t* __restrict__ symbols,
                                    int64_t n, int64_t n_valid,
                                    const uint32_t* __restrict__ table,
                                    uint32_t* __restrict__ codes,
                                    int32_t* __restrict__ lens) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    uint32_t packed = 0;
    if (i < n_valid) packed = __ldg(table + __ldg(symbols + i));
    codes[i] = packed & ((1u << 26) - 1u);
    lens[i] = (int32_t)(packed >> 26);
  }
}

__global__ void __launch_bounds__(1024)
gather_u16_kernel(const int32_t* __restrict__ idx, int64_t n,
                  const uint16_t* __restrict__ table, int n_table,
                  int vectorized, int32_t* __restrict__ out) {
  extern __shared__ uint16_t s_table[];
  for (int i = threadIdx.x; i < n_table; i += blockDim.x) s_table[i] = table[i];
  __syncthreads();
  const int last = n_table - 1;
  auto look = [&](int32_t v) -> int32_t {
    return (int32_t)s_table[min(max(v, 0), last)];
  };
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t n4 = vectorized ? n / 4 : 0;
  const int4* idx4 = reinterpret_cast<const int4*>(idx);
  int4* out4 = reinterpret_cast<int4*>(out);
  for (int64_t i = first; i < n4; i += stride) {
    const int4 v = __ldg(idx4 + i);
    out4[i] = make_int4(look(v.x), look(v.y), look(v.z), look(v.w));
  }
  for (int64_t i = 4 * n4 + first; i < n; i += stride) out[i] = look(__ldg(idx + i));
}

}  // namespace

extern "C" int htpu_gather_u16_pairs(const void* idx, int64_t n,
                                     const void* table, int n_table, void* out,
                                     void* stream) {
  if (n > 0) {
    gather_u16_pairs_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)idx, n, (const uint16_t*)table, n_table,
        (uint32_t*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" int htpu_gather_codes(const void* symbols, int64_t n,
                                 int64_t n_valid, const void* table,
                                 void* codes, void* lens, void* stream) {
  if (n > 0) {
    gather_codes_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint16_t*)symbols, n, n_valid, (const uint32_t*)table,
        (uint32_t*)codes, (int32_t*)lens);
  }
  return (int)cudaGetLastError();
}

// idx (n,) int32; table (n_table,) u16, 1 <= n_table <= 65536; out (n,) int32.
extern "C" int htpu_gather_u16(const void* idx, int64_t n, const void* table,
                               int n_table, void* out, void* stream) {
  const int smem = n_table * 2;
  cudaError_t err = cudaFuncSetAttribute(
      gather_u16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int64_t blocks = (n + 4 * 1024 - 1) / (4 * 1024);
    const int vectorized =
        ((uintptr_t)idx % 16 == 0) && ((uintptr_t)out % 16 == 0);
    gather_u16_kernel<<<(int)(blocks < sms ? blocks : sms), 1024, smem,
                        (cudaStream_t)stream>>>(
        (const int32_t*)idx, n, (const uint16_t*)table, n_table, vectorized,
        (int32_t*)out);
  }
  return (int)cudaGetLastError();
}
