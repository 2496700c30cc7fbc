// K6 histogram: the dense 65,536-bin byte-pair histogram.
//
// Replaces: huffman_tpu/ops/pallas_hist.py, _hist_kernel (reached through
// histogram_pallas). The TPU kernel has no atomics, so it accumulates
// one-hot(hi byte)^T x one-hot(lo byte) products on the matrix unit. On
// the GPU the histogram is a count with integer atomics, which are exact
// in any order, so the kernel equals its plain version bit for bit.
//
// What bounds it on an H100: the bytes it reads (two per symbol; 33.5 MB
// at 32 MiB of input, ~10 us at 3.35 TB/s) and the shared-memory atomics,
// which serialise on the hot bins of skewed data. 65,536 int32 bins are
// 256 KiB, more than the 227 KiB a block may have, so each block counts
// HALF the bin range (blockIdx.y picks the half) in 128 KiB of dynamic
// shared memory, over its own contiguous chunk of the input, and then
// adds its non-zero bins to the global histogram with one atomicAdd each.
// The input is read twice (once per half); the counts need no carry
// handling, unlike 16-bit packed counters.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kHalfBins = 32768;
constexpr int kSmemBytes = kHalfBins * 4;

__global__ void __launch_bounds__(kThreads)
histogram_kernel(const uint16_t* __restrict__ symbols, int64_t n_valid,
                 int64_t chunk, uint32_t* __restrict__ hist) {
  extern __shared__ uint32_t bins[];
  const uint32_t half = blockIdx.y;
  for (int b = threadIdx.x; b < kHalfBins; b += kThreads) bins[b] = 0u;
  __syncthreads();

  const int64_t begin = (int64_t)blockIdx.x * chunk;
  const int64_t end = begin + chunk < n_valid ? begin + chunk : n_valid;
  for (int64_t i = begin + threadIdx.x; i < end; i += kThreads) {
    const uint32_t s = __ldg(symbols + i);
    if ((s >> 15) == half) atomicAdd(&bins[s & (kHalfBins - 1)], 1u);
  }
  __syncthreads();

  uint32_t* out = hist + half * kHalfBins;
  for (int b = threadIdx.x; b < kHalfBins; b += kThreads) {
    const uint32_t v = bins[b];
    if (v) atomicAdd(out + b, v);
  }
}

}  // namespace

// hist must hold 65,536 zeroed int32 bins; symbols past n_valid are not
// read.
extern "C" int htpu_histogram(const void* symbols, int64_t n_valid,
                              void* hist, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      histogram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  if (n_valid <= 0) return (int)cudaGetLastError();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // One block per SM over both halves: sms / 2 chunks, at least 64 Ki
  // symbols each so a small input does not pay many bin flushes.
  int64_t chunks = (n_valid + 65535) / 65536;
  const int64_t max_chunks = sms > 1 ? sms / 2 : 1;
  if (chunks > max_chunks) chunks = max_chunks;
  const int64_t chunk = (n_valid + chunks - 1) / chunks;
  const dim3 grid((unsigned)chunks, 2);
  histogram_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const uint16_t*)symbols, n_valid, chunk, (uint32_t*)hist);
  return (int)cudaGetLastError();
}
