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
// 256 KiB, more than the 227 KiB a block may have, so a thread-block
// cluster of kCtas = 2 blocks holds them: block rank r counts bins
// [r * kCtaBins, (r + 1) * kCtaBins) in dynamic shared memory. Both blocks
// of a cluster read the cluster's share of the input, each counting only
// the symbols of its own bins; the two run side by side, so the second
// read of a 16-byte vector mostly hits L2. Each thread issues kUnroll 16-byte
// loads (8 symbols each) before their atomics. The blocks then add their
// non-zero bins to the global histogram with one atomic each. What sets
// the time is the shared atomics and the test of every symbol a block
// reads: the loads alone take under half of it (PERF.md, PR 8).
//
// Measured and not kept (an A/B on the H100, PERF.md §6): each block
// reads its share once and adds a symbol of its peer's bins in the
// peer's shared memory through distributed shared memory
// (`red.shared::cluster.add`). Those remote adds made it 5x slower than
// reading twice.
//
// The grid is as many clusters as the card holds at once (at least 64 Ki
// symbols a block, so a small input does not pay many bin flushes),
// striding over the input's 16-byte vectors. The input need not be
// 16-byte aligned: the symbols before the first aligned vector and after
// the last whole one (7 at most each) are counted one by one.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;
constexpr int kBins = 65536;
constexpr int kCtas = 2;  // blocks of a cluster, sharing the bins
constexpr int kCtaBins = kBins / kCtas;
constexpr int kOwnerShift = kCtas == 2 ? 15 : kCtas == 4 ? 14 : 13;
constexpr int kSmemBytes = kCtaBins * 4;
constexpr int kUnroll = 4;  // 16-byte loads in flight a thread
static_assert(kCtaBins == 1 << kOwnerShift, "kCtas must be 2, 4 or 8");

// Counts symbol s if its bin is this block's.
__device__ __forceinline__ void count(uint32_t s, uint32_t rank, uint32_t* bins) {
  const uint32_t owner = s >> kOwnerShift;
  if (owner == rank) atomicAdd(bins + (s & (kCtaBins - 1)), 1u);
}

__device__ __forceinline__ void count8(uint4 v, uint32_t rank, uint32_t* bins) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    count(w[k] & 0xFFFFu, rank, bins);
    count(w[k] >> 16, rank, bins);
  }
}

__global__ void __cluster_dims__(kCtas, 1, 1) __launch_bounds__(kThreads)
histogram_kernel(const uint16_t* __restrict__ symbols, int64_t n_valid,
                 int64_t lead, uint32_t* __restrict__ hist) {
  extern __shared__ uint32_t bins[];
  const uint32_t rank = cg::this_cluster().block_rank();
  for (int b = threadIdx.x; b < kCtaBins; b += kThreads) bins[b] = 0u;
  __syncthreads();  // bins zero before any add

  // Symbols [lead, lead + 8 * n_vec) as 16-byte vectors; both blocks of a
  // cluster take the cluster's vectors.
  const uint4* vec = reinterpret_cast<const uint4*>(symbols + lead);
  const int64_t n_vec = (n_valid - lead) / 8;
  const int64_t reader = blockIdx.x / kCtas;
  const int64_t stride = gridDim.x / kCtas * (int64_t)kThreads;
  int64_t i = reader * kThreads + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < n_vec; i += kUnroll * stride) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(vec + i + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) count8(v[u], rank, bins);
  }
  for (; i < n_vec; i += stride) count8(__ldg(vec + i), rank, bins);
  // The unaligned head and the tail, by the first reader.
  if (reader == 0 && threadIdx.x < 16) {
    const int64_t k = threadIdx.x < 8 ? threadIdx.x : lead + 8 * n_vec + threadIdx.x - 8;
    if (threadIdx.x < 8 ? k < lead : k < n_valid) count(symbols[k], rank, bins);
  }
  __syncthreads();  // every add landed

  uint32_t* out = hist + rank * kCtaBins;
  for (int b = threadIdx.x; b < kCtaBins; b += kThreads) {
    const uint32_t v = bins[b];
    if (v) atomicAdd(out + b, v);
  }
}

struct Setup {
  cudaError_t err;
  int clusters;  // clusters the card holds at once
};

// Once a process: the shared-memory attribute and the cluster occupancy.
const Setup& setup() {
  static const Setup s = [] {
    Setup r{cudaFuncSetAttribute(histogram_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemBytes),
            0};
    if (r.err != cudaSuccess) return r;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kCtas);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = kSmemBytes;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = kCtas;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    r.err = cudaOccupancyMaxActiveClusters(&r.clusters, histogram_kernel, &cfg);
    if (r.err == cudaSuccess && r.clusters < 1) r.err = cudaErrorInvalidConfiguration;
    return r;
  }();
  return s;
}

}  // namespace

// hist must hold 65,536 zeroed int32 bins; symbols (2-byte aligned) past
// n_valid are not read.
extern "C" int htpu_histogram(const void* symbols, int64_t n_valid,
                              void* hist, void* stream) {
  const Setup& s = setup();
  if (s.err != cudaSuccess) return (int)s.err;
  if (n_valid <= 0) return (int)cudaGetLastError();
  // Symbols before the first 16-byte boundary.
  const int64_t to_boundary = ((16 - ((uintptr_t)symbols & 15)) & 15) / 2;
  const int64_t lead = to_boundary < n_valid ? to_boundary : n_valid;
  int64_t clusters = (n_valid + kCtas * 65536 - 1) / (kCtas * 65536);
  if (clusters > s.clusters) clusters = s.clusters;
  histogram_kernel<<<(unsigned)(clusters * kCtas), kThreads, kSmemBytes,
                     (cudaStream_t)stream>>>(
      (const uint16_t*)symbols, n_valid, lead, (uint32_t*)hist);
  return (int)cudaGetLastError();
}
