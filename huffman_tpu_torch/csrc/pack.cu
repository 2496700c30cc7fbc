// K4 pack_lanes: per-lane bit packing into a (lane, step) staging grid.
//
// Replaces: huffman_tpu/ops/pallas_encode.py, _pack_kernel (reached
// through _staging_grid, used by pack_streams_pallas). One thread walks
// one block lane's B steps, keeping a partial 32-bit word (top f bits
// valid). Codes are at most 32 bits, so at most one word completes per
// step: staging[lane, t] is the word completed at step t (0 if none) and
// staging[lane, B] the final left-aligned partial word. The arithmetic is
// that of the TPU kernel, including its explicit "& 31" forms: a shift by
// 32 is undefined in C++ as in XLA.
//
// What bounds it on an H100: memory traffic (eight bytes in, four out per
// symbol). Codes and lengths are lane-major, as the symbol gather writes
// them, so a warp's loads at one step touch 32 rows; successive steps
// reuse the same cache lines through L1 and L2. Lanes share nothing, so
// blocks are small (128 threads) and many, unlike the decoder.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void pack_lanes_kernel(const uint32_t* __restrict__ codes,
                                  const int32_t* __restrict__ lens,
                                  int64_t n_lanes, int n_steps,
                                  uint32_t* __restrict__ staging) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  const uint32_t* c_row = codes + lane * n_steps;
  const int32_t* l_row = lens + lane * n_steps;
  uint32_t* out = staging + lane * (n_steps + 1);
  uint32_t buf = 0;
  int f = 0;
  for (int t = 0; t < n_steps; ++t) {
    const uint32_t c = __ldg(c_row + t);
    const int L = __ldg(l_row + t);
    const int total = f + L;
    const uint32_t tot = (uint32_t)total;
    uint32_t add = total <= 32 ? c << ((32u - tot) & 31u)
                               : c >> ((tot - 32u) & 31u);
    if (L == 0) add = 0;
    const uint32_t word = buf | add;
    const bool emit = total >= 32;
    out[t] = emit ? word : 0u;
    const uint32_t spill = total > 32 ? c << ((64u - tot) & 31u) : 0u;
    buf = emit ? spill : word;
    f = total & 31;
  }
  out[n_steps] = buf;
}

}  // namespace

extern "C" int htpu_pack_lanes(const void* codes, const void* lens,
                               int64_t n_lanes, int n_steps, void* staging,
                               void* stream) {
  if (n_lanes > 0) {
    const int blocks = (int)((n_lanes + kThreads - 1) / kThreads);
    pack_lanes_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)codes, (const int32_t*)lens, n_lanes, n_steps,
        (uint32_t*)staging);
  }
  return (int)cudaGetLastError();
}
