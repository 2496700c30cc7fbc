// K4 pack_lanes: per-lane bit packing into a (lane, step) staging grid.
//
// Replaces: huffman_tpu/ops/pallas_encode.py, _pack_kernel (reached
// through _staging_grid, used by pack_streams_pallas). staging[lane, t] is
// the word completed at step t (0 if none) and staging[lane, B] the final
// left-aligned partial word (0 when the lane ends on a word boundary).
//
// Precondition (every caller meets it; not checked): 0 <= L <= 32 and
// code < 2^L at every step. Under it a lane's bit stream is the codes laid
// end to end, so the TPU kernel's serial walk has a prefix-sum form: the
// code of step t starts at bit s_t = (exclusive cumsum of L)_t, and word k
// of the lane is the OR of the one or two parts of the codes overlapping
// bits [32k, 32k + 32). Step t fires (completes word s_t >> 5) when
// (s_t & 31) + L_t >= 32. The parts use the TPU kernel's shifts, explicit
// "& 31" forms included, and a code with L = 0 deposits nothing, as there.
//
// What bounds it on an H100: memory traffic, eight bytes in and four out
// per symbol (201 MB at the 32 MiB main-path shape, 0.060 ms at 3.35
// TB/s). A walk of one lane per thread would load 4 bytes from each of 32
// rows 2 KiB apart per warp instruction, and 32,768 lanes would give under
// 8 warps an SM, too few loads in flight. So one warp packs one lane, 32
// steps at a time: its loads and its staging stores are 128 contiguous
// bytes, a warp shuffle scan gives each step its bit offset (carried from
// column to column), and shared-memory atomicOr deposits the parts into a
// 128-word window of the lane's words. Four columns of loads are issued
// before the first is used, and every lane is a warp, so many loads are in
// flight.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerBlock = 8;   // one warp per lane (row)
constexpr int kColumns = 4;        // 32-step columns loaded ahead
constexpr int kWindow = 128;       // words of a row's window: a column
                                   // touches at most 33, and the 32 it
                                   // clears stay clear of those it read

__global__ void __launch_bounds__(kRowsPerBlock * 32)
pack_lanes_kernel(const uint32_t* __restrict__ codes,
                  const int32_t* __restrict__ lens, int64_t n_lanes,
                  int n_steps, uint32_t* __restrict__ staging) {
  __shared__ uint32_t s_win[kRowsPerBlock][kWindow];
  const int wl = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row = (int64_t)blockIdx.x * kRowsPerBlock + warp;
  if (row >= n_lanes) return;  // a whole warp; the block never syncs
  uint32_t* win = s_win[warp];
#pragma unroll
  for (int i = wl; i < kWindow; i += 32) win[i] = 0;
  __syncwarp();

  const uint32_t* c_row = codes + row * n_steps;
  const int32_t* l_row = lens + row * n_steps;
  uint32_t* out = staging + row * (n_steps + 1);
  // Bits so far, mod 2^32: only the bit within a word and the word index
  // mod kWindow are read.
  uint32_t cum = 0;
  for (int t0 = 0; t0 < n_steps; t0 += 32 * kColumns) {
    uint32_t c[kColumns], L[kColumns];
#pragma unroll
    for (int m = 0; m < kColumns; ++m) {
      const int t = t0 + 32 * m + wl;
      c[m] = t < n_steps ? __ldg(c_row + t) : 0u;
      L[m] = t < n_steps ? (uint32_t)__ldg(l_row + t) : 0u;
    }
#pragma unroll
    for (int m = 0; m < kColumns; ++m) {
      const int t = t0 + 32 * m + wl;
      uint32_t incl = L[m];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t v = __shfl_up_sync(0xFFFFFFFFu, incl, d);
        if (wl >= d) incl += v;
      }
      const uint32_t s = cum + incl - L[m];
      cum += __shfl_sync(0xFFFFFFFFu, incl, 31);
      const uint32_t k = s >> 5;
      const uint32_t tot = (s & 31u) + L[m];
      if (L[m] != 0) {
        atomicOr(&win[k % kWindow], tot <= 32 ? c[m] << ((32u - tot) & 31u)
                                              : c[m] >> ((tot - 32u) & 31u));
        if (tot > 32) atomicOr(&win[(k + 1) % kWindow], c[m] << ((64u - tot) & 31u));
      }
      __syncwarp();
      // A word's last part comes from the step that completes it, so every
      // word completed in this column is whole now.
      if (t < n_steps) out[t] = tot >= 32 ? win[k % kWindow] : 0u;
      // Clear the next column's new words; the column read only words
      // below cum >> 5, which keeps the partial word.
      win[((cum >> 5) + 1 + wl) % kWindow] = 0;
      __syncwarp();
    }
  }
  if (wl == 0) out[n_steps] = (cum & 31u) ? win[(cum >> 5) % kWindow] : 0u;
}

}  // namespace

extern "C" int htpu_pack_lanes(const void* codes, const void* lens,
                               int64_t n_lanes, int n_steps, void* staging,
                               void* stream) {
  if (n_lanes > 0) {
    const int64_t blocks = (n_lanes + kRowsPerBlock - 1) / kRowsPerBlock;
    pack_lanes_kernel<<<(unsigned)blocks, kRowsPerBlock * 32, 0,
                        (cudaStream_t)stream>>>(
        (const uint32_t*)codes, (const int32_t*)lens, n_lanes, n_steps,
        (uint32_t*)staging);
  }
  return (int)cudaGetLastError();
}
