// K10 deposit_streams: interleaved group streams from lane-pack staging, by
// a backward walk.
//
// Replaces: huffman_tpu/ops/pallas_encode.py, _deposit_kernel (reached
// through deposit_streams_pallas, used by pack_streams_kernel_deposit).
// The identity it rests on (docs/FORMATS.md §3): with one bit cumsum
// driving encoder and decoder, the stream slot a lane consumes at its k-th
// fire holds the word the lane completes two fires later. Walking the
// steps backward, that word is the older of the lane's two most recent
// completions: a two-deep carry (v1 newer, v2 older). The lane's final
// partial word stands in for the word completed after its last fire, so it
// seeds v1; the carries left after step 0 are the preload words 0 and 1.
//
// One block of 1,024 threads per group, thread l being block lane l of the
// group (lane g * 1024 + l of the staging). head starts at the group's
// body word count. At each step t = B-1 .. 0 the fired lanes are ranked in
// lane order (__ballot_sync + __popc per warp and a double-buffered array
// of warp totals in shared memory: K1's refill scan, one __syncthreads a
// step), head drops by the step's fire total, and fired lane l writes v2
// to body slot head + rank, then rolls its carries (v2 <- v1, v1 <- the
// word it completed at t). Slots past the body are zeroed by the block, so
// every output word is written once.
//
// Not carried over from the TPU: the MXU triangular prefix count, the
// 7-round inverse-rank search and the 9-row sliding window of
// _deposit_step. They gathered fired lanes into slot order within (8, 128)
// tiles; here each fired thread computes its own slot and stores there.
//
// What bounds it on an H100: the B dependent steps (a block-wide scan and
// a barrier each), not memory; the staging is read once, lane-major, so a
// thread walks its own row backward and successive steps hit the same
// cache lines. A 32 MiB input at B = 512 gives 32 groups, one block each,
// on 32 of 132 SMs, as K1.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 1024;  // GROUP_LANES, fixed by the format
constexpr int kWarps = kLanes / 32;
constexpr int kPreloadWords = 2 * kLanes;

__global__ void __launch_bounds__(kLanes)
deposit_streams_kernel(const uint32_t* __restrict__ staging, int n_steps,
                       const uint32_t* __restrict__ mask_bits, int mask_words,
                       const int32_t* __restrict__ body_words, int cap,
                       uint32_t* __restrict__ out) {
  __shared__ int s_warp_cnt[2][kWarps];

  const int lane = threadIdx.x;
  const int warp = lane >> 5;
  const int wl = lane & 31;
  const int g = blockIdx.x;
  const int64_t row = (int64_t)g * kLanes + lane;
  const uint32_t* st = staging + row * (n_steps + 1);
  const uint32_t* mask = mask_bits + row * mask_words;
  uint32_t* out_g = out + (int64_t)g * (kPreloadWords + cap);
  uint32_t* body = out_g + kPreloadWords;

  const int n_body = body_words[g];
  for (int i = max(n_body, 0) + lane; i < cap; i += kLanes) body[i] = 0u;

  uint32_t v1 = st[n_steps];  // the final partial word
  uint32_t v2 = 0u;
  int head = n_body;
  const unsigned lt_mask = (1u << wl) - 1u;
  uint32_t mw = 0u;
  for (int t = n_steps - 1; t >= 0; --t) {
    if (t == n_steps - 1 || (t & 31) == 31) mw = mask[t >> 5];
    const bool fired = (mw >> (t & 31)) & 1u;
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, fired);
    int* cnt = s_warp_cnt[t & 1];
    if (wl == 0) cnt[warp] = __popc(ballot);
    __syncthreads();
    // Every warp scans the 32 warp totals: lane i holds warp i's count.
    const int c = cnt[wl];
    int incl = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (wl >= d) incl += v;
    }
    const int warp_off = __shfl_sync(0xFFFFFFFFu, incl - c, warp);
    const int total = __shfl_sync(0xFFFFFFFFu, incl, 31);
    head -= total;
    if (fired) {
      const int slot = head + warp_off + __popc(ballot & lt_mask);
      // Only body word counts that disagree with the fire bits can put a
      // slot outside the body; such writes are dropped.
      if (slot >= 0 && slot < cap) body[slot] = v2;
      v2 = v1;
      v1 = st[t];
    }
  }
  out_g[lane] = v1;
  out_g[kLanes + lane] = v2;
}

}  // namespace

// staging (ngroups * 1024, n_steps + 1) u32; mask_bits (ngroups * 1024,
// mask_words) u32, bit t & 31 of word t >> 5 = the lane fired at step t;
// body_words (ngroups,) int32; out (ngroups, 2048 + cap) u32.
extern "C" int htpu_deposit_streams(const void* staging, int n_steps,
                                    const void* mask_bits, int mask_words,
                                    const void* body_words, int ngroups,
                                    int cap, void* out, void* stream) {
  if (ngroups > 0) {
    deposit_streams_kernel<<<ngroups, kLanes, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)staging, n_steps, (const uint32_t*)mask_bits,
        mask_words, (const int32_t*)body_words, cap, (uint32_t*)out);
  }
  return (int)cudaGetLastError();
}
