// K10 deposit_streams: interleaved group streams from lane-pack staging,
// by independent blocks over (group, run of steps).
//
// Replaces: huffman_tpu/ops/pallas_encode.py, _deposit_kernel (reached
// through deposit_streams_pallas, used by pack_streams_kernel_deposit).
// The identity it rests on (docs/FORMATS.md §3): with one bit cumsum
// driving encoder and decoder, the stream slot a lane consumes at its k-th
// fire holds the word the lane completes two fires later. For lane l with
// fire steps t_1 < ... < t_m, let W_k = staging[t_k] (k <= m), W_{m+1} the
// final partial word (staging[B]) and W_{m+2} = 0. Fire t_k writes
// W_{k+2} to body slot
//   n_body - sum_{s >= t_k} F_s + (fires at step t_k of lanes < l),
// F_s being the group's fires at step s; the preload words are W_1 and
// W_2. A slot outside [0, cap) is dropped (only body word counts that
// disagree with the fire bits make one), and every body slot no fire
// writes is zero.
//
// The only value that crosses steps is the slot base, and it is a suffix
// sum of fire counts, known in advance. So no block walks a whole group:
// block (q, g) takes the q-th run of mask words (32 steps each) of group
// g, with one thread a lane. It counts the lanes' fires in the later words
// (a block sum: its base), and each lane finds its first two fires there:
// they are the carries (v1 = W_{k*}, v2 = W_{k*+1}, k* the first fire past
// the run) with which the lane enters the run going backward. Then, a
// word at a time from the last: each warp counts its fires at each of the
// 32 steps (a ballot each), one warp a step turns the 32 warp counts into
// exclusive offsets and a step total, every warp takes the steps' suffix
// sums by shuffles (two barriers a word, none a step), and each warp walks
// the word's steps backward on its own: at a fire a lane stores v2 at its
// slot (base + warp offset + its rank in the warp's ballot) and rolls its
// carries (v2 <- v1, v1 <- the word it completed there). The block of the
// first run writes the preload words; the group's blocks share the
// zeroing of the slots past the body.
//
// What bounds it on an H100: the staging it reads (67 MB at 32 MiB of
// input, 20 us of the 28 us byte bound) and each block's chain of
// dependent reads: the later mask words (one batch), the words at the
// lane's first two later fires, and the block sum before the counts. Each
// warp copies its 32 lanes' 128-byte row segments of the word into a
// padded shared tile (cp.async, one row a copy instruction, where a lane
// reading its own row touches 32 rows an instruction), issued after the
// mask loads and in flight through the block sum and the counts. The walk
// reads the tile and waits on no global load (a warp's step waits on the
// latest load any of its lanes made, so loads taken in the walk cost a
// latency a step). At B = 512 a group has 16 mask words, one block each:
// 512 blocks of 1,024 threads at 32 MiB (32 groups), where one block a
// group ran on 32 SMs; the 135 KiB of tiles hold one block an SM. Each
// block re-reads the mask words after its run (kMaxRuns / 2 times the
// 2 MB of mask bits on average, from L2).
//
// Not carried over from the TPU: the MXU triangular prefix count, the
// 7-round inverse-rank search and the 9-row sliding window of
// _deposit_step. They gathered fired lanes into slot order within (8, 128)
// tiles; here each fired thread computes its own slot and stores there,
// and the stores of a warp at one step are consecutive slots.

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 1024;  // GROUP_LANES, fixed by the format
constexpr int kWarps = kLanes / 32;
constexpr int kPreloadWords = 2 * kLanes;
constexpr int kMaxRuns = 16;  // blocks a group at most
constexpr int kBatch = 16;    // mask words loaded together (all of them at B <= 512)
constexpr int kTileRow = 33;  // a lane's 32 staging words, padded: no bank conflicts
constexpr int kSmemBytes = kWarps * 32 * kTileRow * 4;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Mask word c of a lane, without bits at or past step n_steps.
__device__ __forceinline__ uint32_t fire_word(const uint32_t* mask, int c,
                                              int n_steps) {
  const uint32_t m = __ldg(mask + c);
  const int valid = n_steps - 32 * c;  // in [1, 32] for c < ceil(n_steps / 32)
  return valid >= 32 ? m : m & ((1u << valid) - 1u);
}

// The staging words of steps 32c .. 32c + 31 of the warp's 32 lanes into
// its tile (row = lane), one 128-byte row segment a copy instruction.
__device__ __forceinline__ void load_tile(uint32_t* tile, const uint32_t* staging,
                                          int64_t row0, int n_steps, int c, int wl) {
  const int t = 32 * c + wl;
  if (t < n_steps) {
#pragma unroll 8
    for (int r = 0; r < 32; ++r)
      __pipeline_memcpy_async(tile + r * kTileRow + wl, staging + (row0 + r) * (n_steps + 1) + t, 4);
  }
  __pipeline_commit();
}

__global__ void __launch_bounds__(kLanes)
deposit_streams_kernel(const uint32_t* __restrict__ staging, int n_steps,
                       const uint32_t* __restrict__ mask_bits, int mask_words,
                       const int32_t* __restrict__ body_words, int cap,
                       int words_per_run, uint32_t* __restrict__ out) {
  // [parity of the word][step in the word][warp]: the warp's fires at the
  // step, then its exclusive offset among the group's fires there (a double
  // buffer: no barrier before the next word's counts); step totals.
  __shared__ int s_off[2][32][kWarps + 1];
  __shared__ int s_total[2][32];
  __shared__ int s_later[kWarps];
  extern __shared__ uint32_t s_tiles[];  // [warp][lane][step in the word]

  const int lane = threadIdx.x;
  const int warp = lane >> 5;
  const int wl = lane & 31;
  const int q = blockIdx.x;
  const int g = blockIdx.y;
  const int w0 = q * words_per_run;
  const int w1 = min(mask_words, w0 + words_per_run);
  const int64_t row = (int64_t)g * kLanes + lane;
  const uint32_t* st = staging + row * (n_steps + 1);
  const uint32_t* mask = mask_bits + row * mask_words;
  uint32_t* out_g = out + (int64_t)g * (kPreloadWords + cap);
  uint32_t* body = out_g + kPreloadWords;
  uint32_t* tile = s_tiles + warp * 32 * kTileRow;
  const int n_body = body_words[g];

  // The slots past the body, in equal shares over the group's blocks.
  {
    const int lo = min(max(n_body, 0), cap);
    const int share = (cap - lo + gridDim.x - 1) / gridDim.x;
    const int end = min(cap, lo + (q + 1) * share);
    for (int i = lo + q * share + lane; i < end; i += kLanes) body[i] = 0u;
  }

  // 1. The fires after the run: their count, and the lane's first two.
  // The mask words are loaded kBatch at a time, independently.
  int later = 0, f1 = -1, f2 = -1;
  for (int c0 = w1; c0 < mask_words; c0 += kBatch) {
    uint32_t m[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) m[k] = c0 + k < mask_words ? fire_word(mask, c0 + k, n_steps) : 0u;
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      later += __popc(m[k]);
      if (f2 < 0 && m[k]) {
        if (f1 < 0) {
          f1 = 32 * (c0 + k) + __ffs(m[k]) - 1;
          m[k] &= m[k] - 1u;
        }
        if (m[k]) f2 = 32 * (c0 + k) + __ffs(m[k]) - 1;
      }
    }
  }
  uint32_t v1 = st[f1 >= 0 ? f1 : n_steps];
  uint32_t v2 = f2 >= 0 ? st[f2] : f1 >= 0 ? st[n_steps] : 0u;
  // The last word's staging, in flight through the block sum and the
  // counts (issued after the mask words' loads, which it would delay).
  if (w1 > w0) load_tile(tile, staging, row - wl, n_steps, w1 - 1, wl);
  later = __reduce_add_sync(kFull, later);
  if (wl == 0) s_later[warp] = later;
  __syncthreads();
  // The body slot just past the run's last fire.
  int top = n_body - __reduce_add_sync(kFull, s_later[wl]);

  // 2. The run's words, last first.
  const unsigned lt_mask = (1u << wl) - 1u;
  for (int c = w1 - 1; c >= w0; --c) {
    const int p = c & 1;
    const uint32_t mw = fire_word(mask, c, n_steps);
    int mine = 0;  // lane j: this warp's fires at step j of the word
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int cnt = __popc(__ballot_sync(kFull, (mw >> j) & 1u));
      if (wl == j) mine = cnt;
    }
    s_off[p][wl][warp] = mine;
    __syncthreads();
    {  // warp w: step w of the word, its 32 warp counts in lane order
      const int x = s_off[p][warp][wl];
      int incl = x;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, d);
        if (wl >= d) incl += v;
      }
      s_off[p][warp][wl] = incl - x;
      if (wl == 31) s_total[p][warp] = incl;
    }
    __syncthreads();
    // Lane j: the fires at steps j .. 31 of the word; step j's slots start
    // at top minus that.
    int suffix = s_total[p][wl];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_down_sync(kFull, suffix, d);
      if (wl + d < 32) suffix += v;
    }
    const int base = top - suffix;
    __pipeline_wait_prior(0);
    __syncwarp();  // the warp's tile has landed
    const uint32_t* words = tile + wl * kTileRow;
    // The steps in order, last first, with no barrier: the warp's stores
    // at a step are consecutive slots.
#pragma unroll 4
    for (int j = 31; j >= 0; --j) {
      const bool fired = (mw >> j) & 1u;
      const unsigned ballot = __ballot_sync(kFull, fired);
      const int step_base = __shfl_sync(kFull, base, j);
      if (fired) {
        const int slot = step_base + s_off[p][j][warp] + __popc(ballot & lt_mask);
        if (slot >= 0 && slot < cap) body[slot] = v2;
        v2 = v1;
        v1 = words[j];
      }
    }
    top -= __shfl_sync(kFull, suffix, 0);
    __syncwarp();  // the tile is refilled with the next word
    if (c > w0) load_tile(tile, staging, row - wl, n_steps, c - 1, wl);
  }

  if (q == 0) {
    out_g[lane] = v1;
    out_g[kLanes + lane] = v2;
    // Slots below the group's first fire: only a body word count larger
    // than the fires leaves any.
    for (int i = lane; i < min(top, cap); i += kLanes) body[i] = 0u;
  }
}

}  // namespace

// staging (ngroups * 1024, n_steps + 1) u32; mask_bits (ngroups * 1024,
// mask_words) u32, mask_words = ceil(n_steps / 32), bit t & 31 of word
// t >> 5 = the lane fired at step t; body_words (ngroups,) int32; out
// (ngroups, 2048 + cap) u32.
extern "C" int htpu_deposit_streams(const void* staging, int n_steps,
                                    const void* mask_bits, int mask_words,
                                    const void* body_words, int ngroups,
                                    int cap, void* out, void* stream) {
  // Once a process: the tiles' dynamic shared memory.
  static const cudaError_t setup = cudaFuncSetAttribute(
      deposit_streams_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (setup != cudaSuccess) return (int)setup;
  if (ngroups > 0) {
    const int per_run = mask_words > kMaxRuns ? (mask_words + kMaxRuns - 1) / kMaxRuns : 1;
    const int runs = mask_words > 0 ? (mask_words + per_run - 1) / per_run : 1;
    const dim3 grid((unsigned)runs, (unsigned)ngroups);
    deposit_streams_kernel<<<grid, kLanes, kSmemBytes, (cudaStream_t)stream>>>(
        (const uint32_t*)staging, n_steps, (const uint32_t*)mask_bits,
        mask_words, (const int32_t*)body_words, cap, per_run, (uint32_t*)out);
  }
  return (int)cudaGetLastError();
}
