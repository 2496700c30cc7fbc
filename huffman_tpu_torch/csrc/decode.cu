// K1 decode_groups: lane-parallel canonical Huffman decode of interleaved
// HTPU v2 group streams.
//
// Replaces: huffman_tpu/ops/pallas_decode.py, _decode_kernel (reached
// through decode_groups). The protocol is the executable spec in
// huffman_tpu/container/interleave.py (decode_interleaved_numpy).
//
// One CUDA block decodes one group; thread t is block lane t of the group
// (t = s*128 + l in the JAX (8, 128) tile layout). Each step decodes one
// symbol per lane:
//   1. len  = min_len + #(peek >= lj_limit[i]), unsigned compares;
//   2. rank = base[len] + (peek >> (32 - len)), wrapping mod 2^32;
//   3. translate mode: symbol = sym_table[min(rank, n - 1)] from shared
//      memory; otherwise the rank itself (K2 translates afterwards);
//   4. shift the 64-bit buffer left by len;
//   5. lanes left with < 33 bits take one word each from the sequential
//      stream at head + (exclusive count of refilling lanes before them),
//      a block-wide scan built from __ballot_sync + __popc per warp and
//      a 32-entry shared array of warp totals;
//   6. head advances by the number of refills.
// Two steps pack into one output word (low half = even step), written at
// out[(g * n_steps/2 + step/2) * 1024 + lane]: JAX's (ngroups*B/2, 8, 128).
//
// What bounds it on an H100: the serial dependency chain of each step
// (length search, shifts, the block-wide scan with one __syncthreads),
// not memory. A group is one block, so a 32 MiB input at B = 512 gives 32
// groups and fills 32 of 132 SMs with one 1024-thread block each. The
// design keeps the whole chain in registers and shared memory, reads each
// stream word once with a plain global load (refilling lanes read
// consecutive addresses), and needs one barrier per step by double
// buffering the warp totals. The low occupancy is left for later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 1024;        // GROUP_LANES, fixed by the format
constexpr int kWarps = kLanes / 32;
constexpr int kMaxCodeLen = 32;
constexpr int kRefillThreshold = 33;
constexpr int kPreloadWords = 2;
constexpr int kMaxTranslate = 1024;  // largest alphabet decoded in-kernel

__global__ void __launch_bounds__(kLanes)
decode_groups_kernel(const uint32_t* __restrict__ streams, int64_t stream_words,
                     const int32_t* __restrict__ n_real,
                     const uint32_t* __restrict__ lj_limit,
                     const uint32_t* __restrict__ base,
                     const uint16_t* __restrict__ sym_table, int n_sym,
                     int translate, int n_steps, int min_len, int max_len,
                     uint32_t* __restrict__ out) {
  __shared__ uint32_t s_lj[kMaxCodeLen];
  __shared__ uint32_t s_base[kMaxCodeLen + 1];
  __shared__ uint16_t s_sym[kMaxTranslate];
  __shared__ int s_warp_cnt[2][kWarps];

  const int lane = threadIdx.x;
  const int warp = lane >> 5;
  const int wl = lane & 31;
  const int g = blockIdx.x;

  if (lane < kMaxCodeLen) s_lj[lane] = lj_limit[lane];
  if (lane < kMaxCodeLen + 1) s_base[lane] = base[lane];
  if (translate && lane < n_sym) s_sym[lane] = sym_table[lane];

  const uint32_t* stream = streams + (int64_t)g * stream_words;
  auto load = [&](int64_t i) -> uint32_t {
    return i < stream_words ? stream[i] : 0u;
  };
  uint32_t bufA = load(lane);
  uint32_t bufB = load(kLanes + lane);
  // Pad lanes start with a huge bit count, so they never refill.
  int bits = lane < n_real[g] ? 64 : (1 << 30);
  int64_t head = kPreloadWords * kLanes;
  const unsigned lt_mask = (1u << wl) - 1u;
  __syncthreads();

  uint32_t* out_g = out + (int64_t)g * (n_steps / 2) * kLanes + lane;
  uint32_t pair = 0;
  for (int t = 0; t < n_steps; ++t) {
    const uint32_t peek = bufA;
    int len = min_len;
    for (int i = min_len - 1; i < max_len - 1; ++i) len += peek >= s_lj[i];
    // len is in [1, 32], so the shift is in [0, 31].
    const uint32_t rank = s_base[len] + (peek >> (32 - len));
    uint32_t sym = rank;
    if (translate) sym = s_sym[rank < (uint32_t)n_sym ? rank : n_sym - 1];
    if (t & 1) {
      out_g[(int64_t)(t >> 1) * kLanes] = pair | (sym << 16);
    } else {
      pair = sym & 0xFFFFu;
    }

    // Consume len bits; a shift by 32 is undefined, so len == 32 moves B.
    if (len == 32) {
      bufA = bufB;
      bufB = 0;
    } else {
      bufA = (bufA << len) | (bufB >> (32 - len));
      bufB <<= len;
    }
    bits -= len;

    const bool need = bits < kRefillThreshold;
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, need);
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
    if (need) {
      const int k = warp_off + __popc(ballot & lt_mask);
      const uint32_t word = load(head + k);
      // bits is in [1, 32] here; the 32 case again avoids a 32-bit shift.
      if (bits < 32) {
        bufA |= word >> bits;
        bufB |= word << (32 - bits);
      } else {
        bufB |= word;
      }
      bits += 32;
    }
    head += total;
  }
}

}  // namespace

extern "C" int htpu_decode_groups(const void* streams, int64_t stream_words,
                                  const void* n_real, int ngroups,
                                  const void* lj_limit, const void* base,
                                  const void* sym_table, int n_sym,
                                  int translate, int n_steps, int min_len,
                                  int max_len, void* out, void* stream) {
  if (ngroups > 0) {
    decode_groups_kernel<<<ngroups, kLanes, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)streams, stream_words, (const int32_t*)n_real,
        (const uint32_t*)lj_limit, (const uint32_t*)base,
        (const uint16_t*)sym_table, n_sym, translate, n_steps, min_len,
        max_len, (uint32_t*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* htpu_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
