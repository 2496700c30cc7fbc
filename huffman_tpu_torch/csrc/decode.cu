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
//   1. len  = min_len + #(peek >= lj_limit[i]) over min_len-1 <= i <
//      max_len-1, unsigned compares;
//   2. rank = base[len] + (peek >> (32 - len)), wrapping mod 2^32;
//   3. translate mode: symbol = sym_table[min(rank, n - 1)] from shared
//      memory; otherwise the rank itself (K2 translates afterwards). The
//      table lies in the dynamic shared memory after the ring, sized at
//      launch from n (2n bytes, up to kMaxTranslate symbols: all 65,536
//      u16 symbols take 128 KiB beside the ring's 64 KiB), so a small
//      alphabet keeps the ring's footprint. The lookup is one shared load
//      a lane and step; random ranks cost bank conflicts, which the route
//      A/B in PERF.md §6 weighs against K2's pass over the output;
//   4. shift the 64-bit buffer left by len;
//   5. lanes left with < 33 bits take one word each from the sequential
//      stream at head + (exclusive count of refilling lanes before them);
//   6. head advances by the number of refills.
// Stream words at index >= stream_words read as 0. Two steps pack into one
// output word (low half = even step), written at
// out[(g * n_steps/2 + step/2) * 1024 + lane]: JAX's (ngroups*B/2, 8, 128).
//
// What bounds it on an H100: the serial chain of each step, which all 32
// warps of the block run between one barrier and the next, so the step
// costs the block's instructions over the SM's four schedulers plus the
// chain's latency. Memory is not the bound (a group's stream is read once).
// Three things would lengthen the step, and the design answers each:
//   - the refill word's address is known only after the scan, and the next
//     step needs its value: read from device memory it would be a cold load
//     on every step. So the stream passes through a 16K-word ring in shared
//     memory, filled ahead of head with 4-byte cp.async copies: after each
//     step's barrier the block issues the next 1024 words if the ring has
//     room (words below head are free), and a step waits only for copies
//     issued kAhead steps before. head grows by at most 1024 words a step, so
//     the ring holds every word a step reads (kRingWords >= 1024 *
//     (kAhead + 2)). Any stream width and alignment works: each word is
//     its own copy, zero-filled past stream_words;
//   - a compare loop over the boundaries with runtime bounds does not
//     unroll. So the block sorts the boundaries once and tabulates, for each
//     12-bit prefix of peek, the count at the prefix's first value and
//     whether a boundary falls inside the prefix. The count is monotone in
//     peek, so an unsplit prefix gives the length with one shared load; a
//     split one (only codes longer than 12 bits) walks the sorted
//     boundaries from there. The result is the compare count exactly, for
//     any boundary order;
//   - a shuffle scan of the warp totals takes five dependent rounds. So two
//     warp reductions (redux.sync) give a warp its offset and the total;
//     one __syncthreads a step remains, with the warp totals double
//     buffered.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 1024;        // GROUP_LANES, fixed by the format
constexpr int kWarps = kLanes / 32;
constexpr int kMaxCodeLen = 32;
constexpr int kRefillThreshold = 33;
constexpr int kPreloadWords = 2;
constexpr int kMaxTranslate = 65536;  // largest alphabet decoded in-kernel
constexpr int kRingWords = 16384;    // 64 KiB of dynamic shared memory
constexpr int kAhead = 8;            // steps a ring copy has to land
constexpr int kPrefixBits = 12;
constexpr int kPrefixShift = 32 - kPrefixBits;
constexpr uint8_t kSplit = 0x80;     // a boundary lies inside the prefix
static_assert(kRingWords % kLanes == 0 && kRingWords >= kLanes * (kAhead + 2),
              "the ring must hold kAhead steps of copies beyond head");

__device__ __forceinline__ void copy_word(uint32_t* dst, const uint32_t* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The n-symbol table into shared memory: 16-byte copies in the ring's
// first copy group where the source is 16-byte aligned, plain loads for
// the rest (or all of it).
__device__ __forceinline__ void copy_table(uint16_t* dst,
                                           const uint16_t* __restrict__ src,
                                           int n, int lane) {
  int done = 0;
  if (((uintptr_t)src & 15) == 0) {
    done = n & ~7;
    for (int i = 8 * lane; i < done; i += 8 * kLanes) {
      const unsigned d = (unsigned)__cvta_generic_to_shared(dst + i);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                   "l"(src + i)
                   : "memory");
    }
  }
#pragma unroll 4
  for (int i = done + lane; i < n; i += kLanes) dst[i] = src[i];
}

template <bool kTranslate>
__global__ void __launch_bounds__(kLanes)
decode_groups_kernel(const uint32_t* __restrict__ streams, int64_t stream_words,
                     const int32_t* __restrict__ n_real,
                     const uint32_t* __restrict__ lj_limit,
                     const uint32_t* __restrict__ base,
                     const uint16_t* __restrict__ sym_table, int n_sym,
                     int n_steps, int min_len, int max_len,
                     uint32_t* __restrict__ out) {
  // Dynamic: the ring (kRingWords: word w at w % kRingWords), then in
  // translate mode the n_sym-symbol table.
  extern __shared__ __align__(16) uint32_t ring[];
  uint16_t* const s_sym = reinterpret_cast<uint16_t*>(ring + kRingWords);
  __shared__ uint32_t s_bound[kMaxCodeLen];  // the boundaries, ascending
  __shared__ uint32_t s_base[kMaxCodeLen + 1];
  __shared__ uint8_t s_prefix[1 << kPrefixBits];
  __shared__ int s_warp_cnt[2][kWarps];

  const int lane = threadIdx.x;
  const int warp = lane >> 5;
  const int wl = lane & 31;
  const int g = blockIdx.x;
  const uint32_t* stream = streams + (int64_t)g * stream_words;

  auto copy = [&](int64_t w) {
    const bool valid = w < stream_words;
    copy_word(&ring[(uint32_t)w % kRingWords], stream + (valid ? w : 0), valid);
  };
  for (int i = lane; i < kRingWords; i += kLanes) copy(i);
  if (kTranslate) copy_table(s_sym, sym_table, n_sym, lane);
  commit_copies();

  const int n_bound = max_len - min_len;  // 0..31
  if (lane < kMaxCodeLen + 1) s_base[lane] = base[lane];
  if (lane < n_bound) {  // rank sort of lj_limit[min_len-1 .. max_len-2]
    const uint32_t v = lj_limit[min_len - 1 + lane];
    int r = 0;
    for (int j = 0; j < n_bound; ++j) {
      const uint32_t u = lj_limit[min_len - 1 + j];
      r += u < v || (u == v && j < lane);
    }
    s_bound[r] = v;
  }
  __syncthreads();
  for (int p = lane; p < (1 << kPrefixBits); p += kLanes) {
    const uint32_t lo = (uint32_t)p << kPrefixShift;
    const uint32_t hi = lo | ((1u << kPrefixShift) - 1u);
    int c_lo = 0, c_hi = 0;
    for (int j = 0; j < n_bound; ++j) {
      c_lo += s_bound[j] <= lo;
      c_hi += s_bound[j] <= hi;
    }
    s_prefix[p] = (uint8_t)(c_lo | (c_hi != c_lo ? kSplit : 0));
  }
  wait_copies<0>();
  __syncthreads();

  uint64_t buf = (uint64_t)ring[lane] << 32 | ring[kLanes + lane];
  // Pad lanes start with a huge bit count, so they never refill.
  int bits = lane < n_real[g] ? 64 : (1 << 30);
  int64_t head = kPreloadWords * kLanes;  // next stream word to hand out
  int64_t filled = kRingWords;            // words copied to the ring so far
  const unsigned lt_mask = (1u << wl) - 1u;

  auto step = [&](int parity) -> uint32_t {
    const uint32_t peek = (uint32_t)(buf >> 32);
    const uint32_t e = s_prefix[peek >> kPrefixShift];
    int c = e & (kSplit - 1);
    if (e & kSplit) {
      while (c < n_bound && s_bound[c] <= peek) ++c;
    }
    const int len = min_len + c;  // in [1, 32]: the shift is in [0, 31]
    const uint32_t rank = s_base[len] + (peek >> (32 - len));
    uint32_t sym = rank;
    if (kTranslate) sym = s_sym[rank < (uint32_t)n_sym ? rank : n_sym - 1];
    buf <<= len;
    bits -= len;

    const bool need = bits < kRefillThreshold;
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, need);
    int* cnt = s_warp_cnt[parity];
    if (wl == 0) cnt[warp] = __popc(ballot);
    wait_copies<kAhead - 1>();
    __syncthreads();
    const int c_warp = cnt[wl];
    const int total = __reduce_add_sync(0xFFFFFFFFu, c_warp);
    const int warp_off = __reduce_add_sync(0xFFFFFFFFu, wl < warp ? c_warp : 0);
    if (need) {
      // bits is in [1, 32] here, so the shift is in [0, 31].
      const int64_t w = head + warp_off + __popc(ballot & lt_mask);
      buf |= (uint64_t)ring[(uint32_t)w % kRingWords] << (32 - bits);
      bits += 32;
    }
    // Words below head are consumed by every lane that passed the barrier:
    // their slots take the next chunk. The block reads [head, head+total)
    // now, all of it copied at least kAhead steps ago.
    if (filled + kLanes <= head + kRingWords) {
      copy(filled + lane);
      filled += kLanes;
    }
    commit_copies();
    head += total;
    return sym;
  };

  uint32_t* out_g = out + (int64_t)g * (n_steps / 2) * kLanes + lane;
  for (int h = 0; h < n_steps / 2; ++h, out_g += kLanes) {
    const uint32_t lo = step(0);
    const uint32_t hi = step(1);
    *out_g = (lo & 0xFFFFu) | (hi << 16);
  }
  wait_copies<0>();
}

}  // namespace

extern "C" int htpu_decode_groups(const void* streams, int64_t stream_words,
                                  const void* n_real, int ngroups,
                                  const void* lj_limit, const void* base,
                                  const void* sym_table, int n_sym,
                                  int translate, int n_steps, int min_len,
                                  int max_len, void* out, void* stream) {
  if (translate && (n_sym < 1 || n_sym > kMaxTranslate))
    return (int)cudaErrorInvalidValue;
  if (ngroups <= 0) return (int)cudaGetLastError();
  // The ring, then the table rounded up to 16 bytes. The opt-in ceiling is
  // the kernel's fixed capacity, the same on every call: the attribute is
  // the function's, shared by every host thread launching it, while a
  // launch's own size (and so its occupancy) follows n_sym.
  const size_t ring_bytes = kRingWords * sizeof(uint32_t);
  const size_t smem =
      ring_bytes + (translate ? ((size_t)n_sym * 2 + 15) & ~(size_t)15 : 0);
  const size_t capacity =
      ring_bytes + (translate ? kMaxTranslate * sizeof(uint16_t) : 0);
  auto kernel = translate ? decode_groups_kernel<true> : decode_groups_kernel<false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)capacity);
  if (err != cudaSuccess) return (int)err;
  kernel<<<ngroups, kLanes, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)streams, stream_words, (const int32_t*)n_real,
      (const uint32_t*)lj_limit, (const uint32_t*)base,
      (const uint16_t*)sym_table, n_sym, n_steps, min_len, max_len,
      (uint32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* htpu_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
