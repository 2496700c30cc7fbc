// K11 crc32_words: zlib's CRC32 of decoded words, taken on the card.
//
// Replaces no TPU kernel: the JAX package checks a container's CRC32 with
// zlib on the host, over the bytes decompress returns
// (huffman_tpu/container/block_format.py:742). The port takes it here,
// over the decoded words while they are still on the card, so that only
// the 4-byte result comes back with them (container/block_format.py).
//
// The arithmetic (ops/cuda_crc.py says it at length). CRC32 is linear over
// GF(2): with raw(M) the CRC of M from 0 without the final inversion and
// x^k the polynomial x^k modulo zlib's (reflected) polynomial,
// raw(A || B) = raw(A) x^(8|B|) ^ raw(B), leading zero bytes leave raw
// unchanged, and zlib's CRC of n bytes is ~(raw(M) ^ ~0 x^(8n)). So pieces
// may be folded anywhere, each moved to the end by one product, and XORed.
//
// What bounds it on an H100: it reads each byte once (33.5 MB at the 32
// MiB headline input: 10.0 us at 3.35 TB/s) and folds each byte with one
// table lookup in shared memory (slice-by-16). A warp's 32 lookups into one
// 256-entry table meet random banks, about 3.5 ways on a bank for random
// bytes, so the lookups, not the loads, are what the design keeps few: one
// per byte, and nothing else per byte goes through shared memory.
//
// Design. The body, the 16-byte vectors from the first 16-byte boundary,
// is cut into tiles of kTileBytes aligned to its end (the first tile is
// short: what lies before vector 0 reads as leading zeros). Pass 1
// (crc32_tiles_kernel), one block a tile: lane l of warp w folds vectors
// w * 32 * kSteps + j * 32 + l, j = 0 .. kSteps - 1, so each load of a
// warp reads 512 contiguous bytes. The 496 bytes between two of a lane's
// vectors belong to the other lanes and are zeros in its fold: tables
// premultiplied by x^(8 * 496) carry the lane's CRC across them in the
// same 16 lookups that fold a vector, and its last vector folds with the
// plain tables. One product with a constant of its place then moves each
// lane's CRC to the tile's end, and the block XORs them into the tile's
// raw CRC. Pass 2 (crc32_combine_kernel), one block: tile i's CRC moves to
// the body's end by x^(8 kTileBytes (m - 1 - i)), the powers
// x^(8 kTileBytes 2^k) that the bits of m - 1 - i pick, each a product
// through 4-bit tables built in shared memory; XOR; then the head (the
// bytes before the first 16-byte boundary) and the tail (after the last
// whole vector), under 16 each, fold in a bit at a time, with zlib's
// inversions. Two launches, no grid-wide barrier.
//
// The constants that depend on the geometry alone (the premultiplied
// tables' generators, each lane's and each level's power of x) are
// computed once a process on the host, and the one that depends on the
// length, x^(8 * body bytes), once a call (a product for each set bit of
// the length, about a microsecond). None depends on the bytes.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kPoly = 0xEDB88320u;  // zlib's, reflected
constexpr uint32_t kOne = 1u << 31;     // the polynomial 1 in zlib's bit order
constexpr int kThreads = 256;           // one table column a thread
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 8;               // 16-byte vectors a lane folds
constexpr int kSegmentBytes = 32 * kSteps * 16;  // a warp's
constexpr int64_t kTileVecs = (int64_t)kThreads * kSteps;
constexpr int64_t kTileBytes = 16 * kTileVecs;   // ops/cuda_crc.py: TILE_BYTES
constexpr int kGapBytes = 16 * 31;  // between two of a lane's vectors
constexpr int kLevels = 32;         // powers of x^(8 kTileBytes): m < 2^31
constexpr int kCombineThreads = 1024;
static_assert(kThreads == 256, "pass 1 builds one column of each table a thread");
static_assert(kTileBytes == 32768, "ops/cuda_crc.py: TILE_BYTES");

// a(x) x modulo the polynomial.
__host__ __device__ __forceinline__ uint32_t mulx(uint32_t a) {
  return (a >> 1) ^ (kPoly & (0u - (a & 1u)));
}

// a(x) b(x) modulo the polynomial (zlib's multmodp), from a's x^0 up.
__host__ __device__ inline uint32_t gf_mul(uint32_t a, uint32_t b) {
  uint32_t p = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    p ^= b & (0u - (a >> 31));
    a <<= 1;
    b = mulx(b);
  }
  return p;
}

// One byte into a running CRC, a bit at a time.
__device__ __forceinline__ uint32_t byte_step(uint32_t crc, uint8_t b) {
  crc ^= b;
#pragma unroll
  for (int i = 0; i < 8; ++i) crc = mulx(crc);
  return crc;
}

struct Pass1 {
  uint32_t gap_basis[8];            // T0[1 << b] x^(8 kGapBytes)
  uint32_t to_tile_end[kThreads];   // x^(8 * the tile's bytes after thread t's last vector)
};

struct Pass2 {
  uint32_t level[kLevels];  // x^(8 kTileBytes 2^k)
};

// Slice-by-16: 16 bytes into ``crc`` through tables t[k][b] = the raw CRC
// of byte b and k zero bytes (times a power of x, for the gap tables).
__device__ __forceinline__ uint32_t fold16(uint32_t (*t)[256], uint32_t crc, uint4 v) {
  const uint32_t a = v.x ^ crc;
  return t[15][a & 255] ^ t[14][(a >> 8) & 255] ^ t[13][(a >> 16) & 255] ^ t[12][a >> 24] ^
         t[11][v.y & 255] ^ t[10][(v.y >> 8) & 255] ^ t[9][(v.y >> 16) & 255] ^ t[8][v.y >> 24] ^
         t[7][v.z & 255] ^ t[6][(v.z >> 8) & 255] ^ t[5][(v.z >> 16) & 255] ^ t[4][v.z >> 24] ^
         t[3][v.w & 255] ^ t[2][(v.w >> 8) & 255] ^ t[1][(v.w >> 16) & 255] ^ t[0][v.w >> 24];
}

__global__ void __launch_bounds__(kThreads, 3)
crc32_tiles_kernel(const uint4* __restrict__ vec, int64_t nv, int m, Pass1 c,
                   uint32_t* __restrict__ partials) {
  __shared__ uint32_t plain[16][256];
  __shared__ uint32_t gap[16][256];
  __shared__ uint32_t warp_crc[kWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  // The loads first, so that they are in flight while the tables build.
  const int64_t first =
      nv - (int64_t)(m - blockIdx.x) * kTileVecs + (int64_t)warp * 32 * kSteps + lane;
  uint4 v[kSteps];
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const int64_t i = first + 32 * j;
    v[j] = i >= 0 ? __ldg(vec + i) : make_uint4(0u, 0u, 0u, 0u);
  }

  // Column t of both table sets: T0[t] = t x^8; the gap tables' first row
  // by linearity in t; then row k from row k - 1 by one zero byte.
  uint32_t p = t;
#pragma unroll
  for (int i = 0; i < 8; ++i) p = mulx(p);
  uint32_t g = 0;
#pragma unroll
  for (int b = 0; b < 8; ++b) g ^= c.gap_basis[b] & (0u - ((t >> b) & 1u));
  plain[0][t] = p;
  gap[0][t] = g;
  __syncthreads();  // row 0 whole before any lookup in it
#pragma unroll
  for (int k = 1; k < 16; ++k) {
    p = (p >> 8) ^ plain[0][p & 255];
    g = (g >> 8) ^ plain[0][g & 255];
    plain[k][t] = p;
    gap[k][t] = g;
  }
  __syncthreads();  // every table whole

  uint32_t crc = 0;
#pragma unroll
  for (int j = 0; j < kSteps - 1; ++j) crc = fold16(gap, crc, v[j]);
  crc = fold16(plain, crc, v[kSteps - 1]);
  crc = gf_mul(crc, c.to_tile_end[t]);
  crc = __reduce_xor_sync(0xFFFFFFFFu, crc);
  if (lane == 0) warp_crc[warp] = crc;
  __syncthreads();
  if (t == 0) {
    uint32_t x = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) x ^= warp_crc[w];
    partials[blockIdx.x] = x;
  }
}

// v times level k's power: the 4-bit tables of its images.
__device__ __forceinline__ uint32_t mul_nibbles(uint32_t (*tab)[16], uint32_t v) {
  uint32_t r = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) r ^= tab[q][(v >> (4 * q)) & 15];
  return r;
}

__global__ void __launch_bounds__(kCombineThreads)
crc32_combine_kernel(const uint32_t* __restrict__ partials, int m, Pass2 c,
                     const uint8_t* __restrict__ head, int n_head,
                     const uint8_t* __restrict__ tail, int n_tail, uint32_t x_body,
                     uint32_t* __restrict__ out) {
  __shared__ uint32_t basis[kLevels][32];
  __shared__ uint32_t nib[kLevels][8][16];
  __shared__ uint32_t warp_crc[kCombineThreads / 32];
  const int t = threadIdx.x;
  const int levels = m > 1 ? 32 - __clz(m - 1) : 0;  // the bits of m - 1

  // Level k's images of the 32 bits: bit d is x^(31 - d).
  if (t < levels) {
    uint32_t b = c.level[t];
    for (int d = 31; d >= 0; --d) {
      basis[t][d] = b;
      b = mulx(b);
    }
  }
  __syncthreads();
  for (int e = t; e < levels * 128; e += kCombineThreads) {
    const int k = e >> 7, q = (e >> 4) & 7, x = e & 15;
    uint32_t v = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) v ^= basis[k][4 * q + b] & (0u - ((x >> b) & 1u));
    nib[k][q][x] = v;
  }
  __syncthreads();

  uint32_t acc = 0;
  for (int i = t; i < m; i += kCombineThreads) {
    uint32_t v = partials[i];
    int k = 0;
    for (uint32_t r = (uint32_t)(m - 1 - i); r; r >>= 1, ++k)
      if (r & 1u) v = mul_nibbles(nib[k], v);
    acc ^= v;
  }
  acc = __reduce_xor_sync(0xFFFFFFFFu, acc);
  if ((t & 31) == 0) warp_crc[t >> 5] = acc;
  __syncthreads();
  if (t == 0) {
    uint32_t body = 0;
    for (int w = 0; w < kCombineThreads / 32; ++w) body ^= warp_crc[w];
    uint32_t crc = 0xFFFFFFFFu;
    for (int j = 0; j < n_head; ++j) crc = byte_step(crc, head[j]);
    crc = gf_mul(crc, x_body) ^ body;
    for (int j = 0; j < n_tail; ++j) crc = byte_step(crc, tail[j]);
    out[0] = ~crc;
  }
}

struct Consts {
  uint32_t sq[64];  // x^(8 2^b)
  Pass1 p1;
  Pass2 p2;
};

// x^(8 n): the squares that the bits of n pick.
uint32_t x8n(const Consts& k, uint64_t n) {
  uint32_t p = kOne;
  for (int b = 0; n; ++b, n >>= 1)
    if (n & 1) p = gf_mul(p, k.sq[b]);
  return p;
}

// Once a process: the constants of the geometry.
const Consts& consts() {
  static const Consts k = [] {
    Consts r{};
    r.sq[0] = 1u << 23;  // x^8
    for (int b = 1; b < 64; ++b) r.sq[b] = gf_mul(r.sq[b - 1], r.sq[b - 1]);
    const uint32_t gap = x8n(r, kGapBytes);
    for (int b = 0; b < 8; ++b) {
      uint32_t t0 = 1u << b;
      for (int i = 0; i < 8; ++i) t0 = mulx(t0);
      r.p1.gap_basis[b] = gf_mul(t0, gap);
    }
    for (int t = 0; t < kThreads; ++t)
      r.p1.to_tile_end[t] = x8n(r, 16 * (31 - (t & 31)) +
                                       (uint64_t)kSegmentBytes * (kWarps - 1 - (t >> 5)));
    for (int b = 0; b < kLevels; ++b) r.p2.level[b] = x8n(r, (uint64_t)kTileBytes << b);
    return r;
  }();
  return k;
}

}  // namespace

// scratch: int32[1 + capacity], capacity at least the started tiles of
// n_bytes; scratch[0] receives the CRC. words need only be 4-byte aligned.
extern "C" int htpu_crc32_words(const void* words, int64_t n_bytes, void* scratch,
                                int64_t capacity, void* stream) {
  const Consts& k = consts();
  const uint8_t* base = (const uint8_t*)words;
  int64_t n_head = (int64_t)((16 - ((uintptr_t)base & 15)) & 15);
  if (n_head > n_bytes) n_head = n_bytes;
  const int64_t nv = (n_bytes - n_head) / 16;
  const int64_t n_tail = n_bytes - n_head - 16 * nv;
  const int64_t m = (nv + kTileVecs - 1) / kTileVecs;
  if (n_bytes < 0 || m > capacity || m > INT_MAX) return (int)cudaErrorInvalidValue;
  uint32_t* out = (uint32_t*)scratch;
  uint32_t* partials = out + 1;
  const cudaStream_t s = (cudaStream_t)stream;
  if (m > 0) {
    crc32_tiles_kernel<<<(unsigned)m, kThreads, 0, s>>>(
        (const uint4*)(base + n_head), nv, (int)m, k.p1, partials);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  crc32_combine_kernel<<<1, kCombineThreads, 0, s>>>(
      partials, (int)m, k.p2, base, (int)n_head, base + n_head + 16 * nv, (int)n_tail,
      x8n(k, (uint64_t)(16 * nv)), out);
  return (int)cudaGetLastError();
}
