// Native host runtime of the PyTorch port: the port's own copy of the
// parts of native/htpu_native.cpp that huffman_tpu_torch calls, built with
// g++ at first use by huffman_tpu_torch/runtime/native.py and loaded with
// ctypes (plain C interface).
//
// Components:
//   htpu_code_lengths        — O(n) two-queue optimal code lengths
//   htpu_ref_original_size   — reference-format header walk: original size
//   htpu_ref_decompress      — reference-format reader/decoder (handles
//                              arbitrary prefix codes up to 64 bits)
//   htpu_histogram           — dense byte-pair histogram, threaded
//
// The functions, their arguments, error codes and results are those of the
// JAX package's library, so both packages decode the same bytes and fail
// with the same codes.
//
// Error codes: 0 ok; <0 = HTPU_E_* below.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#define HTPU_API extern "C" __attribute__((visibility("default")))

enum {
  HTPU_OK = 0,
  HTPU_E_ARGS = -1,
  HTPU_E_TRUNCATED = -2,
  HTPU_E_BAD_CODE = -3,
  HTPU_E_OVERFLOW = -4,
  HTPU_E_INVARIANT = -5,
};

namespace {

constexpr int kMaxSymbols = 65536;
constexpr int kMaxCodeLen = 32;

int num_threads(int64_t work_items, int64_t min_per_thread) {
  const char* env = std::getenv("HTPU_THREADS");
  int hw = env ? std::atoi(env) : (int)std::thread::hardware_concurrency();
  if (hw < 1) hw = 1;
  int64_t by_work = work_items / std::max<int64_t>(min_per_thread, 1);
  return (int)std::max<int64_t>(1, std::min<int64_t>(hw, by_work));
}

template <typename F>
void parallel_for(int64_t n, int64_t min_per_thread, F&& f) {
  int nt = num_threads(n, min_per_thread);
  if (nt <= 1) {
    f(0, n, 0);
    return;
  }
  std::vector<std::thread> ts;
  int64_t per = (n + nt - 1) / nt;
  for (int i = 0; i < nt; ++i) {
    int64_t a = i * per, b = std::min<int64_t>(n, a + per);
    if (a >= b) break;
    ts.emplace_back([&f, a, b, i] { f(a, b, i); });
  }
  for (auto& t : ts) t.join();
}

// Peek 64 bits at absolute bit position `pos` from a buffer that the caller
// padded with >= 9 readable bytes past the last meaningful bit.
static inline uint64_t peek64(const uint8_t* p, int64_t pos) {
  uint64_t x;
  std::memcpy(&x, p + (pos >> 3), 8);
  x = __builtin_bswap64(x);
  int s = (int)(pos & 7);
  if (s) x = (x << s) | (uint64_t)(p[(pos >> 3) + 8] >> (8 - s));
  return x;
}

// ---------------------------------------------------------------------------
// Two-queue optimal code lengths (canonical-ready)
// ---------------------------------------------------------------------------

// Same contract and tie-breaking as codebook.code_lengths_from_frequencies:
// leaves ascending by (freq, symbol); merge ties prefer the internal node
// (can deepen trees, but reproduces the reference's exact sizes — part of
// the interop contract pinned by tests);
// single-symbol alphabets get length 1 (fixing the reference's silent
// empty-output bug for such inputs, SURVEY.md §4).
static int code_lengths(const int64_t* freqs, uint8_t* lengths) {
  std::vector<int> present;
  present.reserve(4096);
  for (int s = 0; s < kMaxSymbols; ++s) {
    if (freqs[s] < 0) return HTPU_E_ARGS;
    if (freqs[s] > 0) present.push_back(s);
  }
  std::memset(lengths, 0, kMaxSymbols);
  int64_t n = (int64_t)present.size();
  if (n == 0) return HTPU_OK;
  if (n == 1) {
    lengths[present[0]] = 1;
    return HTPU_OK;
  }
  std::sort(present.begin(), present.end(), [&](int a, int b) {
    if (freqs[a] != freqs[b]) return freqs[a] < freqs[b];
    return a < b;
  });
  std::vector<int64_t> leaf_freq(n);
  for (int64_t i = 0; i < n; ++i) leaf_freq[i] = freqs[present[i]];

  std::vector<int64_t> int_freq(n - 1), left(n - 1), right(n - 1);
  int64_t li = 0, ii = 0;
  for (int64_t k = 0; k < n - 1; ++k) {
    int64_t id[2], f[2];
    for (int j = 0; j < 2; ++j) {
      bool take_leaf = li < n && (ii >= k || leaf_freq[li] < int_freq[ii]);
      if (take_leaf) {
        id[j] = li; f[j] = leaf_freq[li]; ++li;
      } else {
        id[j] = n + ii; f[j] = int_freq[ii]; ++ii;
      }
    }
    int_freq[k] = f[0] + f[1];
    left[k] = id[0];
    right[k] = id[1];
  }

  std::vector<int32_t> depth(2 * n - 1, 0);
  for (int64_t k = n - 2; k >= 0; --k) {
    int32_t d = depth[n + k] + 1;
    depth[left[k]] = d;
    depth[right[k]] = d;
  }

  int32_t maxd = 0;
  for (int64_t i = 0; i < n; ++i) maxd = std::max(maxd, depth[i]);
  if (maxd > kMaxCodeLen) {
    // Boundary package-merge: OPTIMAL length-limited lengths, mirroring
    // codebook._limit_lengths operation-for-operation (same float64
    // arithmetic, same stable leaf-before-package tie order) so the
    // Python and native builders stay bit-identical on these inputs.
    // A clamp-then-deepen repair is not enough: it can miss the Kraft
    // EQUALITY the canonical builders require.
    std::vector<double> leaf_w(leaf_freq.begin(), leaf_freq.end());
    std::vector<std::vector<uint8_t>> flags((size_t)kMaxCodeLen);
    std::vector<double> cur = leaf_w;
    flags[0].assign((size_t)n, 0);
    for (int lvl = 1; lvl < kMaxCodeLen; ++lvl) {
      int64_t m = (int64_t)cur.size() & ~1ll;
      std::vector<double> pk((size_t)(m / 2));
      for (int64_t i = 0; i < m / 2; ++i) pk[(size_t)i] = cur[(size_t)(2 * i)] + cur[(size_t)(2 * i + 1)];
      std::vector<double> w;
      std::vector<uint8_t> f;
      w.reserve((size_t)n + pk.size());
      f.reserve((size_t)n + pk.size());
      int64_t a = 0, b = 0;
      while (a < n || b < (int64_t)pk.size()) {
        bool take_leaf =
            b >= (int64_t)pk.size() || (a < n && leaf_w[(size_t)a] <= pk[(size_t)b]);
        if (take_leaf) { w.push_back(leaf_w[(size_t)a++]); f.push_back(0); }
        else { w.push_back(pk[(size_t)b++]); f.push_back(1); }
      }
      cur.swap(w);
      flags[(size_t)lvl].swap(f);
    }
    for (int64_t i = 0; i < n; ++i) depth[i] = 0;
    int64_t c = 2 * n - 2;
    for (int lvl = kMaxCodeLen - 1; lvl >= 0; --lvl) {
      const auto& fl = flags[(size_t)lvl];
      int64_t p = 0;
      for (int64_t i = 0; i < c && i < (int64_t)fl.size(); ++i) p += fl[(size_t)i];
      int64_t m = c - p;
      for (int64_t r = 0; r < m && r < n; ++r) depth[r] += 1;
      c = 2 * p;
    }
  }
  for (int64_t i = 0; i < n; ++i) lengths[present[i]] = (uint8_t)depth[i];
  return HTPU_OK;
}

}  // namespace

// ---------------------------------------------------------------------------
// Public: code lengths
// ---------------------------------------------------------------------------

HTPU_API int htpu_code_lengths(const int64_t* freqs, uint8_t* lengths) {
  if (!freqs || !lengths) return HTPU_E_ARGS;
  return code_lengths(freqs, lengths);
}

// ---------------------------------------------------------------------------
// Public: reference-format decompress
// ---------------------------------------------------------------------------

namespace {

struct BitReader {
  const uint8_t* p;
  int64_t nbits;
  int64_t pos = 0;

  bool ok(int64_t nb) const { return pos + nb <= nbits; }

  uint64_t read(int nb) {
    uint64_t v = 0;
    int64_t q = pos;
    int rem = nb;
    while (rem > 0) {
      int avail = 8 - (int)(q & 7);
      int take = std::min(avail, rem);
      uint8_t byte = p[q >> 3];
      v = (v << take) | ((byte >> (avail - take)) & ((1u << take) - 1));
      q += take;
      rem -= take;
    }
    pos = q;
    return v;
  }
};

}  // namespace

// Parses the header only; returns the original file size (so the caller can
// size the output buffer), or <0 on error.
HTPU_API int64_t htpu_ref_original_size(const uint8_t* blob, int64_t blob_len) {
  if (!blob || blob_len < 3) return HTPU_E_TRUNCATED;
  int64_t count = blob[0] | ((int64_t)blob[1] << 8);
  if (count == 0) count = 65536;
  bool is_odd = blob[2] != 0;
  int64_t pos = is_odd ? 4 : 3;
  if (blob_len < pos) return HTPU_E_TRUNCATED;
  BitReader r{blob, blob_len * 8, pos * 8};
  for (int64_t i = 0; i < count; ++i) {
    if (!r.ok(24)) return HTPU_E_TRUNCATED;
    r.read(16);
    int64_t len = (int64_t)r.read(8);
    if (len == 0) len = 65536;
    if (len > 64) return HTPU_E_BAD_CODE;
    if (!r.ok(len)) return HTPU_E_TRUNCATED;
    r.read((int)len);
  }
  if (!r.ok(64)) return HTPU_E_TRUNCATED;
  int64_t file_size = 0;
  for (int i = 0; i < 8; ++i) file_size |= (int64_t)r.read(8) << (8 * i);
  // Sanity vs the payload actually present: each pair consumes >= 1 bit,
  // so a hostile/corrupt size field can't demand more than 2 bytes per
  // remaining payload bit (prevents giant caller allocations).
  if (file_size < 0 || file_size / 2 > (blob_len * 8 - r.pos) + 8)
    return HTPU_E_TRUNCATED;
  return file_size;
}

HTPU_API int htpu_ref_decompress(const uint8_t* blob, int64_t blob_len,
                                 uint8_t* out, int64_t out_cap,
                                 int64_t* out_len) {
  if (!blob || !out_len) return HTPU_E_ARGS;
  if (blob_len < 3) return HTPU_E_TRUNCATED;
  int64_t count = blob[0] | ((int64_t)blob[1] << 8);
  if (count == 0) count = 65536;
  bool is_odd = blob[2] != 0;
  uint8_t last_byte = 0;
  int64_t pos_bytes = 3;
  if (is_odd) {
    if (blob_len < 4) return HTPU_E_TRUNCATED;
    last_byte = blob[3];
    pos_bytes = 4;
  }

  // Header: per-symbol (symbol, length, code). Codes may be arbitrary
  // prefix codes (the reference's own tree assignment), up to 64 bits.
  std::vector<uint16_t> syms((size_t)count);
  std::vector<uint8_t> lens((size_t)count);
  std::vector<uint64_t> lj((size_t)count);  // left-justified in 64 bits
  BitReader r{blob, blob_len * 8, pos_bytes * 8};
  for (int64_t i = 0; i < count; ++i) {
    if (!r.ok(24)) return HTPU_E_TRUNCATED;
    syms[i] = (uint16_t)r.read(16);
    int64_t len = (int64_t)r.read(8);
    if (len == 0) len = 65536;
    if (len > 64) return HTPU_E_BAD_CODE;
    if (!r.ok(len)) return HTPU_E_TRUNCATED;
    uint64_t code = r.read((int)len);
    lens[i] = (uint8_t)len;
    lj[i] = (len == 64) ? code : (code << (64 - len));
  }
  if (!r.ok(64)) return HTPU_E_TRUNCATED;
  int64_t file_size = 0;
  for (int i = 0; i < 8; ++i) file_size |= (int64_t)r.read(8) << (8 * i);
  int64_t n_pairs = file_size / 2;
  if (file_size < 0 || n_pairs > (blob_len * 8 - r.pos) + 8)
    return HTPU_E_TRUNCATED;  // each pair consumes >= 1 payload bit
  if (file_size > out_cap) return HTPU_E_OVERFLOW;

  // Sort codewords by left-justified value; in a prefix-free code the
  // match for a 64-bit peek P is the greatest lj <= P (same primitive the
  // device decoder uses, SURVEY.md §7). A 16-bit root table narrows the
  // binary search to (almost always) a single candidate.
  std::vector<int32_t> order((size_t)count);
  for (int64_t i = 0; i < count; ++i) order[i] = (int32_t)i;
  std::sort(order.begin(), order.end(),
            [&](int32_t a, int32_t b) { return lj[a] < lj[b]; });
  std::vector<uint64_t> lj_s((size_t)count);
  std::vector<uint16_t> sym_s((size_t)count);
  std::vector<uint8_t> len_s((size_t)count);
  for (int64_t i = 0; i < count; ++i) {
    lj_s[i] = lj[order[i]];
    sym_s[i] = syms[order[i]];
    len_s[i] = lens[order[i]];
  }
  std::vector<int32_t> root(65537);
  {
    int64_t j = 0;
    for (int64_t v = 0; v < 65536; ++v) {
      uint64_t key = (uint64_t)v << 48;
      while (j < count && lj_s[j] < key) ++j;
      root[v] = (int32_t)j;  // first index with lj >= v << 48
    }
    root[65536] = (int32_t)count;
  }

  // Fast path: a 12-bit direct table for peeks whose top 12 bits uniquely
  // identify the codeword (true for every code of <= 12 bits and for any
  // longer code owning its 12-bit prefix alone). Entry = sym << 8 | len;
  // 0xFFFFFFFF falls back to the range binary search.
  constexpr int kFastBits = 12;
  std::vector<uint32_t> fast((size_t)1 << kFastBits, 0xFFFFFFFFu);
  {
    int64_t j = 0;
    for (uint32_t v = 0; v < (1u << kFastBits); ++v) {
      uint64_t lo_key = (uint64_t)v << (64 - kFastBits);
      uint64_t hi_key = lo_key | (~0ull >> kFastBits);
      while (j < count && lj_s[j] < lo_key) ++j;
      // candidate for the whole bucket: greatest lj <= lo_key
      int64_t idx = j - 1 + (j < count && lj_s[j] == lo_key ? 1 : 0);
      if (idx < 0) continue;
      // unique iff no other codeword boundary falls inside the bucket
      int64_t nxt = idx + 1;
      if (nxt < count && lj_s[nxt] <= hi_key) continue;
      fast[v] = ((uint32_t)sym_s[idx] << 8) | len_s[idx];
    }
  }

  // Payload bit cursor; pad the source so peek64 never reads past the end.
  int64_t payload_pos = r.pos;
  std::vector<uint8_t> padded((size_t)blob_len + 16, 0);
  std::memcpy(padded.data(), blob, (size_t)blob_len);
  const uint8_t* src = padded.data();

  // In-loop cursor bound: decoding must never walk past the final byte
  // (+7 bits of left-aligned flush slack). Bounds also keep peek64 inside
  // the 16-byte padding: pos < blob_len*8+8 => (pos>>3)+9 <= blob_len+10.
  const int64_t pos_limit = blob_len * 8 + 8;
  int64_t pos = payload_pos;
  for (int64_t i = 0; i < n_pairs; ++i) {
    if (pos >= pos_limit) return HTPU_E_TRUNCATED;
    uint64_t peek = peek64(src, pos);
    uint32_t e = fast[peek >> (64 - kFastBits)];
    if (e != 0xFFFFFFFFu) {
      out[2 * i] = (uint8_t)((e >> 8) & 0xFF);
      out[2 * i + 1] = (uint8_t)(e >> 16);
      pos += e & 0xFF;
      continue;
    }
    int32_t lo = root[peek >> 48];
    int32_t hi = root[(peek >> 48) + 1];
    // greatest index in [lo, hi) with lj_s <= peek; fallback lo-1.
    int32_t idx = lo - 1;
    while (lo < hi) {
      int32_t mid = (lo + hi) >> 1;
      if (lj_s[mid] <= peek) { idx = mid; lo = mid + 1; }
      else hi = mid;
    }
    if (idx < 0) return HTPU_E_BAD_CODE;
    out[2 * i] = (uint8_t)(sym_s[idx] & 0xFF);
    out[2 * i + 1] = (uint8_t)(sym_s[idx] >> 8);
    pos += len_s[idx];
  }
  if (pos > blob_len * 8 + 7) return HTPU_E_TRUNCATED;
  if (is_odd) out[file_size - 1] = last_byte;
  *out_len = file_size;
  return HTPU_OK;
}

// ---------------------------------------------------------------------------
// Public: dense byte-pair histogram (host twin of the device histogram)
// ---------------------------------------------------------------------------

HTPU_API int htpu_histogram(const uint8_t* data, int64_t data_len,
                            int64_t* freqs) {
  if ((!data && data_len) || !freqs) return HTPU_E_ARGS;
  std::memset(freqs, 0, kMaxSymbols * sizeof(int64_t));
  int64_t n_pairs = data_len / 2;
  int nt = num_threads(n_pairs, 1 << 17);
  if (nt <= 1) {
    for (int64_t i = 0; i < n_pairs; ++i)
      freqs[data[2 * i] | (data[2 * i + 1] << 8)]++;
    return HTPU_OK;
  }
  std::vector<std::vector<int64_t>> locals(
      (size_t)nt, std::vector<int64_t>(kMaxSymbols, 0));
  parallel_for(n_pairs, 1 << 17, [&](int64_t a, int64_t b, int tid) {
    int64_t* h = locals[(size_t)tid].data();
    for (int64_t i = a; i < b; ++i)
      h[data[2 * i] | (data[2 * i + 1] << 8)]++;
  });
  parallel_for(kMaxSymbols, 4096, [&](int64_t a, int64_t b, int) {
    for (int64_t s = a; s < b; ++s) {
      int64_t acc = 0;
      for (int t = 0; t < nt; ++t) acc += locals[(size_t)t][(size_t)s];
      freqs[s] = acc;
    }
  });
  return HTPU_OK;
}
