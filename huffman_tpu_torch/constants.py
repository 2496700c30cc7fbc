"""Global constants of the port: the port's own copy of
huffman_tpu/constants.py, value for value (the format depends on them).

The symbol model mirrors the reference codec's 16-bit byte-pair alphabet
(reference: Compressor.cu:38-48 packs ``(data[2i+1] << 8) | data[2i]``),
but every value here is a framework-level knob, not a copy of reference
compile-time constants.
"""

# Size of the symbol alphabet: 16-bit byte pairs.
MAX_SYMBOLS = 65536

# Bits per symbol in the raw (uncompressed) representation.
SYMBOL_BITS = 16

# Bytes per symbol.
SYMBOL_BYTES = 2

# Maximum supported codeword length. Canonical decode left-justifies codes
# into 32-bit words, so codewords must fit in 32 bits. Plain Huffman over a
# 65,536-symbol alphabet can theoretically exceed this only with pathological
# (Fibonacci-like) frequency profiles over >2^32 input symbols; the encoder
# asserts and falls back to depth-limited construction if it ever happens.
MAX_CODE_LEN = 32

# Default codebook depth limit for the NATIVE container. Decode-kernel cost
# is linear in codebook depth (the canonical length search), and capping at
# 18 costs < 0.5% ratio even on adversarial full-alphabet data (0 on text,
# whose optimal codes are shallower anyway). The limit only triggers a
# package-merge rebuild when the optimal code is actually deeper. The
# reference-interop format never limits (bit-exact sizes preserved).
DEFAULT_MAX_CODE_LEN = 18

# Default number of symbols per independently-decodable block in the native
# container (see container/block_format.py). 512 symbols = 1 KiB of input
# per block: the decoder runs one block per vector lane, so small blocks
# mean more lanes in flight and fewer sequential bit-cursor steps.
DEFAULT_BLOCK_SYMBOLS = 512

# Interleaved-stream protocol constants (docs/FORMATS.md §3). These define
# the v2 container format itself; the decode kernel (csrc/decode.cu) is
# built for the same geometry.
GROUP_LANES = 1024       # block lanes per interleaved group
PRELOAD_WORDS = 2        # stream words 0,1 of every lane head the stream
REFILL_THRESHOLD = 33    # lanes refill below this many live bits
WINDOW_ROWS = GROUP_LANES // 128 + 1  # decoder refill-window rows

# Alphabet tiers of the fused device encoder: it runs the smallest tier
# >= the input's n_unique (ops/fused.py), so small alphabets pay small
# package-merge lists and rank tables. The host codebook
# (codebook.package_merge_lengths) is built uncapped: byte-identity between
# host- and device-built containers rests on package-merge lengths being
# the same for any cap >= n_unique (sentinel-padded tails never enter the
# level counts), not on the host consulting these tiers. The ladder is the
# JAX package's, not yet tuned on the H100.
ALPHABET_TIERS = (4096, 16384, 32768, MAX_SYMBOLS)

# Native container magic / version.
NATIVE_MAGIC = 0x48545055  # "HTPU"
NATIVE_VERSION = 1
