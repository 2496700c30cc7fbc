"""The port's reference ``.compressed`` container against the JAX
package's: ``compress_reference`` (payload packed by the port's plain
tensor ops) byte-identical to ``huffman_tpu.compress_reference`` on edge
inputs and on codes 29 bits deep, and each package's
``decompress_reference`` reading the other's containers."""

import numpy as np
import pytest

import huffman_tpu
import huffman_tpu_torch
from huffman_tpu_torch.corpus import fibonacci_pairs, zipf_pairs


def _inputs():
    return {
        "empty": b"",
        "one_byte": b"\x7f",
        "two_bytes": b"\x01\x02",
        "odd": bytes(range(256)) * 40 + b"!",
        "single_symbol": b"ab" * 5000,
        "zipf300_odd": zipf_pairs(30_001, 300, np.random.default_rng(4)).tobytes(),
        "fibonacci_18": fibonacci_pairs(18, seed=1).tobytes(),
        "fibonacci_30": fibonacci_pairs().tobytes(),  # 29-bit codes
    }


@pytest.mark.parametrize("name", sorted(_inputs()))
def test_reference_container_matches_jax_and_cross_decodes(name):
    data = _inputs()[name]
    ours = huffman_tpu_torch.compress_reference(data, "cpu")
    theirs = huffman_tpu.compress_reference(data, backend="numpy")
    assert ours == theirs
    assert huffman_tpu.decompress_reference(ours) == data
    assert huffman_tpu_torch.decompress_reference(theirs) == data


def test_reference_blob_is_not_an_htpu_container():
    blob = huffman_tpu_torch.compress_reference(b"abcabcabd" * 50, "cpu")
    with pytest.raises(ValueError, match="not an HTPU container"):
        huffman_tpu_torch.decompress(blob, "cpu")


def test_foreign_codes_deeper_than_32_bits_decode():
    """The format allows codes of up to 64 bits (the reference writes its
    length as one byte); a hand-built container with a 40-bit code takes
    the 64-bit host decoder. Symbols 7, 9, 11 get codes 0, 10, and 11
    followed by 38 ones (lengths 1, 2 and 40: a prefix code, not complete)."""
    from huffman_tpu_torch.bitio import BitWriter

    w = BitWriter()
    w.write_bytes_aligned(bytes([3, 0, 0]))
    for sym, length, code in ((7, 1, 0), (9, 2, 0b10), (11, 40, (1 << 40) - 1)):
        w.write(sym, 16)
        w.write(length, 8)
        w.write(code, length)
    seq = [7, 11, 9, 7, 11]
    for i in range(8):
        w.write((2 * len(seq) >> (8 * i)) & 0xFF, 8)
    for s in seq:
        w.write(*{7: (0, 1), 9: (0b10, 2), 11: ((1 << 40) - 1, 40)}[s])
    blob = w.getvalue()
    want = np.array(seq, "<u2").tobytes()
    assert huffman_tpu_torch.decompress_reference(blob) == want
    assert huffman_tpu.decompress_reference(blob, backend="numpy") == want
