"""The port's HTPU containers against the JAX package: containers equal
byte for byte, and each package decodes the other's containers."""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

import huffman_tpu
import huffman_tpu_torch
from huffman_tpu.codebook import Codebook, package_merge_lengths
from huffman_tpu.constants import MAX_SYMBOLS
from huffman_tpu.ops.tables import device_tables
from huffman_tpu.utils.benchmark import silesia_like, zipf_pairs
from huffman_tpu_torch.corpus import fibonacci_pairs
from huffman_tpu_torch.ops.tables import tables_from_codebook

CPU = torch.device("cpu")


def _inputs():
    return {
        "silesia_like": silesia_like(150_000, seed=7).tobytes(),
        "zipf4k": zipf_pairs(150_001, 4000, np.random.default_rng(3)).tobytes(),
        "zipf300": zipf_pairs(150_000, 300, np.random.default_rng(4)).tobytes(),
    }


@pytest.mark.parametrize("name", ["silesia_like", "zipf4k", "zipf300"])
def test_compress_equals_jax_device_path_and_cross_decodes(name):
    data = _inputs()[name]
    ours = huffman_tpu_torch.compress(data, device="cpu", block_symbols=64)
    theirs = huffman_tpu.compress(data, backend="jax", block_symbols=64)
    assert ours == theirs
    assert huffman_tpu.decompress(ours) == data
    assert huffman_tpu_torch.decompress(theirs, device="cpu") == data


EDGE = {
    "empty": b"",
    "one_byte": b"\x7f",
    "odd": bytes(range(256)) * 40 + b"!",
    "single_symbol": b"ab" * 5000,
    "random_bytes": np.random.default_rng(0).integers(0, 256, 70_000, dtype=np.uint8).tobytes(),
    "two_symbols_odd": b"xyxyyy" * 3001 + b"q",
}


@pytest.mark.parametrize("name", sorted(EDGE))
@pytest.mark.parametrize("max_code_len", [18, None])
def test_edge_inputs_match_host_path(name, max_code_len):
    data = EDGE[name]
    ours = huffman_tpu_torch.compress(data, "cpu", block_symbols=64, max_code_len=max_code_len)
    assert ours == huffman_tpu.compress(
        data, backend="numpy", block_symbols=64, max_code_len=max_code_len
    )
    assert huffman_tpu_torch.decompress(ours, "cpu") == data


def test_caller_codebook_and_odd_block_symbols():
    data = _inputs()["zipf300"][:40_000]
    cb = Codebook.from_frequencies(
        np.bincount(np.frombuffer(data, "<u2"), minlength=MAX_SYMBOLS)
    )
    # The JAX codebook carries over to the port as its lengths.
    port_cb = huffman_tpu_torch.Codebook.from_lengths(np.asarray(cb.lengths))
    ours = huffman_tpu_torch.compress(data, "cpu", block_symbols=33, codebook=port_cb)
    assert ours == huffman_tpu.compress(data, backend="numpy", block_symbols=33, codebook=cb)
    assert huffman_tpu_torch.decompress(ours, "cpu") == data


@pytest.mark.parametrize("kind", ["htpx_global", "htpx_per_shard", "htps"])
def test_jax_htpx_and_htps_blobs_decode(kind):
    """``decompress`` routes the JAX package's sharded archives and
    streams by magic, as ``huffman_tpu.decompress`` does."""
    from huffman_tpu.container import sharded, streaming

    data = _inputs()["zipf300"][:20_001]
    blob = {
        "htpx_global": lambda: huffman_tpu.compress(data, backend="numpy", n_shards=2),
        "htpx_per_shard": lambda: sharded.compress(
            data, n_shards=3, codebook_mode="per-shard", backend="numpy"
        ),
        "htps": lambda: streaming.compress_bytes(data, chunk_bytes=6000, backend="numpy"),
    }[kind]()
    assert huffman_tpu_torch.decompress(blob, "cpu") == data


@pytest.mark.parametrize("mode", ["interleaved", "blocks"])
def test_codes_deeper_than_26_bits(mode):
    """Fibonacci symbol counts: the unlimited code reaches 29 bits, past
    the ``len << 26 | code`` word, so the codes come from the two-table
    gather."""
    data = fibonacci_pairs().tobytes() + b"\x05"
    ours = huffman_tpu_torch.compress(data, "cpu", max_code_len=None, mode=mode)
    theirs = huffman_tpu.compress(data, backend="numpy", max_code_len=None, mode=mode)
    assert ours == theirs
    assert ours[7] == 29  # the header's max code length
    assert huffman_tpu_torch.decompress(theirs, "cpu") == data
    if mode == "interleaved":  # the JAX package decodes v1 with a host loop per symbol
        assert huffman_tpu.decompress(ours) == data


def test_corrupt_payload_fails_crc():
    data = _inputs()["zipf300"][:20_000]
    blob = bytearray(huffman_tpu_torch.compress(data, "cpu", block_symbols=64))
    blob[len(blob) // 2] ^= 0x10  # a payload bit
    with pytest.raises(ValueError, match="CRC"):
        huffman_tpu_torch.decompress(bytes(blob), "cpu")


@pytest.mark.parametrize("n_unique,max_len", [(1, 18), (300, 12), (30000, 18)])
def test_tables_match_jax_device_tables(n_unique, max_len):
    rng = np.random.default_rng(n_unique)
    freqs = np.zeros(MAX_SYMBOLS, np.int64)
    freqs[rng.choice(MAX_SYMBOLS, n_unique, replace=False)] = rng.integers(1, 99, n_unique)
    cb = Codebook.from_lengths(package_merge_lengths(freqs, max_len))
    ours = tables_from_codebook(cb, CPU)
    jax_t = device_tables(cb)
    for name in ("lj_limit", "base", "enc_packed"):
        np.testing.assert_array_equal(
            getattr(ours, name).numpy().view(np.uint32), np.asarray(getattr(jax_t, name))
        )
    np.testing.assert_array_equal(
        ours.sym_order.numpy().view(np.uint16), np.asarray(jax_t.sym_order)[:n_unique]
    )
    assert ours.max_len == jax_t.max_len
    assert ours.min_len == int(cb.lengths[cb.lengths > 0].min())
