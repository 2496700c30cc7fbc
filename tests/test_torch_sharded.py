"""The port's HTPX sharded archive against the JAX package's: archives
equal to ``huffman_tpu.container.sharded.compress(..., backend="numpy")``
byte for byte in both codebook modes, each package decoding the other's
archives, the odd tail and truncation. The archive built over a process
group is in tests/test_torch_parallel.py."""

import numpy as np
import pytest

import huffman_tpu
import huffman_tpu_torch
from huffman_tpu.container import sharded as jax_sharded
from huffman_tpu_torch.container import block_format, sharded


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(4)
    return (rng.zipf(1.4, size=100001) % 240).astype(np.uint8).tobytes()


@pytest.mark.parametrize("n_shards", [1, 3, 8])
@pytest.mark.parametrize("mode", ["global", "per-shard"])
def test_archive_equals_jax_and_cross_decodes(data, n_shards, mode):
    blob = sharded.compress(data, n_shards=n_shards, codebook_mode=mode, device="cpu")
    theirs = jax_sharded.compress(data, n_shards=n_shards, codebook_mode=mode, backend="numpy")
    assert blob == theirs
    assert sharded.decompress(blob, device="cpu") == data
    assert jax_sharded.decompress(blob, backend="numpy") == data


def test_shard_ranges_match_jax():
    for n in (0, 1, 2, 7, 100001, 1 << 20):
        for k in (1, 2, 3, 8):
            assert sharded._shard_ranges(n, k) == jax_sharded._shard_ranges(n, k)


def test_codebook_from_blob_roundtrips():
    from huffman_tpu.container import block_format as jax_bf

    freqs = np.bincount(np.random.default_rng(5).zipf(1.3, 50000) % 3000, minlength=65536)
    cb = block_format._host_codebook(freqs, 18)
    blob = block_format._codebook_to_header(cb)
    np.testing.assert_array_equal(block_format.codebook_from_blob(blob).lengths, cb.lengths)
    np.testing.assert_array_equal(jax_bf.codebook_from_blob(blob).lengths, cb.lengths)
    with pytest.raises(ValueError, match="truncated codebook blob"):
        block_format.codebook_from_blob(blob[:-2])


def test_global_beats_pershard_on_homogeneous_data(data):
    g = sharded.compress(data, n_shards=8, codebook_mode="global", device="cpu")
    p = sharded.compress(data, n_shards=8, codebook_mode="per-shard", device="cpu")
    assert len(g) < len(p)


@pytest.mark.parametrize("kw", [
    {"block_symbols": 64, "mode": "blocks"},
    {"max_code_len": None},
    {"max_code_len": 16, "block_symbols": 33},
])
def test_kwargs_reach_every_shard(data, kw):
    blob = sharded.compress(data, n_shards=3, device="cpu", **kw)
    assert blob == jax_sharded.compress(data, n_shards=3, backend="numpy", **kw)
    assert sharded.decompress(blob, device="cpu") == data


def test_truncation_raises(data):
    blob = sharded.compress(data, n_shards=2, device="cpu")
    for cut in (3, 10, 25, len(blob) - 5):
        with pytest.raises(ValueError):
            sharded.decompress(blob[:cut], device="cpu")
    with pytest.raises(ValueError, match="unsupported HTPX version 7"):
        sharded.decompress(blob[:4] + b"\x07" + blob[5:], device="cpu")
    with pytest.raises(ValueError, match="unknown codebook_mode"):
        sharded.compress(data, n_shards=2, codebook_mode="shared", device="cpu")
    with pytest.raises(ValueError, match="n_shards"):
        sharded.compress(data, n_shards=0, device="cpu")


def test_odd_tail(data):
    odd = data + b"z"
    blob = sharded.compress(odd, n_shards=3, device="cpu")
    assert blob == jax_sharded.compress(odd, n_shards=3, backend="numpy")
    assert sharded.decompress(blob, device="cpu") == odd


def test_api_routes_n_shards_and_both_kinds(data):
    """``compress(n_shards=...)`` writes HTPX, and ``decompress`` tells
    HTPX and HTPS apart by magic, as the JAX package's API does."""
    from huffman_tpu_torch.container import streaming

    ours = huffman_tpu_torch.compress(data, "cpu", n_shards=3)
    assert ours == huffman_tpu.compress(data, backend="numpy", n_shards=3)
    assert huffman_tpu_torch.decompress(ours, "cpu") == data
    htps = streaming.compress_bytes(data, chunk_bytes=1 << 15, device="cpu")
    assert huffman_tpu_torch.decompress(htps, "cpu") == data
    assert huffman_tpu.decompress(htps, backend="numpy") == data
    with pytest.raises(ValueError, match="codebook"):
        huffman_tpu_torch.compress(
            data, "cpu", n_shards=3,
            codebook=block_format._host_codebook(np.ones(65536, np.int64), 18),
        )
