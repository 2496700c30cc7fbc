"""The port's HTPS stream container against the JAX package's: the cases
of tests/test_streaming.py, the stream bytes equal to
``huffman_tpu.container.streaming.compress_bytes(..., backend="numpy")``,
each package decoding the other's streams, and the thread pipeline."""

import io

import numpy as np
import pytest

from huffman_tpu.container import streaming as jax_streaming
from huffman_tpu_torch.container import block_format
from huffman_tpu_torch.container import streaming


def _zipf(n, seed, a=1.5, mod=251):
    rng = np.random.default_rng(seed)
    return (rng.zipf(a, size=n) % mod).astype(np.uint8).tobytes()


@pytest.mark.parametrize("n,chunk", [(0, 1024), (1, 1024), (5000, 512),
                                     (100001, 4096), (65537, 65536)])
def test_roundtrip_equals_jax_and_cross_decodes(n, chunk):
    data = _zipf(n, n)
    blob = streaming.compress_bytes(data, chunk_bytes=chunk, device="cpu")
    theirs = jax_streaming.compress_bytes(data, chunk_bytes=chunk, backend="numpy")
    assert blob == theirs
    assert streaming.decompress_bytes(blob, device="cpu") == data
    assert jax_streaming.decompress_bytes(blob, backend="numpy") == data


def test_memory_bounded_interfaces():
    """Compression through real file objects, chunk by chunk."""
    data = _zipf(300000, 7, a=1.4, mod=240)
    src, comp = io.BytesIO(data), io.BytesIO()
    written = streaming.compress_stream(src, comp, chunk_bytes=1 << 16, device="cpu")
    assert written == len(comp.getvalue())
    comp.seek(0)
    out = io.BytesIO()
    n = streaming.decompress_stream(comp, out, device="cpu")
    assert n == len(data)
    assert out.getvalue() == data


@pytest.mark.parametrize("pipeline", [1, 2, 3])
def test_pipeline_depth_does_not_change_the_bytes(pipeline):
    data = _zipf(70001, 9)
    serial = jax_streaming.compress_bytes(data, chunk_bytes=8192, backend="numpy", pipeline=1)
    blob = streaming.compress_bytes(data, chunk_bytes=8192, device="cpu", pipeline=pipeline)
    assert blob == serial
    assert streaming.decompress_bytes(blob, device="cpu", pipeline=pipeline) == data


def test_fused_route_chunks_in_two_threads(monkeypatch):
    """Chunks past DEVICE_MIN_PAIRS take the fused route (histogram,
    package-merge, rank gather, lane pack), two at a time."""
    monkeypatch.setattr(block_format, "DEVICE_MIN_PAIRS", 1000)
    fused = []
    real = block_format._compress_v2_fused
    monkeypatch.setattr(block_format, "_compress_v2_fused",
                        lambda *a: fused.append(1) or real(*a))
    data = _zipf(40000, 12)
    blob = streaming.compress_bytes(data, chunk_bytes=8192, device="cpu", pipeline=2)
    assert len(fused) == 5
    assert blob == jax_streaming.compress_bytes(data, chunk_bytes=8192, backend="numpy")
    assert streaming.decompress_bytes(blob, device="cpu") == data


def test_kwargs_reach_every_chunk():
    data = _zipf(30000, 13)
    kw = dict(chunk_bytes=10000, block_symbols=64, mode="blocks", max_code_len=None)
    blob = streaming.compress_bytes(data, device="cpu", **kw)
    assert blob == jax_streaming.compress_bytes(data, backend="numpy", **kw)
    assert streaming.decompress_bytes(blob, device="cpu") == data


def test_truncation_and_corruption():
    data = b"stream me " * 5000
    blob = streaming.compress_bytes(data, chunk_bytes=1 << 14, device="cpu")
    for cut in (2, 9, 20, len(blob) // 2, len(blob) - 5):
        with pytest.raises(ValueError):
            streaming.decompress_bytes(blob[:cut], device="cpu")
    bad = bytearray(blob)
    bad[-2] ^= 1  # stream CRC
    with pytest.raises(ValueError, match="HTPS stream CRC mismatch"):
        streaming.decompress_bytes(bytes(bad), device="cpu")


@pytest.mark.parametrize("blob_edit,message", [
    (lambda b: b[:7], "not an HTPS stream"),
    (lambda b: b"XXXX" + b[4:], "not an HTPS stream"),
    (lambda b: b[:4] + b"\x02" + b[5:], "unsupported HTPS version 2"),
    (lambda b: b[:10], "truncated HTPS stream"),
    (lambda b: b[:20], "truncated HTPS record"),
    (lambda b: b[:-3], "truncated HTPS footer"),
    (lambda b: b[:-12] + (1).to_bytes(8, "little") + b[-4:], "HTPS size mismatch"),
])
def test_error_messages_match_jax(blob_edit, message):
    data = _zipf(20000, 14)
    bad = blob_edit(streaming.compress_bytes(data, chunk_bytes=4096, device="cpu"))
    with pytest.raises(ValueError, match=message):
        streaming.decompress_bytes(bad, device="cpu")
    with pytest.raises(ValueError, match=message):
        jax_streaming.decompress_bytes(bad, backend="numpy")


def test_odd_chunk_boundaries():
    data = bytes(range(256)) * 41 + b"x"
    blob = streaming.compress_bytes(data, chunk_bytes=1000, device="cpu")
    assert blob == jax_streaming.compress_bytes(data, chunk_bytes=1000, backend="numpy")
    assert streaming.decompress_bytes(blob, device="cpu") == data


def test_rejects_tiny_chunks_and_defaults_to_the_card():
    with pytest.raises(ValueError, match="chunk_bytes"):
        streaming.compress_bytes(b"abcd", chunk_bytes=1, device="cpu")
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        streaming.compress_bytes(b"abcd" * 100)
    with pytest.raises(RuntimeError, match="cuda"):
        streaming.decompress_bytes(streaming.compress_bytes(b"abcd" * 100, device="cpu"))
