"""Streaming container ("HTPS"): counterpart of
huffman_tpu/container/streaming.py, with ``device`` in place of
``backend``. Memory-bounded compression of arbitrarily large inputs:

    0   u32  magic "HTPS" (0x48545053)
    4   u8   version (1)
    5   u8[3] reserved
    records, until a zero size:
        u32  inner container byte length
        ...  inner HTPU blob
    u32  0 (end marker)
    u64  total original byte count
    u32  CRC32 of the concatenated original data

Each chunk is an independent HTPU container with its own codebook. Up to
``pipeline`` chunks are in flight in a thread pool; on the card every
thread launches on PyTorch's default stream of the chunk's device, so
their kernels run in launch order, and each call allocates its own device
buffers. Records are written in order, so the bytes do not depend on
``pipeline``.
"""

from __future__ import annotations

import io
import zlib
from concurrent.futures import ThreadPoolExecutor

import torch

from ..device import resolve_device
from . import HTPS_MAGIC, block_format

MAGIC = HTPS_MAGIC
DEFAULT_CHUNK_BYTES = 16 << 20
DEFAULT_PIPELINE = 2  # in-flight chunks (1 = serial)


def _pinned(device: str | torch.device) -> torch.device:
    """``device`` resolved, with a CUDA device's index made explicit: the
    pool's threads start on device 0 whatever the caller's current
    device is."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _on(dev: torch.device, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with ``dev`` as the thread's current CUDA
    device (the kernels launch on its current stream)."""
    if dev.type != "cuda":
        return fn(*args, **kwargs)
    with torch.cuda.device(dev):
        return fn(*args, **kwargs)


def compress_stream(
    src, dst, chunk_bytes: int = DEFAULT_CHUNK_BYTES,
    device: str | torch.device = "cuda", pipeline: int = DEFAULT_PIPELINE,
    **kwargs,
) -> int:
    """Read from file-like ``src``, write an HTPS stream to ``dst``.
    Returns the compressed byte count. ``kwargs`` go to
    ``block_format.compress`` for every chunk.

    Reading and the CRC of chunk N+1 overlap the compression of chunk N;
    record order, and therefore the output bytes, are those of the serial
    path."""
    if chunk_bytes < 2:
        raise ValueError("chunk_bytes must be >= 2")
    dev = _pinned(device)
    chunk_bytes &= ~1  # keep chunks pair-aligned (except the last)
    dst.write(int(MAGIC).to_bytes(4, "little") + bytes([1, 0, 0, 0]))
    written = 8
    total = 0
    crc = 0
    pipeline = max(1, int(pipeline))

    def job(chunk: bytes) -> bytes:
        return _on(dev, block_format.compress, chunk, dev, **kwargs)

    with ThreadPoolExecutor(max_workers=pipeline) as pool:
        pending: list = []
        while True:
            chunk = src.read(chunk_bytes)
            if not chunk:
                break
            total += len(chunk)
            crc = zlib.crc32(chunk, crc)
            pending.append(pool.submit(job, chunk))
            if len(pending) >= pipeline:
                blob = pending.pop(0).result()
                dst.write(len(blob).to_bytes(4, "little"))
                dst.write(blob)
                written += 4 + len(blob)
        for fut in pending:
            blob = fut.result()
            dst.write(len(blob).to_bytes(4, "little"))
            dst.write(blob)
            written += 4 + len(blob)
    dst.write((0).to_bytes(4, "little"))
    dst.write(total.to_bytes(8, "little"))
    dst.write((crc & 0xFFFFFFFF).to_bytes(4, "little"))
    return written + 16


def decompress_stream(
    src, dst, device: str | torch.device = "cuda",
    pipeline: int = DEFAULT_PIPELINE,
) -> int:
    """Read an HTPS stream from ``src``, write original bytes to ``dst``.
    Returns the original byte count; raises ValueError on corruption.

    Records decode through a ``pipeline``-deep thread pool; writes, and
    the CRC fold, stay in record order, so corruption is reported
    deterministically."""
    dev = _pinned(device)
    head = src.read(8)
    if len(head) < 8 or int.from_bytes(head[0:4], "little") != MAGIC:
        raise ValueError("not an HTPS stream")
    if head[4] != 1:
        raise ValueError(f"unsupported HTPS version {head[4]}")
    total = 0
    crc = 0
    pipeline = max(1, int(pipeline))

    def job(blob: bytes) -> bytes:
        return _on(dev, block_format.decompress, blob, dev)

    def drain(fut) -> None:
        nonlocal total, crc
        data = fut.result()
        crc = zlib.crc32(data, crc)
        total += len(data)
        dst.write(data)

    with ThreadPoolExecutor(max_workers=pipeline) as pool:
        pending: list = []
        while True:
            size_b = src.read(4)
            if len(size_b) < 4:
                raise ValueError("truncated HTPS stream (missing end marker)")
            size = int.from_bytes(size_b, "little")
            if size == 0:
                break
            blob = src.read(size)
            if len(blob) < size:
                raise ValueError("truncated HTPS record")
            pending.append(pool.submit(job, blob))
            if len(pending) >= pipeline:
                drain(pending.pop(0))
        for fut in pending:
            drain(fut)
    tail = src.read(12)
    if len(tail) < 12:
        raise ValueError("truncated HTPS footer")
    want_total = int.from_bytes(tail[0:8], "little")
    want_crc = int.from_bytes(tail[8:12], "little")
    if total != want_total:
        raise ValueError("HTPS size mismatch")
    if (crc & 0xFFFFFFFF) != want_crc:
        raise ValueError("HTPS stream CRC mismatch")
    return total


def compress_bytes(data: bytes, **kwargs) -> bytes:
    out = io.BytesIO()
    compress_stream(io.BytesIO(data), out, **kwargs)
    return out.getvalue()


def decompress_bytes(blob: bytes, **kwargs) -> bytes:
    out = io.BytesIO()
    decompress_stream(io.BytesIO(blob), out, **kwargs)
    return out.getvalue()
