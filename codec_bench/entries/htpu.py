"""HTPU v2 containers, one a call: ``huffman_tpu_torch.compress(data)`` and
``huffman_tpu_torch.decompress(blob)``."""

from __future__ import annotations

from codec_bench.reference import htpu


def program(ht, direction: str, settings: dict, device):
    """The codec's call for ``direction``: payload bytes in, bytes out."""
    if direction == "compress":
        return lambda data: ht.compress(
            data, device=device, block_symbols=settings["block_symbols"],
            max_code_len=settings["max_code_len"], mode=settings["mode"],
            embed_codebook=settings["embed_codebook"],
        )
    return lambda blob: ht.decompress(blob, device=device)


def reference_job(data: bytes, settings: dict) -> tuple:
    """(function, arguments) whose result is the container that compress
    must write."""
    return htpu.encode, (data, settings["block_symbols"], settings["max_code_len"])


def control(direction: str, settings: dict):
    """The reference in the codec's place, with one stated guarantee
    broken: compress leaves the CRC32 out of the header; decompress skips
    the block-by-block reorder of the decoded lanes (and the CRC check that
    would catch it)."""
    if direction == "compress":
        return lambda data: htpu.encode(
            data, settings["block_symbols"], settings["max_code_len"], crc=False)
    return lambda blob: htpu.decode(blob, reorder=False, verify=False)


def stream_words(blob: bytes) -> int:
    return htpu.Container(blob).stream_words
