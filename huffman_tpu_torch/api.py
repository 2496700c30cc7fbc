"""Public compress/decompress of the PyTorch port (counterpart of
huffman_tpu/api.py): the native HTPU container (v2 and v1) and the
reference ``.compressed`` format."""

from __future__ import annotations

import torch

from .codebook import Codebook
from .container import block_format, detect, reference_format
from .device import resolve_device

_NOT_PORTED = {
    "htps": "HTPS stream containers: ROADMAP.md, Queue 1, front-ends and HTPS/HTPX",
    "htpx": "HTPX sharded archives: ROADMAP.md, Queue 1, front-ends and HTPS/HTPX",
}


def compress(
    data: bytes,
    device: str | torch.device = "cuda",
    block_symbols: int = 512,
    max_code_len: int | None = 18,
    codebook: Codebook | None = None,
    mode: str = "interleaved",
    embed_codebook: bool = True,
) -> bytes:
    """Compress ``data`` to an HTPU container, v2 (``mode="interleaved"``)
    or v1 (``mode="blocks"``), encoding on ``device`` (the card unless the
    caller asks for "cpu"; without a card "cuda" raises). Byte-identical to
    ``huffman_tpu.compress(data, backend="numpy")`` with the same
    arguments. ``codebook`` is the port's ``Codebook``; one built by the
    JAX package carries over as ``Codebook.from_lengths(np.asarray(
    jax_codebook.lengths))``. ``embed_codebook=False`` leaves the given
    codebook out of the container; ``decompress`` then needs it."""
    return block_format.compress(
        data, resolve_device(device), block_symbols, max_code_len, codebook,
        mode, embed_codebook,
    )


def decompress(
    blob: bytes,
    device: str | torch.device = "cuda",
    codebook: Codebook | None = None,
    verify_crc: bool = True,
) -> bytes:
    """Decompress an HTPU container, decoding on ``device`` (the card
    unless the caller asks for "cpu"). ``codebook`` is needed for a
    container that stores none; ``verify_crc=False`` skips the CRC32
    check. HTPS and HTPX containers raise ``NotImplementedError``; other
    blobs raise ``ValueError``."""
    dev = resolve_device(device)
    kind = detect(blob)
    if kind in _NOT_PORTED:
        raise NotImplementedError(f"not ported yet: {_NOT_PORTED[kind]}")
    return block_format.decompress(blob, dev, verify_crc=verify_crc, codebook=codebook)


def compress_reference(data: bytes, device: str | torch.device = "cuda") -> bytes:
    """Compress to the reference ``.compressed`` format, packing the
    payload on ``device``. Byte-identical to
    ``huffman_tpu.compress_reference(data)``."""
    return reference_format.compress(bytes(data), resolve_device(device))


def decompress_reference(blob: bytes) -> bytes:
    """Decompress a reference ``.compressed`` container on the host, with
    a Python loop over its symbols (the format has one serial stream)."""
    return reference_format.decompress(blob)
