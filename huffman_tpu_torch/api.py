"""Public compress/decompress of the PyTorch port (counterpart of
huffman_tpu/api.py): the native HTPU container (v2 and v1), HTPX sharded
archives, HTPS streams, and the reference ``.compressed`` format; and
``ResidentContainer``, an HTPU container held on the card, which
``decompress`` decodes into a tensor there (the port's own: the JAX package
has no counterpart)."""

from __future__ import annotations

import torch

from .codebook import Codebook
from .container import block_format, detect, reference_format, sharded, streaming
from .container.block_format import ResidentContainer
from .device import resolve_device
from .runtime import native


def compress(
    data: bytes,
    device: str | torch.device = "cuda",
    block_symbols: int = 512,
    max_code_len: int | None = 18,
    codebook: Codebook | None = None,
    mode: str = "interleaved",
    embed_codebook: bool = True,
    n_shards: int | None = None,
) -> bytes:
    """Compress ``data`` to an HTPU container, v2 (``mode="interleaved"``)
    or v1 (``mode="blocks"``), encoding on ``device`` (the card unless the
    caller asks for "cpu"; without a card "cuda" raises). Byte-identical to
    ``huffman_tpu.compress(data, backend="numpy")`` with the same
    arguments. ``codebook`` is the port's ``Codebook``; one built by the
    JAX package carries over as ``Codebook.from_lengths(np.asarray(
    jax_codebook.lengths))``. ``embed_codebook=False`` leaves the given
    codebook out of the container; ``decompress`` then needs it.
    ``n_shards`` > 1 writes an HTPX sharded archive (global codebook),
    whose shards build their own containers: it takes no ``codebook``."""
    dev = resolve_device(device)
    if n_shards and n_shards > 1:
        if codebook is not None or not embed_codebook:
            raise ValueError("n_shards > 1 builds its own codebook: pass no codebook")
        return sharded.compress(
            data, n_shards=n_shards, device=dev, block_symbols=block_symbols,
            max_code_len=max_code_len, mode=mode,
        )
    return block_format.compress(
        data, dev, block_symbols, max_code_len, codebook, mode, embed_codebook,
    )


def decompress(
    blob: bytes | ResidentContainer,
    device: str | torch.device = "cuda",
    codebook: Codebook | None = None,
    verify_crc: bool = True,
) -> bytes | torch.Tensor:
    """Decompress a native container (HTPU block, HTPX sharded archive, or
    HTPS stream, told apart by magic), decoding on ``device`` (the card
    unless the caller asks for "cpu"). ``codebook`` (for an HTPU container
    that stores none) and ``verify_crc=False`` (skip the CRC32 check)
    apply to HTPU containers. Other blobs raise ``ValueError``.

    A ``ResidentContainer`` in place of the bytes is decoded on the device
    that holds it, whatever ``device`` says (``codebook`` is not read), and
    the result is a new ``torch.uint8`` tensor of the original bytes there,
    not ``bytes``."""
    if isinstance(blob, ResidentContainer):
        return block_format.decompress(blob, blob.device, verify_crc=verify_crc)
    dev = resolve_device(device)
    kind = detect(blob)
    if kind == "htpx":
        return sharded.decompress(blob, dev)
    if kind == "htps":
        return streaming.decompress_bytes(blob, device=dev)
    return block_format.decompress(blob, dev, verify_crc=verify_crc, codebook=codebook)


def compress_reference(data: bytes, device: str | torch.device = "cuda") -> bytes:
    """Compress to the reference ``.compressed`` format, packing the
    payload on ``device``. Byte-identical to
    ``huffman_tpu.compress_reference(data)``."""
    return reference_format.compress(bytes(data), resolve_device(device))


def decompress_reference(blob: bytes) -> bytes:
    """Decompress a reference ``.compressed`` container on the host (the
    format has one serial stream): by the native runtime's C++ decoder,
    which raises ``runtime.native.NativeError`` (a ``RuntimeError``) on a
    corrupt blob, as ``huffman_tpu.decompress_reference`` does; by a Python
    loop over its symbols where that runtime cannot be built."""
    if native.available():
        return native.decompress_reference(blob)
    return reference_format.decompress(blob)
