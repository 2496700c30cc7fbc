"""Public compress/decompress of the PyTorch port (counterpart of
huffman_tpu/api.py), for the native HTPU container only."""

from __future__ import annotations

import torch

from .codebook import Codebook
from .container import block_format, detect
from .device import resolve_device

_NOT_PORTED = {
    "htps": "HTPS stream containers: ROADMAP.md, Queue 1, front-ends and HTPS/HTPX",
    "htpx": "HTPX sharded archives: ROADMAP.md, Queue 1, front-ends and HTPS/HTPX",
    "reference": (
        "the reference .compressed format: ROADMAP.md, Queue 1, "
        "v1 / reference-format device paths"
    ),
}


def compress(
    data: bytes,
    device: str | torch.device = "cuda",
    block_symbols: int = 512,
    max_code_len: int | None = 18,
    codebook: Codebook | None = None,
) -> bytes:
    """Compress ``data`` to an HTPU v2 container, encoding on ``device``
    (the card unless the caller asks for "cpu"; without a card "cuda"
    raises). Byte-identical to ``huffman_tpu.compress(data,
    backend="numpy")`` with the same ``block_symbols``, ``max_code_len``
    and codebook. ``codebook`` is the port's ``Codebook``; one built by the
    JAX package carries over as ``Codebook.from_lengths(np.asarray(
    jax_codebook.lengths))``."""
    return block_format.compress(
        data, resolve_device(device), block_symbols, max_code_len, codebook
    )


def decompress(blob: bytes, device: str | torch.device = "cuda") -> bytes:
    """Decompress an HTPU container, decoding on ``device`` (the card
    unless the caller asks for "cpu"); other container kinds raise
    ``NotImplementedError``."""
    dev = resolve_device(device)
    kind = detect(blob)
    if kind != "htpu":
        raise NotImplementedError(f"not ported yet: {_NOT_PORTED[kind]}")
    return block_format.decompress(blob, dev)
