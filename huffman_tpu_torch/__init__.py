"""huffman_tpu_torch: the PyTorch/CUDA port of huffman_tpu.

It compresses to and decompresses from the native HTPU container (v2
interleaved groups and v1 block slabs), HTPX sharded archives, HTPS
streams and the reference ``.compressed`` format, byte-identical to the
JAX package, with the device work in CUDA kernels
written for Hopper (``csrc/``, built with ``nvcc`` at first use). The host
code it needs from ``huffman_tpu`` (codebook, container header and parser,
interleave protocol helpers, corpora) is copied into this package under
the same module names: it imports nothing of ``huffman_tpu`` and never
imports JAX.

Public API (the command line is ``python -m huffman_tpu_torch``, the
distribution layer ``huffman_tpu_torch.parallel.pipeline``):
    compress(data, device="cuda", ..., n_shards=None) / decompress(blob, device="cuda", ...)
    ResidentContainer(blob, device="cuda"): a container held on the card;
        decompress(handle) decodes it there into a uint8 tensor
    compress_reference(data, device="cuda") / decompress_reference(blob)
    Codebook, code_lengths_from_frequencies
    resolve_device(device)
"""

from .api import (
    ResidentContainer,
    compress,
    compress_reference,
    decompress,
    decompress_reference,
)
from .codebook import Codebook, code_lengths_from_frequencies
from .device import resolve_device

__all__ = [
    "Codebook",
    "ResidentContainer",
    "code_lengths_from_frequencies",
    "compress",
    "compress_reference",
    "decompress",
    "decompress_reference",
    "resolve_device",
]

__version__ = "0.1.0"
