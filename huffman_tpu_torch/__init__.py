"""huffman_tpu_torch: the PyTorch/CUDA port of huffman_tpu.

It compresses to and decompresses from the native HTPU v2 container,
byte-identical to the JAX package, with the device work in four CUDA
kernels written for Hopper (``csrc/``, built with ``nvcc`` at first use).
The host-only parts of ``huffman_tpu`` (codebook, container headers,
interleave protocol, native runtime) are imported from it, not copied.
This package never imports JAX.

Public API:
    compress(data, device, ...) / decompress(blob, device)
    resolve_device(device)
"""

from .api import compress, decompress
from .device import resolve_device

__all__ = ["compress", "decompress", "resolve_device"]
