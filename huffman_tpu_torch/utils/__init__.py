"""Measurement helpers of the PyTorch port: ``timing``, ``profiling`` and
``benchmark``, counterparts of huffman_tpu/utils/ of the same names."""

from . import benchmark, profiling, timing

__all__ = ["benchmark", "profiling", "timing"]
