"""The repo's benchmark corpora, made from a seed.

``silesia_like`` and ``zipf_pairs`` are the JAX package's own generators
(huffman_tpu/utils/benchmark.py, host-only numpy), so both packages
measure the same bytes; ``wide30k`` is bench.py's 30,000-symbol corpus.
"""

from __future__ import annotations

import numpy as np

from huffman_tpu.utils.benchmark import silesia_like, zipf_pairs

__all__ = ["silesia_like", "wide30k", "zipf_pairs"]


def wide30k(n_bytes: int, seed: int = 3) -> np.ndarray:
    """Zipf byte pairs over 30,000 distinct symbols, as bench.py builds
    its wide-alphabet corpus."""
    return zipf_pairs(n_bytes, 30000, np.random.default_rng(seed))
