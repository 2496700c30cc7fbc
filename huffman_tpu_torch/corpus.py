"""The repo's benchmark corpora, made from a seed.

``zipf_pairs`` and ``silesia_like`` are the port's own copies of the JAX
package's generators (huffman_tpu/utils/benchmark.py): the same seed gives
the same bytes, so both packages measure the same inputs. ``wide30k`` is
bench.py's 30,000-symbol corpus. ``fibonacci_pairs`` is the input whose
unlimited Huffman code is deepest for its size: codes past the 26 bits of
the kernels' ``len << 26 | code`` word.
"""

from __future__ import annotations

import numpy as np

__all__ = ["fibonacci_pairs", "silesia_like", "wide30k", "zipf_pairs"]


def zipf_pairs(
    n_bytes: int,
    n_unique: int,
    rng: np.random.Generator,
    expo: float = 0.65,
) -> np.ndarray:
    """Zipf(expo) byte-pair corpus over ``n_unique`` uniformly drawn 16-bit
    symbols. Returns uint8 bytes, little-endian pairs."""
    a = rng.choice(65536, n_unique, replace=False).astype(np.uint16)
    p = 1.0 / np.arange(1, n_unique + 1) ** expo
    p /= p.sum()
    return rng.choice(a, n_bytes // 2, p=p).astype("<u2").view(np.uint8)


def silesia_like(n_bytes: int, seed: int = 0) -> np.ndarray:
    """Synthetic corpus with text-like symbol statistics: 80% Zipf(1.1)
    text over 3,000 printable byte pairs, 20% uniform noise over 1,024
    pairs. About 4,000 distinct symbols and a ~0.56 ratio."""
    rng = np.random.default_rng(seed)
    n_text = int(n_bytes * 0.8)
    alphabet = rng.choice(128 * 128, size=3000, replace=False).astype(np.uint16)
    ranks = np.arange(1, alphabet.size + 1, dtype=np.float64)
    probs = 1.0 / ranks**1.1
    probs /= probs.sum()
    text_syms = rng.choice(alphabet, size=n_text // 2, p=probs)
    text = text_syms.astype("<u2").view(np.uint8)
    noise_alpha = rng.choice(65536, size=1024, replace=False).astype(np.uint16)
    noise_syms = rng.choice(noise_alpha, size=(n_bytes - text.size) // 2)
    noise = noise_syms.astype("<u2").view(np.uint8)
    out = np.concatenate([text, noise])
    if out.size < n_bytes:  # odd-length tail byte
        out = np.concatenate([out, rng.integers(0, 256, 1, dtype=np.uint8)])
    return out


def wide30k(n_bytes: int, seed: int = 3) -> np.ndarray:
    """Zipf byte pairs over 30,000 distinct symbols, as bench.py builds
    its wide-alphabet corpus."""
    return zipf_pairs(n_bytes, 30000, np.random.default_rng(seed))


def fibonacci_pairs(n_symbols: int = 30, seed: int = 0) -> np.ndarray:
    """Byte pairs of ``n_symbols`` distinct symbols, the k-th occurring
    F(k) times (F(1) = F(2) = 1), shuffled from ``seed``: the unlimited
    two-queue Huffman code gives them depths 1..n_symbols - 1. The default
    30 symbols make 2,178,308 pairs (4.36 MB) and 29-bit codes."""
    fib = [1, 1]
    while len(fib) < n_symbols:
        fib.append(fib[-1] + fib[-2])
    symbols = np.repeat(np.arange(n_symbols, dtype=np.uint16) * 7 + 1000, fib[:n_symbols])
    np.random.default_rng(seed).shuffle(symbols)
    return symbols.astype("<u2").view(np.uint8)
