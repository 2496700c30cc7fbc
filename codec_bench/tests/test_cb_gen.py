"""The input generators: the same seed and index give the same bytes,
others differ, and the draws follow their distributions."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from codec_bench import gen

SILESIA = {"kind": "silesia_like", "text_share": 0.8, "text_pairs": 3000, "text_zipf": 1.1,
           "text_alphabet": 16384, "noise_pairs": 1024, "base_seed": 7, "shuffle_bytes": 1000}
FULL = {"kind": "zipf_pairs", "n_unique": 65536, "zipf": 0.65, "base_seed": 11, "shuffle_bytes": 1000}
CPU = torch.device("cpu")


@pytest.mark.parametrize("content", [SILESIA, FULL], ids=["silesia_like", "zipf_pairs"])
@pytest.mark.parametrize("n_bytes", [100000, 100001])
def test_same_seed_same_bytes(content, n_bytes):
    a = gen.make(content, n_bytes, 2**33 + 5, 3, CPU)
    assert a.dtype == torch.uint8 and a.numel() == n_bytes
    assert torch.equal(a, gen.make(content, n_bytes, 2**33 + 5, 3, CPU))
    assert not torch.equal(a, gen.make(content, n_bytes, 2**33 + 6, 3, CPU))
    assert not torch.equal(a, gen.make(content, n_bytes, 2**33 + 5, 4, CPU))


def test_every_seed_does_the_same_work():
    # Pieces of one interleaved group (1,024 blocks of 512 pairs): the
    # containers of two seeds differ in their bytes and in nothing else.
    from codec_bench.reference import htpu

    content = dict(FULL, n_unique=300, shuffle_bytes=1 << 20)
    a = gen.make(content, 3 << 20, 2**33 + 1, 0, CPU).numpy().tobytes()
    b = gen.make(content, 3 << 20, 2**33 + 2, 0, CPU).numpy().tobytes()
    assert a != b and sorted(a[i:i + (1 << 20)] for i in range(0, len(a), 1 << 20)) == \
        sorted(b[i:i + (1 << 20)] for i in range(0, len(b), 1 << 20))
    ca, cb = htpu.Container(htpu.encode(a)), htpu.Container(htpu.encode(b))
    assert len(htpu.encode(a)) == len(htpu.encode(b)) and ca.stream_words == cb.stream_words


def test_input_seed_takes_any_whole_number():
    seeds = {gen.input_seed(s, i) for s in (0, 1, 2**31 + 1, 2**40, -3) for i in range(3)}
    assert len(seeds) == 15 and all(0 <= s < 2**63 for s in seeds)


def _pairs(t: torch.Tensor) -> np.ndarray:
    return np.frombuffer(t.numpy().tobytes(), "<u2", count=t.numel() // 2)


def _zipf_slope(counts: np.ndarray, lo: int, hi: int) -> float:
    """Least-squares slope of log count against log rank over ranks
    lo..hi (1-based)."""
    c = np.sort(counts[counts > 0])[::-1][lo - 1:hi].astype(np.float64)
    r = np.arange(lo, lo + c.size, dtype=np.float64)
    return float(np.polyfit(np.log(r), np.log(c), 1)[0])


def test_silesia_like_follows_its_distribution():
    n = 4 << 20
    # Unshuffled, so that the text and the noise keep their places.
    pairs = _pairs(gen.make(dict(SILESIA, shuffle_bytes=n + 1), n, 11, 0, CPU))
    n_text = int(n * 0.8) // 2
    text, noise = pairs[:n_text], pairs[n_text:]
    assert np.unique(text).size <= 3000 and text.max() < 16384
    assert np.unique(noise).size == 1024
    # The text's rank-frequency slope is -1.1 over its well-sampled ranks.
    assert abs(_zipf_slope(np.bincount(text), 1, 300) + 1.1) < 0.05
    # The noise is uniform over its 1,024 pairs.
    counts = np.bincount(noise)[np.unique(noise)]
    assert counts.std() / counts.mean() < 5 / np.sqrt(counts.mean())
    assert 3500 <= np.unique(pairs).size <= 4100


def test_zipf_pairs_follows_its_distribution():
    n = 8 << 20
    pairs = _pairs(gen.make(FULL, n, 12, 0, CPU))
    counts = np.bincount(pairs, minlength=65536)
    assert abs(_zipf_slope(counts, 1, 2000) + 0.65) < 0.03
    # The top rank's share is 1 / sum(k ** -0.65).
    expect = 1 / np.sum(np.arange(1, 65537, dtype=np.float64) ** -0.65)
    assert abs(counts.max() / pairs.size - expect) < 0.05 * expect
    assert np.count_nonzero(counts) > 60000
