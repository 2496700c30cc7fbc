"""The byte counts behind the roofline shares, on known shapes."""

from __future__ import annotations

import numpy as np
import pytest

from codec_bench import roofline
from codec_bench.entries import htpu as htpu_entry
from codec_bench.reference import htpu


def test_counts_and_share():
    assert roofline.decode_bytes(1000, 10) == 1040
    # 3.35e12 bytes in one second of kernels is the whole bandwidth.
    assert roofline.share_pct(335 * 10**10, 1.0, "NVIDIA H100 80GB HBM3") == pytest.approx(100.0)
    assert roofline.share_pct(335 * 10**9, 0.5, "NVIDIA H100 80GB HBM3") == pytest.approx(20.0)
    assert roofline.share_pct(1000, 1.0, "cpu") is None
    assert roofline.share_pct(1000, 0.0, "NVIDIA H100 80GB HBM3") is None


def test_stream_words_of_known_containers():
    # 4096 pairs of one symbol: 8 blocks of 512 one-bit codes, 16 words a
    # block. A lane's stream is its words 0 and 1, preloaded, and one refill
    # for each word its bits complete, words 2 .. 17 (the last two zero):
    # 18 words a lane, in one group of 8 real lanes.
    data = b"\x05\x00" * 4096
    blob = htpu.encode(data)
    c = htpu.Container(blob)
    assert c.group_words.tolist() == [8 * 18]
    assert htpu_entry.stream_words(blob) == 8 * 18
    # A stored container has no stream words.
    raw = np.random.default_rng(0).integers(0, 256, 4096, dtype=np.uint8).tobytes()
    assert htpu.Container(htpu.encode(raw)).stored
    assert htpu_entry.stream_words(htpu.encode(raw)) == 0
