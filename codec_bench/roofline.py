"""The least time a call's work needs on the card, from bytes alone.

A codec moves bytes and does little arithmetic on each, so its bound is the
card's memory bandwidth: every input byte read once and every output byte
written once. Decompress reads the container's stream words and writes
the restored bytes. Headers and codebooks are left out (a few KiB a
container). The count does not depend on how the codec computes, so a
share stays comparable when the kernels change.

``PEAK_BYTES_PER_S``: the published HBM bandwidth of each card, by the name
``torch.cuda.get_device_name()`` gives (NVIDIA's H100 data sheet, SXM part,
80 GB of HBM3 at 3.35 TB/s, at the full power limit of 700 W).
"""

from __future__ import annotations

PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def decode_bytes(output_bytes: int, stream_words: int) -> int:
    return 4 * stream_words + output_bytes


def share_pct(n_bytes: int, kernel_s: float, card: str) -> float | None:
    """The bound's time over ``kernel_s``, in %; None for a card without a
    published peak or no kernel time."""
    peak = PEAK_BYTES_PER_S.get(card)
    if peak is None or kernel_s <= 0:
        return None
    return 100.0 * n_bytes / peak / kernel_s
