"""Host helper of the group-interleaved v2 stream protocol: the port's own
copy of ``pad_streams`` from huffman_tpu/container/interleave.py, NumPy
only.

The protocol (docs/FORMATS.md §3): every lane starts with words 0 and 1
preloaded; at each step it consumes one codeword's bits and refills one
word once fewer than 33 bits remain; refilling lanes of a step take
consecutive stream slots in lane order. Past a lane's data the zero bits
decode as the all-zeros code of length ``min_len``, so the encoder counts
those garbage steps at ``min_len`` to stay in lockstep with the decoder.
"""

from __future__ import annotations

import numpy as np

from ..constants import WINDOW_ROWS


def padded_rows(max_words: int, rows_bucket: int = 64) -> int:
    """Rows of 128 words that hold a group's stream of ``max_words`` words
    plus the decoder's window slack, rounded up to ``rows_bucket`` rows."""
    rows = (max_words + 127) // 128 + WINDOW_ROWS
    return (rows + rows_bucket - 1) // rows_bucket * rows_bucket


def pad_streams(streams: list[np.ndarray], rows_bucket: int = 64) -> tuple[np.ndarray, np.ndarray]:
    """Pad per-group streams to a common row count (``padded_rows`` of the
    longest). Returns (stacked (ngroups*rows, 128) uint32, per-group word
    counts)."""
    counts = np.array([s.size for s in streams], dtype=np.int64)
    rows = padded_rows(int(counts.max(initial=0)), rows_bucket)
    out = np.zeros((len(streams), rows * 128), dtype=np.uint32)
    for g, s in enumerate(streams):
        out[g, : s.size] = s
    return out.reshape(len(streams) * rows, 128), counts
