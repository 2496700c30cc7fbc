"""Bytes copied between unpinned host memory and the card per byte of
input (compress) or output (decompress): the codec's own counters
``h2d_pageable_bytes`` and ``d2h_pageable_bytes`` under the direction's
root span, over its ``bytes_in`` or ``bytes_out`` (``counters.py``). A
count: every run of a cell reads the same. Copies through pinned memory
do not count, so a codec that reuses pinned host buffers reads 0."""

from codec_bench import counters

NEEDS = {"profile"}


def value(counts: dict | None, direction: str):
    c = counters.of_root(counts, direction)
    if c is None:
        return None
    copied = c.get("h2d_pageable_bytes", 0) + c.get("d2h_pageable_bytes", 0)
    return copied / c[counters.DATA_BYTES[direction]]


def read(t, qualifier: str):
    if qualifier != t.direction:
        return None
    return value(counters.snapshot(t), qualifier)
