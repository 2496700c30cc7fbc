"""Host pages made resident per MB (10^6 bytes) of input (compress) or
output (decompress), under the direction's root span, over its
``bytes_in`` or ``bytes_out`` (``counters.py``). A host buffer that the C
heap maps afresh costs a page each 4 KiB every call; one that it hands
back from its free lists costs none.

The codec keeps one of two counters, whichever its kernel allows, and the
reader takes the one the root has, naming it on standard error:
``faults``, the calling thread's minor page faults, where the kernel
counts them (one fresh anonymous page each); ``resident_pages``, where it
counts none, as under gVisor, the card's machine: the pages by which the
process's resident set grew between the codec's span boundaries. That is
fewer than the pages faulted in, since a buffer mapped and unmapped
between two boundaries does not show."""

import sys

from codec_bench import counters

NEEDS = {"profile"}
COUNTERS = ("faults", "resident_pages")


def value(counts: dict | None, direction: str):
    c = counters.of_root(counts, direction)
    if c is None:
        return None
    name = next((k for k in COUNTERS if k in c), None)
    if name is None:
        return None
    print(f"  {direction}: {c[name]} {name} over {c[counters.DATA_BYTES[direction]]} bytes",
          file=sys.stderr, flush=True)
    return c[name] / (c[counters.DATA_BYTES[direction]] / 1e6)


def read(t, qualifier: str):
    if qualifier != t.direction:
        return None
    return value(counters.snapshot(t), qualifier)
