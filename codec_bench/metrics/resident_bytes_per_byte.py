"""Device bytes a resident container holds per byte it restores: the
codec's own counters ``resident_bytes`` over ``original_bytes`` under its
``load`` root, where it loads containers to the card to decode them there
(``counters.py``). K1 reads the held streams in full each call. A count:
every run of a cell reads the same. None for a codec without that root."""

from codec_bench import counters

NEEDS = {"profile"}
ROOT = "load"


def value(counts: dict | None):
    c = (counts or {}).get(ROOT) or {}
    if not c.get("calls") or not c.get("original_bytes") or "resident_bytes" not in c:
        return None
    return c["resident_bytes"] / c["original_bytes"]


def read(t, qualifier: str):
    if t.direction != "decompress":
        return None
    return value(counters.snapshot(t))
