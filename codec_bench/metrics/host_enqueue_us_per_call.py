"""Host microseconds a resident call takes to enqueue its work: the
codec's own counter ``host_enqueue_ns`` under the ``decompress`` root (each
resident call's host time less its blocking read of the card's answer)
over ``resident_calls`` (``counters.py``). The counter runs in every call,
and in most of them no profiler records, so the profiler's own cost on the
host barely shows. Once the card waits on the host, this sets the pace.

None where the codec keeps no such counter (an older codec, or one that
holds no container on the card), or for the other direction."""

from __future__ import annotations

from codec_bench import counters

NEEDS = {"profile"}
ROOT = "decompress"


def value(counts: dict | None) -> float | None:
    c = (counts or {}).get(ROOT) or {}
    if not c.get("resident_calls") or "host_enqueue_ns" not in c:
        return None
    return c["host_enqueue_ns"] / c["resident_calls"] / 1e3


def read(t, qualifier: str):
    if qualifier != t.direction or qualifier != ROOT:
        return None
    return value(counters.snapshot(t))
