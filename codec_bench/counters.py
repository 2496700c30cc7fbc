"""The codec's own counters, as ``<codec>.utils.profiling.counters()``
keeps them: per root span (``compress``, ``decompress``), the totals since
the process started, set-up and window included. A codec without them
gives None, and so does a root with no calls."""

from __future__ import annotations

import importlib

# The bytes a direction's ratios are taken over: compress's input,
# decompress's output.
DATA_BYTES = {"compress": "bytes_in", "decompress": "bytes_out"}


def of_root(counts: dict | None, root: str) -> dict | None:
    """``counts[root]`` where that root was called and moved data."""
    c = (counts or {}).get(root) or {}
    return c if c.get("calls") and c.get(DATA_BYTES[root]) else None


def snapshot(t) -> dict | None:
    """The codec's counters in this process (``t.package_dir`` names the
    codec's package), or None where it keeps none."""
    try:
        profiling = importlib.import_module(f"{t.package_dir.name}.utils.profiling")
    except ImportError:
        return None
    read = getattr(profiling, "counters", None)
    return read() if callable(read) else None
