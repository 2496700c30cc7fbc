"""The end-to-end metrics, by name, from a run's window.

* ``setup_s``: seconds from the process's start to the window's start.
* ``<direction>_GBps``: bytes of input (compress) or of restored output
  (decompress) of every call completed in the window, over the window's
  wall time, from the first call's start to the last call's end, less the
  harness's digests of the sampled outputs between calls; 1e9 bytes a GB.
* ``<direction>_p<q>_ms``: the q-th percentile of the latency of every
  call in the window, each ended by ``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import re


def percentile(values: list[float], q: float) -> float:
    """Linear interpolation between the closest ranks (numpy's default)."""
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def value(name: str, window) -> float | None:
    """The metric ``name`` of ``window`` (``run.Window``), or None when the
    name is not one of this cell's."""
    if name == "setup_s":
        return window.setup_s
    m = re.fullmatch(r"(compress|decompress)_GBps", name)
    if m:
        return window.bytes_done / window.wall_s / 1e9 if m[1] == window.direction else None
    m = re.fullmatch(r"(compress|decompress)_p(\d+)_ms", name)
    if m:
        return percentile(window.latencies_s, float(m[2])) * 1e3 if m[1] == window.direction else None
    return None
