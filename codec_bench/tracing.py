"""What a ``--trace 1`` run records, in passes over the cell's inputs after
the window, each pass calling every input once:

* ``profile``: ``torch.profiler`` (host and device), read from its Chrome
  trace: the device's kernels, copies and fills, the host's events, and
  the benchmark's ``codec_bench.call`` range around each call. During the
  pass the benchmark's own spans wrap calls into the codec's layers, so
  that idle gaps can be labelled by them: ``spans/*.json`` name the
  functions (``module:attribute``, or ``module:object.attribute`` for a
  function reached through a module the codec imports, such as ``zlib``),
  each replaced by a wrapper that opens a
  ``torch.profiler.record_function`` of its name, then put back.
* ``cprofile``: ``cProfile`` over one pass, for readers of host time by
  file.

A reader (``metrics/``) declares the passes it needs; the run makes those
the cell's metrics need and no others.
"""

from __future__ import annotations

import cProfile
import importlib
import json
import pstats
import tempfile
from dataclasses import dataclass, field
from pathlib import Path

CALL = "codec_bench.call"
DEVICE_CATS = {"kernel": "kernel", "gpu_memcpy": "copy", "gpu_memset": "copy"}
HOST_CATS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function"}


def load_targets(bench_dir: Path) -> list[dict]:
    targets = []
    for path in sorted((bench_dir / "spans").glob("*.json")):
        targets += json.loads(path.read_text())["targets"]
    return targets


class _Proxy:
    """A module's stand-in with one attribute replaced."""

    def __init__(self, module, attr: str, value):
        self._module = module
        setattr(self, attr, value)

    def __getattr__(self, name):
        return getattr(self._module, name)


class Spans:
    """Context that wraps the targets' functions in profiler ranges."""

    def __init__(self, targets: list[dict]):
        self.targets = targets
        self._undo: list[tuple[object, str, object]] = []

    def _wrap(self, fn, name: str):
        import torch

        def wrapper(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return wrapper

    def __enter__(self):
        for t in self.targets:
            module_name, _, path = t["at"].partition(":")
            owner = importlib.import_module(module_name)
            name = t.get("name") or f"{module_name.rsplit('.', 1)[-1]}.{path}"
            if "." in path:  # a function reached through an imported module
                obj, attr = path.split(".")
                inner = getattr(owner, obj)
                proxy = _Proxy(inner, attr, self._wrap(getattr(inner, attr), name))
                self._undo.append((owner, obj, inner))
                setattr(owner, obj, proxy)
            else:
                self._undo.append((owner, path, getattr(owner, path)))
                setattr(owner, path, self._wrap(getattr(owner, path), name))
        return self

    def __exit__(self, *exc):
        for owner, attr, value in reversed(self._undo):
            setattr(owner, attr, value)
        self._undo.clear()


@dataclass
class DeviceTrace:
    """A profiled pass, times in seconds on the profiler's clock."""

    device: list[tuple[str, str, float, float]]  # (name, "kernel" | "copy", start, end)
    host: list[tuple[str, float, float]]
    calls: list[tuple[float, float]]
    busy: list[tuple[float, float]] = field(default_factory=list)  # union, inside calls

    def __post_init__(self):
        merged: list[list[float]] = []
        for _, _, a, b in sorted(self.device, key=lambda e: e[2]):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        for c0, c1 in self.calls:
            for a, b in merged:
                if b > c0 and a < c1:
                    self.busy.append((max(a, c0), min(b, c1)))

    def seconds(self, kind: str) -> float:
        return sum(b - a for _, k, a, b in self.device if k == kind)

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy)

    @property
    def window_s(self) -> float:
        return sum(b - a for a, b in self.calls)

    def gaps(self) -> list[tuple[float, float]]:
        out = []
        for c0, c1 in self.calls:
            t = c0
            for a, b in self.busy:
                if a >= c1 or b <= c0:
                    continue
                if a > t:
                    out.append((t, a))
                t = max(t, b)
            if c1 > t:
                out.append((t, c1))
        return out

    def label(self, g0: float, g1: float) -> str:
        """The innermost host event across the gap; else the one that
        overlaps it most."""
        inside = [(b - a, n) for n, a, b in self.host if a <= g0 and b >= g1 and n != CALL]
        if inside:
            return min(inside)[1]
        overlap = [(min(b, g1) - max(a, g0), n) for n, a, b in self.host
                   if b > g0 and a < g1 and n != CALL]
        return max(overlap)[1] if overlap else "host, no profiler event"

    def breakdown(self, n: int = 10) -> dict:
        ops: dict[str, float] = {}
        for name, _, a, b in self.device:
            ops[name[:120]] = ops.get(name[:120], 0.0) + (b - a)
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n]
        return {
            "device_ops": sorted(([k, v] for k, v in ops.items()), key=lambda e: -e[1])[:n],
            "idle_gaps": [[self.label(a, b), b - a] for a, b in gaps],
        }


def profile(run_pass) -> DeviceTrace:
    """``run_pass()`` under ``torch.profiler``, read from its Chrome trace
    (written under the temporary directory, then deleted)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        run_pass()
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    device, host, calls = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        a = float(e["ts"]) / 1e6
        b = a + float(e["dur"]) / 1e6
        name = str(e.get("name", ""))
        if cat in DEVICE_CATS:
            device.append((name, DEVICE_CATS[cat], a, b))
        elif cat in HOST_CATS:
            host.append((name, a, b))
            if name == CALL and cat == "user_annotation":
                calls.append((a, b))
    return DeviceTrace(device, host, sorted(calls))


def cprofile(run_pass) -> pstats.Stats:
    prof = cProfile.Profile()
    prof.enable()
    try:
        run_pass()
    finally:
        prof.disable()
    return pstats.Stats(prof)


@dataclass
class Traced:
    """What the readers get. Per pass: ``pass_bytes`` is the input bytes
    (compress) or restored bytes (decompress) of every call,
    ``pass_wall_s`` its mean wall time in the window, where nothing is
    instrumented, ``pass_stream_words`` the stream words of its containers
    (None where they could not be parsed)."""

    direction: str
    container: str
    card: str
    package_dir: Path
    pass_bytes: int
    pass_wall_s: float
    pass_stream_words: int | None
    device: DeviceTrace | None = None
    cprofile: pstats.Stats | None = None
