"""Host milliseconds per GB of input (compress) or output (decompress) in
the codec's own host stages, read from the profiled pass's program spans:
the ``htpu.*`` ranges that the codec opens around its stages of work
(``<codec>.utils.profiling.span``). It sums the self time of the
direction's host stages (``HOST``): a span's duration less the part of it
that the spans nested in it cover. Copies, launches and waits for the card
lie in other spans, and are left out. The sum's share of the profiled
calls' time is scaled to the pass's wall time in the window, where nothing
is instrumented, as ``host_container_ms_per_GB`` scales cProfile's share:
the few profiled calls run slower or faster than the window's mean, while
the stages' share of them holds (on an H100's host, 54–58% of a call
profiled, 55–60% timed by the host clock alone). Standard error gives the
unscaled figure beside it.

The reader also prints a table on standard error: each span's self time a
call, and the card's idle time a call inside the calls put down to the
innermost program span open at each instant, with the idle time no program
span covers. Spans of one thread only: the calls are single-threaded."""

from __future__ import annotations

import sys

NEEDS = {"profile"}
PREFIX = "htpu."
HOST = {"decompress": ("parse", "pad", "bytes", "crc32"), "compress": ("header", "crc32", "emit")}
UNCOVERED = "(no program span)"


def program_spans(host: list[tuple[str, float, float]]) -> list[tuple[str, float, float]]:
    """The ``htpu.*`` events of a trace's host events, named without the
    prefix."""
    return [(n[len(PREFIX):], a, b) for n, a, b in host if n.startswith(PREFIX)]


def self_seconds(spans: list[tuple[str, float, float]]) -> dict[str, float]:
    """Each span name's summed self time. Spans nest: a span's direct
    children lie inside it and apart from each other, so what they cover
    is the sum of their durations."""
    own = [b - a for _, a, b in spans]
    stack: list[int] = []
    for i in sorted(range(len(spans)), key=lambda i: (spans[i][1], -spans[i][2], i)):
        _, a, b = spans[i]
        while stack and not (a >= spans[stack[-1]][1] and b <= spans[stack[-1]][2]):
            stack.pop()
        if stack:
            own[stack[-1]] -= b - a
        stack.append(i)
    out: dict[str, float] = {}
    for (name, _, _), s in zip(spans, own):
        out[name] = out.get(name, 0.0) + max(s, 0.0)
    return out


def idle_by_span(gaps: list[tuple[float, float]],
                 spans: list[tuple[str, float, float]]) -> dict[str, float]:
    """Seconds of the gaps put down to the innermost span open across each
    piece of them (the one opened last), else to ``UNCOVERED``."""
    out: dict[str, float] = {}
    for g0, g1 in gaps:
        near = [s for s in spans if s[2] > g0 and s[1] < g1]
        cuts = sorted({g0, g1, *(x for _, a, b in near for x in (a, b) if g0 < x < g1)})
        for x0, x1 in zip(cuts, cuts[1:]):
            open_ = [(a, -b, name) for name, a, b in near if a <= x0 and b >= x1]
            name = max(open_)[2] if open_ else UNCOVERED
            out[name] = out.get(name, 0.0) + (x1 - x0)
    return out


def table(spans, gaps, n_calls: int) -> str:
    """The per-call table of self and idle time by span."""
    own = self_seconds(spans)
    idle = idle_by_span(gaps, spans)
    idle_s = sum(idle.values())
    rows = [f"program spans over {n_calls} calls, ms a call: self time, the card's idle time "
            f"under the innermost span, its share of the idle time"]
    for name in sorted(set(own) | set(idle), key=lambda k: -idle.get(k, 0.0)):
        i = idle.get(name, 0.0)
        rows.append(f"  {name:<18} self {1e3 * own.get(name, 0.0) / n_calls:9.3f}  "
                    f"idle {1e3 * i / n_calls:9.3f}  {100 * i / idle_s if idle_s else 0.0:6.2f}%")
    covered = 1.0 - idle.get(UNCOVERED, 0.0) / idle_s if idle_s else 0.0
    rows.append(f"  idle inside the calls {1e3 * idle_s / n_calls:.3f} ms a call, "
                f"{100 * covered:.2f}% of it under program spans")
    return "\n".join(rows)


def read(t, qualifier: str):
    if qualifier != t.direction or t.device is None or not t.device.window_s:
        return None
    spans = program_spans(t.device.host)
    if not any(name == qualifier for name, _, _ in spans):
        return None
    print(table(spans, t.device.gaps(), max(len(t.device.calls), 1)), file=sys.stderr, flush=True)
    own = self_seconds(spans)
    host_s = sum(own.get(name, 0.0) for name in HOST[qualifier])
    per_gb = 1e3 / (t.pass_bytes / 1e9)
    scaled = host_s / t.device.window_s * t.pass_wall_s * per_gb if t.pass_wall_s else None
    print(f"  host stages {', '.join(HOST[qualifier])}: {100 * host_s / t.device.window_s:.2f}% "
          f"of the profiled calls' time; unscaled {host_s * per_gb:.3f} ms/GB in them, scaled "
          f"to the window's pass time {scaled if scaled is None else f'{scaled:.3f}'} ms/GB",
          file=sys.stderr, flush=True)
    return scaled
