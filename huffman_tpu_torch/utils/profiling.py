"""Profiling helpers: counterpart of huffman_tpu/utils/profiling.py.

``trace(log_dir)`` records a block with ``torch.profiler`` (host ops, and
the card's kernels and copies where CUDA is available) and writes a Chrome
trace into ``log_dir`` (open it in Perfetto or chrome://tracing). Unlike
the JAX version, a profiler failure raises instead of yielding None: a
trace that silently went missing reads as a run without device work.

``span(name)`` marks a stage of the codec's own work. While a
``torch.profiler`` session records, a span is a profiler range named
``htpu.<name>``, so the stages land in the same trace as the card's
kernels and copies, on the same clock; otherwise it opens no range. Spans
nest on a stack per thread; a span opened on an empty stack is a root
(``compress``, ``decompress``, and ``load``, which holds a container on a
device: ``block_format.ResidentContainer``). A root counts its ``calls``.
``count(name, n)`` adds to the open root's counter (nothing where no root
is open), ``copied(src, dst)`` counts a copy between unpinned host memory
and a CUDA device as ``h2d_pageable_bytes`` or ``d2h_pageable_bytes``, and
``counters()`` is a snapshot ``{root: {counter: total}}`` of the totals
since the process started.

Whether or not a profiler records, each span boundary also counts the
host memory made resident since the last one, put down to the innermost
span then open, under one of two names:

* ``faults``, ``faults.<name>``: the calling thread's minor page faults,
  where the kernel counts them. Each thread counts its own.
* ``resident_pages``, ``resident_pages.<name>``: where the kernel counts no
  faults (gVisor reads 0), the pages by which the process's resident set
  grew since the last boundary of any thread. This is fewer than the pages
  faulted in: a buffer mapped and unmapped between two boundaries does not
  show. Each page of growth is counted at most once: with several threads
  at work it goes to whichever thread meets a boundary next, to its
  innermost open span, and is dropped where that thread has none open.

The root's ``faults`` or ``resident_pages`` is the sum over its spans; the
per-span counts are for diagnosis.

The JAX module's ``dump_hlo`` has no counterpart: the port's kernels are
compiled by ``nvcc``, and the compiler's view of them is the ptxas report
(registers, spills) that ``chip_smoke.py`` prints after the build.
"""

from __future__ import annotations

import contextlib
import os
import resource
import tempfile
import threading
import time
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(log_dir: str | os.PathLike | None = None):
    """Profile the block; yields the profiler (``key_averages()`` and the
    like are read after the block) and writes
    ``log_dir/trace_<pid>_<ns>.json`` at its end. ``log_dir`` defaults to
    ``htpu-torch-trace`` in the temporary directory."""
    out_dir = Path(log_dir or Path(tempfile.gettempdir()) / "htpu-torch-trace")
    out_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out_dir / f"trace_{os.getpid()}_{time.time_ns()}.json"))


_lock = threading.Lock()
_totals: dict[str, dict[str, int]] = {}
_statm: int | None = None  # a descriptor of /proc/self/statm, opened at first use
_resident_last: int | None = None  # the resident pages at the last boundary
FAULTS, RESIDENT = "faults", "resident_pages"
_memory: str | None = None  # which of the two this process counts, chosen at the first span


class _Thread(threading.local):
    def __init__(self):
        self.stack: list[str] = []  # the open spans, outermost first
        self.last = 0  # the thread's fault count at its last span boundary


_thread = _Thread()


def _minor_faults() -> int:
    """The calling thread's minor page faults, as the kernel counts them."""
    return resource.getrusage(resource.RUSAGE_THREAD).ru_minflt


def _resident_pages() -> int:
    """The process's resident pages."""
    global _statm
    if _statm is None:
        _statm = os.open("/proc/self/statm", os.O_RDONLY)
    return int(os.pread(_statm, 128, 0).split()[1])


def _after_fork() -> None:
    global _statm, _resident_last
    _statm = _resident_last = None  # a forked child reads its own file


os.register_at_fork(after_in_child=_after_fork)


def _memory_counter() -> str:
    global _memory
    if _memory is None:
        # A kernel that counts faults has counted thousands by now; gVisor
        # counts none, and its resident set is what shows fresh pages.
        counts = resource.getrusage(resource.RUSAGE_SELF).ru_minflt > 0
        _memory = FAULTS if counts else RESIDENT
    return _memory


def _add(root: str, items) -> None:
    with _lock:
        counts = _totals.setdefault(root, {})
        for name, n in items:
            counts[name] = counts.get(name, 0) + n


def _boundary(t: _Thread) -> None:
    """Put the memory made resident since the last span boundary down to
    the innermost open span and to its root's total."""
    global _resident_last
    name = _memory_counter()
    if name == FAULTS:
        now = _minor_faults()
        n, t.last = now - t.last, now
    else:
        with _lock:
            now = _resident_pages()
            n = 0 if _resident_last is None else now - _resident_last
            _resident_last = now
    if n > 0 and t.stack:
        _add(t.stack[0], ((name, n), (f"{name}.{t.stack[-1]}", n)))


class span:
    """``with span(name):`` marks one stage (see the module docstring)."""

    __slots__ = ("name", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = None
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function("htpu." + self.name)
            self._range.__enter__()
        t = _thread
        _boundary(t)
        t.stack.append(self.name)
        return self

    def __exit__(self, *exc):
        t = _thread
        _boundary(t)
        t.stack.pop()
        if not t.stack:
            _add(self.name, ((_memory_counter(), 0), ("calls", 1)))
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` of the open root; nothing where no
    root is open."""
    stack = _thread.stack
    if stack:
        _add(stack[0], ((name, int(n)),))


def copied(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Count the copy of ``src`` into ``dst`` and return ``dst``: its
    bytes are ``h2d_pageable_bytes`` where an unpinned host tensor went to
    a CUDA device, ``d2h_pageable_bytes`` where a CUDA tensor came to an
    unpinned host tensor, and nothing else (a copy that stays on one side,
    or one through pinned memory, which the card reaches directly)."""
    if src.is_cuda != dst.is_cuda:
        host = dst if src.is_cuda else src
        if not host.is_pinned():
            count("d2h_pageable_bytes" if src.is_cuda else "h2d_pageable_bytes", src.nbytes)
    return dst


def counters() -> dict[str, dict[str, int]]:
    """A snapshot of every root's counters: ``{root: {counter: total}}``
    since the process started."""
    with _lock:
        return {root: dict(c) for root, c in _totals.items()}
