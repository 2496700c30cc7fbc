"""Profiling helper: counterpart of huffman_tpu/utils/profiling.py.

``trace(log_dir)`` records a block with ``torch.profiler`` (host ops, and
the card's kernels and copies where CUDA is available) and writes a Chrome
trace into ``log_dir`` (open it in Perfetto or chrome://tracing). Unlike
the JAX version, a profiler failure raises instead of yielding None: a
trace that silently went missing reads as a run without device work.

The JAX module's ``dump_hlo`` has no counterpart: the port's kernels are
compiled by ``nvcc``, and the compiler's view of them is the ptxas report
(registers, spills) that ``chip_smoke.py`` prints after the build.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
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
