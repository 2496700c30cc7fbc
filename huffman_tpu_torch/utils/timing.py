"""Timing: counterpart of huffman_tpu/utils/timing.py, without its
``StageTimer`` (the codec marks its stages with ``utils/profiling.span``,
which does not wait for the card). ``time_fn`` times single calls (CUDA
events when the call's tensors lie on the card, the host clock
otherwise); ``wall_times``
times whole calls on the host clock, synchronising the card before and
after each; ``amortized_time_fn`` times K calls enqueued back to back
between two CUDA events.
"""

from __future__ import annotations

import statistics
import time

import torch


def _tensors(x):
    """The tensors in ``x``: a tensor, or lists, tuples and dicts of them."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def holds_cuda(*xs) -> bool:
    """Whether any tensor in ``xs`` lies on a CUDA device."""
    return any(t.is_cuda for x in xs for t in _tensors(x))


def time_fn(fn, *args, iters: int = 5, warmup: int = 2) -> float:
    """Median seconds of ``iters`` calls of ``fn(*args)`` after ``warmup``
    calls, each timed alone: by CUDA events on the current stream when the
    arguments or the warm-up results hold CUDA tensors, else by the host
    clock."""
    outs = [fn(*args) for _ in range(warmup)]
    if not holds_cuda(args, outs):
        return statistics.median(wall_times(fn, *args, iters=iters, warmup=0))
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return statistics.median(times)


def wall_times(fn, *args, iters: int = 7, warmup: int = 1) -> list[float]:
    """Host-clock seconds of each of ``iters`` calls after ``warmup``: the
    whole call as its caller waits for it, host work included, with
    ``torch.cuda.synchronize()`` before and after each call where CUDA is
    initialised."""
    sync = torch.cuda.synchronize if torch.cuda.is_initialized() else (lambda: None)
    for _ in range(warmup):
        fn(*args)
    times = []
    for _ in range(iters):
        sync()
        t0 = time.perf_counter()
        fn(*args)
        sync()
        times.append(time.perf_counter() - t0)
    return times


def amortized_times(fn, arg, iters: int = 20, reps: int = 3) -> list[float]:
    """Seconds per call of ``fn(arg)`` in each of ``reps`` repetitions,
    each ``iters`` calls enqueued back to back on the current stream
    between two CUDA events, after one warm-up call; by the host clock
    when neither ``arg`` nor the warm-up's result holds CUDA tensors.

    The JAX version chains the iterations through a checksum inside one
    jit program, because XLA could hoist the op out of its loop or drop
    it as dead code. Eager PyTorch runs every launch it is given, so no
    chaining is needed here. A call that reads a result to the host in the
    middle (a size, a count) waits for the card there: such gaps are part
    of its time, as they are of its caller's."""
    out = fn(arg)
    if not holds_cuda(arg, out):
        return [t / iters for t in wall_times(lambda: [fn(arg) for _ in range(iters)],
                                              iters=reps, warmup=0)]
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn(arg)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3 / iters)
    return times


def amortized_time_fn(fn, arg, iters: int = 20, reps: int = 3) -> float:
    """Median seconds per call of ``fn(arg)`` over ``amortized_times``."""
    return statistics.median(amortized_times(fn, arg, iters=iters, reps=reps))
