"""Host milliseconds per GB of input (compress) or output (decompress) in
the codec's host container layer: its share of a pass under ``cProfile``,
times the pass's wall time in the window, where nothing is instrumented.

cProfile's self times split the profiled pass into parts that do not
overlap. The layer's part is the self time of the functions defined in
the files below, and of each function defined elsewhere that is neither
PyTorch's nor another of the codec's modules (NumPy, zlib's CRC32, bytes
and the interpreter's builtins) as far as the layer calls it: a share of
such a function's time, found from its callers, follows them to the layer
or away from it. The profiler slows Python code more than the rest, so
the share reads somewhat high; it never reads more than the whole pass.
Single-threaded calls only: cProfile sees the calling thread alone."""

NEEDS = {"cprofile"}

FILES = (
    "container/block_format.py", "container/interleave.py",
    "container/reference_format.py", "codebook.py", "bitio.py",
)


def layer_seconds(stats: dict, is_layer, is_other) -> float:
    """The layer's part of ``stats`` (pstats' ``Stats.stats``): functions
    for which ``is_layer(path, name)`` holds count whole, those for which
    ``is_other`` holds not at all, and any other function by the share of
    its time that its callers spend in the layer."""
    fixed = {f: 1.0 if is_layer(f[0], f[2]) else 0.0
             for f in stats if is_layer(f[0], f[2]) or is_other(f[0], f[2])}
    share = {f: fixed.get(f, 0.0) for f in stats}
    for _ in range(64):  # callers before callees; recursion settles
        moved = 0.0
        for f, (_, _, _, _, callers) in stats.items():
            if f in fixed:
                continue
            total = sum(c[3] for c in callers.values())
            s = sum(c[3] * share.get(caller, 0.0) for caller, c in callers.items()) / total \
                if total > 0 else 0.0
            moved = max(moved, abs(s - share[f]))
            share[f] = s
        if moved < 1e-9:
            break
    out = 0.0
    for f, (_, _, self_s, _, callers) in stats.items():
        if f in fixed:
            out += self_s * fixed[f]
        else:
            out += sum(c[2] * share.get(caller, 0.0) for caller, c in callers.items())
    return out


def read(t, qualifier: str):
    if t.container != "htpu" or qualifier != t.direction or t.cprofile is None:
        return None
    layer = {str(t.package_dir / f) for f in FILES}
    package = str(t.package_dir)
    seconds = layer_seconds(
        t.cprofile.stats,
        lambda path, name: path in layer,
        lambda path, name: path.startswith(package) or "torch" in path or "torch" in name,
    )
    profiled_s = t.cprofile.total_tt
    if not seconds or not profiled_s or not t.pass_wall_s:
        return None
    return seconds / profiled_s * t.pass_wall_s * 1e3 / (t.pass_bytes / 1e9)
