"""Where the port's first-use builds go, and the lock around them.

Both libraries the port compiles at first use (the CUDA kernels of
``runtime/kernels.py`` and the host runtime of ``runtime/native.py``) are
written to ``<package parent>/build/huffman_tpu_torch`` when that can be
written, which is every source checkout. An installed package whose
parent cannot be written builds into ``$XDG_CACHE_HOME/huffman_tpu_torch``
(``~/.cache/huffman_tpu_torch`` where that variable is unset) instead.

Several processes may build at once (test workers, HTPS threads): each
build writes a temporary file and ``os.replace``-s it into place under an
exclusive ``flock`` on ``<build dir>/.lock``, so a library is compiled
once and never seen half written.
"""

from __future__ import annotations

import contextlib
import fcntl
import os
from pathlib import Path

LOCAL_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "huffman_tpu_torch"


def _writable(path: Path) -> bool:
    """Whether ``path`` exists as a writable directory or could be created:
    its nearest existing ancestor is a writable directory."""
    for p in (path, *path.parents):
        if p.exists():
            return p.is_dir() and os.access(p, os.W_OK | os.X_OK)
    return False


def build_dir() -> Path:
    """The directory the port's libraries are built into (see the module
    docstring); not created here."""
    if _writable(LOCAL_BUILD_DIR):
        return LOCAL_BUILD_DIR
    cache = os.environ.get("XDG_CACHE_HOME") or str(Path.home() / ".cache")
    return Path(cache) / "huffman_tpu_torch"


@contextlib.contextmanager
def locked(directory: Path):
    """Hold the exclusive build lock of ``directory`` (created if needed)."""
    directory.mkdir(parents=True, exist_ok=True)
    with open(directory / ".lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
