"""Containers of the port. ``detect(blob)`` names a container's kind, as
huffman_tpu.container.detect does: "htpu", "htpx", "htps", or "reference"
(the reference format has no magic field; it is the fallback)."""

from ..constants import NATIVE_MAGIC

HTPX_MAGIC = 0x48545058  # "HTPX", sharded archives
HTPS_MAGIC = 0x48545053  # "HTPS", stream containers

__all__ = ["detect"]


def detect(blob: bytes) -> str:
    if len(blob) >= 4:
        magic = int.from_bytes(blob[0:4], "little")
        if magic == NATIVE_MAGIC:
            return "htpu"
        if magic == HTPX_MAGIC:
            return "htpx"
        if magic == HTPS_MAGIC:
            return "htps"
    return "reference"
