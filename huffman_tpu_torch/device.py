"""Device selection for the PyTorch port.

The public entry points run on the card (``device="cuda"``) unless the
caller asks for the CPU, where the kernels' plain versions run. Asking for
CUDA on a machine without a usable card raises; the port never substitutes
the CPU for a device that was asked for.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """``device`` as a ``torch.device``; raises ``RuntimeError`` when it
    names CUDA and no CUDA device is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False"
        )
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev
