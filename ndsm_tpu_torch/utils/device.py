"""Device checks.

The port runs where the caller says it runs.  ``device="cuda"`` on a host
without a usable CUDA device raises; nothing here probes a device and
quietly answers "not available" so that a caller can fall back to the
CPU.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``.  Raises ``RuntimeError`` for a CUDA
    device that this process cannot use."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} requested but torch sees no CUDA "
                f"device (torch {torch.__version__}, built for CUDA "
                f"{torch.version.cuda})"
            )
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device={str(device)!r}: only {torch.cuda.device_count()} "
                "CUDA device(s) visible"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} (cuda or cpu)")
    return dev

