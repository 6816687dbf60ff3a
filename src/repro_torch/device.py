"""Device selection shared by the port's entry points.

Entry points run on the CUDA card unless the caller explicitly asks for
the CPU (``device="cpu"`` / ``--device cpu``).  Without a card and
without that request they raise: nothing silently drifts to the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``cuda`` by default; ``cpu`` only when asked for by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(--device cpu) to run on the CPU")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for ``device``'s queued work (a no-op on the CPU): the fence
    of the drivers' host-clock timings."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
