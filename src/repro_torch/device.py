"""Device selection for the port's public entry points.

Every entry point takes ``device=None`` and resolves it here: ``None``
means the CUDA card, and a machine without one raises instead of quietly
running on the CPU.  The CPU is used only when a caller asks for it
(``device="cpu"``), which is what the parity tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless ``device`` names
    another one.  Raises when CUDA is asked for (explicitly or by
    default) and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
