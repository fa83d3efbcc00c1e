"""Device selection: the port runs on CUDA unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = "cuda"
                   ) -> torch.device:
    """``torch.device`` for ``device`` (default ``"cuda"``).

    Raises ``RuntimeError`` when CUDA is asked for and absent: an entry point
    never falls back to the CPU on its own, so a CPU run is always one the
    caller asked for (``device="cpu"``).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available — pass "
            "device='cpu' to run on the CPU")
    return dev
