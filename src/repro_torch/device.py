"""Device selection for the port's entry points.

The default device is the card. Nothing moves to the CPU on its own: a
caller that wants the CPU (the tests, a CPU smoke run) says so with
``device="cpu"``, and asking for the card where there is none raises.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> the card. Raises ``RuntimeError`` when a CUDA device is
    requested (explicitly or by default) and torch sees no card."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on an NVIDIA GPU by default and torch sees "
            "none; pass device='cpu' to run the plain PyTorch path")
    return dev
