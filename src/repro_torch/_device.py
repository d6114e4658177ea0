"""Default-device rule for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``, as the tests do). With no card and no explicit device
they raise instead of silently falling back: a CPU run measures nothing
about the card.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``; an explicit device is taken as given. Raises
    ``RuntimeError`` when CUDA is asked for (explicitly or by default) and
    ``torch.cuda.is_available()`` is false."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available: pass device='cpu' to run the plain "
            "PyTorch path")
    return dev
