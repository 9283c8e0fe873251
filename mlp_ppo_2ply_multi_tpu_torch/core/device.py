"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU. A missing
card is an error, never a silent move to the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``. Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def check_on(t: torch.Tensor, device: torch.device, what: str) -> None:
    """Raise unless ``t`` lies on ``device`` (type, and index if it has one)."""
    same = t.device.type == device.type and (
        device.index is None or t.device.index == device.index
    )
    if not same:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
