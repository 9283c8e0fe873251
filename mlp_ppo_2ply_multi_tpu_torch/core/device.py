"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU. A missing
card is an error, never a silent move to the CPU.
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]

# (name, device) -> the constant's tensor on that device
_CONSTANTS: Dict[Tuple[str, str], torch.Tensor] = {}


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


def device_constant(
    name: str, value: Union[np.ndarray, torch.Tensor], device: torch.device
) -> torch.Tensor:
    """``value`` (a numpy array or a CPU tensor) as a tensor on ``device``,
    made at the first call for (``name``, device) and the same tensor at
    every later one. Read-only by contract.

    A step that copies a host table to the card on every call synchronises
    the host with the card and cannot be captured in a CUDA graph. The one
    copy made here goes from pinned memory without blocking, so not even the
    first call synchronises. Make the first call outside a capture."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (name, str(dev))
    t = _CONSTANTS.get(key)
    if t is None:
        t = torch.as_tensor(value).clone()
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        elif dev.type != "cpu":
            t = t.to(dev)
        _CONSTANTS[key] = t
    return t
