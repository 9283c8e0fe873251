"""Checkpoints of the full training state, with ``torch.save``.

Port of ``mlp_ppo_2ply_multi_tpu/io/checkpoint.py`` (orbax there). The
reference checkpoints weights only, so a resume loses the optimizer state,
the update version and the RNG, and restarts the temperature schedule
(SURVEY.md §5.4). Here params, Adam state, version, episode count and the
state of the ``torch.Generator`` the rollout draws from (the counterpart of
the PRNG key the JAX package saves) round-trip bitwise. One file a step,
``ckpt_<step>.pt``, written to a temporary name and renamed; the newest
``max_to_keep`` steps are kept. The port does not read orbax checkpoints.

``export_torch``/``import_torch`` read and write the reference's .pth
weights (``value_net.save_checkpoint``/``load_checkpoint``).
"""
from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

import torch

from mlp_ppo_2ply_multi_tpu_torch.core.device import DeviceLike, resolve_device
from mlp_ppo_2ply_multi_tpu_torch.learner.td import AdamState, TrainState, map_state
from mlp_ppo_2ply_multi_tpu_torch.model import value_net

_FILE = re.compile(r"^ckpt_(\d+)\.pt$")


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step}.pt")


def steps(directory: str) -> List[int]:
    """The steps saved in ``directory``, oldest first."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_FILE.match, os.listdir(directory)) if m)


def save(
    directory: str,
    state: TrainState,
    generator: torch.Generator,
    step: Optional[int] = None,
    max_to_keep: int = 5,
) -> int:
    """Write one checkpoint; returns the step it was saved under (by default
    the cumulative episode count, as the reference's episode-indexed file
    names, main.py:150-153). A checkpoint of the same step is replaced."""
    if step is None:
        step = int(state.episode_count)
    cpu = map_state(lambda t: t.detach().cpu(), state)
    payload = {
        "params": cpu.params,
        "mu": cpu.opt_state.mu,
        "nu": cpu.opt_state.nu,
        "count": cpu.opt_state.count,
        "version": cpu.version,
        "episode_count": cpu.episode_count,
        "generator": generator.get_state(),
        "step": step,
    }
    os.makedirs(directory, exist_ok=True)
    path = _path(directory, step)
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)
    for old in steps(directory)[:-max_to_keep]:
        os.remove(_path(directory, old))
    return step


def restore(
    directory: str, device: DeviceLike = None, step: Optional[int] = None
) -> Tuple[TrainState, torch.Tensor, int]:
    """(state on ``device`` (default ``cuda``), generator state, step) of
    ``step`` or, by default, the latest checkpoint in ``directory``. Set the
    generator state with ``torch.Generator.set_state``."""
    dev = resolve_device(device)
    if step is None:
        saved = steps(directory)
        if not saved:
            raise FileNotFoundError(f"no checkpoints in {directory}")
        step = saved[-1]
    p = torch.load(_path(directory, step), map_location="cpu", weights_only=True)
    state = TrainState(
        params=p["params"],
        opt_state=AdamState(count=p["count"], mu=p["mu"], nu=p["nu"]),
        version=p["version"],
        episode_count=p["episode_count"],
    )
    return map_state(lambda t: t.to(dev), state), p["generator"], step


def export_torch(state: TrainState, path: str) -> None:
    """Write the weights as a .pth state dict the reference's play CLI
    loads (play_versus_ai.py:20-29)."""
    value_net.save_checkpoint(state.params, path)


def import_torch(path: str, device: DeviceLike = None):
    """Reference .pth weights as params on ``device`` (default ``cuda``)."""
    return value_net.load_checkpoint(path, device)
