"""Metrics writer: JSONL always, TensorBoard when tensorboardX imports.

Port of ``mlp_ppo_2ply_multi_tpu/io/metrics.py``: the reference trainer's
metric set (trainer.py:186-228) with the Q4/Q14 corrections of SURVEY.md
§7.1 (true shaping counts, true eps/sec). The local JSONL file is the
contract. The fsspec mirror (``--remote-dir``) is not ported (ROADMAP A15).
``device_memory_stats`` is the counterpart of the JAX package's
``utils/profiling.py`` function, read from ``torch.cuda``.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch


class MetricsWriter:
    def __init__(self, logdir: str, run_name: Optional[str] = None):
        ts = time.strftime("%Y%m%d-%H%M%S")
        self.run_dir = os.path.join(logdir, run_name or f"bg_td_{ts}")
        os.makedirs(self.run_dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.run_dir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            pass
        else:
            self._tb = SummaryWriter(logdir=self.run_dir)
        self._t0 = time.time()

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        rec = {"step": int(step), "t": round(time.time() - self._t0, 3)}
        rec.update({k: float(v) for k, v in values.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(k, float(v), step)

    def histogram(self, step: int, name: str, values) -> None:
        if isinstance(values, torch.Tensor):
            values = values.detach().cpu().numpy()
        arr = np.asarray(values).ravel()
        rec = {
            "step": int(step),
            "hist": name,
            "mean": float(arr.mean()),
            "std": float(arr.std()),
            "min": float(arr.min()),
            "max": float(arr.max()),
        }
        self._jsonl.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            self._tb.add_histogram(name, arr, step)

    def param_histograms(self, step: int, params: Dict[str, torch.Tensor]) -> None:
        """Per-parameter weight/bias histograms (trainer.py:222-226), named
        ``params/<key>`` in sorted key order, as the JAX package names them."""
        for k in sorted(params):
            self.histogram(step, f"params/{k}", params[k])

    def flush(self) -> None:
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class Throughput:
    """eps/sec + env-steps/sec counters (reference main.py:140-147 prints
    eps/sec inflated 1.5x — quirk Q14; these are true rates)."""

    def __init__(self):
        self.t0 = time.time()
        self.episodes = 0
        self.env_steps = 0

    def add(self, episodes: int, env_steps: int) -> None:
        self.episodes += int(episodes)
        self.env_steps += int(env_steps)

    def rates(self) -> Dict[str, float]:
        dt = max(time.time() - self.t0, 1e-9)
        return {
            "eps_per_sec": self.episodes / dt,
            "env_steps_per_sec": self.env_steps / dt,
        }


def device_memory_stats(device=None) -> Dict[str, float]:
    """Device memory of one card in MB (the reference's NVML prints around
    each update, trainer.py:54-62,170-184), under the JAX package's keys:
    ``hbm_used_mb`` (allocated by tensors now), ``hbm_limit_mb`` (the card's
    total memory) and ``hbm_peak_mb`` (the most allocated since the last
    reset of the peak). {} for a CPU device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return {}
    mb = 1.0 / (1024 * 1024)
    return {
        "hbm_used_mb": torch.cuda.memory_allocated(dev) * mb,
        "hbm_limit_mb": torch.cuda.get_device_properties(dev).total_memory * mb,
        "hbm_peak_mb": torch.cuda.max_memory_allocated(dev) * mb,
    }
