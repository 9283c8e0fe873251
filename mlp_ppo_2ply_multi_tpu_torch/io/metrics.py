"""Metrics writer: JSONL always, TensorBoard when tensorboardX imports.

Port of ``mlp_ppo_2ply_multi_tpu/io/metrics.py``: the reference trainer's
metric set (trainer.py:186-228) with the Q4/Q14 corrections of SURVEY.md
§7.1 (true shaping counts, true eps/sec). The local JSONL file is the
contract; with ``remote_uri`` the run directory is mirrored through fsspec
(``io/remote.py``, rate-limited, failures swallowed), the reference's
S3-streaming logger (logger.py:9-56). ``device_memory_stats`` lives in
``utils/profiling.py``, as in the JAX package, and is re-exported here.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from mlp_ppo_2ply_multi_tpu_torch.io.remote import RemoteMirror
from mlp_ppo_2ply_multi_tpu_torch.utils.profiling import device_memory_stats  # noqa: F401


class MetricsWriter:
    def __init__(
        self,
        logdir: str,
        run_name: Optional[str] = None,
        remote_uri: Optional[str] = None,
    ):
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
        self._mirror = RemoteMirror(self.run_dir, remote_uri) if remote_uri else None

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        rec = {"step": int(step), "t": round(time.time() - self._t0, 3)}
        rec.update({k: float(v) for k, v in values.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(k, float(v), step)
        if self._mirror is not None:
            self._mirror.maybe_sync()

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
        if self._mirror is not None:
            self._mirror.close()


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

