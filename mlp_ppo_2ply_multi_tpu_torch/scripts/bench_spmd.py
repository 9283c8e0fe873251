"""Weak-scaling benchmark of the mesh train step: sustained train-step
throughput over an n-rank data mesh with the per-rank batch held fixed.

Port of ``scripts/bench_spmd.py``, with its arguments and sizes. For each n
it runs ``parallel.sharding.make_train_step`` (--num-steps rollout steps in
continuous mode, then one fused TD(0) update whose gradients are averaged
over "data") on a (n, 1) mesh at n x --per-device-batch games: 3 warm-up
train steps, then --steps timed ones on the host clock, ended by a
synchronise. JAX runs one process over n devices; ``torch.distributed``
runs one process a rank, so the ranks are spawned as
``scripts.multiprocess_distributed.spawn`` spawns them: NCCL on cards (one
card a rank), gloo on the CPU. The default n is every power of two up to
the cards present; a machine with one card gives n = 1 (a one-rank NCCL
group), and the scaling column needs more cards.

On the CPU (``--device cpu``) it takes JAX's CPU sizes: reduced movegen
widths, at most 16 games a rank, 4 rollout steps a train step, 2 timed
steps, and n = 1 unless --devices says otherwise. Without a card and
without ``--device cpu`` it raises.

Prints one JSON line per n: ``devices``, ``env_steps_per_s``,
``per_device``, ``per_device_batch`` and the device.

Usage: python -m mlp_ppo_2ply_multi_tpu_torch.scripts.bench_spmd \\
    [--per-device-batch 4096] [--num-steps 64] [--steps 10] [--devices N] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

import torch

from mlp_ppo_2ply_multi_tpu_torch.core.config import Config
from mlp_ppo_2ply_multi_tpu_torch.core.device import resolve_device
from mlp_ppo_2ply_multi_tpu_torch.env import vec_env
from mlp_ppo_2ply_multi_tpu_torch.learner import td
from mlp_ppo_2ply_multi_tpu_torch.parallel import distributed, sharding
from mlp_ppo_2ply_multi_tpu_torch.scripts.bench import SMOKE_MOVEGEN, card, production_config
from mlp_ppo_2ply_multi_tpu_torch.scripts.multiprocess_distributed import spawn

WARMUP = 3


def job_bench(p: dict, device: torch.device) -> float:
    """One rank of ``bench_n``: the train step on this rank's games; returns
    the global env-steps/s of the timed train steps."""
    if device.type == "cuda":
        torch.cuda.set_device(distributed.local_device(device))
    distributed.init(device=device, world_size=p["n"])
    dev = distributed.local_device(device)
    try:
        cfg, n = p["cfg"], p["n"]
        batch = p["per_dev_batch"] * n
        mesh = sharding.make_mesh(n, 1)
        gen = torch.Generator(device=dev).manual_seed(0)
        state = sharding.shard_train_state(td.init_train_state(cfg, gen, dev), mesh, tp=False)
        env = sharding.shard_env_state(vec_env.reset(batch, gen, dev), mesh)
        step = sharding.make_train_step(mesh, cfg, p["num_steps"], tp=False)
        rgen = sharding.data_generator(mesh, 2, dev)
        for _ in range(WARMUP):
            state, env, m = step(state, env, rgen)
        float(m["loss"])
        t0 = time.perf_counter()
        for _ in range(p["steps"]):
            state, env, m = step(state, env, rgen)
        float(m["loss"])  # the host waits for the last update
        return batch * p["num_steps"] * p["steps"] / (time.perf_counter() - t0)
    finally:
        distributed.shutdown()


def bench_n(n: int, per_dev_batch: int, num_steps: int, steps: int, cfg: Config,
            device: str) -> float:
    """Global env-steps/s of the train step on n spawned ranks."""
    payload = dict(n=n, per_dev_batch=per_dev_batch, num_steps=num_steps, steps=steps,
                   cfg=cfg)
    return spawn(n, [(job_bench, payload)], device)[0][0]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--per-device-batch", type=int, default=4096)
    ap.add_argument("--num-steps", type=int, default=64,
                    help="env steps per train step (rollout length)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cpu":
        cfg = Config(movegen=SMOKE_MOVEGEN)
        args.per_device_batch = min(args.per_device_batch, 16)
        args.num_steps, args.steps = 4, 2
        total = 1
    else:
        cfg = production_config()
        total = torch.cuda.device_count()
    ns = [args.devices] if args.devices else [n for n in (1, 2, 4, 8, 16, 32, 64)
                                              if n <= total]
    where = card(dev)
    for n in ns:
        rate = bench_n(n, args.per_device_batch, args.num_steps, args.steps, cfg, dev.type)
        print(json.dumps({"devices": n, "env_steps_per_s": rate, "per_device": rate / n,
                          "per_device_batch": args.per_device_batch,
                          "devices_present": total, **where}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
