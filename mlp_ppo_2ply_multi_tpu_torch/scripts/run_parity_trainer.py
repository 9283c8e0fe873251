"""Matched-hyperparameter parity training run, for learning curves to set
beside the reference trainer's.

Counterpart of ``scripts/run_parity_trainer.py``: td_mode "reference" (Q3
parity targets), one sequential Adam step per episode (Q2), 200 episodes an
update, sync rollouts (every column one complete or 300-step-truncated
episode), at ``Config()``'s full movegen widths and f32 net. Each update is
``apps.train.sync_update``: a sync ``actor.rollout`` (a replayed CUDA graph
on a card, whose merged legal moves run the nd_tail kernel at K = 576) and
the per-episode ``learner.td.update``, at the temperature ``td.temperature``
gives the state's version.

Saves ``ep%08d.pth`` in the reference's .pth format
(``value_net.save_checkpoint``) at 0 and every ``--ckpt-every`` episodes
after, and at the end, so ``scripts/eval_curve.py`` reads both trainers'
checkpoints; writes ``train.jsonl`` with the JAX script's keys (episodes,
version, temperature, loss, eps_per_sec). Randomness comes from one
``torch.Generator`` seeded with ``--seed``.

Usage:
  python -m mlp_ppo_2ply_multi_tpu_torch.scripts.run_parity_trainer \\
      --episodes 20000 --seed 0 --out RUN_DIR [--ckpt-every 1500] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, List, Optional

from mlp_ppo_2ply_multi_tpu_torch.apps import train
from mlp_ppo_2ply_multi_tpu_torch.core.config import Config, TrainConfig
from mlp_ppo_2ply_multi_tpu_torch.core.device import DeviceLike, resolve_device
from mlp_ppo_2ply_multi_tpu_torch.learner.td import TrainState
from mlp_ppo_2ply_multi_tpu_torch.model import value_net


def parity_config(seed: int = 0) -> Config:
    """The JAX script's config."""
    return Config(train=TrainConfig(batch_games=200, per_episode_updates=True,
                                    td_mode="reference", rollout_mode="sync", seed=seed))


def run(cfg: Config, episodes: int, out: str, ckpt_every: int = 1500,
        device: DeviceLike = None, log: Callable[[str], None] = print) -> TrainState:
    """Sync updates of ``cfg.train.batch_games`` episodes until ``episodes``
    are done; a checkpoint before the first update, whenever the episode
    count reaches the next multiple of ``ckpt_every``, and after the last.
    Returns the final state."""
    dev = resolve_device(device)
    os.makedirs(out, exist_ok=True)
    gen, state = train.start(cfg, dev)

    def save(total: int) -> None:
        value_net.save_checkpoint(state.params, os.path.join(out, f"ep{total:08d}.pth"))

    total = next_ckpt = 0
    t0 = time.time()
    with open(os.path.join(out, "train.jsonl"), "w") as f:
        while total < episodes:
            if total >= next_ckpt:
                save(total)
                next_ckpt += ckpt_every
            state, metrics, temp = train.sync_update(state, gen, cfg, dev)
            total = int(state.episode_count)
            rec = {
                "episodes": total,
                "version": int(state.version),
                "temperature": float(temp),
                "loss": float(metrics["loss"]),
                "eps_per_sec": total / (time.time() - t0),
            }
            f.write(json.dumps(rec) + "\n")
            f.flush()
    save(total)
    log(f"done: {total} episodes in {time.time() - t0:.0f}s")
    return state


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--episodes", type=int, default=12000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="ourrun")
    ap.add_argument("--ckpt-every", type=int, default=1500)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    run(parity_config(args.seed), args.episodes, args.out, args.ckpt_every, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
