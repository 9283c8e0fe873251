"""Learning-curve evaluation: the win rate against a uniform random player
of every checkpoint of one or more training runs.

Counterpart of ``scripts/eval_curve_stacked.py`` and
``scripts/eval_curve_tpu.py``: ``Config()`` (full movegen widths, f32 net),
greedy argmax against uniform random over the legal moves, side-alternated
halves of ``--games // 2`` games, at most ``--max-steps`` steps. The win
rate is wins over finished games. A run directory's checkpoints are its
``ep<episodes>.pth`` files (the reference's .pth, which
``scripts/run_parity_trainer.py`` writes) and the port's
``ckpt_<step>.pt`` files (at their episode count).

Where the JAX script stacks every checkpoint and vmaps one program over
them, here each side order is one captured ``MatchGraph``
(``eval.arena.play_match``), replayed for every checkpoint: a checkpoint is
loaded by ``copy_``-ing its weights into one fixed set of parameter tensors,
so the graph cache's key (the params' storage) never changes and a sweep of
N checkpoints captures 2 graphs, not 2N. The captures are counted and
printed. Checkpoint i of a run plays from generators seeded
``seed + 7919 (i + 1)`` (the net as player 0) and that plus 1 (as player 1),
as ``scripts/eval_curve_tpu.py`` seeds its keys.

Writes JSON ``{run: [{"episodes", "win_rate_vs_random", "finished",
"games"}, ...]}``, the schema of ``artifacts/curves_ours_tpu.json``.

Usage:
  python -m mlp_ppo_2ply_multi_tpu_torch.scripts.eval_curve --games 500 \\
      --out curves.json RUN_DIR [RUN_DIR ...] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

from mlp_ppo_2ply_multi_tpu_torch.core import graphs
from mlp_ppo_2ply_multi_tpu_torch.core.config import Config
from mlp_ppo_2ply_multi_tpu_torch.core.device import DeviceLike, resolve_device
from mlp_ppo_2ply_multi_tpu_torch.eval import arena
from mlp_ppo_2ply_multi_tpu_torch.io import checkpoint
from mlp_ppo_2ply_multi_tpu_torch.model import value_net

_PTH = re.compile(r"^ep(\d+)\.pth$")
_PT = re.compile(r"^ckpt_(\d+)\.pt$")
SEED_STRIDE = 7919


def checkpoints(run: str) -> List[Tuple[int, str, Dict[str, torch.Tensor]]]:
    """(episodes, path, weights as CPU tensors) of every ``ep*.pth`` and
    ``ckpt_<step>.pt`` in ``run``, by episodes; each file is read once."""
    out = []
    for name in os.listdir(run):
        path = os.path.join(run, name)
        if _PTH.match(name):
            out.append((int(_PTH.match(name).group(1)), path,
                        value_net.load_checkpoint(path, "cpu")))
        elif _PT.match(name):
            state = checkpoint.restore(run, "cpu", int(_PT.match(name).group(1)))[0]
            out.append((int(state.episode_count), path, state.params))
    return sorted(out, key=lambda c: c[:2])


def win_rate(params, greedy, rand, cfg: Config, games: int, max_steps: int, seed: int,
             dev: torch.device) -> Dict[str, object]:
    """``games // 2`` games with the net as player 0 from a generator seeded
    ``seed``, as many as player 1 from ``seed + 1``. Returns the record and
    both halves' winners."""
    half = games // 2
    res0 = arena.play_match(params, params, greedy, rand,
                            torch.Generator(device=dev).manual_seed(seed), cfg,
                            batch=half, max_steps=max_steps, device=dev)
    res1 = arena.play_match(params, params, rand, greedy,
                            torch.Generator(device=dev).manual_seed(seed + 1), cfg,
                            batch=half, max_steps=max_steps, device=dev)
    w0, w1 = res0.winner.cpu(), res1.winner.cpu()
    wins = int((w0 == 0).sum() + (w1 == 1).sum())
    finished = int((w0 >= 0).sum() + (w1 >= 0).sum())
    return dict(win_rate_vs_random=wins / max(finished, 1), finished=finished,
                games=2 * half, winners=(w0, w1))


def sweep(runs: List[str], games: int = 500, seed: int = 0, max_steps: int = 400,
          device: DeviceLike = None, log=print, cfg: Optional[Config] = None
          ) -> Tuple[Dict[str, list], Dict[str, object]]:
    """Every checkpoint of ``runs`` through ``win_rate`` at ``cfg`` (default
    ``Config()``), its weights copied into one fixed set of tensors. Returns
    (curves, info: graphs captured, checkpoints, seconds, and each
    checkpoint's winners by run and index)."""
    dev = resolve_device(device)
    cfg = cfg or Config()
    greedy, rand = arena.greedy_policy(cfg), arena.random_policy(cfg)
    params = None
    captures0 = graphs.captures
    out: Dict[str, list] = {}
    winners: Dict[str, list] = {}
    n = 0
    t0 = time.perf_counter()
    for run in runs:
        for i, (eps, _, weights) in enumerate(checkpoints(run)):
            t1 = time.perf_counter()
            if params is None:
                params = {k: v.to(dev).clone() for k, v in weights.items()}
            else:
                for k, v in weights.items():
                    params[k].copy_(v)
            rec = win_rate(params, greedy, rand, cfg, games, max_steps,
                           seed + SEED_STRIDE * (i + 1), dev)
            winners.setdefault(run, []).append(rec.pop("winners"))
            out.setdefault(run, []).append({"episodes": eps, **rec})
            n += 1
            log(f"{run} ep{eps}: {rec['win_rate_vs_random']:.3f} ({rec['finished']}/"
                f"{rec['games']} finished, {time.perf_counter() - t1:.1f}s)")
    info = dict(checkpoints=n, captures=graphs.captures - captures0,
                seconds=time.perf_counter() - t0, winners=winners)
    return out, info


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("runs", nargs="+", help="directories holding ep*.pth / ckpt_<step>.pt")
    ap.add_argument("--games", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-steps", type=int, default=400)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out, info = sweep(args.runs, args.games, args.seed, args.max_steps, dev,
                      log=lambda s: print(s, flush=True))
    print(f"{info['checkpoints']} checkpoints x {2 * (args.games // 2)} games in "
          f"{info['seconds']:.1f}s; graphs captured: {info['captures']}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
