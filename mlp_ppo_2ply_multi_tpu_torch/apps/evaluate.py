"""Evaluation CLI: win rate vs random / 1-ply greedy / 2-ply / another
checkpoint (a capability the reference lacks; required by BASELINE.md).

Port of ``mlp_ppo_2ply_multi_tpu/apps/evaluate.py``: the same flags and
configs, with ``--device cuda|cpu`` in place of ``--platform``. A checkpoint
is a reference ``.pth``, one of the port's ``ckpt_<step>.pt`` files, a
directory of them (the latest), or nothing (an untrained net: the JAX
package's distribution, not its draws). An orbax directory is refused with
exit status 2: the port does not read orbax. On a card the match runs as
replayed CUDA graphs of 16 match steps (``eval.arena.play_match``).

Usage:
    python -m mlp_ppo_2ply_multi_tpu_torch.apps.evaluate --checkpoint ckpt_or_pth \\
        --opponent random|greedy|twoply|<path> --games 1024 [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import sys

import torch

from mlp_ppo_2ply_multi_tpu_torch.core.config import (
    Config,
    MoveGenConfig,
    TrainConfig,
    TwoPlyConfig,
)
from mlp_ppo_2ply_multi_tpu_torch.core.device import resolve_device
from mlp_ppo_2ply_multi_tpu_torch.eval import arena
from mlp_ppo_2ply_multi_tpu_torch.io import checkpoint
from mlp_ppo_2ply_multi_tpu_torch.model import value_net

_CKPT_FILE = re.compile(r"^ckpt_(\d+)\.pt$")


class Refused(Exception):
    """A checkpoint the port does not read."""


def _load(path, cfg: Config, dev):
    if path is None:
        gen = torch.Generator(device=dev).manual_seed(0)
        return value_net.init_params(cfg.model, gen, dev)
    if path.endswith(".pth"):
        return value_net.load_checkpoint(path, dev)
    m = _CKPT_FILE.match(os.path.basename(path))
    if m and os.path.isfile(path):
        return checkpoint.restore(os.path.dirname(path) or ".", dev, int(m.group(1)))[0].params
    if os.path.isdir(path) and checkpoint.steps(path):
        return checkpoint.restore(path, dev)[0].params
    raise Refused(
        f"{path}: not a .pth, a ckpt_<step>.pt or a directory of them; the port "
        "does not read orbax checkpoints (export one to .pth with the JAX package)"
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--checkpoint", default=None,
                    help=".pth / ckpt_<step>.pt / directory of them / empty=untrained")
    ap.add_argument("--opponent", default="random",
                    help="random | greedy | twoply | path to checkpoint")
    ap.add_argument("--games", type=int, default=1024)
    ap.add_argument("--max-steps", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--agent-policy", choices=("greedy", "twoply"), default="greedy")
    ap.add_argument("--twoply-tuned", action="store_true",
                    help="use the tuned production 2-ply scorer (unrolled "
                         "rolls, per-die doubles widths, width-96 nd "
                         "replies) for BOTH sides' twoply policies instead "
                         "of the exact default scorer")
    ap.add_argument("--opponent-scorer", choices=("same", "tuned", "exact"),
                    default="same",
                    help="2-ply scorer for the OPPONENT side only: --agent-policy "
                         "twoply --twoply-tuned --opponent twoply "
                         "--opponent-scorer exact is the tuned-vs-exact "
                         "head-to-head quality guard")
    ap.add_argument("--small-movegen", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to play; cuda without a card is an error")
    ap.add_argument("--td-mode", choices=("reference", "negamax", "side0"),
                    default="reference",
                    help="value-orientation semantics the checkpoint was "
                         "trained with (side0: side 1 minimizes)")
    ap.add_argument("--opponent-td-mode",
                    choices=("reference", "negamax", "side0"), default=None,
                    help="orientation for a CHECKPOINT opponent trained "
                         "under a different td_mode (default: same as "
                         "--td-mode)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    def make_cfg(td_mode, scorer="same"):
        if scorer == "same":
            scorer = "tuned" if args.twoply_tuned else "exact"
        tw = TwoPlyConfig.tuned() if scorer == "tuned" else TwoPlyConfig(enabled=True)
        c = Config(twoply=tw, train=TrainConfig(td_mode=td_mode))
        if args.small_movegen:
            c = dataclasses.replace(
                c, movegen=MoveGenConfig(w1=16, w2=32, w3=48, w4=64, a_max=64)
            )
        return c

    cfg = make_cfg(args.td_mode)
    cfg_b = make_cfg(args.opponent_td_mode or args.td_mode, args.opponent_scorer)

    try:
        params_a = _load(args.checkpoint, cfg, dev)
        policy_a = (
            arena.twoply_greedy_policy(cfg)
            if args.agent_policy == "twoply"
            else arena.greedy_policy(cfg)
        )
        if args.opponent == "random":
            params_b, policy_b = params_a, arena.random_policy(cfg)
        elif args.opponent == "greedy":
            params_b, policy_b = params_a, arena.greedy_policy(cfg_b)
        elif args.opponent == "twoply":
            params_b, policy_b = params_a, arena.twoply_greedy_policy(cfg_b)
        else:
            params_b, policy_b = _load(args.opponent, cfg_b, dev), arena.greedy_policy(cfg_b)
    except Refused as e:
        ap.error(str(e))

    res = arena.play_match(
        params_a, params_b, policy_a, policy_b,
        torch.Generator(device=dev).manual_seed(args.seed), cfg,
        batch=args.games, max_steps=args.max_steps, device=dev,
    )
    print(json.dumps(arena.summarize(res)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
