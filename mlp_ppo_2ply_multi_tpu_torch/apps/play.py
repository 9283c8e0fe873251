"""Interactive human-vs-AI play CLI.

Port of ``mlp_ppo_2ply_multi_tpu/apps/play.py`` (the reference's
play_versus_ai.py): load a checkpoint, render the board each turn, let the
human pick from the enumerated legal moves, and have the agent play argmax
over afterstate values (:165-195), optionally with the value-annotated move
list shown (the reference's debug variant :65-123) and optional 2-ply
expectimax scoring. The game loop runs on the port's pure-Python oracle
with a numpy forward; with ``--engine torch`` the agent's move enumeration
and evaluation run through the port's batched engine at batch 1, on the
card unless ``--device cpu``.

Usage:
    python -m mlp_ppo_2ply_multi_tpu_torch.apps.play --checkpoint model.pth \\
        [--human-player 0|1] [--show-values] [--two-ply] [--seed N] \\
        [--engine oracle|torch] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import random
import sys
from typing import Optional

import numpy as np
import torch

from mlp_ppo_2ply_multi_tpu_torch.apps.render import describe_move, render
from mlp_ppo_2ply_multi_tpu_torch.core.config import Config, ModelConfig, MoveGenConfig
from mlp_ppo_2ply_multi_tpu_torch.core.device import DeviceLike, resolve_device
from mlp_ppo_2ply_multi_tpu_torch.encoder.features import encode_board
from mlp_ppo_2ply_multi_tpu_torch.engine.board import Board
from mlp_ppo_2ply_multi_tpu_torch.engine.movegen import legal_moves
from mlp_ppo_2ply_multi_tpu_torch.model import value_net
from mlp_ppo_2ply_multi_tpu_torch.oracle import rules
from mlp_ppo_2ply_multi_tpu_torch.oracle.env import OracleEnv

# Reference two_ply.py:10-35
_ROLLS = [(a, b) for a in range(1, 7) for b in range(a, 7)]
_PROBS = [(1 if a == b else 2) / 36.0 for a, b in _ROLLS]


def load_params(path: Optional[str]):
    """Params as host numpy arrays: the play CLI's oracle path is numpy.
    No path: an untrained net from seed 0 (the JAX package's distribution,
    not its draws)."""
    if path is None:
        print("no checkpoint given; playing against an untrained net")
        gen = torch.Generator().manual_seed(0)
        p = value_net.init_params(Config().model, gen, "cpu")
    else:
        p = value_net.load_checkpoint(path, "cpu")
    return {k: v.numpy() for k, v in p.items()}


def move_values(params, env: OracleEnv) -> np.ndarray:
    feats = np.array(
        [rules.encode(b, env.player) for _, b in env.legal], dtype=np.float32
    )
    return value_net.forward_np(params, feats)


class TorchEngine:
    """``--engine torch``: the agent's move enumeration and candidate
    evaluation run through the port's batched engine (merged legal moves ->
    encoder -> value_net.forward, f32) at batch 1 on ``device``, instead of
    the pure-Python oracle. The chosen afterstate is mapped back to the
    oracle env's move index by board identity (the canonical engine emits
    the oracle's move set, possibly in another order)."""

    def __init__(self, params, device: DeviceLike = None):
        self.dev = resolve_device(device)
        self.params = {k: torch.tensor(v, dtype=torch.float32, device=self.dev)
                       for k, v in params.items()}
        self.mg = MoveGenConfig()
        self.mcfg = ModelConfig()

    @torch.no_grad()
    def move_values(self, env: OracleEnv):
        """Returns (afterstate board tuples, values) in engine order."""
        b = env.board
        data = torch.tensor([list(b[0]) + list(b[1]) + list(b[2]) + list(b[3])],
                            dtype=torch.int8, device=self.dev)
        player = torch.tensor([env.player], dtype=torch.int32, device=self.dev)
        dice = torch.tensor([list(env.roll)], dtype=torch.int32, device=self.dev)
        ms = legal_moves(Board(data=data), player, dice, self.mg)
        v = value_net.forward(self.params, encode_board(ms.boards, player[..., None]), self.mcfg)
        boards, valid, v = ms.boards.data.cpu().numpy(), ms.valid.cpu().numpy(), v.cpu().numpy()
        out_boards, out_v = [], []
        for k in np.nonzero(valid[0])[0]:
            d = boards[0, k]
            out_boards.append((
                tuple(int(x) for x in d[0:24]),
                tuple(int(x) for x in d[24:48]),
                (int(d[48]), int(d[49])),
                (int(d[50]), int(d[51])),
            ))
            out_v.append(float(v[0, k]))
        return out_boards, np.asarray(out_v, np.float32)

    def agent_action(self, env: OracleEnv) -> int:
        boards, v = self.move_values(env)
        assert len(boards) == env.num_moves, (
            f"engine/oracle move-count mismatch: {len(boards)} vs "
            f"{env.num_moves} (board={env.board} roll={env.roll})"
        )
        best = boards[int(np.argmax(v))]
        for i, (_, ob) in enumerate(env.legal):
            if ob == best:
                return i
        raise AssertionError(f"engine afterstate not in oracle move set: {best}")


def twoply_scores(params, env: OracleEnv, v: np.ndarray, k=4, alpha=1.0, beta=0.9):
    """Rerank the top-k 1-ply candidates (reference two_ply.py:44-150; top-5
    opponent values, 50-cap on small doubles kept deterministic)."""
    top = np.argsort(-v)[:k]
    scores = np.full_like(v, -np.inf)
    opp_pl = 1 - env.player
    for i in top:
        _, board = env.legal[i]
        total = 0.0
        for roll, prob in zip(_ROLLS, _PROBS):
            mvs = rules.full_moves(board, opp_pl, list(roll))
            if roll[0] == roll[1] and roll[0] <= 3 and len(mvs) > 50:
                mvs = mvs[:50]
            if mvs:
                feats = np.array(
                    [rules.encode(b, opp_pl) for _, b in mvs], np.float32
                )
                vv = value_net.forward_np(params, feats)
                total += float(np.sort(vv)[::-1][:5].mean()) * prob
        scores[i] = alpha * v[i] - beta * total
    return scores


def agent_action(params, env: OracleEnv, two_ply: bool) -> int:
    v = move_values(params, env)
    if two_ply and env.num_moves >= 4:
        return int(np.argmax(twoply_scores(params, env, v)))
    return int(np.argmax(v))


def human_action(params, env: OracleEnv, show_values: bool) -> int:
    v = move_values(params, env) if show_values else None
    for i, (mv, _) in enumerate(env.legal):
        note = f"   V={v[i]:+.4f}" if v is not None else ""
        print(f"  [{i}] {describe_move(mv)}{note}")
    while True:
        try:
            s = input(f"your move [0-{env.num_moves - 1}]: ").strip()
        except EOFError:
            # stdin closed (piped input exhausted): quit instead of
            # reprompting forever
            print("\nstdin closed — quitting")
            raise SystemExit(0)
        try:
            a = int(s)
            if 0 <= a < env.num_moves:
                return a
        except ValueError:
            pass
        print("invalid choice")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--checkpoint", default=None, help=".pth file")
    ap.add_argument("--human-player", type=int, default=0, choices=(0, 1))
    ap.add_argument("--show-values", action="store_true")
    ap.add_argument("--two-ply", action="store_true")
    ap.add_argument("--select-agent-moves", action="store_true",
                    help="debug mode: on the agent's turn, show its "
                         "value-annotated move list and pick its move by hand "
                         "(reference play_versus_ai.py:65-123, "
                         "play_game_human_select_agent_moves)")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--engine", default="oracle", choices=("oracle", "torch"),
                    help="agent move evaluation engine: 'oracle' (pure "
                         "python, default) or 'torch' (the port's batched "
                         "legal moves + value net at batch 1)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where --engine torch runs; cuda without a card is an error")
    args = ap.parse_args(argv)

    params = load_params(args.checkpoint)
    engine = TorchEngine(params, args.device) if args.engine == "torch" else None
    rng = random.Random(args.seed)
    dice = iter(lambda: (rng.randint(1, 6), rng.randint(1, 6)), None)
    env = OracleEnv(dice)
    env.reset()
    print(f"you are {'X' if args.human_player == 0 else 'O'}")

    steps = 0
    while not env.game_over and steps < 10_000:
        print(render(env.board, env.player, env.roll))
        if env.num_moves == 0:
            print(f"{'X' if env.player == 0 else 'O'} has no legal move — pass")
            env.step(None)
        elif env.player == args.human_player:
            a = human_action(params, env, args.show_values)
            env.step(a)
        elif args.select_agent_moves:
            best = agent_action(params, env, args.two_ply)
            print(f"agent's argmax would be [{best}] "
                  f"{describe_move(env.legal[best][0])}; pick its move:")
            a = human_action(params, env, show_values=True)
            env.step(a)
        else:
            if engine is not None and not args.two_ply:
                a = engine.agent_action(env)
            else:
                a = agent_action(params, env, args.two_ply)
            print(f"agent plays: {describe_move(env.legal[a][0])}")
            env.step(a)
        steps += 1

    print(render(env.board, env.player))
    if env.win_type:
        winner = 1 - env.player if env.game_over else None
        # game_over flips no turn; the winner is the player who just moved
        for pl in (0, 1):
            if env.board[3][pl] >= 15:
                winner = pl
        print(f"game over: {'X' if winner == 0 else 'O'} wins ({env.win_type})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
