"""Fixed-seed trajectory parity of the port: the games of
``scripts/trajectory_parity.py`` played through the port's env and its
sorted (exact reference-order) engine.

Counterpart of the JAX script's ``jax`` side (``run_jax``): the same numpy
streams from MASTER_SEED (opening rolls, per-step dice, the raw action
table), the same policy ``action[t, g] = raw[t, g] % min(count, 500)``, and
each game reduced to one 32-bit rolling FNV-1a hash over its step stream
(side to move, roll, count, action, reward, done, the 52 board cells after
the step), then its win type and step count. Games run through
``vec_env.reset_from_rolls``, ``movegen.legal_moves`` with
``Config(movegen=MoveGenConfig(algo="sorted"))`` and ``vec_env.step``, on the
card unless ``--device cpu``.

``--streams`` is the JAX script's ``--games``: it sizes the numpy draws, so
only runs with the same value share games (the repo's artifact,
``artifacts/traj_jax_4096.jsonl``, has 4096). ``--games N`` plays the first
N games of those streams; ``compare`` compares the games both files hold.
Files are the JAX script's JSON lines ``{"g", "hash", "steps", "wt"}``, so
either script's ``compare`` reads the other's.

Usage:
  python -m mlp_ppo_2ply_multi_tpu_torch.scripts.trajectory_parity torch \\
      [--games N] [--streams 4096] [--chunk C] [--device cuda|cpu] [--out F]
  python -m mlp_ppo_2ply_multi_tpu_torch.scripts.trajectory_parity compare REF_F OUT_F [--out F]
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from mlp_ppo_2ply_multi_tpu_torch.core.config import Config, MoveGenConfig
from mlp_ppo_2ply_multi_tpu_torch.core.device import resolve_device
from mlp_ppo_2ply_multi_tpu_torch.core.tree import tmap
from mlp_ppo_2ply_multi_tpu_torch.engine.board import MASK32
from mlp_ppo_2ply_multi_tpu_torch.engine.movegen import legal_moves
from mlp_ppo_2ply_multi_tpu_torch.env import vec_env

MASTER_SEED = 20260817
T_MAX = 300  # reference MAX_TIMESTEPS (configuration.py:4, worker.py:101)
Q7_CAP = 500  # reference max_legal_moves (backgammon_env.py:35)
FNV_OFFSET = 2166136261
FNV_PRIME = 16777619
PASS_MARK = 0xFFFF
CFG = Config(movegen=MoveGenConfig(algo="sorted"))
CHECK_EVERY = 8  # steps between removals of finished games from the batch


def fixed_streams(games: int):
    """Opening rolls, per-step dice and the raw action table, drawn from
    MASTER_SEED exactly as the JAX script draws them."""
    rng = np.random.default_rng(MASTER_SEED)
    nd_pairs = np.asarray(
        [(i, j) for i in range(1, 7) for j in range(1, 7) if i != j], np.int32
    )
    opener = nd_pairs[rng.integers(0, 30, size=games)]
    first = nd_pairs[rng.integers(0, 30, size=games)]
    dice = rng.integers(1, 7, size=(T_MAX, games, 2)).astype(np.int32)
    raw = rng.integers(0, 2**31 - 1, size=(T_MAX, games)).astype(np.int32)
    return opener, first, dice, raw


def fnv_mix(h: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """One FNV-1a round on uint32 values held in int64: (h ^ v) * prime,
    v taken as its low 32 bits (a negative int32 as uint32 does)."""
    return ((h ^ (v.to(torch.int64) & MASK32)) * FNV_PRIME) & MASK32


def play_step(state: vec_env.EnvState, h: torch.Tensor, raw_t, next_dice):
    """One lockstep decision of every game and its hash update (the JAX
    script's ``jit_step``); a game over or at the step cap keeps its hash."""
    live = ~state.game_over & (state.step_count < CFG.env.max_timesteps)
    moves = legal_moves(state.board, state.player, state.dice, CFG.movegen)
    count = moves.count.clamp(max=Q7_CAP)
    action = torch.where(count > 0, raw_t % count.clamp(min=1), 0)
    res = vec_env.step(state, moves, action, next_dice, CFG.env)
    nh = h
    for v in (
        state.player, state.dice[:, 0], state.dice[:, 1], count,
        torch.where(count > 0, action, PASS_MARK), torch.round(res.reward * 100),
        res.done,
    ):
        nh = fnv_mix(nh, v)
    cells = res.state.board.data.to(torch.int64) & 0xFF
    for c in range(cells.shape[-1]):
        nh = fnv_mix(nh, cells[:, c])
    return res.state, torch.where(live, nh, h)


def run(games: int, streams: int = 4096, chunk: int = 0, device=None,
        log=print) -> List[Dict[str, int]]:
    """Play the first ``games`` games of ``fixed_streams(streams)`` in
    chunks of ``chunk`` games (all at once when 0); one record a game.
    Every ``CHECK_EVERY`` steps the games that are over or at the step cap
    leave the batch with their final hashes (a finished game's state and
    hash no longer change), and a chunk ends when none is left."""
    if not 0 < games <= streams:
        raise ValueError(f"--games must be in [1, {streams}], got {games}")
    dev = resolve_device(device)
    opener, first, dice, raw = fixed_streams(streams)
    chunk = chunk or games
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    out: List[Dict[str, int]] = []
    t0 = time.perf_counter()
    for base in range(0, games, chunk):
        sl = slice(base, min(base + chunk, games))
        state = vec_env.reset_from_rolls(to(opener[sl]), to(first[sl]))
        h = torch.full((sl.stop - base,), FNV_OFFSET, dtype=torch.int64, device=dev)
        raw_c, dice_c = to(raw[:, sl]), to(dice[:, sl])
        ids = torch.arange(sl.stop - base, device=dev)  # the batch's games
        done: Dict[int, Dict[str, int]] = {}
        for t in range(T_MAX):
            state, h = play_step(state, h, raw_c[t, ids], dice_c[t, ids])
            if t % CHECK_EVERY == CHECK_EVERY - 1 or t == T_MAX - 1:
                live = ~state.game_over & (state.step_count < CFG.env.max_timesteps)
                if t == T_MAX - 1:
                    live = torch.zeros_like(live)
                fin = (~live).nonzero()[:, 0]
                hf = fnv_mix(fnv_mix(h[fin], state.win_type[fin]), state.step_count[fin])
                for g, hv, sc, wt in zip(ids[fin].tolist(), hf.tolist(),
                                         state.step_count[fin].tolist(),
                                         state.win_type[fin].tolist()):
                    done[base + g] = {"g": base + g, "hash": hv, "steps": sc, "wt": wt}
                keep = live.nonzero()[:, 0]
                if keep.numel() == 0:
                    break
                state = tmap(lambda a: a[keep], state)
                h, ids = h[keep], ids[keep]
        out.extend(done[g] for g in sorted(done))
        log(f"[torch] {sl.stop}/{games} games, {time.perf_counter() - t0:.0f}s")
    return out


def load(path: str) -> Dict[int, Dict[str, int]]:
    with open(path) as f:
        return {r["g"]: r for r in map(json.loads, f)}


def compare(ref: Dict[int, Dict[str, int]], ours: Dict[int, Dict[str, int]]) -> dict:
    """The JAX script's ``compare`` over the games both hold: matches, the
    first mismatches, and the sha256 of ``ours``'s hashes in game order."""
    games = sorted(set(ref) & set(ours))
    if not games:
        raise ValueError(f"no overlapping games ({len(ref)} and {len(ours)} records)")
    mismatch = [g for g in games if ref[g]["hash"] != ours[g]["hash"]]
    digest = hashlib.sha256(
        b"".join(ours[g]["hash"].to_bytes(4, "little") for g in games)
    ).hexdigest()
    return {
        "games_compared": len(games),
        "bit_identical": len(games) - len(mismatch),
        "mismatched_games": mismatch[:32],
        "transcript_sha256": digest,
        "total_steps": sum(ours[g]["steps"] for g in games),
        "seed": MASTER_SEED,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("mode", choices=["torch", "compare"])
    ap.add_argument("paths", nargs="*")
    ap.add_argument("--games", type=int, default=None, help="games to play (default: --streams)")
    ap.add_argument("--streams", type=int, default=4096,
                    help="games the numpy streams are drawn for (the JAX script's --games)")
    ap.add_argument("--chunk", type=int, default=0, help="games a chunk (0: all)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.mode == "torch":
        recs = run(args.games or args.streams, args.streams, args.chunk, args.device)
        out = args.out or "traj_torch.jsonl"
        with open(out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in recs)
        print(f"[torch] DONE {len(recs)} games -> {out}")
        return 0
    if len(args.paths) != 2:
        ap.error("compare takes REF_F OUT_F")
    result = compare(load(args.paths[0]), load(args.paths[1]))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 1 if result["mismatched_games"] else 0


if __name__ == "__main__":
    sys.exit(main())
