"""Large-scale differential stress of the port's canonical engine against
the rules oracle: move-set equality (and order for non-doubles) over
thousands of random positions.

Counterpart of ``scripts/stress_movegen2.py``, with its contract: batch
``bi`` is the 128 positions of ``sample_cases(50_000 + bi, 128,
doubles_bias)`` (``oracle/sampling.py``). The engine runs on the card
(unless ``--device cpu``) and ``oracle.rules.full_moves`` on the host; the
engine's outputs come to the host once a batch. A non-double must present
the oracle's afterstates in the oracle's order, a double the same set at the
same count.

Two configurations:

  a  ``MoveGenConfig(algo="canonical", dd_subbatch_div=0)`` through the
     merged ``movegen2.legal_moves``, doubles_bias 0.35 (the JAX script's).
     Its non-doubles tail is the fused nd_tail kernel at K = 576.
  b  ``Config.production().movegen`` (``MoveGenConfig.fast()``) through
     the main path's ``movegen2.legal_moves_split``, iid dice (bias 0: the
     production doubles sub-batch assumes them). Each row's afterstates
     are read from the plane it lives in: ``nd_boards`` where ``nd_keep``,
     ``ndw_boards[ndw_slot]`` where ``ndw_in``, ``dd_boards[dd_slot]``
     where ``dd_in``.

A row whose overflow flag is set may legitimately differ (a width
truncated its candidates, the reference's Q7 class): such rows are counted
and reported. Every other row must equal the oracle, so a mismatch on a row
without the flag is a mismatch. Prints a JSON report and then ``done: N
positions, M mismatches`` for each configuration; exit status 1 on any
mismatch.

Usage:
  python -m mlp_ppo_2ply_multi_tpu_torch.scripts.stress_movegen2 [n_batches] \\
      [--configs a b] [--device cuda|cpu] [--out report.json]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from mlp_ppo_2ply_multi_tpu_torch.core.config import Config, MoveGenConfig
from mlp_ppo_2ply_multi_tpu_torch.core.device import resolve_device
from mlp_ppo_2ply_multi_tpu_torch.engine import movegen2
from mlp_ppo_2ply_multi_tpu_torch.engine.board import Board
from mlp_ppo_2ply_multi_tpu_torch.experimental import nd_tail
from mlp_ppo_2ply_multi_tpu_torch.oracle import rules
from mlp_ppo_2ply_multi_tpu_torch.oracle.sampling import sample_cases

BATCH = 128
SEED0 = 50_000
MAX_PRINTED = 20  # mismatch lines printed per configuration


def configs() -> Dict[str, Tuple[MoveGenConfig, float, bool]]:
    """name -> (movegen config, doubles bias, split planes)."""
    return {
        # dd_subbatch_div=0: the sampled dice are doubles-heavy (bias 0.35 >>
        # 1/6), which would overflow the iid-dice sub-batch
        "a": (MoveGenConfig(algo="canonical", dd_subbatch_div=0), 0.35, False),
        "b": (Config.production().movegen, 0.0, True),
    }


def oracle_afterstates(board, player: int, dice) -> List[tuple]:
    """The oracle's afterstates of one position, in its order."""
    return [b for _, b in rules.full_moves(board, player, list(dice))]


def _as_tuple(row: List[int]) -> tuple:
    return (tuple(row[0:24]), tuple(row[24:48]), (row[48], row[49]), (row[50], row[51]))


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def engine_rows(cfg: MoveGenConfig, split: bool, board: torch.Tensor, player: torch.Tensor,
                dice: torch.Tensor) -> Tuple[Callable[[int], np.ndarray], np.ndarray]:
    """One engine call on a batch; its outputs copied to the host at once.
    Returns (row g -> int8 [moves, 52] afterstates in slot order, overflow
    bool [n])."""
    if not split:
        ms = movegen2.legal_moves(Board(board), player, dice, cfg)
        boards, valid = _host(ms.boards.data), _host(ms.valid)
        return (lambda g: boards[g][valid[g]]), _host(ms.overflow)
    sm = movegen2.legal_moves_split(Board(board), player, dice, cfg)
    h = {f: _host(getattr(sm, f).data if f.endswith("boards") else getattr(sm, f))
         for f in ("nd_boards", "nd_keep", "ndw_boards", "ndw_keep", "ndw_in", "ndw_slot",
                   "dd_boards", "dd_valid", "dd_in", "dd_slot")}
    is_double = _host(dice[:, 0] == dice[:, 1])

    def rows(g: int) -> np.ndarray:
        if is_double[g]:
            if not h["dd_in"][g]:
                return h["dd_boards"][:0, 0]
            s = h["dd_slot"][g]
            return h["dd_boards"][s][h["dd_valid"][s]]
        if h["ndw_in"][g]:
            s = h["ndw_slot"][g]
            return h["ndw_boards"][s][h["ndw_keep"][s]]
        return h["nd_boards"][g][h["nd_keep"][g]]

    return rows, _host(sm.overflow)


def run(name: str, n_batches: int, device=None, log: Callable[[str], None] = print
        ) -> Dict[str, object]:
    """Configuration ``name`` over the batches of seeds ``SEED0 .. SEED0 +
    n_batches - 1``.
    Returns the report: positions, mismatches, overflow rows (and how many of
    them differ), seconds in the engine and the oracle, positions/s and the
    nd_tail kernel's launches in the run."""
    dev = resolve_device(device)
    cfg, bias, split = configs()[name]
    launches0 = nd_tail.KERNEL.launches
    bad = overflow = overflow_differ = printed = 0
    t_engine = t_oracle = 0.0
    t0 = time.perf_counter()
    for bi in range(n_batches):
        boards, players, dice = sample_cases(SEED0 + bi, BATCH, doubles_bias=bias)
        data = np.array([list(b[0]) + list(b[1]) + list(b[2]) + list(b[3]) for b in boards],
                        dtype=np.int8)
        t1 = time.perf_counter()
        rows, over = engine_rows(
            cfg, split, torch.from_numpy(data).to(dev),
            torch.tensor(players, dtype=torch.int32, device=dev),
            torch.tensor(dice, dtype=torch.int32, device=dev))
        t2 = time.perf_counter()
        for g in range(BATCH):
            want = oracle_afterstates(boards[g], players[g], dice[g])
            got = [_as_tuple(r) for r in rows(g).tolist()]
            if dice[g][0] == dice[g][1]:
                ok = set(got) == set(want) and len(got) == len(want)
            else:
                ok = got == want
            overflow += bool(over[g])
            if ok:
                continue
            if over[g]:
                overflow_differ += 1
                continue
            bad += 1
            if printed < MAX_PRINTED:
                printed += 1
                log(f"MISMATCH config {name} batch {bi} game {g}: dice {dice[g]} player "
                    f"{players[g]} board {boards[g]}; want {len(want)} got {len(got)}")
        t_engine += t2 - t1
        t_oracle += time.perf_counter() - t2
        if (bi + 1) % 100 == 0:
            log(f"config {name}: {bi + 1} batches, {bad} mismatches, {overflow} overflow rows")
    seconds = time.perf_counter() - t0
    n = n_batches * BATCH
    return dict(config=name, movegen=dataclasses.asdict(cfg), doubles_bias=bias,
                split_planes=split, device=str(dev), batches=n_batches, positions=n, mismatches=bad,
                overflow_rows=overflow, overflow_rows_differing=overflow_differ,
                seconds=seconds, engine_s=t_engine, oracle_s=t_oracle,
                positions_per_s=n / seconds,
                nd_tail_launches=nd_tail.KERNEL.launches - launches0)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("n_batches", nargs="?", type=int, default=30)
    ap.add_argument("--configs", nargs="+", choices=tuple(configs()), default=["a"])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=None, help="write the reports here as JSON")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    reports = []
    for name in args.configs:
        rep = run(name, args.n_batches, dev)
        reports.append(rep)
        print(json.dumps(rep), flush=True)
        print(f"done: {rep['positions']} positions, {rep['mismatches']} mismatches", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(reports, f, indent=1)
    return 1 if any(r["mismatches"] for r in reports) else 0


if __name__ == "__main__":
    sys.exit(main())
