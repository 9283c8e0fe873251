"""Random legal-position sampling for differential tests.

Copy of ``mlp_ppo_2ply_multi_tpu/oracle/sampling.py`` (``random_board``,
``random_roll``) on the port's own ``oracle/rules.py``, plus
``sample_cases``, the position batches that the repo's tests and the
rules stress (``scripts/stress_movegen2.py``) draw from one seed.

Positions satisfy backgammon invariants: 15 checkers per player across
points/bar/off, and no point occupied by both players. Distribution is
chosen to exercise all move-gen states (normal, bar, bear-off, near-win,
doubles forced chains), not to match real play frequencies.
"""
from __future__ import annotations

import random
from typing import List, Tuple

from mlp_ppo_2ply_multi_tpu_torch.oracle.rules import BoardT


def random_board(rng: random.Random, mode: str = "mixed") -> BoardT:
    """mode: 'mixed' | 'race' (no contact, bear-off heavy) | 'bar' (checkers
    on the bar) | 'dense' (tall points, forced chains likely)."""
    if mode == "mixed":
        mode = rng.choice(["open", "open", "race", "bar", "dense", "endgame"])

    pts = [[0] * 24, [0] * 24]
    bar = [0, 0]
    off = [0, 0]
    owner = [-1] * 24

    def place(player: int, n: int, candidates, max_stack: int) -> None:
        remaining = n
        while remaining > 0:
            i = rng.choice(candidates)
            if owner[i] not in (-1, player):
                continue
            k = min(remaining, rng.randint(1, max_stack))
            pts[player][i] += k
            owner[i] = player
            remaining -= k

    for player in (0, 1):
        n = 15
        if mode == "bar":
            bar[player] = rng.randint(0 if player else 1, 3)
            n -= bar[player]
        if mode in ("race", "endgame"):
            off[player] = rng.randint(0, 13 if mode == "endgame" else 7)
            n -= off[player]
        if mode == "endgame":
            home = list(range(18, 24)) if player == 0 else list(range(0, 6))
            place(player, n, home, 5)
        elif mode == "race":
            zone = list(range(12, 24)) if player == 0 else list(range(0, 12))
            place(player, n, zone, 5)
        elif mode == "dense":
            place(player, n, list(range(24)), 3)
        else:  # open
            place(player, n, list(range(24)), 6)
    return (tuple(pts[0]), tuple(pts[1]), tuple(bar), tuple(off))


def random_roll(rng: random.Random, doubles_bias: float = 0.0) -> Tuple[int, int]:
    if doubles_bias and rng.random() < doubles_bias:
        d = rng.randint(1, 6)
        return (d, d)
    return (rng.randint(1, 6), rng.randint(1, 6))


def sample_cases(
    seed: int, n: int, doubles_bias: float = 0.4
) -> Tuple[List[BoardT], List[int], List[Tuple[int, int]]]:
    """``n`` (board, player, dice) cases from one ``random.Random(seed)``:
    per case a board, the side to move, then the roll."""
    rng = random.Random(seed)
    boards, players, dice = [], [], []
    for _ in range(n):
        boards.append(random_board(rng))
        players.append(rng.randint(0, 1))
        dice.append(random_roll(rng, doubles_bias=doubles_bias))
    return boards, players, dice
