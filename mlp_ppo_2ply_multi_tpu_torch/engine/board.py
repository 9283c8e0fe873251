"""Batched board state and primitive operations (flat 52-cell layout).

Port of ``mlp_ppo_2ply_multi_tpu/engine/board.py``. A batch of boards is one
int8 tensor with a 52-cell minor axis:

    [ 0:24)  player-0 checkers per point
    [24:48)  player-1 checkers per point
    [48:50)  bar counts (p0, p1)
    [50:52)  borne-off counts (p0, p1)

Every predicate mirrors the reference's semantics (file:line cited per
function) and is bit-exact against the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from mlp_ppo_2ply_multi_tpu_torch.core.types import (
    BAR,
    BEAR_OFF,
    CHECKERS_PER_PLAYER,
    NUM_POINTS,
)

N_CELLS = 52
_BAR0, _OFF0 = 48, 50


class Board(NamedTuple):
    data: torch.Tensor  # int8[..., 52]

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        return tuple(self.data.shape[:-1])


# Starting position, reference immutable_board.py:27-70.
_INITIAL = np.zeros(N_CELLS, dtype=np.int8)
_INITIAL[0], _INITIAL[11], _INITIAL[16], _INITIAL[18] = 2, 5, 3, 5
_INITIAL[24 + 23], _INITIAL[24 + 12], _INITIAL[24 + 7], _INITIAL[24 + 5] = 2, 5, 3, 5


def initial_board(batch_shape: Tuple[int, ...], device: torch.device) -> Board:
    """Batch of starting positions (reference immutable_board.py:27-70)."""
    init = torch.as_tensor(_INITIAL, device=device)
    return Board(data=init.expand(*batch_shape, N_CELLS).clone())


def _p(player: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(player).to(torch.int64)


def player_points(board: Board, player: torch.Tensor) -> torch.Tensor:
    """int8[..., 24] checkers of ``player``."""
    p = _p(player)[..., None]
    return torch.where(p == 0, board.data[..., 0:24], board.data[..., 24:48])


def opponent_points(board: Board, player: torch.Tensor) -> torch.Tensor:
    return player_points(board, 1 - _p(player))


def _sel2(board: Board, base: int, player: torch.Tensor) -> torch.Tensor:
    p = _p(player)
    return torch.where(p == 0, board.data[..., base], board.data[..., base + 1])


def bar_count(board: Board, player: torch.Tensor) -> torch.Tensor:
    return _sel2(board, _BAR0, player)


def off_count(board: Board, player: torch.Tensor) -> torch.Tensor:
    return _sel2(board, _OFF0, player)


def apply_submove(
    board: Board,
    player: torch.Tensor,
    start: torch.Tensor,
    end: torch.Tensor,
    hits: torch.Tensor,
    valid: torch.Tensor,
) -> Board:
    """Apply one submove per batch element; no-op where ``valid`` is False.

    Semantics of reference immutable_board.py:183-258: remove a checker from
    ``start`` (or the bar when start==BAR), send a hit blot to the opponent's
    bar, add the checker to ``end`` (or the off tray when end==BEAR_OFF).
    """
    p = _p(player)
    q = 1 - p
    v = valid.to(torch.int8)
    hit = (hits & valid).to(torch.int8)
    start = start.to(torch.int64)
    end = end.to(torch.int64)
    own_from = torch.where(start == BAR, _BAR0 + p, start + 24 * p)
    own_to = torch.where(end == BEAR_OFF, _OFF0 + p, end + 24 * p)
    opp_at = end + 24 * q  # only used when hit (end is then a point)
    opp_bar = _BAR0 + q

    iota = torch.arange(N_CELLS, device=board.data.device)
    oh = lambda c: (c[..., None] == iota).to(torch.int8)
    delta = v[..., None] * (oh(own_to) - oh(own_from)) + hit[..., None] * (
        oh(opp_bar) - oh(opp_at)
    )
    return Board(data=board.data + delta)


# ---------------------------------------------------------------------------
# Predicates (reference conditions.py / env_helper.py)
# ---------------------------------------------------------------------------

_HOME_MASK = np.zeros((2, NUM_POINTS), dtype=bool)
_HOME_MASK[0, 18:24] = True  # P1 home, conditions.py:173
_HOME_MASK[1, 0:6] = True  # P2 home, conditions.py:171


def _home_mask(player: torch.Tensor, device: torch.device) -> torch.Tensor:
    hm = torch.as_tensor(_HOME_MASK, device=device)
    return torch.where(_p(player)[..., None] == 0, hm[0], hm[1])


def has_won(board: Board, player: torch.Tensor) -> torch.Tensor:
    """reference conditions.py:137-149 (borne_off == 15)."""
    return off_count(board, player) == CHECKERS_PER_PLAYER


def on_bar(board: Board, player: torch.Tensor) -> torch.Tensor:
    """reference conditions.py:122-134."""
    return bar_count(board, player) > 0


def all_checkers_home(board: Board, player: torch.Tensor) -> torch.Tensor:
    """reference conditions.py:152-194: no bar checkers and no checkers
    outside the home board."""
    own = player_points(board, player).to(torch.int32)
    outside = torch.where(_home_mask(player, own.device), 0, own).sum(-1)
    return (~on_bar(board, player)) & (outside == 0)


def board_state_kind(board: Board, player: torch.Tensor) -> torch.Tensor:
    """reference conditions.py:5-22 priority: GAME_OVER > ON_BAR > BEAR_OFF >
    NORMAL. Returns int8 codes from BoardStateKind."""
    home = all_checkers_home(board, player)
    kind = torch.where(home, 2, 0).to(torch.int8)
    kind = torch.where(on_bar(board, player), 1, kind).to(torch.int8)
    kind = torch.where(has_won(board, player), 3, kind).to(torch.int8)
    return kind


def is_gammon(board: Board, winner: torch.Tensor) -> torch.Tensor:
    """reference env_helper.py:120-127: opponent borne off nothing."""
    return off_count(board, 1 - _p(winner)) == 0


def is_backgammon(board: Board, winner: torch.Tensor) -> torch.Tensor:
    """reference env_helper.py:130-163: opponent borne off nothing AND has a
    checker in the winner's home board or on the bar."""
    opp = 1 - _p(winner)
    opp_pts = player_points(board, opp).to(torch.int32)
    in_home = torch.where(_home_mask(winner, opp_pts.device), opp_pts, 0).sum(-1) > 0
    return is_gammon(board, winner) & (in_home | on_bar(board, opp))


def is_closed_out(board: Board, player: torch.Tensor) -> torch.Tensor:
    """reference env_helper.py:218-242: opponent on the bar and every point of
    the player's home board holds >= 2 of the player's checkers."""
    own = player_points(board, player)
    made = torch.where(_home_mask(player, own.device), own >= 2, True)
    return on_bar(board, 1 - _p(player)) & made.all(-1)


def has_five_prime(board: Board, player: torch.Tensor) -> torch.Tensor:
    """reference env_helper.py:167-215: a run of >=5 consecutive points each
    holding >=2 of the player's checkers, with at least one opponent checker
    "behind" the prime (ahead of it in the player's direction of travel)."""
    own = player_points(board, player)
    opp = player_points(board, 1 - _p(player))
    made = own >= 2  # [..., 24]
    w = made
    for shift in range(1, 5):
        w = w & torch.roll(made, -shift, dims=-1)
    idx = torch.arange(NUM_POINTS, device=own.device)
    window_ok = w & (idx <= NUM_POINTS - 5)

    opp_any = (opp > 0).to(torch.int32)
    suffix = torch.flip(torch.cumsum(torch.flip(opp_any, (-1,)), -1), (-1,))
    prefix = torch.cumsum(opp_any, -1)
    zeros = lambda k: torch.zeros(
        (*suffix.shape[:-1], k), dtype=suffix.dtype, device=suffix.device
    )
    after = torch.cat([suffix[..., 5:], zeros(5)], -1)
    before = torch.cat([zeros(1), prefix[..., :-1]], -1)
    behind = torch.where(_p(player)[..., None] == 0, after, before) > 0
    return (window_ok & behind).any(-1)


def checker_conservation_ok(board: Board) -> torch.Tensor:
    """Property invariant: each player's points + bar + off == 15."""
    d = board.data.to(torch.int32)
    t0 = d[..., 0:24].sum(-1) + d[..., _BAR0] + d[..., _OFF0]
    t1 = d[..., 24:48].sum(-1) + d[..., _BAR0 + 1] + d[..., _OFF0 + 1]
    return (t0 == CHECKERS_PER_PLAYER) & (t1 == CHECKERS_PER_PLAYER)


def pack_board(board: Board) -> torch.Tensor:
    """int8[..., 52] compact form — the identity in the flat layout."""
    return board.data


def unpack_board(packed: torch.Tensor) -> Board:
    return Board(data=packed)
