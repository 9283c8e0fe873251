"""Single-die slot tables and board-batch helpers used by the sortless engine.

Port of the parts of ``mlp_ppo_2ply_multi_tpu/engine/movegen.py`` that
``movegen2`` imports. The JAX version replaces every data-dependent lookup
with static-shift selects, select chains over static lanes and one-hot
matmuls, because row-varying lane gathers are slow on the TPU. Those are
TPU workarounds, not contract: here every lookup is a plain ``gather`` and
the results are bit-identical.

The 27-slot single-die move table (reference get_moves_one_die.py:13-251):
  0..23  normal move from point i (NORMAL and BEAR_OFF states)
  24     bar entry (ON_BAR state)
  25     farthest-checker bear-off
  26     exact-point bear-off
Slot order == reference emission order.

The sorted engine (``algo="sorted"``) is not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from mlp_ppo_2ply_multi_tpu_torch.core.types import BAR, BEAR_OFF, NUM_POINTS
from mlp_ppo_2ply_multi_tpu_torch.engine.board import (
    Board,
    board_state_kind,
    opponent_points,
    player_points,
)

N_SLOTS = 27


class SlotTable(NamedTuple):
    """Per-slot single-die submoves for a board batch; tensors [..., 27]."""

    start: torch.Tensor  # int64, 0..23 or 24 (bar)
    end: torch.Tensor  # int64, 0..23 or 25 (bear-off)
    hits: torch.Tensor  # bool
    valid: torch.Tensor  # bool


class MoveSet(NamedTuple):
    """Enumerated legal full moves as afterstates; the entry axis is the last
    batch axis of ``boards``."""

    boards: Board  # afterstates, batch [..., A]
    valid: torch.Tensor  # bool[..., A]
    count: torch.Tensor  # int32[...]
    # bool[...]: True where a fixed-shape width cap dropped a candidate
    overflow: Optional[torch.Tensor] = None


class SlotCtx(NamedTuple):
    """Opponent-side single-die context, computed once on a turn's ROOT board
    and reused for every board reachable from it within the turn (a hit only
    removes an opponent blot, which never flips a ``>= 2`` blocking test;
    see the JAX module's SlotCtx docstring for the full argument)."""

    move_ok: torch.Tensor  # bool[..., 24]: dest in-board and not blocked
    entry_free: torch.Tensor  # bool[...]: bar-entry point not blocked


def _bcast(x, shape) -> torch.Tensor:
    return torch.broadcast_to(torch.as_tensor(x).to(torch.int64), shape)


def _take_last(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[..., idx] for a per-row index idx[...] (same batch shape)."""
    return torch.gather(a, -1, idx[..., None])[..., 0]


def _dest(p: torch.Tensor, d: torch.Tensor):
    """(in_board bool[..., 24], clipped destination int64[..., 24]) of a
    normal move from each point."""
    iota = torch.arange(NUM_POINTS, device=p.device)
    dest = iota + (d * (1 - 2 * p))[..., None]
    in_board = (dest >= 0) & (dest < NUM_POINTS)
    return in_board, dest.clamp(0, NUM_POINTS - 1)


def _entry(p: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    return torch.where(p == 0, d - 1, NUM_POINTS - d)


def _exact(p: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    return torch.where(p == 0, NUM_POINTS - d, d - 1)


def farthest_point(board: Board, player: torch.Tensor) -> torch.Tensor:
    """Farthest occupied home point (get_moves_one_die.py:191-203), int64;
    defaults to the first home point when the home board is empty."""
    own = player_points(board, player)
    p = _bcast(player, board.batch_shape)
    iota = torch.arange(6, device=own.device)
    occ1 = own[..., 18:24] > 0
    first1 = torch.where(occ1, iota, 6).amin(-1)
    last_p1 = 18 + torch.where(occ1.any(-1), first1, 0)
    occ2 = own[..., 0:6] > 0
    last2 = torch.where(occ2, iota, -1).amax(-1)
    last_p2 = torch.where(occ2.any(-1), last2, 5)
    return torch.where(p == 0, last_p1, last_p2)


def slot_table(board: Board, player: torch.Tensor, die: torch.Tensor) -> SlotTable:
    """Single-die moves (reference get_moves_one_die.py:13-251) as a fixed
    27-slot table in reference emission order."""
    bs = board.batch_shape
    p = _bcast(player, bs)
    d = _bcast(die, bs)
    own = player_points(board, p)
    opp = opponent_points(board, p)
    kind = board_state_kind(board, p)

    in_board, dest_c = _dest(p, d)
    opp_at_dest = torch.where(in_board, torch.gather(opp, -1, dest_c), 0)
    normal_ok = (
        ((kind == 0) | (kind == 2))[..., None]
        & (own > 0)
        & in_board
        & (opp_at_dest < 2)
    )
    normal_hits = in_board & (opp_at_dest == 1)

    # slot 24: bar entry (get_moves_one_die.py:86-130)
    entry = _entry(p, d)
    opp_at_entry = _take_last(opp, entry)
    bar_ok = (kind == 1) & (opp_at_entry < 2)
    bar_hits = opp_at_entry == 1

    last = farthest_point(board, p)
    # slot 25: overshoot bear-off of the farthest checker (:206-214, :229-236)
    over_ok = (kind == 2) & torch.where(
        p == 0, last + d >= NUM_POINTS, last - d < 0
    )
    # slot 26: exact-point bear-off (:216-227, :238-249)
    exact = _exact(p, d)
    exact_ok = (kind == 2) & (exact != last) & (_take_last(own, exact) > 0)

    iota = torch.arange(NUM_POINTS, device=own.device).expand(*bs, NUM_POINTS)
    col = lambda x: x[..., None]
    full = lambda v: torch.full((*bs, 1), v, dtype=torch.int64, device=own.device)
    start = torch.cat([iota, full(BAR), col(last), col(exact)], -1)
    end = torch.cat([dest_c, col(entry), full(BEAR_OFF), full(BEAR_OFF)], -1)
    no = torch.zeros((*bs, 2), dtype=torch.bool, device=own.device)
    hits = torch.cat([normal_hits, col(bar_hits), no], -1)
    valid = torch.cat([normal_ok, col(bar_ok), col(over_ok), col(exact_ok)], -1)
    return SlotTable(start=start, end=end, hits=hits, valid=valid)


def slot_ctx(board: Board, player: torch.Tensor, die: torch.Tensor) -> SlotCtx:
    """Build the SlotCtx for ``board`` as the turn's root."""
    bs = board.batch_shape
    p = _bcast(player, bs)
    d = _bcast(die, bs)
    opp = opponent_points(board, p)
    in_board, dest_c = _dest(p, d)
    opp_at_dest = torch.where(in_board, torch.gather(opp, -1, dest_c), 0)
    opp_at_entry = _take_last(opp, _entry(p, d))
    return SlotCtx(
        move_ok=in_board & (opp_at_dest < 2), entry_free=opp_at_entry < 2
    )


def ctx_entry_axis(ctx: SlotCtx) -> SlotCtx:
    """Broadcast a root-batch SlotCtx against boards carrying one extra
    trailing entry axis (children / frontier entries of that root)."""
    return SlotCtx(
        move_ok=ctx.move_ok[..., None, :], entry_free=ctx.entry_free[..., None]
    )


def slot_valid(
    board: Board, player: torch.Tensor, die: torch.Tensor, ctx: SlotCtx
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Validity bits of ``slot_table(board, player, die).valid`` with the
    opponent-side tests taken from a root SlotCtx — bit-exact for any board
    reachable from that root within the turn.

    Returns (valid bool[..., 27], farthest occupied home point int64[...]).
    """
    bs = board.batch_shape
    p = _bcast(player, bs)
    d = _bcast(die, bs)
    own = player_points(board, p)
    kind = board_state_kind(board, p)
    last = farthest_point(board, p)

    normal_ok = ((kind == 0) | (kind == 2))[..., None] & (own > 0) & ctx.move_ok
    bar_ok = (kind == 1) & ctx.entry_free
    over_ok = (kind == 2) & torch.where(
        p == 0, last + d >= NUM_POINTS, last - d < 0
    )
    exact = _exact(p, d)
    exact_ok = (kind == 2) & (exact != last) & (_take_last(own, exact) > 0)
    col = lambda x: x[..., None]
    valid = torch.cat([normal_ok, col(bar_ok), col(over_ok), col(exact_ok)], -1)
    return valid, last


def slot_params(
    board: Board, player: torch.Tensor, die: torch.Tensor, slot: torch.Tensor
):
    """(start, end, hits) of the submove named by ``slot`` on per-row boards
    (``board``'s batch shape equals ``slot``'s shape)."""
    p = _bcast(player, slot.shape)
    d = _bcast(die, slot.shape)
    s = slot.to(torch.int64)
    last = farthest_point(board, p)
    exact = _exact(p, d)
    entry = _entry(p, d)
    start = torch.where(
        s < 24, s, torch.where(s == 24, BAR, torch.where(s == 25, last, exact))
    )
    end_normal = (s + d * (1 - 2 * p)).clamp(0, NUM_POINTS - 1)
    end = torch.where(s < 24, end_normal, torch.where(s == 24, entry, BEAR_OFF))
    opp = opponent_points(board, p)
    opp_at_end = torch.where(
        end == BEAR_OFF, 0, _take_last(opp, end.clamp(0, NUM_POINTS - 1))
    )
    hits = (end != BEAR_OFF) & (opp_at_end == 1)
    return start, end, hits


# ---------------------------------------------------------------------------
# board batch helpers
# ---------------------------------------------------------------------------

def board_expand(b: Board, n: int) -> Board:
    """Insert a broadcast entry axis of size n as the last batch axis."""
    return Board(data=b.data[..., None, :].expand(*b.batch_shape, n, b.data.shape[-1]))


def board_take(b: Board, idx: torch.Tensor) -> Board:
    """Gather along the entry axis (last batch axis); idx int[..., K] with the
    same leading shape as the board batch. Indices must be in range."""
    idx = idx.to(torch.int64)
    c = b.data.shape[-1]
    return Board(
        data=torch.gather(b.data, -2, idx[..., None].expand(*idx.shape, c))
    )


def board_where(pred: torch.Tensor, a: Board, b: Board) -> Board:
    """Per-entry select; pred bool[..., K] aligned with the entry axis."""
    return Board(data=torch.where(pred[..., None], a.data, b.data))
