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

``legal_moves`` dispatches on ``MoveGenConfig.algo`` as the JAX module's
does: "canonical" is the sortless engine of ``movegen2``; "sorted" is this
module's exact reference-order engine (JAX ``movegen.py:442-891``): board
hashes, a sort-based first-occurrence dedup and a level-wise doubles DFS.
Its board takes with data-dependent indices go through the row take
``ops.take_rows`` (the CUDA kernel on a card); the JAX sorts become stable
``torch.sort`` calls, its uint32 hash arithmetic int64 masked to 32 bits,
and its associative scan a ``cummin``. No step of it synchronises the host
with the card.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from mlp_ppo_2ply_multi_tpu_torch.core.config import MoveGenConfig
from mlp_ppo_2ply_multi_tpu_torch.core.device import device_constant
from mlp_ppo_2ply_multi_tpu_torch.core.types import BAR, BEAR_OFF, NUM_POINTS
from mlp_ppo_2ply_multi_tpu_torch.engine.board import (
    MASK32,
    Board,
    apply_submove,
    board_hash,
    board_state_kind,
    hash_delta_slots,
    opponent_points,
    player_points,
)
from mlp_ppo_2ply_multi_tpu_torch.ops.take_rows import take_rows

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


class SlotStats(NamedTuple):
    """Die-independent mover-side board statistics consumed by slot_valid;
    computed once per board and combined with several dice
    (``slot_valid_stats``) by the 2-ply scorer, which tests each first-die
    child set against five second dice."""

    own: torch.Tensor  # int8[..., 24]
    kind: torch.Tensor  # int8[...]
    last: torch.Tensor  # int64[...] farthest occupied home point


def slot_stats(board: Board, player: torch.Tensor) -> SlotStats:
    p = _bcast(player, board.batch_shape)
    return SlotStats(
        own=player_points(board, p),
        kind=board_state_kind(board, p),
        last=farthest_point(board, p),
    )


def slot_valid(
    board: Board, player: torch.Tensor, die: torch.Tensor, ctx: SlotCtx
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Validity bits of ``slot_table(board, player, die).valid`` with the
    opponent-side tests taken from a root SlotCtx — bit-exact for any board
    reachable from that root within the turn.

    Returns (valid bool[..., 27], farthest occupied home point int64[...]).
    """
    return slot_valid_stats(slot_stats(board, player), player, die, ctx)


def slot_valid_stats(
    stats: SlotStats, player: torch.Tensor, die: torch.Tensor, ctx: SlotCtx
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``slot_valid`` from precomputed SlotStats."""
    bs = stats.kind.shape
    p = _bcast(player, bs)
    d = _bcast(die, bs)
    own, kind, last = stats.own, stats.kind, stats.last

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


# ---------------------------------------------------------------------------
# the sorted reference-order engine (JAX movegen.py:442-891)
# ---------------------------------------------------------------------------

_INF32 = 0x7FFFFFFF


def _delta_over_slots(b: Board, player: torch.Tensor, st: SlotTable):
    """Hash deltas of every slot; board batch [...], slots [..., S]."""
    return hash_delta_slots(b.data, player, st.start, st.end, st.hits)


def _take_st(st: SlotTable, idx: torch.Tensor) -> SlotTable:
    return SlotTable(*(torch.gather(a, -1, idx) for a in st))


def _flat_st(st: SlotTable) -> SlotTable:
    return SlotTable(*(a.flatten(-2) for a in st))


def _rows(b: Board, idx: torch.Tensor) -> Board:
    """``board_take`` of a data-dependent per-game index through the row
    take (``ops.take_rows``): board batch [N, W], idx [N, K] in [0, W)."""
    return Board(data=take_rows(b.data, idx))


def _stable_argsort(key: torch.Tensor) -> torch.Tensor:
    return torch.sort(key, dim=-1, stable=True).indices


def _segmented_min_to_group_first(values: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """For group-contiguous ``values`` (int, in [0, 2^32)) with ``first``
    marking each group's first element: at every position, the min over
    [pos .. group end]. Each position's key puts its group's number above
    its value, so a reversed running min (``cummin``) never reaches into a
    later group: the segmented scan of JAX ``movegen.py:462-481``."""
    group = torch.cumsum(first.to(torch.int64), -1) << 32
    key = torch.flip(group + values.to(torch.int64), (-1,))
    return torch.flip(torch.cummin(key, -1).values, (-1,)) - group


def dedup_compact(
    h1: torch.Tensor,
    h2: torch.Tensor,
    valid: torch.Tensor,
    width: int,
    flag_rank: Optional[torch.Tensor] = None,
):
    """First-occurrence dedup over the candidate axis (last) and compaction
    (JAX ``movegen.py:484-533``): for ``width`` output slots in rank
    (= index = reference enumeration) order, (orig_idx int64, out_valid,
    min-merged flag_rank or None). The earliest candidate of each distinct
    valid (h1, h2) survives (add_unique_board, reference
    handle_move_types.py:196-221).

    Every output slot, the spare ones too, equals JAX's: ``jnp.lexsort((h2,
    h1, inval))`` is a stable sort on the (h1, h2) pair as one int64 key
    (unsigned order kept by offsetting h1), then a stable partition of the
    valid entries ahead of the invalid ones."""
    n = h1.shape[-1]
    width = min(width, n)
    key = (h1 - 2**31) * 2**32 + h2
    perm = _stable_argsort(key)
    v_p = torch.gather(valid, -1, perm)
    nv = v_p.sum(-1, keepdim=True)
    pos = torch.where(v_p, torch.cumsum(v_p, -1) - 1, nv + torch.cumsum(~v_p, -1) - 1)
    perm = torch.empty_like(perm).scatter_(-1, pos, perm)

    take = lambda a: torch.gather(a, -1, perm)
    v_s, h1_s, h2_s = take(valid), take(h1), take(h2)
    same_prev = (h1_s[..., 1:] == h1_s[..., :-1]) & (h2_s[..., 1:] == h2_s[..., :-1]) \
        & v_s[..., :-1]
    is_first = v_s.clone()
    is_first[..., 1:] &= ~same_prev

    mfr_s = None
    if flag_rank is not None:
        mfr_s = _segmented_min_to_group_first(take(flag_rank), is_first)

    # JAX's stable argsort of where(is_first, rank, INF): the keepers in
    # rank (candidate index) order, then every other position in sorted
    # order; the output position of each is counted, not sorted for.
    keep_at = torch.zeros_like(is_first).scatter_(-1, perm, is_first)
    rank_pos = torch.gather(torch.cumsum(keep_at, -1) - 1, -1, perm)
    rest_pos = is_first.sum(-1, keepdim=True) + torch.cumsum(~is_first, -1) - 1
    pos = torch.where(is_first, rank_pos, rest_pos)
    perm2 = torch.empty_like(perm).scatter_(-1, pos, torch.arange(n, device=perm.device)
                                            .expand_as(perm))[..., :width]
    g = lambda a: torch.gather(a, -1, perm2)
    return g(perm), g(is_first), (g(mfr_s) if mfr_s is not None else None)


# Non-doubles (reference generate_all_moves.py:25-53, handle_move_types.py:
# 7-81). Static candidate layout: [pass-A pairs (729) | pass-A singles (27) |
# pass-B pairs (729) | pass-B singles (27)].
_N_ND = 2 * (N_SLOTS * N_SLOTS + N_SLOTS)
_c = np.arange(_N_ND)
_CAND_PASS = (_c >= N_SLOTS * N_SLOTS + N_SLOTS).astype(np.int64)
_off = _c - _CAND_PASS * (N_SLOTS * N_SLOTS + N_SLOTS)
_is_pair = _off < N_SLOTS * N_SLOTS
_CAND_I = np.where(_is_pair, _off // N_SLOTS, _off - N_SLOTS * N_SLOTS).astype(np.int64)
_CAND_J = np.where(_is_pair, _off % N_SLOTS, -1).astype(np.int64)
_CAND = np.stack([_CAND_PASS, _CAND_I, _CAND_J])
del _c, _off, _is_pair


def _nondoubles_pass(board: Board, player, d_first, d_second, h0):
    """One ordering pass (JAX ``movegen.py:552-578``): first-ply slots s1
    and afterstates b1 [N, 27], second-ply slots s2 [N, 27, 27], hashes of
    both plies, pair and single validity."""
    s1 = slot_table(board, player, d_first)
    p27 = player[..., None]
    b1 = apply_submove(board_expand(board, N_SLOTS), p27, s1.start, s1.end, s1.hits, s1.valid)
    d1_1, d1_2 = _delta_over_slots(board, player, s1)
    h1 = ((h0[0][..., None] + d1_1) & MASK32, (h0[1][..., None] + d1_2) & MASK32)

    s2 = slot_table(b1, p27, d_second[..., None])
    d2_1, d2_2 = _delta_over_slots(b1, p27, s2)
    hp = ((h1[0][..., None] + d2_1) & MASK32, (h1[1][..., None] + d2_2) & MASK32)

    pair_valid = s1.valid[..., None] & s2.valid
    any_pair = pair_valid.any(-1).any(-1)
    single_valid = s1.valid & ~any_pair[..., None]
    return s1, b1, s2, h1, hp, pair_valid, any_pair, single_valid


def _unique_count_upto2(h1, h2, valid):
    """Distinct (h1, h2) among the valid entries (27: a pairwise compare)."""
    eq = (h1[..., None, :] == h1[..., :, None]) & (h2[..., None, :] == h2[..., :, None])
    n = h1.shape[-1]
    earlier = torch.ones((n, n), dtype=torch.bool, device=h1.device).tril(-1)
    dup = (eq & earlier & valid[..., None, :]).any(-1)
    return (valid & ~dup).sum(-1, dtype=torch.int32)


def enumerate_nondoubles(board: Board, player, dice, cfg: MoveGenConfig) -> MoveSet:
    """Non-doubles enumeration in reference order (JAX ``movegen.py:
    595-662``) over a board batch [N]: pass A high die first, pass B low
    die first, skipped iff A gave exactly one unique single-submove move;
    one dedup across both passes in insertion order, then the max-submove
    filter and the Q7 cap. The first-ply afterstates of the survivors come
    through the row take."""
    d_hi = torch.maximum(dice[..., 0], dice[..., 1]).to(torch.int64)
    d_lo = torch.minimum(dice[..., 0], dice[..., 1]).to(torch.int64)
    h0 = board_hash(board)

    sA1, bA1, sA2, hA1, hAp, pvA, anyA, svA = _nondoubles_pass(board, player, d_hi, d_lo, h0)
    sB1, bB1, sB2, hB1, hBp, pvB, anyB, svB = _nondoubles_pass(board, player, d_lo, d_hi, h0)

    skip_b = (~anyA) & (_unique_count_upto2(hA1[0], hA1[1], svA) == 1)
    pvB = pvB & ~skip_b[..., None, None]
    svB = svB & ~skip_b[..., None]
    any_pair = anyA | pvB.any(-1).any(-1)  # must use both dice
    svA = svA & ~any_pair[..., None]
    svB = svB & ~any_pair[..., None]

    flat2 = lambda a: a.flatten(-2)
    valid = torch.cat([flat2(pvA), svA, flat2(pvB), svB], -1)
    ch1 = torch.cat([flat2(hAp[0]), hA1[0], flat2(hBp[0]), hB1[0]], -1)
    ch2 = torch.cat([flat2(hAp[1]), hA1[1], flat2(hBp[1]), hB1[1]], -1)
    out_idx, out_valid, _ = dedup_compact(ch1, ch2, valid, cfg.a_max)

    cpass, ci, cj = device_constant("movegen.nd_candidates", _CAND, board.data.device)[:, out_idx]
    first = board_where(cpass == 0, _rows(bA1, ci), _rows(bB1, ci))
    lin = (ci * N_SLOTS + cj.clamp_min(0)).clamp(0, N_SLOTS * N_SLOTS - 1)
    stA, stB = _take_st(_flat_st(sA2), lin), _take_st(_flat_st(sB2), lin)
    st2 = SlotTable(*(torch.where(cpass == 0, a, b) for a, b in zip(stA, stB)))
    after = apply_submove(first, player[..., None], st2.start, st2.end, st2.hits,
                          st2.valid & (cj >= 0) & out_valid)
    return MoveSet(boards=after, valid=out_valid, count=out_valid.sum(-1, dtype=torch.int32))


# Doubles (reference handle_move_types.py:84-193)


class _Frontier(NamedTuple):
    boards: Board  # [N, W]
    h1: torch.Tensor
    h2: torch.Tensor
    valid: torch.Tensor
    # rank of the earliest only-child DFS prefix reaching this board, INF
    # when none (drives forced-shorter recording)
    flag_rank: torch.Tensor


class _Shorts(NamedTuple):
    boards: Board
    rank: torch.Tensor  # record position = flag_rank of the entry
    valid: torch.Tensor


def _expand_level(front: _Frontier, player, die, out_width: int) -> Tuple[_Frontier, _Shorts]:
    """One submove deeper (JAX ``movegen.py:684-738``), and this level's
    forced-shorter records: entries with no children whose own submove was
    the only option at its depth. The parents of the survivors come through
    the row take."""
    w = front.valid.shape[-1]
    pw = player[..., None]
    st = slot_table(front.boards, pw, die[..., None])  # [N, W, 27]
    child_valid = front.valid[..., None] & st.valid
    pcc = child_valid.sum(-1)
    shorts = _Shorts(front.boards, front.flag_rank,
                     front.valid & (pcc == 0) & (front.flag_rank < _INF32))

    d1, d2 = _delta_over_slots(front.boards, pw, st)
    cf1 = ((front.h1[..., None] + d1) & MASK32).flatten(-2)
    cf2 = ((front.h2[..., None] + d2) & MASK32).flatten(-2)
    # flattened child index == DFS rank at this level (the frontier is
    # rank-sorted)
    n = w * N_SLOTS
    child_rank = torch.arange(n, device=pcc.device)
    cfr = torch.where(((pcc == 1)[..., None] & child_valid).flatten(-2), child_rank, _INF32)
    out_idx, out_valid, out_mfr = dedup_compact(cf1, cf2, child_valid.flatten(-2), out_width,
                                                flag_rank=cfr)

    pboards = _rows(front.boards, out_idx // N_SLOTS)
    stg = _take_st(_flat_st(st), out_idx)
    nboards = apply_submove(pboards, pw, stg.start, stg.end, stg.hits, stg.valid & out_valid)
    nf = _Frontier(nboards, torch.gather(cf1, -1, out_idx), torch.gather(cf2, -1, out_idx),
                   out_valid, out_mfr)
    return nf, shorts


def _shorts_to_set(sh: _Shorts, use: torch.Tensor) -> MoveSet:
    v = sh.valid & use[..., None]
    p = _stable_argsort(torch.where(v, sh.rank, _INF32))
    vs = torch.gather(v, -1, p)
    return MoveSet(boards=_rows(sh.boards, p), valid=vs, count=vs.sum(-1, dtype=torch.int32))


def _pad_to(ms: MoveSet, width: int) -> MoveSet:
    """The first ``width`` slots, or the slots tiled to ``width`` with the
    padding invalid (JAX's static takes by ``arange`` and ``arange % cur``,
    as slices and an index_select)."""
    cur = ms.valid.shape[-1]
    if cur >= width:
        return MoveSet(Board(ms.boards.data[..., :width, :]), ms.valid[..., :width],
                       ms.count.clamp(max=width))
    idx = torch.arange(width, device=ms.valid.device) % cur
    pad = torch.zeros((*ms.valid.shape[:-1], width - cur), dtype=torch.bool,
                      device=ms.valid.device)
    return MoveSet(Board(ms.boards.data.index_select(-2, idx)),
                   torch.cat([ms.valid, pad], -1), ms.count)


def _merge(a: MoveSet, b: MoveSet, use_a: torch.Tensor) -> MoveSet:
    return MoveSet(
        boards=board_where(use_a[..., None].expand_as(a.valid), a.boards, b.boards),
        valid=torch.where(use_a[..., None], a.valid, b.valid),
        count=torch.where(use_a, a.count, b.count),
    )


def enumerate_doubles(board: Board, player, die, cfg: MoveGenConfig) -> MoveSet:
    """Doubles enumeration in reference order by dedup-merged level-wise DFS
    (JAX ``movegen.py:741-866``, which argues why merging duplicates that
    keep the earliest rank preserves every final board's first-occurrence
    position). Forced-shorter sequences are recorded where a frontier entry
    has no children and was its parent's only child; the result is the
    level-4 frontier when it has any board, else the deepest non-empty
    level of forced records. Board batch [N]."""
    h0_1, h0_2 = board_hash(board)
    s1 = slot_table(board, player, die)
    root_count = s1.valid.sum(-1)

    # level 1: the valid slots compacted in slot order (no two slots give
    # the same board). Every row of board_expand is the root board, so
    # JAX's take of it by perm is the expand itself.
    key = torch.where(s1.valid, torch.arange(N_SLOTS, device=die.device), _INF32)
    perm = _stable_argsort(key)[..., : cfg.w1]
    st1 = _take_st(s1, perm)
    f_valid = st1.valid
    b1 = apply_submove(board_expand(board, perm.shape[-1]), player[..., None],
                       st1.start, st1.end, st1.hits, st1.valid)
    d1, d2 = _delta_over_slots(board, player, s1)
    rank1 = torch.gather(key, -1, perm)  # the slot index where valid
    only = (root_count == 1)[..., None] & f_valid
    front = _Frontier(
        boards=b1,
        h1=(h0_1[..., None] + torch.gather(d1, -1, perm)) & MASK32,
        h2=(h0_2[..., None] + torch.gather(d2, -1, perm)) & MASK32,
        valid=f_valid,
        flag_rank=torch.where(only, rank1, _INF32),
    )

    front2, shorts1 = _expand_level(front, player, die, cfg.w2)
    front3, shorts2 = _expand_level(front2, player, die, cfg.w3)
    front4, shorts3 = _expand_level(front3, player, die, cfg.w4)

    has4 = front4.valid.any(-1)
    a3 = shorts3.valid.any(-1)
    a2 = shorts2.valid.any(-1)
    use3 = ~has4 & a3
    use2 = ~has4 & ~a3 & a2
    use1 = ~has4 & ~a3 & ~a2
    m4 = MoveSet(front4.boards, front4.valid & has4[..., None],
                 front4.valid.sum(-1, dtype=torch.int32))
    m4p, m3p, m2p, m1p = (
        _pad_to(m, cfg.a_max)
        for m in (m4, _shorts_to_set(shorts3, use3), _shorts_to_set(shorts2, use2),
                  _shorts_to_set(shorts1, use1))
    )
    out = _merge(m4p, m3p, has4)
    out = _merge(out, m2p, has4 | use3)
    out = _merge(out, m1p, has4 | use3 | use2)
    return out._replace(count=out.count.clamp(max=cfg.a_max))


def _legal_moves_sorted(board: Board, player, dice, cfg: MoveGenConfig) -> MoveSet:
    """The sorted engine over any batch shape (flattened to [N] so each
    row take sees contiguous [N, W, 52] tables). Its MoveSet has no
    overflow: the JAX engine does not track one."""
    bs = board.batch_shape
    n = math.prod(bs)
    dev = board.data.device
    fb = Board(board.data.reshape(n, board.data.shape[-1]))
    fp = torch.broadcast_to(torch.as_tensor(player, device=dev), bs).reshape(n).to(torch.int64)
    fd = torch.broadcast_to(torch.as_tensor(dice, device=dev), (*bs, 2)).reshape(n, 2)
    fd = fd.to(torch.int64)
    nd = enumerate_nondoubles(fb, fp, fd, cfg)
    dd = enumerate_doubles(fb, fp, fd[..., 0], cfg)
    is_double = fd[..., 0] == fd[..., 1]
    ms = _merge(dd, nd, is_double)
    a = ms.valid.shape[-1]
    return MoveSet(
        boards=Board(ms.boards.data.reshape(*bs, a, ms.boards.data.shape[-1])),
        valid=ms.valid.reshape(*bs, a),
        count=ms.count.reshape(bs),
    )


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def moveset_width(cfg: MoveGenConfig) -> int:
    """Slots of the MoveSet ``legal_moves`` returns: a_max for the sorted
    engine, max(a_max, nd_dedup_k) for the canonical one."""
    if cfg.algo == "canonical":
        return max(cfg.a_max, cfg.nd_dedup_k)
    return cfg.a_max


def check_canonical(cfg: MoveGenConfig) -> None:
    """Raise unless ``cfg.algo`` names the canonical engine: the split-planes
    path (``movegen2.legal_moves_split``) has no sorted form, in JAX as
    here."""
    if cfg.algo != "canonical":
        raise NotImplementedError(
            f"MoveGenConfig.algo={cfg.algo!r}: legal_moves_split runs the canonical "
            "engine only; the sorted engine runs through movegen.legal_moves"
        )


def legal_moves(
    board: Board, player: torch.Tensor, dice: torch.Tensor, cfg: MoveGenConfig
) -> MoveSet:
    """All legal full moves per game as afterstate boards, capped at
    cfg.a_max (Q7). Dispatches on ``cfg.algo`` (JAX ``movegen.py:870-891``):
    "canonical" is ``movegen2.legal_moves``, "sorted" this module's exact
    reference-order engine."""
    if cfg.algo == "canonical":
        from mlp_ppo_2ply_multi_tpu_torch.engine import movegen2

        return movegen2.legal_moves(board, player, dice, cfg)
    return _legal_moves_sorted(board, player, dice, cfg)
