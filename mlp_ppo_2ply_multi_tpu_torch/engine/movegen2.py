"""Sortless full-move enumeration: ``legal_moves_split`` (the 1-ply actor),
the merged ``legal_moves`` and the batched enumerations of the 2-ply scorer.

Port of ``mlp_ppo_2ply_multi_tpu/engine/movegen2.py`` (see its module
docstring for the algorithms and their reference citations):

* Non-doubles: two ordering passes over the 27-slot table give 1512
  candidate cells whose index order IS the reference's insertion order. The
  valid ones are compacted in order, their afterstates built, duplicates
  dropped by canonical delta signature (first occurrence kept), then the
  max-submove filter and the Q7 cap apply. The tail runs two-tier (width
  ``nd_tier`` for every game, full width ``nd_dedup_k`` on a sub-batch of the
  wide games), or else as one full-width pass through the fused tail
  (``experimental/nd_tail.py``: the CUDA kernel on a card; the 2-ply reply
  path). With ``nd_sig_dedup=False`` the dedup compares whole afterstates
  instead (JAX's Gram dedup, ``_dup_earlier_mask``), and the single-pass
  tail runs in plain PyTorch, where JAX runs its plain ``_nd_tail`` too.
* ``enumerate_nondoubles_raw`` stops before the dedup: every present
  candidate in insertion order with its signature and the exact
  max-submove bit (``nd_has_pair_exact``), for the 2-ply scorer's
  value-first replies.
* Doubles: canonical multiset enumeration (submove ranks nondecreasing), so
  no duplicates arise; run on a compacted sub-batch of the doubles games,
  two-tier there when ``dd_tier`` is set
  (``experimental.tiered.doubles_two_tier``).

The JAX version selects the k-th set bit with compare-reduces and one-hot
matmuls because binary search and row gathers are slow on the TPU. Here a
select is ``cumsum`` + ``torch.searchsorted`` and every take is a gather;
integer results are bit-identical. Slots that are not ok (beyond a row's
count) hold whatever the clipped indices produce: consumers read only valid
slots.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from mlp_ppo_2ply_multi_tpu_torch.core.config import MoveGenConfig
from mlp_ppo_2ply_multi_tpu_torch.core.tree import tmap
from mlp_ppo_2ply_multi_tpu_torch.core.types import BAR, BEAR_OFF, NUM_POINTS
from mlp_ppo_2ply_multi_tpu_torch.engine.board import Board, apply_submove, pack_board
from mlp_ppo_2ply_multi_tpu_torch.engine.movegen import (
    N_SLOTS,
    MoveSet,
    SlotCtx,
    SlotStats,
    SlotTable,
    board_expand,
    board_take,
    board_where,
    check_canonical,
    ctx_entry_axis,
    slot_ctx,
    slot_params,
    slot_table,
    slot_valid,
    slot_valid_stats,
)


def _popcount(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(-1, dtype=torch.int32)


def _select_set_bits(
    valid: torch.Tensor, width: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices of the first ``width`` True positions per row, in order.

    Returns (idx int64[..., width] clipped in-range, ok bool[..., width]):
    idx[k] = #(i : cs[i] <= k) with cs the inclusive popcount prefix, i.e.
    the position of the k-th set bit. Covers the JAX package's
    ``_select_set_bits``, ``_select_set_bits_blocked`` (blk = idx // BLOCK,
    loc = idx % BLOCK) and ``_select_set_bits_fast``: all three agree at ok
    slots.
    """
    n = valid.shape[-1]
    cs = torch.cumsum(valid.to(torch.int32), -1, dtype=torch.int32).contiguous()
    ks = torch.arange(width, dtype=torch.int32, device=valid.device)
    ks = ks.expand(*cs.shape[:-1], width).contiguous()
    idx = torch.searchsorted(cs, ks, right=True)
    ok = ks < cs[..., -1:]
    return idx.clamp_max(n - 1), ok


def _rows_in(mask: torch.Tensor, width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(in_sub, slot) for a sub-batch of the first ``width`` set rows of
    ``mask`` [n], the rows ``_select_set_bits(mask, width)`` gathers: for
    each row, whether the sub-batch holds it, and its place there (clipped
    to [0, width))."""
    rank = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32) - 1
    return mask & (rank < width), rank.clamp(0, width - 1)


def _take0(x, idx: torch.Tensor):
    """Row gather along the leading axis of a tensor or a Board."""
    if isinstance(x, Board):
        return Board(data=x.data[idx])
    return x[idx]


# ---------------------------------------------------------------------------
# Non-doubles
# ---------------------------------------------------------------------------


class _Pass(NamedTuple):
    s1: SlotTable  # first-ply slots on the root board
    b1: Board  # 27 first-ply afterstates
    s2_valid: torch.Tensor  # second-ply slot validity per afterstate [..., 27, 27]
    pair_valid: torch.Tensor
    any_pair: torch.Tensor
    single_valid: torch.Tensor


def _run_pass_pre(
    s1: SlotTable,
    b1: Board,
    player,
    d_second,
    ctx: Optional[SlotCtx] = None,
    stats: Optional[SlotStats] = None,
) -> _Pass:
    """A pass from a precomputed first-die slot table and children
    (``die_tables``). The second ply needs only validity: with a root SlotCtx
    for ``d_second`` it is the mover-side-only slot_valid (from the children's
    precomputed SlotStats when ``stats`` is given, as the 2-ply scorer does),
    without one the full slot_table."""
    p27 = player[..., None]
    if stats is not None:
        if ctx is None:
            raise ValueError("stats= needs ctx=")
        s2_valid, _ = slot_valid_stats(
            stats, p27, d_second[..., None], ctx_entry_axis(ctx)
        )
    elif ctx is None:
        s2_valid = slot_table(b1, p27, d_second[..., None]).valid
    else:
        s2_valid, _ = slot_valid(b1, p27, d_second[..., None], ctx_entry_axis(ctx))
    pair_valid = s1.valid[..., None] & s2_valid
    any_pair = pair_valid.flatten(-2).any(-1)
    single_valid = s1.valid & ~any_pair[..., None]
    return _Pass(s1, b1, s2_valid, pair_valid, any_pair, single_valid)


def _run_pass(board: Board, player, d_first, d_second) -> _Pass:
    """One ordering pass: first-ply slot table and children, second-ply
    validity from the mover-side-only slot_valid with a root SlotCtx."""
    s1 = slot_table(board, player, d_first)
    b1 = apply_submove(
        board_expand(board, N_SLOTS), player[..., None], s1.start, s1.end,
        s1.hits, s1.valid,
    )
    return _run_pass_pre(
        s1, b1, player, d_second, ctx=slot_ctx(board, player, d_second)
    )


def _six_dies(board: Board, player: torch.Tensor):
    """The board, player and dies 1..6 broadcast on a new leading [6] axis."""
    bs = board.batch_shape
    dev = board.data.device
    b6 = Board(data=board.data[None].expand(6, *board.data.shape))
    p6 = torch.broadcast_to(torch.as_tensor(player).to(torch.int64), (6, *bs))
    dies = torch.arange(1, 7, device=dev).reshape(6, *([1] * len(bs)))
    return b6, p6, dies.expand(6, *bs)


def die_tables(board: Board, player: torch.Tensor) -> Tuple[SlotTable, Board]:
    """First-ply slot tables and children for all six die values in one
    batched pass: SlotTable fields [6, ..., 27], children [6, ..., 27]. The
    2-ply scorer's 15 fixed non-double rolls need only these six (die ->
    table, children) results, not 30."""
    b6, p6, d6 = _six_dies(board, player)
    s1 = slot_table(b6, p6, d6)
    b1 = apply_submove(
        board_expand(b6, N_SLOTS), p6[..., None], s1.start, s1.end, s1.hits,
        s1.valid,
    )
    return s1, b1


def die_ctxs(board: Board, player: torch.Tensor) -> SlotCtx:
    """Root SlotCtx for all six die values, fields on a leading [6] axis
    (the companion of ``die_tables``)."""
    return slot_ctx(*_six_dies(board, player))


_SIG_SENT = 31  # sorts after every real cell id (0..25)


def _submove_sig(s1, e1, h1, s2, e2, h2, is_pair) -> torch.Tensor:
    """Canonical afterstate signature of a 1- or 2-submove candidate:
    signature equality <=> afterstate equality on a shared root board (net
    mover cell-delta multiset plus hit-cell multiset, each sorted and
    sentinel-padded; six five-bit lanes). See the JAX ``_submove_sig``."""
    pair = is_pair
    cancel1 = pair & (s1 == e2)
    cancel2 = pair & (s2 == e1)
    both = pair & ~cancel1 & ~cancel2
    m1 = torch.where(cancel1, s2, s1)
    m2 = torch.where(both, s2, _SIG_SENT)
    p1 = torch.where(cancel2, e2, e1)
    p2 = torch.where(both, e2, _SIG_SENT)
    t1 = torch.where(h1, e1, _SIG_SENT)
    t2 = torch.where(pair & h2, e2, _SIG_SENT)
    sig = torch.minimum(m1, m2)
    for lane in (
        torch.maximum(m1, m2),
        torch.minimum(p1, p2),
        torch.maximum(p1, p2),
        torch.minimum(t1, t2),
        torch.maximum(t1, t2),
    ):
        sig = sig * 32 + lane
    return sig


def _dup_earlier_sig(sig: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """dup[i] = exists valid j < i with identical signature."""
    k = sig.shape[-1]
    eq = sig[..., :, None] == sig[..., None, :]
    earlier = torch.ones((k, k), dtype=torch.bool, device=sig.device).tril(-1)
    return (eq & earlier & ok[..., None, :]).any(-1)


def _dup_earlier_mask(packed: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """dup[i] = exists valid j < i with an identical board: the board form of
    ``_dup_earlier_sig`` (the Gram dedup, ``nd_sig_dedup=False``).

    JAX decides "same board" by a squared distance from a bf16 Gram matrix
    with f32 accumulation, exact for cells in [0, 15]. On a card a bf16 or
    TF32 product may round, so here the equality is exact by construction:
    each board's bytes are read as int64 words (8 cells a word, 52 cells
    padded to 7 words) and two boards are equal when every word is. The
    pairwise test is [..., K, K] bools, one word at a time."""
    k = packed.shape[-2]
    pad = (-packed.shape[-1]) % 8
    words = torch.nn.functional.pad(packed, (0, pad)).contiguous().view(torch.int64)
    eq = torch.ones((k, k), dtype=torch.bool, device=packed.device).tril(-1)
    eq = eq & ok[..., None, :]
    for w in words.unbind(-1):
        eq &= w[..., :, None] == w[..., None, :]
    return eq.any(-1)


def _nd_tail_front(
    b0: Board,
    b1a: Board,
    b1b: Board,
    valid: torch.Tensor,
    player: torch.Tensor,
    d_hi: torch.Tensor,
    d_lo: torch.Tensor,
    K: int,
):
    """Select the first K valid candidate cells in insertion order and build
    their afterstates. Returns (afterstates [..., K], kok presence, kpair
    "is a 2-submove move", canonical delta signature [..., K]).

    Cell layout: blocks of 27 — blocks 0..26 pass-A pairs (block = first slot
    i, local = second slot j), block 27 pass-A singles (local = i), blocks
    28..54 pass-B pairs, 55 pass-B singles."""
    idx, kok = _select_set_bits(valid, K)
    blk, loc = idx // N_SLOTS, idx % N_SLOTS
    cpass = (blk >= N_SLOTS + 1).to(torch.int64)
    bb = blk - cpass * (N_SLOTS + 1)
    is_pair = bb < N_SLOTS
    ci = torch.where(is_pair, bb, loc)
    cj = torch.where(is_pair, loc, -1)

    b1cat = Board(data=torch.cat([b1a.data, b1b.data], -2))
    first = board_take(b1cat, ci + cpass * N_SLOTS)

    pk = player[..., None]
    d_second = torch.where(cpass == 0, d_lo[..., None], d_hi[..., None])
    s2, e2, h2 = slot_params(first, pk, d_second, cj.clamp_min(0))
    app = kok & (cj >= 0)
    after = apply_submove(first, pk, s2, e2, h2, app)

    d_first = torch.where(cpass == 0, d_hi[..., None], d_lo[..., None])
    s1, e1, h1 = slot_params(board_expand(b0, K), pk, d_first, ci)
    sig = _submove_sig(s1, e1, h1, s2, e2, h2, app)
    return after, kok, cj >= 0, sig


def _nd_tail(
    b0: Board,
    b1a: Board,
    b1b: Board,
    valid: torch.Tensor,
    player: torch.Tensor,
    d_hi: torch.Tensor,
    d_lo: torch.Tensor,
    K: int,
    a_max: int,
    sig_dedup: bool = True,
):
    """Width-K back half of non-doubles enumeration: compact, build
    afterstates, first-occurrence dedup (handle_move_types.py:196-221) by
    canonical delta signature or, with ``sig_dedup=False``, by whole board
    (``_dup_earlier_mask``), max-submove filter AFTER dedup
    (generate_all_moves.py:69-90), Q7 cap in survivor-rank order without a
    final compaction. Returns (afterstates [..., K], keep mask, pre-cap
    survivor total int32, and "present 2-submove candidate" bool[..., K])."""
    after, kok, kpair, sig = _nd_tail_front(
        b0, b1a, b1b, valid, player, d_hi, d_lo, K
    )
    if sig_dedup:
        dup = _dup_earlier_sig(sig, kok)
    else:
        dup = _dup_earlier_mask(pack_board(after), kok)
    keep = kok & ~dup
    has_pair = (keep & kpair).any(-1)
    keep = keep & (kpair | ~has_pair[..., None])
    rank = torch.cumsum(keep.to(torch.int32), -1, dtype=torch.int32)
    pre_cap_total = rank[..., -1]
    return after, keep & (rank <= a_max), pre_cap_total, kok & kpair


def _nd_candidates(
    board: Board,
    player: torch.Tensor,
    dice: torch.Tensor,
    passes: Optional[Tuple[_Pass, _Pass]] = None,
):
    """The two expansion passes and the 1512-cell candidate validity bits in
    exact reference insertion order (generate_all_moves.py:25-53), with the
    reverse-order skip (:40-50). ``passes`` supplies precomputed (high-first,
    low-first) passes built from ``die_tables``. Returns (pa, pb, valid,
    d_hi, d_lo)."""
    d_hi = torch.maximum(dice[..., 0], dice[..., 1]).to(torch.int64)
    d_lo = torch.minimum(dice[..., 0], dice[..., 1]).to(torch.int64)
    if passes is None:
        pa = _run_pass(board, player, d_hi, d_lo)
        pb = _run_pass(board, player, d_lo, d_hi)
    else:
        pa, pb = passes
    skip_b = (~pa.any_pair) & (_popcount(pa.single_valid) == 1)
    pvB = pb.pair_valid & ~skip_b[..., None, None]
    svB = pb.single_valid & ~skip_b[..., None]
    valid = torch.cat(
        [pa.pair_valid.flatten(-2), pa.single_valid, pvB.flatten(-2), svB], -1
    )
    return pa, pb, valid, d_hi, d_lo


class NdPlanes(NamedTuple):
    """The two-tier non-doubles tail's planes."""

    after_n: Board  # [n, T, 52] tier-1 afterstates (exact when n_pre <= T)
    keep_n: torch.Tensor  # [n, T]
    after_w: Board  # [wn, K, 52] full-width tail on the wide sub-batch
    keep_w: torch.Tensor  # [wn, K]
    in_sub: torch.Tensor  # [n] row's result lives in the wide plane
    slot: torch.Tensor  # [n] row index into the wide plane (clipped)
    overflow: torch.Tensor  # [n] truncation ledger (Q7 class)


def _nd_two_tier(
    board: Board,
    pa: _Pass,
    pb: _Pass,
    valid: torch.Tensor,
    player: torch.Tensor,
    d_hi: torch.Tensor,
    d_lo: torch.Tensor,
    cfg: MoveGenConfig,
) -> NdPlanes:
    """Tier 1 runs the tail at width T for every game (exact whenever
    n_pre <= T); tier 2 gathers the wide games into a batch/div sub-batch
    and runs the full-width tail there. A wide game beyond the sub-batch
    keeps its tier-1 result and is flagged via overflow."""
    K, T = cfg.nd_dedup_k, cfg.nd_tier
    n_pre = _popcount(valid)
    n = valid.shape[0]
    after_n, keep_n, pct_n, _ = _nd_tail(
        board, pa.b1, pb.b1, valid, player, d_hi, d_lo, T, cfg.a_max,
        cfg.nd_sig_dedup,
    )
    wide = n_pre > T
    wn = max(8, n // cfg.nd_wide_div)
    sel, sel_ok = _select_set_bits(wide, wn)
    after_w, keep_w, pct_w, _ = _nd_tail(
        _take0(board, sel),
        _take0(pa.b1, sel),
        _take0(pb.b1, sel),
        valid[sel] & sel_ok[:, None],
        player[sel],
        d_hi[sel],
        d_lo[sel],
        K,
        cfg.a_max,
        cfg.nd_sig_dedup,
    )
    in_sub, slot = _rows_in(wide, wn)
    pct = torch.where(in_sub, pct_w[slot], pct_n)
    overflow = (in_sub & ((n_pre > K) | (pct > cfg.a_max))) | (wide & ~in_sub)
    return NdPlanes(after_n, keep_n, after_w, keep_w, in_sub, slot, overflow)


def enumerate_nondoubles(
    board: Board,
    player: torch.Tensor,
    dice: torch.Tensor,
    cfg: MoveGenConfig,
    passes: Optional[Tuple[_Pass, _Pass]] = None,
) -> MoveSet:
    """Sortless non-doubles enumeration in exact reference order
    (generate_all_moves.py:25-53). ``passes`` supplies precomputed
    (high-first, low-first) passes from ``die_tables`` (the 2-ply scorer).

    The tail runs two-tier when ``0 < nd_tier < nd_dedup_k`` on a flat batch.
    Else it is one full-width pass: with signature dedup through
    ``experimental.nd_tail.nd_tail_fused`` (the CUDA kernel on a card, its
    plain version on the CPU), whatever ``nd_tail_kernel`` says, since the
    flag only chose the Pallas kernel on the TPU; with the Gram dedup
    (``nd_sig_dedup=False``) in plain PyTorch on any device, as JAX runs its
    plain ``_nd_tail`` there (the kernel dedups by signature only)."""
    pa, pb, valid, d_hi, d_lo = _nd_candidates(board, player, dice, passes)
    K, T = cfg.nd_dedup_k, cfg.nd_tier
    if T and T < K and valid.dim() == 2:
        pl = _nd_two_tier(board, pa, pb, valid, player, d_hi, d_lo, cfg)
        narrow = _pad_entries(MoveSet(pl.after_n, pl.keep_n, None), K)
        after = board_where(pl.in_sub[:, None], _take0(pl.after_w, pl.slot), narrow.boards)
        keep = torch.where(pl.in_sub[:, None], pl.keep_w[pl.slot], narrow.valid)
        overflow = pl.overflow
    elif not cfg.nd_sig_dedup:
        after, keep, pct, _ = _nd_tail(
            board, pa.b1, pb.b1, valid, player, d_hi, d_lo, K, cfg.a_max, False
        )
        # candidates lost to the dedup-slot cap or the Q7 presented cap
        overflow = (_popcount(valid) > K) | (pct > cfg.a_max)
    else:
        from mlp_ppo_2ply_multi_tpu_torch.experimental.nd_tail import nd_tail_fused

        bs = board.batch_shape
        n = valid[..., 0].numel()
        row = lambda x: torch.broadcast_to(
            torch.as_tensor(x, device=valid.device), bs
        ).reshape(n)
        cells = board.data.shape[-1]
        after_d, keep, n_pre, pct, _ = nd_tail_fused(
            valid.reshape(n, valid.shape[-1]), pa.b1.data.reshape(n, N_SLOTS, cells),
            pb.b1.data.reshape(n, N_SLOTS, cells), board.data.reshape(n, cells),
            row(player), row(d_hi), row(d_lo), K, cfg.a_max,
        )
        after = Board(data=after_d.reshape(*bs, K, cells))
        keep = keep.reshape(*bs, K)
        # candidates lost to the dedup-slot cap or the Q7 presented cap
        overflow = ((n_pre > K) | (pct > cfg.a_max)).reshape(bs)
    return MoveSet(boards=after, valid=keep, count=_popcount(keep), overflow=overflow)


class RawMoves(NamedTuple):
    """Undeduped non-doubles afterstates for consumers that want the top
    values (the 2-ply scorer's value-first replies): every valid candidate
    cell in insertion order (no dedup, no max-submove filter, no Q7 cap),
    with the exact post-dedup ``has_pair`` bit those filters would give
    (``nd_has_pair_exact``). Duplicates carry bit-equal boards and so
    bit-equal values: a consumer that needs the top-N distinct values can
    dedup after a top-M select at M^2 cost instead of K^2."""

    boards: Board  # [..., K]
    valid: torch.Tensor  # bool[..., K] presence (insertion order)
    kpair: torch.Tensor  # bool[..., K] candidate is a 2-submove move
    has_pair: torch.Tensor  # bool[...] exact max-submove filter bit
    overflow: torch.Tensor  # bool[...] more than K pre-dedup candidates
    sig: torch.Tensor  # int64[..., K] canonical delta signature (_submove_sig)


def nd_has_pair_exact(pa: _Pass, pvB: torch.Tensor) -> torch.Tensor:
    """Exact "some 2-submove move survives the reference's first-occurrence
    dedup", without running the dedup: ``any_pair_A | any(pvB)``, with
    ``pvB`` the skip-masked pass-B pair grid (generate_all_moves.py:40-50).
    Dedup can never drop every pair while leaving singles: pass-A pairs come
    first in insertion order, and a pass-B pair equals an earlier single
    only by a chained bear-off, which implies a pass-A pair or a pass B the
    reverse-order skip zeroes (the JAX ``nd_has_pair_exact`` has the
    argument in full)."""
    return pa.any_pair | pvB.flatten(-2).any(-1)


def enumerate_nondoubles_raw(
    board: Board,
    player: torch.Tensor,
    dice: torch.Tensor,
    K: int,
    passes: Optional[Tuple[_Pass, _Pass]] = None,
) -> RawMoves:
    """Non-doubles enumeration without the dedup, filter and cap tail (see
    RawMoves), in exact reference insertion order."""
    pa, pb, valid, d_hi, d_lo = _nd_candidates(board, player, dice, passes)
    after, kok, kpair, sig = _nd_tail_front(
        board, pa.b1, pb.b1, valid, player, d_hi, d_lo, K
    )
    skip_b = (~pa.any_pair) & (_popcount(pa.single_valid) == 1)
    pvB = pb.pair_valid & ~skip_b[..., None, None]
    return RawMoves(after, kok, kpair, nd_has_pair_exact(pa, pvB), _popcount(valid) > K, sig)


# ---------------------------------------------------------------------------
# Doubles — canonical multiset enumeration
# ---------------------------------------------------------------------------


class _Frontier(NamedTuple):
    boards: Board  # [..., W]
    last_rank: torch.Tensor  # int8[..., W]
    only: torch.Tensor  # bool: arriving submove was parent's only full child
    valid: torch.Tensor


def _submove_rank(player: torch.Tensor, start: torch.Tensor, end: torch.Tensor):
    """Canonical rank of an applied submove: direction-adjusted start
    position, doubled, +1 for a bear-off; a bar entry ranks -1."""
    adj = torch.where(player == 0, start, NUM_POINTS - 1 - start)
    rank = 2 * adj + (end == BEAR_OFF).to(torch.int64)
    return torch.where(start == BAR, -1, rank).to(torch.int8)


def _rank_lanes(last: torch.Tensor, player: torch.Tensor, die: torch.Tensor):
    """Canonical rank per slot without a materialized SlotTable: slot starts
    are static per (player, die) except the farthest-bear-off lane, which
    takes ``last``. int8[..., 27]."""
    p = torch.as_tensor(player).to(torch.int64)
    d = torch.as_tensor(die).to(torch.int64)
    iota = torch.arange(NUM_POINTS, device=last.device)
    adj_i = torch.where(p[..., None] == 0, iota, NUM_POINTS - 1 - iota)
    adj_i = adj_i.expand(*last.shape, NUM_POINTS)
    adj_last = torch.where(p == 0, last, NUM_POINTS - 1 - last)
    exact = torch.where(p == 0, NUM_POINTS - d, d - 1)
    adj_exact = torch.where(p == 0, exact, NUM_POINTS - 1 - exact).expand(last.shape)
    neg1 = torch.full_like(last, -1)
    col = lambda x: x[..., None]
    return torch.cat(
        [2 * adj_i, col(neg1), col(2 * adj_last + 1), col(2 * adj_exact + 1)], -1
    ).to(torch.int8)


def _expand(
    front: _Frontier,
    player: torch.Tensor,
    die: torch.Tensor,
    width: int,
    ctx: SlotCtx,
) -> Tuple[_Frontier, MoveSet, torch.Tensor]:
    """One canonical level expansion. Also returns this level's forced-short
    records (boards, valid, count) in frontier order and a bool[...]
    overflow flag (more legal children than ``width`` slots)."""
    pw = player[..., None]
    dw = die[..., None]
    valid27, last = slot_valid(front.boards, pw, dw, ctx_entry_axis(ctx))
    rank = _rank_lanes(last, pw, dw)
    full_cc = _popcount(valid27)  # [..., W]

    shorts_valid = front.valid & front.only & (full_cc == 0)
    shorts = MoveSet(
        boards=front.boards, valid=shorts_valid, count=_popcount(shorts_valid)
    )
    child_valid = (
        front.valid[..., None] & valid27 & (rank >= front.last_rank[..., None])
    )
    # select over the flattened [W, 27] grid: parent = idx // 27 is the
    # frontier entry, the local position the slot index
    idx, out_ok = _select_set_bits(child_valid.flatten(-2), width)
    parent, slot = idx // N_SLOTS, idx % N_SLOTS
    pboards = board_take(front.boards, parent)
    sg, eg, hg = slot_params(pboards, pw, dw, slot)
    nboards = apply_submove(pboards, pw, sg, eg, hg, out_ok)
    nrank = _submove_rank(torch.broadcast_to(pw, slot.shape), sg, eg)
    ponly = torch.gather(full_cc == 1, -1, parent)
    n_children = child_valid.flatten(-2).sum(-1)
    return (
        _Frontier(boards=nboards, last_rank=nrank, only=ponly, valid=out_ok),
        shorts,
        n_children > width,
    )


def _pad_entries(ms: MoveSet, width: int) -> MoveSet:
    """Zero-pad a flat [n, w] set's entry axis to ``width``."""
    p = width - ms.valid.shape[-1]
    if p <= 0:
        return ms
    return MoveSet(
        boards=Board(data=torch.nn.functional.pad(ms.boards.data, (0, 0, 0, p))),
        valid=torch.nn.functional.pad(ms.valid, (0, p)),
        count=ms.count,
        overflow=ms.overflow,
    )


def enumerate_doubles(
    board: Board,
    player: torch.Tensor,
    die: torch.Tensor,
    cfg: MoveGenConfig,
    s1: Optional[SlotTable] = None,
) -> MoveSet:
    """Canonical doubles enumeration — zero sorts, zero dedup. ``s1``
    supplies a precomputed root slot table for this die (``die_tables``).
    The three level expansions share one root SlotCtx (the die is constant
    for the whole turn). Flat [n] batch."""
    ctx = slot_ctx(board, player, die)
    if s1 is None:
        s1 = slot_table(board, player, die)
    root_cc = _popcount(s1.valid)
    idx1, ok1 = _select_set_bits(s1.valid, cfg.w1)
    b0 = board_expand(board, cfg.w1)
    pw = player[..., None]
    sg, eg, hg = slot_params(b0, pw, die[..., None], idx1)
    b1 = apply_submove(b0, pw, sg, eg, hg, ok1)
    front = _Frontier(
        boards=b1,
        last_rank=_submove_rank(torch.broadcast_to(pw, idx1.shape), sg, eg),
        only=torch.broadcast_to((root_cc == 1)[..., None], ok1.shape),
        valid=ok1,
    )
    front2, shorts1, ov2 = _expand(front, player, die, cfg.w2, ctx)
    front3, shorts2, ov3 = _expand(front2, player, die, cfg.w3, ctx)
    front4, shorts3, ov4 = _expand(front3, player, die, cfg.w4, ctx)

    has4 = front4.valid.any(-1)
    a3 = shorts3.valid.any(-1)
    a2 = shorts2.valid.any(-1)
    a_max = cfg.a_max

    def level(ms: MoveSet, use: torch.Tensor, width: int) -> MoveSet:
        """Gate a level's set and bring it to ``width`` slots: padded in
        frontier order when it fits, else rank-capped compaction (Q7)."""
        v = ms.valid & use[..., None]
        if v.shape[-1] <= width:
            padded = _pad_entries(MoveSet(ms.boards, v, None), width)
            return padded._replace(count=_popcount(padded.valid))
        idx, ok = _select_set_bits(v, width)
        return MoveSet(board_take(ms.boards, idx), ok, _popcount(ok))

    use3 = (~has4) & a3
    use2 = (~has4) & ~a3 & a2
    use1 = (~has4) & ~a3 & ~a2
    m4 = level(MoveSet(front4.boards, front4.valid, None), has4, a_max)
    m3 = level(shorts3, use3, min(cfg.w3, a_max))
    m2 = level(shorts2, use2, min(cfg.w2, a_max))
    m1 = level(shorts1, use1, min(cfg.w1, a_max))

    def merge(a: MoveSet, b: MoveSet, use_a: torch.Tensor) -> MoveSet:
        return MoveSet(
            boards=board_where(use_a[..., None].expand(a.valid.shape), a.boards, b.boards),
            valid=torch.where(use_a[..., None], a.valid, b.valid),
            count=torch.where(use_a, a.count, b.count),
        )

    w12 = max(m1.valid.shape[-1], m2.valid.shape[-1])
    out = merge(_pad_entries(m2, w12), _pad_entries(m1, w12), a2)
    w123 = max(w12, m3.valid.shape[-1])
    out = merge(_pad_entries(m3, w123), _pad_entries(out, w123), a3)
    out = merge(m4, _pad_entries(out, a_max), has4)

    def cap_ov(valid, use, width):
        if valid.shape[-1] <= width:
            return torch.zeros_like(has4)
        return _popcount(valid & use[..., None]) > width

    n4 = torch.where(has4, _popcount(front4.valid & has4[..., None]), 0)
    overflow = (
        (root_cc > cfg.w1) | ov2 | ov3 | ov4
        | (n4 > a_max)
        | cap_ov(shorts3.valid, use3, a_max)
        | cap_ov(shorts2.valid, use2, a_max)
        | cap_ov(shorts1.valid, use1, a_max)
    )
    return out._replace(overflow=overflow)


# ---------------------------------------------------------------------------
# Any batch shape, and the merged legal moves (the 2-ply actor's input)
# ---------------------------------------------------------------------------


def _flatten_batch(board: Board, player, dice, dice_tail: Tuple[int, ...]):
    """(flatten fn, flat board, flat int64 player [n], flat int64 dice
    [n, *dice_tail]) for a board batch of any shape; player and dice
    broadcast into it."""
    bs = board.batch_shape
    n = math.prod(bs)
    dev = board.data.device
    flat = lambda t: tmap(lambda a: a.reshape(n, *a.shape[len(bs):]), t)
    as64 = lambda x: torch.as_tensor(x, device=dev).to(torch.int64)
    fp = torch.broadcast_to(as64(player), bs).reshape(n)
    fd = torch.broadcast_to(as64(dice), (*bs, *dice_tail)).reshape(n, *dice_tail)
    return flat, flat(board), fp, fd


def _unflatten_moveset(ms: MoveSet, batch_shape) -> MoveSet:
    a = ms.valid.shape[-1]
    return MoveSet(
        boards=Board(data=ms.boards.data.reshape(*batch_shape, a, ms.boards.data.shape[-1])),
        valid=ms.valid.reshape(*batch_shape, a),
        count=ms.count.reshape(batch_shape),
        overflow=None if ms.overflow is None else ms.overflow.reshape(batch_shape),
    )


def enumerate_nondoubles_batched(
    board: Board,
    player: torch.Tensor,
    dice: torch.Tensor,
    cfg: MoveGenConfig,
    passes: Optional[Tuple[_Pass, _Pass]] = None,
) -> MoveSet:
    """``enumerate_nondoubles`` over any batch shape (player and dice [..., 2]
    broadcast); the 2-ply scorer's fixed non-double rolls."""
    flat, fb, fp, fd = _flatten_batch(board, player, dice, (2,))
    fpasses = None if passes is None else (flat(passes[0]), flat(passes[1]))
    ms = enumerate_nondoubles(fb, fp, fd, cfg, fpasses)
    return _unflatten_moveset(ms, board.batch_shape)


def enumerate_nondoubles_raw_batched(
    board: Board,
    player: torch.Tensor,
    dice: torch.Tensor,
    K: int,
    passes: Optional[Tuple[_Pass, _Pass]] = None,
) -> RawMoves:
    """``enumerate_nondoubles_raw`` over any batch shape (the 2-ply scorer's
    [chunk, ..., candidates] fan-out)."""
    flat, fb, fp, fd = _flatten_batch(board, player, dice, (2,))
    fpasses = None if passes is None else (flat(passes[0]), flat(passes[1]))
    raw = enumerate_nondoubles_raw(fb, fp, fd, K, fpasses)
    bs = board.batch_shape
    return RawMoves(
        boards=Board(data=raw.boards.data.reshape(*bs, K, raw.boards.data.shape[-1])),
        valid=raw.valid.reshape(*bs, K),
        kpair=raw.kpair.reshape(*bs, K),
        has_pair=raw.has_pair.reshape(bs),
        overflow=raw.overflow.reshape(bs),
        sig=raw.sig.reshape(*bs, K),
    )


def enumerate_doubles_batched(
    board: Board,
    player: torch.Tensor,
    die: torch.Tensor,
    cfg: MoveGenConfig,
    s1: Optional[SlotTable] = None,
) -> MoveSet:
    """``enumerate_doubles`` over any batch shape, padded to the non-doubles
    width ``max(a_max, nd_dedup_k)``."""
    flat, fb, fp, fd = _flatten_batch(board, player, die, ())
    ms = enumerate_doubles(fb, fp, fd, cfg, None if s1 is None else flat(s1))
    ms = _pad_entries(ms, max(cfg.a_max, cfg.nd_dedup_k))
    return _unflatten_moveset(ms, board.batch_shape)


def legal_moves(
    board: Board, player: torch.Tensor, dice: torch.Tensor, cfg: MoveGenConfig
) -> MoveSet:
    """Merged legal moves over any batch shape: the non-doubles set, and the
    doubles set on a compacted batch/``dd_subbatch_div`` sub-batch of the
    games that rolled doubles (the whole batch when n <= 64 or the divisor
    is 0), merged per game at width ``max`` of the two. A doubles game
    beyond the sub-batch presents zero moves and is flagged as overflow.
    ``dd_tier`` runs the sub-batch two-tier
    (``experimental.tiered.doubles_two_tier``); as in JAX it is read only
    there, not on the whole-batch branch."""
    bs = board.batch_shape
    _, fboard, fplayer, fdice = _flatten_batch(board, player, dice, (2,))
    n = fplayer.shape[0]
    is_double = fdice[:, 0] == fdice[:, 1]

    nd = enumerate_nondoubles(fboard, fplayer, fdice, cfg)
    if n <= 64 or cfg.dd_subbatch_div <= 0:
        dd = enumerate_doubles(fboard, fplayer, fdice[:, 0], cfg)
    else:
        w_dd = max(8, -(-n // cfg.dd_subbatch_div))
        sel_idx, sel_ok = _select_set_bits(is_double, w_dd)
        sub_args = (_take0(fboard, sel_idx), fplayer[sel_idx], fdice[sel_idx, 0])
        if cfg.dd_tier:
            from mlp_ppo_2ply_multi_tpu_torch.experimental.tiered import doubles_two_tier

            sub = doubles_two_tier(*sub_args, sel_ok, cfg)
        else:
            sub = enumerate_doubles(*sub_args, cfg)
        sub_valid = sub.valid & sel_ok[:, None]
        dd_in, slot = _rows_in(is_double, w_dd)  # read only where is_double
        dd = MoveSet(
            boards=_take0(sub.boards, slot),
            valid=sub_valid[slot] & dd_in[:, None],
            count=torch.where(dd_in, sub.count[slot], 0),
            overflow=torch.where(dd_in, sub.overflow[slot], True),
        )
    width = max(nd.valid.shape[-1], dd.valid.shape[-1])
    nd, dd = _pad_entries(nd, width), _pad_entries(dd, width)
    out = MoveSet(
        boards=board_where(is_double[:, None].expand(n, width), dd.boards, nd.boards),
        valid=torch.where(is_double[:, None], dd.valid, nd.valid),
        count=torch.where(is_double, dd.count, nd.count),
        overflow=torch.where(is_double, dd.overflow, nd.overflow),
    )
    return _unflatten_moveset(out, bs)


# ---------------------------------------------------------------------------
# Plane-form legal moves (the production actor's input)
# ---------------------------------------------------------------------------


class SplitMoves(NamedTuple):
    """The three natural planes of the production enumeration (narrow nd
    tier, wide-nd sub-batch, doubles sub-batch) plus the merged per-row
    facts. The merged [n, W, 52] board tensor is never built."""

    nd_boards: Board  # [n, T, 52] tier-1 nd afterstates
    nd_keep: torch.Tensor  # [n, T]
    ndw_boards: Board  # [wn, K, 52] wide-nd sub-batch
    ndw_keep: torch.Tensor  # [wn, K]
    ndw_in: torch.Tensor  # [n] row's nd result lives in the wide plane
    ndw_slot: torch.Tensor  # [n] row index into the wide plane (clipped)
    dd_boards: Board  # [wd, A, 52] doubles sub-batch
    dd_valid: torch.Tensor  # [wd, A]
    dd_in: torch.Tensor  # [n] row is a double resolved in the sub-batch
    dd_slot: torch.Tensor  # [n]
    valid: torch.Tensor  # [n, W] merged valid mask
    count: torch.Tensor  # [n] int32
    overflow: torch.Tensor  # [n]


def legal_moves_split(
    board: Board, player: torch.Tensor, dice: torch.Tensor, cfg: MoveGenConfig
) -> SplitMoves:
    """Plane-form legal moves. Requires the canonical engine, the tiered nd
    tail (0 < nd_tier < nd_dedup_k) and the doubles sub-batch; flat [n]
    batch. The nd tail dedups as ``nd_sig_dedup`` says; ``dd_tier`` is not
    read (JAX's ``legal_moves_split`` runs the single doubles chain)."""
    check_canonical(cfg)
    if not (cfg.nd_tier and cfg.nd_tier < cfg.nd_dedup_k):
        raise ValueError("legal_moves_split needs 0 < nd_tier < nd_dedup_k")
    if cfg.dd_subbatch_div <= 0:
        raise ValueError("legal_moves_split needs the doubles sub-batch")
    if len(board.batch_shape) != 1:
        raise ValueError("legal_moves_split takes a flat [n] batch")
    n = board.batch_shape[0]
    player = torch.broadcast_to(torch.as_tensor(player).to(torch.int64), (n,))
    dice = torch.broadcast_to(torch.as_tensor(dice).to(torch.int64), (n, 2))
    is_double = dice[:, 0] == dice[:, 1]

    pa, pb, valid_cells, d_hi, d_lo = _nd_candidates(board, player, dice)
    pl = _nd_two_tier(board, pa, pb, valid_cells, player, d_hi, d_lo, cfg)

    w_dd = max(8, -(-n // cfg.dd_subbatch_div))
    sel_idx, sel_ok = _select_set_bits(is_double, w_dd)
    sub = enumerate_doubles(
        _take0(board, sel_idx), player[sel_idx], dice[sel_idx, 0], cfg
    )
    sub_valid = sub.valid & sel_ok[:, None]
    dd_in, dd_slot = _rows_in(is_double, w_dd)

    W = max(cfg.a_max, cfg.nd_dedup_k, sub.valid.shape[-1])
    pad_w = lambda v: torch.nn.functional.pad(v, (0, W - v.shape[-1]))
    nd_valid = torch.where(
        pl.in_sub[:, None], pad_w(pl.keep_w[pl.slot]), pad_w(pl.keep_n)
    )
    dd_valid_rows = pad_w(sub_valid[dd_slot]) & dd_in[:, None]
    valid = torch.where(is_double[:, None], dd_valid_rows, nd_valid)
    dd_overflow = torch.where(dd_in, sub.overflow[dd_slot], True)
    return SplitMoves(
        nd_boards=pl.after_n,
        nd_keep=pl.keep_n,
        ndw_boards=pl.after_w,
        ndw_keep=pl.keep_w,
        ndw_in=pl.in_sub,
        ndw_slot=pl.slot,
        dd_boards=sub.boards,
        dd_valid=sub_valid,
        dd_in=dd_in,
        dd_slot=dd_slot,
        valid=valid,
        count=_popcount(valid),
        overflow=torch.where(is_double, dd_overflow, pl.overflow),
    )
