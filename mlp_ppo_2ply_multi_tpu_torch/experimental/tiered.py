"""The tiered two-plane movegen pipeline and the two-tier doubles expansion.

Port of ``mlp_ppo_2ply_multi_tpu/experimental/tiered.py``, a rejected
experiment kept default-off (``experimental/__init__.py``). Exact up to the
surfaced ``overflow`` flags; reached through ``train --tiered``,
``MoveGenConfig.tiered`` and ``MoveGenConfig.dd_tier``.

* ``doubles_two_tier``: every doubles game of a compacted sub-batch runs the
  canonical chain at the narrow ``dd_tier`` level widths; the games whose
  narrow run overflowed re-run at the full widths on a sub-sub-batch.
* ``legal_moves_tiered``: a narrow [B, nd_tier] plane for every game and the
  merged full-width ``legal_moves`` on a batch/``tiered_wide_div`` sub-batch
  of the games the narrow enumeration flags; the merged [B, a_max, 52] move
  tensor is never built.
* ``chosen_tiered``: softmax(V/T) sampling in each plane through
  ``fused_value`` (the CUDA kernel on a card), returning the chosen board.

Sampling is ``argmax(logits + gumbel)`` with injected noise, what
``jax.random.categorical`` computes: ``gumbel_t1`` [B, nd_tier] for the
narrow plane, ``gumbel_t2`` [max(8, B // tiered_wide_div), W] for the wide
one (``actor.rollout._noise_shapes``), through ``model.sampling``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from mlp_ppo_2ply_multi_tpu_torch.core.config import Config, MoveGenConfig
from mlp_ppo_2ply_multi_tpu_torch.encoder.features import encode_board
from mlp_ppo_2ply_multi_tpu_torch.engine.board import Board
from mlp_ppo_2ply_multi_tpu_torch.engine.movegen import MoveSet, board_take, board_where
from mlp_ppo_2ply_multi_tpu_torch.engine.movegen2 import (
    _nd_candidates,
    _nd_tail,
    _pad_entries,
    _popcount,
    _rows_in,
    _select_set_bits,
    _take0,
    enumerate_doubles,
    legal_moves,
)
from mlp_ppo_2ply_multi_tpu_torch.model import value_net
from mlp_ppo_2ply_multi_tpu_torch.model.sampling import orient, sample
from mlp_ppo_2ply_multi_tpu_torch.ops.fused_value import fused_value


def _narrow_cfg(cfg: MoveGenConfig) -> MoveGenConfig:
    t2, t3, t4 = cfg.dd_tier
    return dataclasses.replace(cfg, w2=t2, w3=t3, w4=t4, a_max=min(cfg.a_max, t4))


def doubles_two_tier(
    board: Board,
    player: torch.Tensor,
    die: torch.Tensor,
    ok: torch.Tensor,
    cfg: MoveGenConfig,
) -> MoveSet:
    """Two-tier doubles expansion (``MoveGenConfig.dd_tier``) over an already
    compacted [W] doubles sub-batch (``ok``: the row holds a game).

    Tier 1 runs the whole canonical chain at the narrow (t2, t3, t4) widths
    for every game; each level reports more children than its width before
    truncating, so the narrow run's overflow is exactly "needed more than
    the narrow widths". Those games re-run at the full w2/w3/w4 on a
    W/``dd_wide_div`` sub-sub-batch (tier 2). A wide game beyond that
    keeps its narrow result and stays flagged."""
    narrow = enumerate_doubles(board, player, die, _narrow_cfg(cfg))
    wide = narrow.overflow & ok
    wn = max(8, ok.shape[0] // cfg.dd_wide_div)
    sel, _ = _select_set_bits(wide, wn)
    wsub = enumerate_doubles(_take0(board, sel), player[sel], die[sel], cfg)
    nar = _pad_entries(narrow, wsub.valid.shape[-1])
    in_sub, slot = _rows_in(wide, wn)
    return MoveSet(
        boards=board_where(in_sub[:, None], _take0(wsub.boards, slot), nar.boards),
        valid=torch.where(in_sub[:, None], wsub.valid[slot], nar.valid),
        count=torch.where(in_sub, wsub.count[slot], narrow.count),
        overflow=torch.where(in_sub, wsub.overflow[slot], narrow.overflow),
    )


class Tiered(NamedTuple):
    """Two-plane legal-move set (``MoveGenConfig.tiered``): a ``narrow``
    plane with every game's enumeration at width T = nd_tier (exact for
    non-doubles with at most T pre-dedup candidates and doubles that fit
    the dd_tier widths), and the ordinary full-width ``legal_moves`` of the
    games the narrow enumeration flags on a batch/``tiered_wide_div``
    sub-batch (``wide``). A flagged game beyond the wide capacity keeps its
    narrow result and surfaces in ``overflow``."""

    narrow_boards: Board  # [B, T]
    narrow_valid: torch.Tensor  # bool[B, T] (non-contiguous survivor mask)
    wide: MoveSet  # [Wb, W] full-fidelity sub-batch
    wide_player: torch.Tensor  # int64[Wb] mover of each wide row
    in_wide: torch.Tensor  # bool[B] game's result lives in the wide plane
    wide_slot: torch.Tensor  # int32[B] row in the wide plane (clipped)
    count: torch.Tensor  # int32[B]
    overflow: torch.Tensor  # bool[B]


def legal_moves_tiered(
    board: Board, player: torch.Tensor, dice: torch.Tensor, cfg: MoveGenConfig
) -> Tiered:
    """Tiered legal moves over a flat [B] batch. Needs ``nd_tier`` and
    ``dd_tier`` with t4 <= nd_tier. The wide plane runs ``legal_moves``
    without sub-batches or tiers, so its rows equal the full enumeration's."""
    T = cfg.nd_tier
    if not (T and cfg.dd_tier):
        raise ValueError("legal_moves_tiered needs nd_tier and dd_tier")
    if cfg.dd_tier[2] > T:
        raise ValueError("the dd_tier level-4 width must fit the narrow plane")
    n = board.batch_shape[0]
    player = torch.broadcast_to(torch.as_tensor(player).to(torch.int64), (n,))
    dice = torch.broadcast_to(torch.as_tensor(dice).to(torch.int64), (n, 2))
    is_dd = dice[:, 0] == dice[:, 1]

    # narrow non-doubles: candidate front + width-T tail for every game
    pa, pb, valid, d_hi, d_lo = _nd_candidates(board, player, dice)
    after_n, keep_n, _, _ = _nd_tail(
        board, pa.b1, pb.b1, valid, player, d_hi, d_lo, T, cfg.a_max, cfg.nd_sig_dedup
    )
    nd_wide = ~is_dd & (_popcount(valid) > T)

    # narrow doubles: the compacted sub-batch chain at the dd_tier widths
    w_dd = max(8, -(-n // cfg.dd_subbatch_div)) if cfg.dd_subbatch_div else n
    seld, okd = _select_set_bits(is_dd, w_dd)
    dnarrow = enumerate_doubles(_take0(board, seld), player[seld], dice[seld, 0],
                                _narrow_cfg(cfg))
    dpad = _pad_entries(dnarrow._replace(valid=dnarrow.valid & okd[:, None]), T)
    in_dd_sub, slot_d = _rows_in(is_dd, w_dd)

    # the planes merged at width T: the only [B, T, 52] tensor
    narrow_boards = board_where(is_dd[:, None], _take0(dpad.boards, slot_d), after_n)
    narrow_valid = torch.where(
        is_dd[:, None], dpad.valid[slot_d] & in_dd_sub[:, None], keep_n
    )

    # wide plane: full-fidelity legal_moves on the flagged games; a doubles
    # game needs it when its narrow chain overflowed or it missed the
    # doubles sub-batch
    wide_mask = nd_wide | (is_dd & (~in_dd_sub | dnarrow.overflow[slot_d]))
    wb = max(8, n // cfg.tiered_wide_div)
    selw, okw = _select_set_bits(wide_mask, wb)
    wcfg = dataclasses.replace(cfg, dd_subbatch_div=0, nd_tier=0, dd_tier=())
    wide_player = player[selw]
    wide = legal_moves(_take0(board, selw), wide_player, dice[selw], wcfg)
    wide = MoveSet(
        boards=wide.boards,
        valid=wide.valid & okw[:, None],
        count=torch.where(okw, wide.count, 0),
        overflow=wide.overflow,
    )
    in_wide, slot_w = _rows_in(wide_mask, wb)
    count = torch.where(in_wide, wide.count[slot_w], _popcount(narrow_valid))
    # wide rows report the full enumeration's caps; narrow rows are exact;
    # flagged games beyond the wide capacity keep their narrow result
    overflow = (in_wide & wide.overflow[slot_w]) | (wide_mask & ~in_wide)
    return Tiered(
        narrow_boards=narrow_boards,
        narrow_valid=narrow_valid,
        wide=wide,
        wide_player=wide_player,
        in_wide=in_wide,
        wide_slot=slot_w,
        count=count,
        overflow=overflow,
    )


def chosen_tiered(
    params, state, tiered: Tiered, gumbel_t1: torch.Tensor, gumbel_t2: torch.Tensor,
    temperature: torch.Tensor, cfg: Config,
) -> Tuple[Board, torch.Tensor]:
    """Sample a move in each plane of a Tiered set and return (the chosen
    board [B, 52], v_obs [B]); the merged [B, A, 52] move tensor never
    exists. The same softmax(V/T) semantics as ``select_action``: the
    candidates of each plane through ``fused_value`` (two launches), the
    observation through ``value_net.forward``."""
    v_obs = value_net.forward(params, encode_board(state.board, state.player), cfg.model)
    flag1, sgn1 = orient(state.player, cfg.train.td_mode)
    v1 = fused_value(tiered.narrow_boards.data, flag1[..., None], params)
    pick1 = sample(v1, tiered.narrow_valid, sgn1, gumbel_t1, temperature)
    c1 = board_take(tiered.narrow_boards, pick1[..., None]).data[:, 0]

    flag2, sgn2 = orient(tiered.wide_player, cfg.train.td_mode)
    v2 = fused_value(tiered.wide.boards.data, flag2[..., None], params)
    pick2 = sample(v2, tiered.wide.valid, sgn2, gumbel_t2, temperature)
    c2 = board_take(tiered.wide.boards, pick2[..., None]).data[:, 0]
    chosen = torch.where(tiered.in_wide[:, None], c2[tiered.wide_slot], c1)
    return Board(data=chosen), v_obs
