"""Batched 2-ply expectimax rerank.

Port of ``mlp_ppo_2ply_multi_tpu/twoply/expectimax.py`` (reference
semantics, with the reference's file:line, in that module's docstring):

* the top-k (4) 1-ply candidates by value are reranked;
* a candidate's opponent response is the sum over the 21 distinct rolls of
  P(roll) x mean(top-5 opponent reply values); a roll with no legal reply
  adds 0; the small doubles [1,1], [2,2], [3,3] keep their first 50 replies
  in enumeration order;
* score = alpha x V(candidate) - beta x E[opponent response];
* fewer than k legal moves: plain 1-ply softmax selection.

Only the unrolled scorer (``TwoPlyConfig.unroll_rolls``, ``roll_chunk <= 1``)
is ported: its 15 non-double rolls and 6 doubles run one after the other in
``ROLLS`` order, the non-doubles first, which is the JAX accumulation order.
The scan scorer and the value-first dedup (``value_first_m``) raise.
Sampling takes injected Gumbel noise: ``argmax(logits + gumbel)`` is what
``jax.random.categorical`` computes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from mlp_ppo_2ply_multi_tpu_torch.core.config import Config, MoveGenConfig
from mlp_ppo_2ply_multi_tpu_torch.core.device import device_constant
from mlp_ppo_2ply_multi_tpu_torch.encoder.features import encode_board
from mlp_ppo_2ply_multi_tpu_torch.engine import movegen2
from mlp_ppo_2ply_multi_tpu_torch.engine.board import Board
from mlp_ppo_2ply_multi_tpu_torch.engine.movegen import MoveSet, board_take, slot_stats
from mlp_ppo_2ply_multi_tpu_torch.model import value_net
from mlp_ppo_2ply_multi_tpu_torch.ops.fused_value import fused_value

_NEG = -1e9

# The 21 distinct rolls and their outcome counts /36 (two_ply.py:10-35).
ROLLS = np.asarray(
    [
        [1, 1], [1, 2], [1, 3], [1, 4], [1, 5], [1, 6],
        [2, 2], [2, 3], [2, 4], [2, 5], [2, 6],
        [3, 3], [3, 4], [3, 5], [3, 6],
        [4, 4], [4, 5], [4, 6],
        [5, 5], [5, 6],
        [6, 6],
    ],
    dtype=np.int32,
)
COUNTS = np.asarray(
    [1, 2, 2, 2, 2, 2, 1, 2, 2, 2, 2, 1, 2, 2, 2, 1, 2, 2, 1, 2, 1],
    dtype=np.float32,
)
PROBS = COUNTS / 36.0
# [1,1],[2,2],[3,3] get the 50-move cap (two_ply.py:119-121).
SMALL_DOUBLE = np.asarray([r[0] == r[1] and r[0] <= 3 for r in ROLLS], dtype=bool)


def rolls(device: torch.device) -> torch.Tensor:
    """int64 [21, 2]: ``ROLLS`` on ``device``, made once per device. Row i
    is roll i's dice, and its first entry the die of a double."""
    return device_constant("expectimax.rolls", ROLLS.astype(np.int64), device)


def topk_small(v: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top k along the last axis as k rounds of masked max. Ties go as in the
    JAX version: the earlier index wins each round (``torch.argmax`` returns
    the first maximum), equal values at later indices surface in later
    rounds. Returns (values [..., k], int64 indices [..., k])."""
    vals, idxs = [], []
    cur = v
    lanes = torch.arange(v.shape[-1], device=v.device)
    for _ in range(k):
        m = cur.amax(-1, keepdim=True)
        first = torch.argmax((cur == m).to(torch.uint8), -1)
        vals.append(m[..., 0])
        idxs.append(first)
        cur = torch.where(lanes == first[..., None], -torch.inf, cur)
    return torch.stack(vals, -1), torch.stack(idxs, -1)


def _values(params, boards: Board, flag, cfg: Config) -> torch.Tensor:
    """Candidate values through ``fused_value`` when the actor has the fused
    kernel, else encode + forward (the f32 parity path, CPU only: on a card
    the values go through the kernel)."""
    if cfg.model.fused_actor_kernel:
        return fused_value(boards.data, flag, params)
    if boards.data.device.type != "cpu":
        raise NotImplementedError(
            "on a card the 2-ply scorer values boards through the fused_value "
            "kernel: set model.fused_actor_kernel"
        )
    return value_net.forward(params, encode_board(boards, flag), cfg.model)


def oriented_values(params, boards: Board, mover, cfg: Config) -> torch.Tensor:
    """Afterstate values, higher is better for ``mover`` under the configured
    td_mode: "side0" evaluates with the truthful opponent-on-roll flag and
    negates for side 1; the reference mode uses the mover's flag, and both
    players maximize. ``mover`` broadcasts against the boards' batch shape."""
    if cfg.train.td_mode == "side0":
        v = _values(params, boards, 1 - mover, cfg)
        return v * torch.where(mover == 0, 1.0, -1.0)
    return _values(params, boards, mover, cfg)


def reply_movegen_cfg(cfg: Config) -> MoveGenConfig:
    """Reduced-width enumeration for opponent replies: the scorer needs only
    the top-5 values, fixed rolls evaluate every game (no doubles sub-batch),
    and the reply tail tiers with the scorer's own settings."""
    a = cfg.twoply.reply_a_max
    return dataclasses.replace(
        cfg.movegen, w2=min(cfg.movegen.w2, a), w3=min(cfg.movegen.w3, a),
        w4=min(cfg.movegen.w4, a), a_max=a,
        nd_dedup_k=min(cfg.movegen.nd_dedup_k, a),
        dd_subbatch_div=0,
        nd_tier=cfg.twoply.reply_nd_tier,
        nd_wide_div=cfg.twoply.reply_wide_div,
    )


def weighted_opponent_response(
    params, boards: Board, opp: torch.Tensor, cfg: Config, return_flags: bool = False
):
    """E[opponent response] per candidate board: f32 [..., K] for boards of
    batch shape [..., K] and ``opp`` [...]. With ``return_flags`` also a
    bool [..., K] "inexact" flag: a per-roll reply width
    (``nd_reply_widths``/``dd_reply_widths``) truncated the replies."""
    tw = cfg.twoply
    if not tw.unroll_rolls or tw.roll_chunk > 1:
        raise NotImplementedError("only the unrolled 2-ply scorer is ported")
    if tw.value_first_m:
        raise NotImplementedError("the value-first reply dedup is not ported")
    out = _wor_unrolled(params, boards, opp, cfg, reply_movegen_cfg(cfg))
    return out if return_flags else out[0]


def _at(tree, i: int):
    return movegen2._tmap(lambda a: a[i], tree)


def _wor_unrolled(
    params, boards: Board, opp: torch.Tensor, cfg: Config, mg: MoveGenConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 15 non-double reply enumerations, then the 6 doubles, each at its
    own widths, each scored and added in turn."""
    tw = cfg.twoply
    topn, cap = tw.top_n_responses, tw.small_double_cap
    opp_k = opp[..., None]
    bs = boards.batch_shape
    dev = boards.data.device

    def score_one(ms: MoveSet, prob: float, cap_active: bool) -> torch.Tensor:
        valid = ms.valid
        if cap_active:
            rank = torch.cumsum(valid.to(torch.int32), -1, dtype=torch.int32)
            valid = valid & (rank <= cap)
        v = oriented_values(params, ms.boards, opp_k[..., None], cfg)
        v = torch.where(valid, v, _NEG)
        top, _ = topk_small(v, topn)
        present = top > _NEG / 2
        n = present.to(torch.float32).sum(-1).clamp_min(1.0)
        avg = torch.where(present, top, 0.0).sum(-1) / n
        return torch.where(valid.any(-1), avg * prob, 0.0)

    # first-ply tables, children and root contexts for all six dies, and the
    # children's die-independent stats, each computed once
    s1_all, b1_all = movegen2.die_tables(boards, opp_k)
    ctx_all = movegen2.die_ctxs(boards, opp_k)
    stats_all = slot_stats(b1_all, opp_k[None, ..., None])

    total = torch.zeros(bs, dtype=torch.float32, device=dev)
    flags = torch.zeros(bs, dtype=torch.bool, device=dev)
    dice_all = rolls(dev)
    order = sorted(range(len(ROLLS)), key=lambda i: bool(ROLLS[i, 0] == ROLLS[i, 1]))
    nd_pos = 0
    for i in order:
        (r0, r1), prob = ROLLS[i].tolist(), float(PROBS[i])
        if r0 != r1:
            hi, lo = max(r0, r1), min(r0, r1)
            d_hi = torch.full(bs, hi, dtype=torch.int64, device=dev)
            d_lo = torch.full(bs, lo, dtype=torch.int64, device=dev)
            pa = movegen2._run_pass_pre(
                _at(s1_all, hi - 1), _at(b1_all, hi - 1), opp_k, d_lo,
                ctx=_at(ctx_all, lo - 1), stats=_at(stats_all, hi - 1),
            )
            pb = movegen2._run_pass_pre(
                _at(s1_all, lo - 1), _at(b1_all, lo - 1), opp_k, d_hi,
                ctx=_at(ctx_all, hi - 1), stats=_at(stats_all, lo - 1),
            )
            mgr = mg
            if tw.nd_reply_widths:
                k = tw.nd_reply_widths[nd_pos]
                mgr = dataclasses.replace(mg, nd_dedup_k=k, a_max=k)
            nd_pos += 1
            dice = dice_all[i]
            ms = movegen2.enumerate_nondoubles_batched(
                boards, opp_k, dice, mgr, passes=(pa, pb)
            )
            total = total + score_one(ms, prob, False)
            if tw.nd_reply_widths:
                flags = flags | ms.overflow
        else:
            mgd = mg
            if tw.dd_reply_widths:
                w2, w3, w4, am = tw.dd_reply_widths[r0 - 1]
                mgd = dataclasses.replace(
                    mg, w2=w2, w3=w3, w4=w4, a_max=am,
                    nd_dedup_k=min(mg.nd_dedup_k, am),
                )
            die = dice_all[i, 0]
            ms = movegen2.enumerate_doubles_batched(
                boards, opp_k, die, mgd, s1=_at(s1_all, r0 - 1)
            )
            total = total + score_one(ms, prob, r0 <= 3)
            if tw.dd_reply_widths:
                flags = flags | ms.overflow
    return total, flags


class SampledLogits(NamedTuple):
    """The sampled logits (logits + Gumbel noise) that ``select_action_2ply``
    takes the argmax of."""

    rerank: torch.Tensor  # f32 [B, k] 2-ply scores / T + noise
    cand: torch.Tensor  # int64 [B, k] entry index of each reranked candidate
    one_ply: torch.Tensor  # f32 [B, W] 1-ply values / T + noise
    use_2ply: torch.Tensor  # bool [B] the row has >= k legal moves


def sampled_logits_2ply(
    params: Dict[str, torch.Tensor],
    state,
    moves: MoveSet,
    gumbel_2ply: torch.Tensor,
    gumbel_1ply: torch.Tensor,
    temperature: torch.Tensor,
    cfg: Config,
) -> SampledLogits:
    """softmax(score/T) logits over the reranked top-k candidates and
    softmax(V/T) logits over all entries, each plus its Gumbel noise
    (``gumbel_2ply`` [B, k], ``gumbel_1ply`` [B, W])."""
    k = cfg.twoply.top_k_candidates
    v_moves = oriented_values(params, moves.boards, state.player[..., None], cfg)
    v_masked = torch.where(moves.valid, v_moves, _NEG)

    topv, topi = topk_small(v_masked, k)  # [B, k]
    top_valid = torch.gather(moves.valid, -1, topi)
    cand = board_take(moves.boards, topi)
    w_o = weighted_opponent_response(params, cand, 1 - state.player, cfg)
    scores = cfg.twoply.alpha * topv - cfg.twoply.beta * w_o
    logits2 = torch.where(top_valid, scores / temperature, _NEG)
    logits1 = torch.where(moves.valid, v_masked / temperature, _NEG)
    return SampledLogits(
        logits2 + gumbel_2ply, topi, logits1 + gumbel_1ply, moves.count >= k
    )


def select_action_2ply(
    params: Dict[str, torch.Tensor],
    state,
    moves: MoveSet,
    gumbel_2ply: torch.Tensor,
    gumbel_1ply: torch.Tensor,
    temperature: torch.Tensor,
    cfg: Config,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """2-ply move selection: softmax(score/T) over the reranked top-k
    candidates where >= k legal moves exist, 1-ply softmax(V/T) otherwise,
    each sampled as argmax(``sampled_logits_2ply``). Returns (action [B]
    int64 into the move set's entry axis, v_obs [B])."""
    v_obs = value_net.forward(params, encode_board(state.board, state.player), cfg.model)
    s = sampled_logits_2ply(
        params, state, moves, gumbel_2ply, gumbel_1ply, temperature, cfg
    )
    pick = torch.argmax(s.rerank, -1)
    action_2ply = torch.gather(s.cand, -1, pick[..., None])[..., 0]
    action_1ply = torch.argmax(s.one_ply, -1)
    return torch.where(s.use_2ply, action_2ply, action_1ply), v_obs


def sampled_gap(s: SampledLogits, row: int, a: int, b: int) -> float:
    """|difference| of the sampled logits of entries ``a`` and ``b`` of one
    row, in the draw that decided the row (the rerank or the 1-ply softmax);
    inf where the rerank did not hold both. A small gap between two
    decisions taken from one state is a near-tie."""
    if not bool(s.use_2ply[row]):
        return abs(float(s.one_ply[row, a] - s.one_ply[row, b]))
    pos = {int(i): j for j, i in enumerate(s.cand[row])}
    if a not in pos or b not in pos:
        return math.inf
    return abs(float(s.rerank[row, pos[a]] - s.rerank[row, pos[b]]))
