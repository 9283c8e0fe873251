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

Two scorers compute the opponent response, with JAX's accumulation order:

* the unrolled scorer (``TwoPlyConfig.unroll_rolls``, ``roll_chunk <= 1``,
  no ``value_first_m``): the 15 non-double rolls, then the 6 doubles, in
  ``ROLLS`` order, each at its own widths (``nd_reply_widths``,
  ``dd_reply_widths``) and added to the total in turn;
* the scan scorer (otherwise; JAX's ``lax.scan`` over roll chunks, here a
  Python loop over them): ``roll_chunk`` C rolls folded into the batch, the
  last chunk padded with repeats of its final roll at probability 0; each
  chunk is summed over its C axis and then added to the total, so at C = 1
  it equals the unrolled scorer bit for bit at equal widths. With
  ``value_first_m`` M (a rejected experiment, default 0) the non-double
  replies are not deduped: the top M by value are, and the mean takes the
  first ``top_n_responses`` distinct ones; a row where that may differ from
  the reference-order dedup is flagged inexact.

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
from mlp_ppo_2ply_multi_tpu_torch.core.tree import tmap
from mlp_ppo_2ply_multi_tpu_torch.encoder.features import encode_board
from mlp_ppo_2ply_multi_tpu_torch.engine import movegen2
from mlp_ppo_2ply_multi_tpu_torch.engine.board import Board, pack_board
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
    kernel, else encode + forward in ``cfg.model.dtype`` on the boards'
    device (JAX's ``oriented_values`` path, which no Pallas kernel serves:
    the config picks the path, as in JAX)."""
    if cfg.model.fused_actor_kernel:
        return fused_value(boards.data, flag, params)
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
    bool [..., K] "inexact" flag: in the unrolled scorer a per-roll reply
    width (``nd_reply_widths``/``dd_reply_widths``) truncated the replies,
    in the value-first scan more than M - top_n of the top M replies were
    duplicates. The unrolled scorer runs unless ``unroll_rolls`` is off,
    ``roll_chunk`` is above 1 or ``value_first_m`` is set (JAX's
    dispatch); else the scan scorer."""
    tw = cfg.twoply
    mg = reply_movegen_cfg(cfg)
    if tw.unroll_rolls and tw.roll_chunk <= 1 and not tw.value_first_m:
        out = _wor_unrolled(params, boards, opp, cfg, mg)
    else:
        out = _wor_scan(params, boards, opp, cfg, mg)
    return out if return_flags else out[0]


def _at(tree, i: int):
    return tmap(lambda a: a[i], tree)


def _at_many(tree, idx):
    """The entries ``idx`` (a host sequence) of every leaf's leading axis,
    stacked: device ops only, so the step stays capturable."""
    return tmap(lambda a: torch.stack([a[i] for i in idx]), tree)


def _chunks(c: int, *arrs):
    """Stack roll-constant host arrays into chunks of ``c``; the last chunk
    is padded with repeats of its final roll whose probability (always the
    second array) is zeroed. Each result is [n_chunks, c, ...]."""
    n = len(arrs[0])
    pad = (-n) % c
    out = []
    for i, a in enumerate(arrs):
        a = np.asarray(a)
        a = np.concatenate([a, np.repeat(a[-1:], pad, axis=0)], axis=0)
        if i == 1 and pad:
            a[-pad:] = 0.0
        out.append(a.reshape(-1, c, *a.shape[1:]))
    return out


def _top_mean(top: torch.Tensor, use: torch.Tensor) -> torch.Tensor:
    """Mean of the ``use`` entries of ``top`` (at least one counted)."""
    n = use.to(torch.float32).sum(-1).clamp_min(1.0)
    return torch.where(use, top, 0.0).sum(-1) / n


def _wor_scan(
    params, boards: Board, opp: torch.Tensor, cfg: Config, mg: MoveGenConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan scorer (JAX ``weighted_opponent_response``'s ``lax.scan``
    branch): 5 chunks of the 15 non-double rolls at C = 3 (15 at C = 1),
    then the 6 doubles, each chunk's C rolls folded into the batch
    ([C, ..., K] boards), every roll at the uniform ``reply_movegen_cfg``
    widths. A chunk's scores are summed over C, then added to the total."""
    tw = cfg.twoply
    topn, cap = tw.top_n_responses, tw.small_double_cap
    c = max(1, tw.roll_chunk)
    bs = boards.batch_shape
    dev = boards.data.device
    opp_k = opp[..., None]  # [..., 1] broadcasts over the candidates
    bc = Board(data=boards.data[None].expand(c, *boards.data.shape))
    lead = (slice(None),) + (None,) * len(bs)  # [C] -> [C, 1, ...]
    ones = (1,) * len(bs)

    def score_moveset(ms: MoveSet, probs_c: torch.Tensor, cap_active) -> torch.Tensor:
        """The probability-weighted sum over a chunk's C rolls; "the first
        cap moves" by valid-entry rank (the valid mask need not be
        contiguous)."""
        rank = torch.cumsum(ms.valid.to(torch.int32), -1, dtype=torch.int32)
        valid = ms.valid & ((rank <= cap) | ~cap_active[lead + (None,)])
        v = oriented_values(params, ms.boards, opp_k[..., None], cfg)  # [C, ..., K, A]
        top, _ = topk_small(torch.where(valid, v, _NEG), topn)
        avg = _top_mean(top, top > _NEG / 2)
        return torch.where(valid.any(-1), avg * probs_c[lead], 0.0).sum(0)

    def score_raw(raw: movegen2.RawMoves, probs_c: torch.Tensor):
        """Value-first scoring of an undeduped reply set: values over every
        present candidate (max-submove filter from the exact has_pair), the
        top M by value, dedup of only those M (by signature, or by board
        with ``nd_sig_dedup=False``), the mean of the first top_n distinct.
        Exact unless more than M - top_n of the top M are duplicates
        (flagged): duplicates carry bit-equal values."""
        m = tw.value_first_m
        if m < topn:
            raise ValueError("value_first_m must cover top_n_responses")
        vmask = raw.valid & (raw.kpair | ~raw.has_pair[..., None])
        v = oriented_values(params, raw.boards, opp_k[..., None], cfg)
        top, ti = topk_small(torch.where(vmask, v, _NEG), m)  # [C, ..., K, m]
        ok = top > _NEG / 2
        if cfg.movegen.nd_sig_dedup:
            dup = movegen2._dup_earlier_sig(torch.gather(raw.sig, -1, ti), ok)
        else:
            dup = movegen2._dup_earlier_mask(pack_board(board_take(raw.boards, ti)), ok)
        surv = ok & ~dup
        rank = torch.cumsum(surv.to(torch.int32), -1, dtype=torch.int32)
        avg = _top_mean(top, surv & (rank <= topn))
        n_present = vmask.sum(-1)
        # only this path's own failure: too many duplicates among the top M
        # (raw.overflow, the pre-dedup count above reply_a_max, truncates
        # both paths alike and is not folded in)
        inexact = (n_present > m) & (surv.sum(-1) < topn)
        total = torch.where(vmask.any(-1), avg * probs_c[lead], 0.0).sum(0)
        return total, inexact.any(0)

    # the first-ply tables, children and root contexts of all six dies,
    # once; each chunk takes its rolls' dies from the leading [6] axis
    s1_all, b1_all = movegen2.die_tables(boards, opp_k)
    ctx_all = movegen2.die_ctxs(boards, opp_k)

    nd = ROLLS[:, 0] != ROLLS[:, 1]
    nd_rolls, nd_probs = _chunks(c, ROLLS[nd], PROBS[nd])
    dd_dies, dd_probs, dd_small = _chunks(c, ROLLS[~nd][:, 0], PROBS[~nd], SMALL_DOUBLE[~nd])
    key = f"expectimax.scan{c}"
    nd_dice = device_constant(key + ".nd_rolls", nd_rolls.astype(np.int64), dev)
    nd_p = device_constant(key + ".nd_probs", nd_probs, dev)
    dd_d = device_constant(key + ".dd_dies", dd_dies.astype(np.int64), dev)
    dd_p = device_constant(key + ".dd_probs", dd_probs, dev)
    dd_cap = device_constant(key + ".dd_small", dd_small, dev)
    no_cap = device_constant(f"{key}.no_cap", np.zeros(c, bool), dev)

    total = torch.zeros(bs, dtype=torch.float32, device=dev)
    flags = torch.zeros(bs, dtype=torch.bool, device=dev)
    for j, rolls_c in enumerate(nd_rolls):
        hi = [max(r) - 1 for r in rolls_c.tolist()]  # die index of each roll
        lo = [min(r) - 1 for r in rolls_c.tolist()]
        dice = nd_dice[j].reshape(c, *ones, 2).expand(c, *bs, 2)
        d_hi = dice.amax(-1)
        d_lo = dice.amin(-1)
        pa = movegen2._run_pass_pre(
            _at_many(s1_all, hi), _at_many(b1_all, hi), opp_k[None], d_lo,
            ctx=_at_many(ctx_all, lo),
        )
        pb = movegen2._run_pass_pre(
            _at_many(s1_all, lo), _at_many(b1_all, lo), opp_k[None], d_hi,
            ctx=_at_many(ctx_all, hi),
        )
        if tw.value_first_m:
            raw = movegen2.enumerate_nondoubles_raw_batched(
                bc, opp_k[None], dice, mg.a_max, passes=(pa, pb)
            )
            t, ix = score_raw(raw, nd_p[j])
            total, flags = total + t, flags | ix
        else:
            ms = movegen2.enumerate_nondoubles_batched(
                bc, opp_k[None], dice, mg, passes=(pa, pb)
            )
            total = total + score_moveset(ms, nd_p[j], no_cap)
    for j, dies_c in enumerate(dd_dies):
        die = dd_d[j].reshape(c, *ones).expand(c, *bs)
        ms = movegen2.enumerate_doubles_batched(
            bc, opp_k[None], die, mg, s1=_at_many(s1_all, [d - 1 for d in dies_c.tolist()])
        )
        total = total + score_moveset(ms, dd_p[j], dd_cap[j])
    return total, flags


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
        avg = _top_mean(top, top > _NEG / 2)
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
