"""Batched 1-ply self-play actor: movegen -> values -> softmax(V/T) sampling
-> env step, for every game in lockstep.

Port of the split-planes production path of
``mlp_ppo_2ply_multi_tpu/actor/rollout.py`` (``Config.production()``:
``split_planes=True``, ``fused_actor_kernel=True``, ``actor_tier_width=96``):

1. ``legal_moves_split`` enumerates the moves as three planes;
2. the observation value ``value_net.forward(encode_board(...))``;
3. two-tier candidate evaluation (``_select_action_split``): the first
   ``tier`` valid slots of every game through ``fused_value``, and the wide
   games at full width on a batch/``actor_tier_wide_div`` sub-batch through
   ``fused_value`` again;
4. sampling ``argmax(logits + gumbel)`` — exactly what
   ``jax.random.categorical`` computes (both argmaxes return the first
   maximum on ties);
5. ``step_chosen``, then ``reset_where`` in continuous mode.

Randomness is injected through ``StepNoise``. Without one, a step draws its
noise from the caller's ``torch.Generator`` on the device. The other
branches of the JAX ``rollout_step`` (merged movegen, 2-ply, tiered) raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from mlp_ppo_2ply_multi_tpu_torch.core.config import Config
from mlp_ppo_2ply_multi_tpu_torch.core.device import (
    DeviceLike,
    check_on,
    resolve_device,
)
from mlp_ppo_2ply_multi_tpu_torch.encoder.features import encode_board
from mlp_ppo_2ply_multi_tpu_torch.engine import board as B
from mlp_ppo_2ply_multi_tpu_torch.engine.board import Board
from mlp_ppo_2ply_multi_tpu_torch.engine.movegen import board_take, board_where
from mlp_ppo_2ply_multi_tpu_torch.engine.movegen2 import (
    SplitMoves,
    _select_set_bits,
    _take0,
    legal_moves_split,
)
from mlp_ppo_2ply_multi_tpu_torch.env import vec_env
from mlp_ppo_2ply_multi_tpu_torch.model import value_net
from mlp_ppo_2ply_multi_tpu_torch.ops.fused_value import fused_value

_NEG = -1e9


class Transition(NamedTuple):
    """One lockstep env step for every game."""

    packed_board: torch.Tensor  # int8[B, 52] board BEFORE the move
    player: torch.Tensor  # int32[B] side to move at decision time
    reward: torch.Tensor  # float32[B]
    recorded: torch.Tensor  # bool[B] decision made (experience recorded)
    done: torch.Tensor  # bool[B] episode ended with a win on this step
    boundary: torch.Tensor  # bool[B] episode boundary after this step
    value: torch.Tensor  # float32[B] V(obs) at decision time (diagnostics)
    win_type: torch.Tensor  # int8[B]
    close_out: torch.Tensor  # bool[B]
    prime: torch.Tensor  # bool[B]
    num_moves: torch.Tensor  # int32[B] legal move count
    overflow: torch.Tensor  # bool[B] a width cap dropped candidates


class StepNoise(NamedTuple):
    """All randomness of one step, injectable for parity runs."""

    gumbel_t1: torch.Tensor  # f32 [B, tier] tier-1 sampling noise
    gumbel_t2: torch.Tensor  # f32 [wn, W] tier-2 sampling noise
    next_dice: torch.Tensor  # int [B, 2] dice adopted by advancing games
    reset_opener: torch.Tensor  # int [B, 2] non-double opening rolls
    reset_first: torch.Tensor  # int [B, 2] non-double first rolls


def _split_shapes(batch: int, cfg: Config) -> Tuple[int, int, int]:
    """(tier, wn, W) of the split-planes actor at this batch: W is the merged
    slot width of ``legal_moves_split`` (the doubles plane is a_max wide)."""
    w = max(cfg.movegen.a_max, cfg.movegen.nd_dedup_k)
    wn = max(8, batch // cfg.model.actor_tier_wide_div)
    return cfg.model.actor_tier_width, wn, w


def gumbel(
    shape: Tuple[int, ...], gen: Optional[torch.Generator], device: torch.device
) -> torch.Tensor:
    """-log(-log(u)), u uniform on [tiny, 1), as jax.random.gumbel draws it."""
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def draw_noise(
    batch: int, cfg: Config, gen: Optional[torch.Generator], device: torch.device
) -> StepNoise:
    tier, wn, w = _split_shapes(batch, cfg)
    return StepNoise(
        gumbel_t1=gumbel((batch, tier), gen, device),
        gumbel_t2=gumbel((wn, w), gen, device),
        next_dice=vec_env.roll_dice(gen, (batch,), device),
        reset_opener=vec_env.roll_nondouble(gen, (batch,), device),
        reset_first=vec_env.roll_nondouble(gen, (batch,), device),
    )


def _pad_boards(bd: Board, w: int) -> Board:
    p = w - bd.data.shape[-2]
    if p <= 0:
        return bd
    return Board(data=torch.nn.functional.pad(bd.data, (0, 0, 0, p)))


def _select_action_split(
    params,
    sm: SplitMoves,
    cand_flag: torch.Tensor,
    sgn: Optional[torch.Tensor],
    gumbel_t1: torch.Tensor,
    gumbel_t2: torch.Tensor,
    temperature: torch.Tensor,
    cfg: Config,
):
    """Two-tier candidate evaluation over SplitMoves planes.

    Returns (action in merged-slot coordinates, chosen board [B, 52],
    overflow flag). The tier-1 boards are taken inside each plane, so the
    padded merged [B, W, 52] tensor never exists."""
    tier = cfg.model.actor_tier_width
    b = sm.valid.shape[0]
    W = sm.valid.shape[-1]
    T = sm.nd_boards.data.shape[-2]

    # ---- tier 1: the first `tier` valid slots of every game ----
    idx1, ok1 = _select_set_bits(sm.valid, tier)  # merged-slot coordinates
    t1 = board_take(sm.nd_boards, idx1.clamp_max(T - 1))
    # wide-nd and doubles planes: compact inside the sub-batch (their valid
    # masks equal the merged rows), then fan out by row
    idx1_w, _ = _select_set_bits(sm.ndw_keep, tier)
    idx1_d, _ = _select_set_bits(sm.dd_valid, tier)
    t1_wd = torch.cat(
        [board_take(sm.ndw_boards, idx1_w).data, board_take(sm.dd_boards, idx1_d).data]
    )
    wn_w = sm.ndw_boards.data.shape[0]
    slot_wd = torch.where(sm.dd_in, wn_w + sm.dd_slot, sm.ndw_slot)
    t1 = board_where((sm.ndw_in | sm.dd_in)[:, None], Board(t1_wd[slot_wd]), t1)
    v1 = fused_value(t1.data, cand_flag[..., None], params)  # [B, tier]
    if sgn is not None:
        v1 = v1 * sgn[..., None]
    logits1 = torch.where(ok1, v1 / temperature, _NEG)
    pick1 = torch.argmax(logits1 + gumbel_t1, -1)  # tier-space index
    a1 = torch.gather(idx1, -1, pick1[..., None])[..., 0]

    # ---- tier 2: wide games at full width on a compacted sub-batch ----
    wide = sm.count > tier
    wn = max(8, b // cfg.model.actor_tier_wide_div)
    sel, sel_ok = _select_set_bits(wide, wn)  # [wn]
    t2_boards = _pad_boards(_take0(sm.ndw_boards, sm.ndw_slot[sel]), W)
    if tier < T:
        nd_rows = _pad_boards(_take0(sm.nd_boards, sel), W)
        t2_boards = board_where(sm.ndw_in[sel][:, None], t2_boards, nd_rows)
    dd_rows = _pad_boards(_take0(sm.dd_boards, sm.dd_slot[sel]), W)
    t2_boards = board_where(sm.dd_in[sel][:, None], dd_rows, t2_boards)
    t2_flag = torch.broadcast_to(cand_flag, (b,))[sel]
    t2_valid = sm.valid[sel] & sel_ok[:, None]
    v2 = fused_value(t2_boards.data, t2_flag[..., None], params)  # [wn, W]
    if sgn is not None:
        v2 = v2 * sgn[sel][..., None]
    logits2 = torch.where(t2_valid, v2 / temperature, _NEG)
    a2 = torch.argmax(logits2 + gumbel_t2, -1)  # [wn]

    rank = torch.cumsum(wide.to(torch.int32), 0, dtype=torch.int32) - 1
    in_sub = wide & (rank < wn)
    slot2 = rank.clamp(0, wn - 1)
    action = torch.where(in_sub, a2[slot2], a1)

    # chosen board straight from the tier tensors (no full-width take)
    chosen1 = board_take(t1, pick1[..., None]).data[:, 0]
    chosen2 = board_take(t2_boards, a2[..., None]).data[:, 0]
    chosen = Board(data=torch.where(in_sub[:, None], chosen2[slot2], chosen1))
    return action, chosen, wide & ~in_sub


def rollout_step(
    params,
    state: vec_env.EnvState,
    temperature,
    cfg: Config,
    continuous: bool,
    noise: Optional[StepNoise] = None,
    gen: Optional[torch.Generator] = None,
    device: DeviceLike = None,
) -> Tuple[vec_env.EnvState, Transition]:
    """One lockstep self-play step for the whole batch (split-planes path).

    ``state`` and ``params`` must lie on ``device`` (default ``cuda``).
    ``noise`` injects the step's randomness; without it the step draws
    from ``gen`` on the device."""
    dev = resolve_device(device)
    check_on(state.board.data, dev, "state")
    check_on(params["w1"], dev, "params")
    if cfg.twoply.enabled:
        raise NotImplementedError(
            "2-ply selection (twoply/expectimax.py) is ported in a later slice"
        )
    if cfg.movegen.tiered:
        raise NotImplementedError(
            "the rejected tiered pipeline (experimental/tiered.py) is ported last"
        )
    if not cfg.movegen.split_planes:
        raise NotImplementedError(
            "the merged legal_moves path is ported in a later slice (with 2-ply)"
        )
    if not (cfg.model.fused_actor_kernel and cfg.model.actor_tier_width):
        raise NotImplementedError(
            "split planes need the tiered fused actor; the unfused select_action "
            "is ported in a later slice"
        )
    b = state.player.shape[0]
    if noise is None:
        noise = draw_noise(b, cfg, gen, dev)
    temperature = torch.as_tensor(temperature, dtype=torch.float32, device=dev)

    sm = legal_moves_split(state.board, state.player, state.dice, cfg.movegen)
    side0 = cfg.train.td_mode == "side0"
    cand_flag = (1 - state.player) if side0 else state.player
    sgn = (
        torch.where(state.player == 0, 1.0, -1.0).to(torch.float32)
        if side0 else None
    )
    v_obs = value_net.forward(
        params, encode_board(state.board, state.player), cfg.model
    )
    _, chosen, tier_ov = _select_action_split(
        params, sm, cand_flag, sgn, noise.gumbel_t1, noise.gumbel_t2,
        temperature, cfg,
    )
    res = vec_env.step_chosen(state, sm.count, chosen, noise.next_dice, cfg.env)

    trunc = ~res.state.game_over & (res.state.step_count >= cfg.env.max_timesteps)
    t = Transition(
        packed_board=B.pack_board(state.board),
        player=state.player,
        reward=res.reward,
        recorded=res.recorded,
        done=res.done,
        boundary=res.done | trunc,
        value=v_obs,
        win_type=res.win_type,
        close_out=res.close_out_bonus,
        prime=res.prime_bonus,
        num_moves=sm.count,
        overflow=tier_ov | sm.overflow,
    )
    new_state = res.state
    if continuous:
        new_state = vec_env.reset_where(
            res.done | trunc, new_state, noise.reset_opener, noise.reset_first
        )
    return new_state, t


def rollout_loop(
    params,
    state: vec_env.EnvState,
    temperature,
    cfg: Config,
    num_steps: int,
    continuous: bool = False,
    gen: Optional[torch.Generator] = None,
    device: DeviceLike = None,
) -> Tuple[vec_env.EnvState, Transition]:
    """``num_steps`` lockstep steps driven from a Python loop; returns the
    final state and a [T, B] transition stack. In sync mode call it with a
    fresh state and num_steps = cfg.env.max_timesteps."""
    ts = []
    for _ in range(num_steps):
        state, t = rollout_step(
            params, state, temperature, cfg, continuous, gen=gen, device=device
        )
        ts.append(t)
    return state, Transition(*(torch.stack(xs) for xs in zip(*ts)))
