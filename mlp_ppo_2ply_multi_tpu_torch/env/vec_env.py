"""Batched backgammon environment stepping B games in lockstep.

Port of ``mlp_ppo_2ply_multi_tpu/env/vec_env.py``; semantics, with the
reference's file:line, are in that module's docstring: the opening procedure
(a uniform draw over the 30 ordered non-double pairs), auto-pass on zero
legal moves, win typing, one-time close-out/five-prime shaping per player per
game, and step_count for the caller's 300-step truncation.

Dice are injectable everywhere: ``reset_from_rolls`` and ``reset_where`` take
the opening rolls, ``step``/``step_chosen`` take the next dice. Randomness
comes from an explicit ``torch.Generator`` only where a caller asks for it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from mlp_ppo_2ply_multi_tpu_torch.core.config import EnvConfig
from mlp_ppo_2ply_multi_tpu_torch.core.device import DeviceLike, resolve_device
from mlp_ppo_2ply_multi_tpu_torch.engine import board as B
from mlp_ppo_2ply_multi_tpu_torch.engine.board import Board
from mlp_ppo_2ply_multi_tpu_torch.engine.movegen import MoveSet, board_take


class EnvState(NamedTuple):
    board: Board  # [B]
    player: torch.Tensor  # int32[B] side to move
    dice: torch.Tensor  # int32[B, 2]
    game_over: torch.Tensor  # bool[B]
    win_type: torch.Tensor  # int8[B]: 0 none / 1 regular / 2 gammon / 3 backgammon
    close_out_given: torch.Tensor  # bool[B, 2]
    prime_given: torch.Tensor  # bool[B, 2]
    step_count: torch.Tensor  # int32[B] env steps this episode (incl. passes)


class StepResult(NamedTuple):
    state: EnvState
    reward: torch.Tensor  # float32[B], from the mover's perspective
    done: torch.Tensor  # bool[B] game ended on this step
    recorded: torch.Tensor  # bool[B] a decision was made
    passed: torch.Tensor  # bool[B] auto-pass happened
    win_type: torch.Tensor  # int8[B] (nonzero only where done)
    close_out_bonus: torch.Tensor  # bool[B]
    prime_bonus: torch.Tensor  # bool[B]


# The 30 ordered non-double dice pairs.
_ND_PAIRS = np.asarray(
    [(i, j) for i in range(1, 7) for j in range(1, 7) if i != j], dtype=np.int32
)


def roll_nondouble(
    gen: Optional[torch.Generator], shape: Tuple[int, ...], device: torch.device
) -> torch.Tensor:
    idx = torch.randint(0, 30, shape, generator=gen, device=device)
    return torch.as_tensor(_ND_PAIRS, device=device)[idx]


def roll_dice(
    gen: Optional[torch.Generator], shape: Tuple[int, ...], device: torch.device
) -> torch.Tensor:
    return torch.randint(
        1, 7, (*shape, 2), generator=gen, device=device, dtype=torch.int32
    )


def reset_from_rolls(opener: torch.Tensor, first: torch.Tensor) -> EnvState:
    """Fresh episodes with injected opening rolls (both non-double [B, 2]):
    the player whose die is higher starts (opener[:, 0] < opener[:, 1] means
    player 1), and ``first`` is the roll played first."""
    batch = opener.shape[0]
    dev = opener.device
    zeros = lambda *s, dt: torch.zeros(s, dtype=dt, device=dev)
    return EnvState(
        board=B.initial_board((batch,), dev),
        player=(opener[..., 0] < opener[..., 1]).to(torch.int32),
        dice=first.to(device=dev, dtype=torch.int32),
        game_over=zeros(batch, dt=torch.bool),
        win_type=zeros(batch, dt=torch.int8),
        close_out_given=zeros(batch, 2, dt=torch.bool),
        prime_given=zeros(batch, 2, dt=torch.bool),
        step_count=zeros(batch, dt=torch.int32),
    )


def reset(
    batch: int,
    gen: Optional[torch.Generator] = None,
    device: DeviceLike = None,
) -> EnvState:
    """Fresh episodes for the whole batch (reference backgammon_env.py:92-128),
    rolled from ``gen`` on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    opener = roll_nondouble(gen, (batch,), dev)
    first = roll_nondouble(gen, (batch,), dev)
    return reset_from_rolls(opener, first)


def reset_where(
    mask: torch.Tensor, state: EnvState, opener: torch.Tensor, first: torch.Tensor
) -> EnvState:
    """Re-initialize only the masked games (continuous rollout mode) from the
    opening rolls ``opener``/``first`` [B, 2]."""
    fresh = reset_from_rolls(opener, first)

    def sel(a, b):
        return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)

    return EnvState(
        board=Board(data=sel(fresh.board.data, state.board.data)),
        **{
            k: sel(getattr(fresh, k), getattr(state, k))
            for k in EnvState._fields
            if k != "board"
        },
    )


def step(
    state: EnvState,
    moves: MoveSet,
    action: torch.Tensor,
    next_dice: torch.Tensor,
    cfg: EnvConfig,
) -> StepResult:
    """One lockstep transition: ``action`` indexes the entry axis of
    ``moves`` (ignored where count == 0)."""
    a = action.to(torch.int64).clamp(0, moves.valid.shape[-1] - 1)
    chosen = board_take(moves.boards, a[..., None])
    return step_chosen(
        state, moves.count, Board(data=chosen.data[..., 0, :]), next_dice, cfg
    )


def step_chosen(
    state: EnvState,
    count: torch.Tensor,
    chosen: Board,
    next_dice: torch.Tensor,
    cfg: EnvConfig,
) -> StepResult:
    """``step`` with the selected afterstate supplied directly; ``chosen`` is
    ignored where count == 0. Games already over or truncated freeze."""
    p = state.player
    live = ~state.game_over & (state.step_count < cfg.max_timesteps)
    passing = live & (count == 0)
    acting = live & (count > 0)

    new_board = Board(
        data=torch.where(acting[..., None], chosen.data, state.board.data)
    )
    won = B.has_won(new_board, p) & acting
    bg = won & B.is_backgammon(new_board, p)
    gam = won & ~bg & B.is_gammon(new_board, p)
    reg = won & ~bg & ~gam
    i8 = lambda x: x.to(torch.int8)
    win_type_now = i8(reg) * 1 + i8(gam) * 2 + i8(bg) * 3
    f32 = lambda x: x.to(torch.float32)
    reward = (
        f32(reg) * cfg.reward_win_normal
        + f32(gam) * cfg.reward_win_gammon
        + f32(bg) * cfg.reward_win_backgammon
    )

    # one-time shaping (backgammon_env.py:196-213)
    pl = p.to(torch.int64)[..., None]
    given_c = torch.gather(state.close_out_given, -1, pl)[..., 0]
    given_p = torch.gather(state.prime_given, -1, pl)[..., 0]
    closeout = acting & ~won & B.is_closed_out(new_board, p) & ~given_c
    prime = acting & ~won & B.has_five_prime(new_board, p) & ~given_p
    if cfg.shaping_rewards:
        reward = (
            reward + f32(closeout) * cfg.reward_close_out
            + f32(prime) * cfg.reward_five_prime
        )
        p_oh = torch.nn.functional.one_hot(p.to(torch.int64), 2).to(torch.bool)
        new_cg = state.close_out_given | (p_oh & closeout[..., None])
        new_pg = state.prime_given | (p_oh & prime[..., None])
    else:
        closeout = torch.zeros_like(closeout)
        prime = torch.zeros_like(prime)
        new_cg, new_pg = state.close_out_given, state.prime_given

    # turn flip + fresh roll for acting (not won) and passing games
    advance = passing | (acting & ~won)
    new_state = EnvState(
        board=new_board,
        player=torch.where(advance, 1 - p, p),
        dice=torch.where(advance[..., None], next_dice.to(state.dice.dtype), state.dice),
        game_over=state.game_over | won,
        win_type=torch.where(won, win_type_now, state.win_type),
        close_out_given=new_cg,
        prime_given=new_pg,
        step_count=state.step_count + (acting | passing).to(torch.int32),
    )
    return StepResult(
        state=new_state,
        reward=reward,
        done=won,
        recorded=acting,
        passed=passing,
        win_type=win_type_now,
        close_out_bonus=closeout,
        prime_bonus=prime,
    )
