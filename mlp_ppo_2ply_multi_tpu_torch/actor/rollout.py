"""Batched self-play actor: movegen -> values -> sampling -> env step, for
every game in lockstep.

Port of ``mlp_ppo_2ply_multi_tpu/actor/rollout.py``, all four of its
branches:

* 1-ply tiered (``movegen.tiered``, ``train --tiered``; a rejected
  experiment kept default-off): ``experimental.tiered.legal_moves_tiered``
  gives a narrow [B, nd_tier] plane and a full-width sub-batch of the games
  it flags, ``chosen_tiered`` samples in each through ``fused_value`` (two
  launches) and returns the chosen board, then ``step_chosen``. It comes
  before split planes, needs the fused actor and reports no tier overflow.

* 1-ply split planes (``Config.production()``: ``split_planes=True``,
  ``fused_actor_kernel=True``, ``actor_tier_width=96``):

  1. ``legal_moves_split`` enumerates the moves as three planes;
  2. the observation value ``value_net.forward(encode_board(...))``;
  3. two-tier candidate evaluation (``_select_action_split``): the first
     ``tier`` valid slots of every game through ``fused_value``, and the
     wide games at full width on a batch/``actor_tier_wide_div`` sub-batch
     through ``fused_value`` again;
  4. sampling ``argmax(logits + gumbel)`` — exactly what
     ``jax.random.categorical`` computes (both argmaxes return the first
     maximum on ties);
  5. ``step_chosen``, then ``reset_where`` in continuous mode.

* 1-ply merged moves (``split_planes=False``): the merged ``legal_moves``,
  then ``select_action``: the unfused f32 encode + forward of the
  observation and every candidate, or (``fused_actor_kernel``) the
  candidates through ``fused_value``, two-tier (``_select_action_tiered``)
  when ``actor_tier_width`` is below the slot width; then ``vec_env.step``.

* 2-ply (``twoply.enabled``, ``Config.production_twoply()``): the merged
  ``legal_moves``, ``twoply.expectimax.select_action_2ply`` (the top-4 1-ply
  candidates reranked by the expected opponent reply), ``vec_env.step``,
  then ``reset_where``.

Randomness is injected through ``StepNoise`` (1-ply) or ``TwoPlyNoise``
(2-ply). Without one, a step draws its noise from the caller's
``torch.Generator`` on the device. The step never builds an autograd
graph.

Three functions stack steps into a [T, B] trajectory:

* ``rollout_loop`` dispatches every op of every step from Python;
* ``rollout_chunked`` (JAX: ``chunk`` steps as one compiled program with
  the state donated) runs ``chunk`` steps as one captured CUDA graph on a
  card, replayed T / chunk times; on the CPU the same chunks run eagerly;
* ``rollout`` (JAX: one ``lax.scan`` over the episode) is
  ``rollout_chunked`` with chunk 4 where 4 divides T, else 1.

All three draw the same noise stream from one generator: the graphed
ones draw each step's noise outside the graph, in step order, so on one
seed they give ``rollout_loop``'s trajectory.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from mlp_ppo_2ply_multi_tpu_torch.core.config import Config
from mlp_ppo_2ply_multi_tpu_torch.core.device import (
    DeviceLike,
    check_on,
    resolve_device,
)
from mlp_ppo_2ply_multi_tpu_torch.core.graphs import (
    cached_graph,
    capture_graph,
    capture_stream,
    params_signature,
    syncs_raise,
)
from mlp_ppo_2ply_multi_tpu_torch.core.tree import copy_into, leaves, tmap
from mlp_ppo_2ply_multi_tpu_torch.encoder.features import encode_board
from mlp_ppo_2ply_multi_tpu_torch.engine import board as B
from mlp_ppo_2ply_multi_tpu_torch.engine.board import Board
from mlp_ppo_2ply_multi_tpu_torch.engine.movegen import (
    MoveSet,
    board_take,
    board_where,
    legal_moves,
    moveset_width,
)
from mlp_ppo_2ply_multi_tpu_torch.engine.movegen2 import (
    SplitMoves,
    _rows_in,
    _select_set_bits,
    _take0,
    legal_moves_split,
)
from mlp_ppo_2ply_multi_tpu_torch.env import vec_env
from mlp_ppo_2ply_multi_tpu_torch.experimental import tiered as xt
from mlp_ppo_2ply_multi_tpu_torch.model import value_net
from mlp_ppo_2ply_multi_tpu_torch.model.sampling import orient, sample
from mlp_ppo_2ply_multi_tpu_torch.ops.fused_value import fused_value
from mlp_ppo_2ply_multi_tpu_torch.twoply.expectimax import select_action_2ply


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
    """All randomness of one 1-ply step, injectable for parity runs. Without
    a tier (``_noise_shapes``) gumbel_t1 is [B, W] and gumbel_t2 empty; in
    the tiered pipeline they sample its narrow and wide planes."""

    gumbel_t1: torch.Tensor  # f32 [B, tier] tier-1 (narrow plane) sampling noise
    gumbel_t2: torch.Tensor  # f32 [wn, W] tier-2 (wide plane) sampling noise
    next_dice: torch.Tensor  # int [B, 2] dice adopted by advancing games
    reset_opener: torch.Tensor  # int [B, 2] non-double opening rolls
    reset_first: torch.Tensor  # int [B, 2] non-double first rolls


class TwoPlyNoise(NamedTuple):
    """All randomness of one 2-ply step, injectable for parity runs."""

    gumbel_2ply: torch.Tensor  # f32 [B, k] rerank sampling noise
    gumbel_1ply: torch.Tensor  # f32 [B, W] 1-ply fallback sampling noise
    next_dice: torch.Tensor  # int [B, 2] dice adopted by advancing games
    reset_opener: torch.Tensor  # int [B, 2] non-double opening rolls
    reset_first: torch.Tensor  # int [B, 2] non-double first rolls


def _noise_shapes(batch: int, cfg: Config) -> Tuple[int, int, int]:
    """(t1, wn, W) of the 1-ply sampling noise, gumbel_t1 [batch, t1] and
    gumbel_t2 [wn, W]. W is the slot width of the engine's moves
    (``moveset_width``: max(a_max, nd_dedup_k) for the canonical
    ``legal_moves`` and ``legal_moves_split``, a_max for the sorted engine).
    The two-tier actor has t1 = tier and wn = max(8, batch //
    actor_tier_wide_div); without a tier (no fused kernel, a tier of 0 or
    one not below W) t1 = W and wn = 0. The tiered pipeline
    (``movegen.tiered``, 1-ply) samples its narrow plane, t1 = nd_tier, and
    its wide plane, wn = max(8, batch // tiered_wide_div)."""
    w = moveset_width(cfg.movegen)
    if cfg.movegen.tiered and not cfg.twoply.enabled:
        return cfg.movegen.nd_tier, max(8, batch // cfg.movegen.tiered_wide_div), w
    tier = cfg.model.actor_tier_width
    if not (cfg.model.fused_actor_kernel and 0 < tier < w):
        return w, 0, w
    return tier, max(8, batch // cfg.model.actor_tier_wide_div), w


def gumbel(
    shape: Tuple[int, ...], gen: Optional[torch.Generator], device: torch.device
) -> torch.Tensor:
    """-log(-log(u)), u uniform on [tiny, 1), as jax.random.gumbel draws it."""
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def draw_noise(
    batch: int, cfg: Config, gen: Optional[torch.Generator], device: torch.device
) -> Union[StepNoise, TwoPlyNoise]:
    """The step's noise: a TwoPlyNoise when 2-ply is enabled, else a
    StepNoise (``_noise_shapes``)."""
    t1, wn, w = _noise_shapes(batch, cfg)
    if cfg.twoply.enabled:
        return TwoPlyNoise(
            gumbel_2ply=gumbel((batch, cfg.twoply.top_k_candidates), gen, device),
            gumbel_1ply=gumbel((batch, w), gen, device),
            next_dice=vec_env.roll_dice(gen, (batch,), device),
            reset_opener=vec_env.roll_nondouble(gen, (batch,), device),
            reset_first=vec_env.roll_nondouble(gen, (batch,), device),
        )
    return StepNoise(
        gumbel_t1=gumbel((batch, t1), gen, device),
        gumbel_t2=gumbel((wn, w), gen, device),
        next_dice=vec_env.roll_dice(gen, (batch,), device),
        reset_opener=vec_env.roll_nondouble(gen, (batch,), device),
        reset_first=vec_env.roll_nondouble(gen, (batch,), device),
    )


def _temperature(temperature, dev: torch.device) -> torch.Tensor:
    """The temperature as a 0-d f32 tensor on ``dev``. A Python number is
    written by a fill on the device, not copied from the host, so the step
    never synchronises the host with the card."""
    if isinstance(temperature, torch.Tensor):
        return temperature.to(device=dev, dtype=torch.float32)
    return torch.full((), float(temperature), dtype=torch.float32, device=dev)


def _overflow(moves: MoveSet) -> torch.Tensor:
    """The MoveSet's overflow flag; all False for an engine that tracks none
    (the sorted engine), as JAX ``actor/rollout.py:346-350`` reads it."""
    if moves.overflow is None:
        return torch.zeros_like(moves.count, dtype=torch.bool)
    return moves.overflow


def _wide_rows(count: torch.Tensor, tier: int, cfg: Config):
    """The tier-2 sub-batch: (wide, sel, sel_ok, in_sub, slot) — the games
    with more than ``tier`` moves, the first batch/``actor_tier_wide_div``
    (at least 8) of them gathered by ``sel``, and for each game whether it
    is in the sub-batch and where."""
    wide = count > tier
    wn = max(8, count.shape[0] // cfg.model.actor_tier_wide_div)
    sel, sel_ok = _select_set_bits(wide, wn)  # [wn]
    return (wide, sel, sel_ok, *_rows_in(wide, wn))


def select_action(
    params,
    state: vec_env.EnvState,
    moves: MoveSet,
    gumbel_t1: torch.Tensor,
    gumbel_t2: torch.Tensor,
    temperature: torch.Tensor,
    cfg: Config,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """softmax(V/T) sampling over the merged MoveSet's afterstate values
    (the JAX ``select_action``). Returns (action, v_obs, tier_overflow).

    Without ``fused_actor_kernel`` the observation and every candidate go
    through one encode + forward in ``cfg.model.dtype`` (the f32 parity
    path); with it the observation takes ``value_net.forward`` and the
    candidates ``fused_value``, two-tier (``_select_action_tiered``) when
    ``actor_tier_width`` is below the slot width. td_mode "side0" encodes
    candidates with the opponent on roll, and side 1 minimizes."""
    cand_flag, sgn = orient(state.player, cfg.train.td_mode)
    tier = cfg.model.actor_tier_width
    if cfg.model.fused_actor_kernel:
        v_obs = value_net.forward(params, encode_board(state.board, state.player), cfg.model)
        if 0 < tier < moves.valid.shape[-1]:
            action, tier_ov = _select_action_tiered(
                params, moves, cand_flag, sgn, gumbel_t1, gumbel_t2, temperature, cfg
            )
            return action, v_obs, tier_ov
        v_moves = fused_value(moves.boards.data, cand_flag[..., None], params)
    else:
        obs = encode_board(state.board, state.player)  # [B, 198]
        cand = encode_board(moves.boards, cand_flag[..., None])  # [B, A, 198]
        v = value_net.forward(params, torch.cat([obs[..., None, :], cand], -2), cfg.model)
        v_obs, v_moves = v[..., 0], v[..., 1:]
    action = sample(v_moves, moves.valid, sgn, gumbel_t1, temperature)
    return action, v_obs, torch.zeros_like(moves.valid[..., 0])


def _select_action_tiered(
    params, moves: MoveSet, cand_flag, sgn, gumbel_t1, gumbel_t2, temperature, cfg: Config
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-tier candidate evaluation over the merged MoveSet: every game's
    first ``tier`` valid slots, and the games with more moves at full width
    on a batch/``actor_tier_wide_div`` sub-batch. Returns (action in slot
    coordinates, overflow flag of wide games beyond the sub-batch, which
    sample from their truncated tier-1 set)."""
    tier = cfg.model.actor_tier_width
    b = moves.valid.shape[0]
    idx1, ok1 = _select_set_bits(moves.valid, tier)  # [B, tier]
    t1 = board_take(moves.boards, idx1)
    v1 = fused_value(t1.data, cand_flag[..., None], params)  # [B, tier]
    pick1 = sample(v1, ok1, sgn, gumbel_t1, temperature)  # tier-space index
    a1 = torch.gather(idx1, -1, pick1[..., None])[..., 0]

    wide, sel, sel_ok, in_sub, slot2 = _wide_rows(moves.count, tier, cfg)
    t2_flag = torch.broadcast_to(cand_flag, (b,))[sel]
    v2 = fused_value(moves.boards.data[sel], t2_flag[..., None], params)  # [wn, A]
    a2 = sample(
        v2, moves.valid[sel] & sel_ok[:, None], None if sgn is None else sgn[sel],
        gumbel_t2, temperature,
    )
    return torch.where(in_sub, a2[slot2], a1), wide & ~in_sub


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
    pick1 = sample(v1, ok1, sgn, gumbel_t1, temperature)  # tier-space index
    a1 = torch.gather(idx1, -1, pick1[..., None])[..., 0]

    # ---- tier 2: wide games at full width on a compacted sub-batch ----
    wide, sel, sel_ok, in_sub, slot2 = _wide_rows(sm.count, tier, cfg)
    t2_boards = _pad_boards(_take0(sm.ndw_boards, sm.ndw_slot[sel]), W)
    if tier < T:
        nd_rows = _pad_boards(_take0(sm.nd_boards, sel), W)
        t2_boards = board_where(sm.ndw_in[sel][:, None], t2_boards, nd_rows)
    dd_rows = _pad_boards(_take0(sm.dd_boards, sm.dd_slot[sel]), W)
    t2_boards = board_where(sm.dd_in[sel][:, None], dd_rows, t2_boards)
    t2_flag = torch.broadcast_to(cand_flag, (b,))[sel]
    t2_valid = sm.valid[sel] & sel_ok[:, None]
    v2 = fused_value(t2_boards.data, t2_flag[..., None], params)  # [wn, W]
    a2 = sample(v2, t2_valid, None if sgn is None else sgn[sel], gumbel_t2, temperature)
    action = torch.where(in_sub, a2[slot2], a1)

    # chosen board straight from the tier tensors (no full-width take)
    chosen1 = board_take(t1, pick1[..., None]).data[:, 0]
    chosen2 = board_take(t2_boards, a2[..., None]).data[:, 0]
    chosen = Board(data=torch.where(in_sub[:, None], chosen2[slot2], chosen1))
    return action, chosen, wide & ~in_sub


@torch.no_grad()
def rollout_step(
    params,
    state: vec_env.EnvState,
    temperature,
    cfg: Config,
    continuous: bool,
    noise: Union[StepNoise, TwoPlyNoise, None] = None,
    gen: Optional[torch.Generator] = None,
    device: DeviceLike = None,
) -> Tuple[vec_env.EnvState, Transition]:
    """One lockstep self-play step for the whole batch: the 2-ply path when
    ``cfg.twoply.enabled``, else the 1-ply tiered pipeline
    (``movegen.tiered``), the split-planes path or (without ``split_planes``)
    the merged-moves path.

    ``state`` and ``params`` must lie on ``device`` (default ``cuda``).
    ``noise`` (a TwoPlyNoise for 2-ply, else a StepNoise) injects the step's
    randomness; without it the step draws from ``gen`` on the device."""
    dev = resolve_device(device)
    check_on(state.board.data, dev, "state")
    check_on(params["w1"], dev, "params")
    tiered = cfg.movegen.tiered and not cfg.twoply.enabled
    if tiered and not cfg.model.fused_actor_kernel:
        raise ValueError("the tiered pipeline needs the fused actor kernel")
    if not (cfg.twoply.enabled or tiered):
        if cfg.movegen.split_planes and not (
            cfg.model.fused_actor_kernel and cfg.model.actor_tier_width
        ):
            raise ValueError("split planes need the tiered fused actor")
    b = state.player.shape[0]
    if noise is None:
        noise = draw_noise(b, cfg, gen, dev)
    want = TwoPlyNoise if cfg.twoply.enabled else StepNoise
    if not isinstance(noise, want):
        raise TypeError(f"this step takes a {want.__name__}, got {type(noise).__name__}")
    temperature = _temperature(temperature, dev)

    if tiered:
        ti = xt.legal_moves_tiered(state.board, state.player, state.dice, cfg.movegen)
        chosen, v_obs = xt.chosen_tiered(
            params, state, ti, noise.gumbel_t1, noise.gumbel_t2, temperature, cfg
        )
        res = vec_env.step_chosen(state, ti.count, chosen, noise.next_dice, cfg.env)
        count, overflow = ti.count, ti.overflow
    elif cfg.twoply.enabled:
        moves = legal_moves(state.board, state.player, state.dice, cfg.movegen)
        action, v_obs = select_action_2ply(
            params, state, moves, noise.gumbel_2ply, noise.gumbel_1ply,
            temperature, cfg,
        )
        res = vec_env.step(state, moves, action, noise.next_dice, cfg.env)
        count, overflow = moves.count, _overflow(moves)
    elif not cfg.movegen.split_planes:
        moves = legal_moves(state.board, state.player, state.dice, cfg.movegen)
        action, v_obs, tier_ov = select_action(
            params, state, moves, noise.gumbel_t1, noise.gumbel_t2, temperature, cfg
        )
        res = vec_env.step(state, moves, action, noise.next_dice, cfg.env)
        count, overflow = moves.count, tier_ov | _overflow(moves)
    else:
        sm = legal_moves_split(state.board, state.player, state.dice, cfg.movegen)
        cand_flag, sgn = orient(state.player, cfg.train.td_mode)
        v_obs = value_net.forward(
            params, encode_board(state.board, state.player), cfg.model
        )
        _, chosen, tier_ov = _select_action_split(
            params, sm, cand_flag, sgn, noise.gumbel_t1, noise.gumbel_t2,
            temperature, cfg,
        )
        res = vec_env.step_chosen(state, sm.count, chosen, noise.next_dice, cfg.env)
        count, overflow = sm.count, tier_ov | sm.overflow

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
        num_moves=count,
        overflow=overflow,
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


# ---------------------------------------------------------------------------
# chunked and scanned rollouts: captured CUDA graphs of the step
# ---------------------------------------------------------------------------

Noise = Union[StepNoise, TwoPlyNoise]


def run_steps(params, state, temperature, cfg: Config, continuous: bool,
              noises: Sequence[Noise], dev: torch.device):
    """``len(noises)`` eager steps, one for each noise; returns the final
    state and their [len(noises), B] transition stack."""
    ts = []
    for nz in noises:
        state, t = rollout_step(params, state, temperature, cfg, continuous, noise=nz,
                                device=dev)
        ts.append(t)
    return state, Transition(*(torch.stack(xs) for xs in zip(*ts)))


class ChunkGraph:
    """``chunk`` rollout steps captured as one CUDA graph.

    Its static inputs are the env state, one noise per step and the
    temperature; the captured chunk ends by copying its final state into the
    state buffers (the counterpart of JAX's donated state), so the state
    stays in them from one replay to the next. ``traj`` holds the last
    replay's [chunk, B] transitions. Built by running the first chunk
    eagerly on the capture stream (the warm-up, and real work: the caller
    takes its transitions from ``warmup``, its final state is in the
    buffers), then capturing. ``info`` has the capture's seconds (with
    instantiation) and the bytes its memory pool holds."""

    def __init__(self, params, state, temperature, cfg: Config, chunk: int,
                 continuous: bool, dev: torch.device, noises: Sequence[Noise]):
        stream = capture_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            self.temp = _temperature(temperature, dev).clone()
            with syncs_raise():
                state, traj = run_steps(params, state, self.temp, cfg, continuous, noises, dev)
            self.state = tmap(torch.clone, state)
            self.noise = [tmap(torch.clone, nz) for nz in noises]
        self.warmup: Optional[Transition] = traj

        def body() -> None:
            st, self.traj = run_steps(
                params, self.state, self.temp, cfg, continuous, self.noise, dev)
            copy_into(self.state, st)

        self.graph, self.launches, info = capture_graph(
            body, dev, f"{chunk} rollout steps")
        self.info = dict(chunk=chunk, batch=state.player.shape[0], **info)

    def replay(self, noises: Sequence[Noise], state=None, temperature=None) -> None:
        """One chunk on the current stream, from ``state`` and at
        ``temperature`` (None: those the buffers hold, the last replay's
        final state); counts the launches it ran."""
        if state is not None:
            copy_into(self.state, state)
        if isinstance(temperature, torch.Tensor):
            self.temp.copy_(temperature)
        elif temperature is not None:
            self.temp.fill_(float(temperature))
        for buf, nz in zip(self.noise, noises):
            copy_into(buf, nz)
        self.graph.replay()
        self.launches.replayed()


def _graph_key(params, state, cfg: Config, chunk: int, continuous: bool) -> tuple:
    """A chunk graph is kept for (cfg, chunk, continuous, device, params
    storage, state shapes)."""
    return ("rollout", cfg, chunk, continuous, str(state.board.data.device),
            params_signature(params), tuple((tuple(t.shape), t.dtype) for t in leaves(state)))


def _on(noise: Noise, dev: torch.device) -> Noise:
    return tmap(lambda t: t.to(dev), noise)


@torch.no_grad()
def rollout_chunked(
    params,
    state: vec_env.EnvState,
    temperature,
    cfg: Config,
    num_steps: int,
    chunk: int = 4,
    continuous: bool = True,
    gen: Optional[torch.Generator] = None,
    device: DeviceLike = None,
    noise: Optional[Sequence[Noise]] = None,
) -> Tuple[vec_env.EnvState, Transition]:
    """``num_steps`` lockstep steps, ``chunk`` at a time; returns the final
    state and a [num_steps, B] transition stack in step order. The
    counterpart of JAX's ``rollout_chunked`` (``num_steps % chunk == 0``).

    On a card the chunk is one CUDA graph, captured at the first call for
    (cfg, B, chunk, continuous, device, params storage) and replayed
    num_steps / chunk times at this and every later call; the first call
    runs its first chunk eagerly, as the warm-up before the capture. A
    capture that fails raises: there is no eager fallback. On the CPU the
    chunks run eagerly.

    Each step's noise is drawn outside the graph from ``gen``, in step
    order, so on one seed this returns ``rollout_loop``'s trajectory;
    ``noise`` (``num_steps`` StepNoise or TwoPlyNoise) replaces the draws.
    ``state`` and ``params`` must lie on ``device`` (default ``cuda``);
    ``state`` is not changed."""
    dev = resolve_device(device)
    check_on(state.board.data, dev, "state")
    check_on(params["w1"], dev, "params")
    if chunk < 1 or num_steps < 1 or num_steps % chunk:
        raise ValueError(f"num_steps ({num_steps}) must be a positive multiple of chunk ({chunk})")
    if noise is not None and len(noise) != num_steps:
        raise ValueError(f"noise has {len(noise)} steps, num_steps is {num_steps}")
    b = state.player.shape[0]

    def chunk_noise(c: int) -> List[Noise]:
        if noise is not None:
            return [_on(nz, dev) for nz in noise[c * chunk:(c + 1) * chunk]]
        return [draw_noise(b, cfg, gen, dev) for _ in range(chunk)]

    out: List[torch.Tensor] = []

    def keep(c: int, traj: Transition) -> None:
        if not out:
            out.extend(torch.empty((num_steps, *x.shape[1:]), dtype=x.dtype, device=dev)
                       for x in traj)
        for dst, src in zip(out, traj):
            dst[c * chunk:(c + 1) * chunk].copy_(src)

    n_chunks = num_steps // chunk
    if dev.type != "cuda":
        for c in range(n_chunks):
            state, traj = run_steps(params, state, temperature, cfg, continuous,
                                     chunk_noise(c), dev)
            keep(c, traj)
        return state, Transition(*out)

    g, first = cached_graph(_graph_key(params, state, cfg, chunk, continuous),
                            lambda: ChunkGraph(params, state, temperature, cfg, chunk,
                                               continuous, dev, chunk_noise(0)))
    if first:
        keep(0, g.warmup)
        g.warmup = None
    for c in range(int(first), n_chunks):
        if c == 0:
            g.replay(chunk_noise(c), state, temperature)
        else:
            g.replay(chunk_noise(c))
        keep(c, g.traj)
    return tmap(torch.clone, g.state), Transition(*out)


def rollout(
    params,
    state: vec_env.EnvState,
    temperature,
    cfg: Config,
    num_steps: int,
    continuous: bool = False,
    gen: Optional[torch.Generator] = None,
    device: DeviceLike = None,
    noise: Optional[Sequence[Noise]] = None,
) -> Tuple[vec_env.EnvState, Transition]:
    """The counterpart of JAX's scanned ``rollout`` (one ``lax.scan`` over
    ``num_steps``): ``rollout_chunked`` with chunk 4 where 4 divides
    num_steps, else 1, so a 300-step episode is 75 replays of a 4-step
    graph. In sync mode call it with a fresh state and num_steps =
    cfg.env.max_timesteps."""
    chunk = 4 if num_steps % 4 == 0 else 1
    return rollout_chunked(params, state, temperature, cfg, num_steps, chunk=chunk,
                           continuous=continuous, gen=gen, device=device, noise=noise)
