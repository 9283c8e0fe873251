"""Head-to-head evaluation arena: batched policy-vs-policy matches.

Port of ``mlp_ppo_2ply_multi_tpu/eval/arena.py``. Both policies act on every
game of the batch in lockstep, and each game takes the action of the side to
move (side A plays player 0, side B player 1).

A policy maps (params, state, moves, gumbel) -> action int64 [B]. Where the
JAX policy draws ``jax.random.categorical(key, logits)``, this one takes
``argmax(logits + gumbel)`` with the Gumbel noise [B, W] injected by the
caller, which is what ``categorical`` computes.

JAX's ``play_match`` is one ``lax.scan`` over ``max_steps``. Here a chunk of
match steps is one CUDA graph on a card (``MatchGraph``), captured at the
first call for (cfg, B, chunk, policies, device, params storage) and
replayed; the first chunk of that call runs eagerly as the warm-up. Each
step's noise and dice are drawn from the caller's generator outside the
graph, in step order, so the graphed and the eager match are equal on one
seed. A failed capture raises: nothing falls back to the eager loop. On the
CPU the chunks run eagerly.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from mlp_ppo_2ply_multi_tpu_torch.actor.rollout import gumbel
from mlp_ppo_2ply_multi_tpu_torch.core.config import Config
from mlp_ppo_2ply_multi_tpu_torch.core.device import DeviceLike, check_on, resolve_device
from mlp_ppo_2ply_multi_tpu_torch.core.graphs import (
    cached_graph,
    capture_graph,
    capture_stream,
    params_signature,
    syncs_raise,
)
from mlp_ppo_2ply_multi_tpu_torch.core.tree import copy_into, tmap
from mlp_ppo_2ply_multi_tpu_torch.engine.movegen import MoveSet, board_take, legal_moves
from mlp_ppo_2ply_multi_tpu_torch.env import vec_env
from mlp_ppo_2ply_multi_tpu_torch.twoply import expectimax

_NEG = -1e9

# (params, state, moves, gumbel [B, W]) -> action int64 [B]
Policy = Callable[[dict, vec_env.EnvState, MoveSet, torch.Tensor], torch.Tensor]


def _candidate_values(params, state, moves: MoveSet, cfg: Config) -> torch.Tensor:
    """Afterstate values oriented so HIGHER is better for the mover, under
    the configured td_mode (side0: truthful opponent-on-roll flag, side 1
    minimizes the side-0 value)."""
    return expectimax.oriented_values(params, moves.boards, state.player[..., None], cfg)


def greedy_policy(cfg: Config) -> Policy:
    """argmax over afterstate values: the reference play CLI's agent
    (play_versus_ai.py:165-195)."""

    def act(params, state, moves, noise):
        v = _candidate_values(params, state, moves, cfg)
        return torch.argmax(torch.where(moves.valid, v, _NEG), -1)

    return act


def softmax_policy(cfg: Config, temperature: float) -> Policy:
    def act(params, state, moves, noise):
        v = _candidate_values(params, state, moves, cfg)
        logits = torch.where(moves.valid, v / temperature, _NEG)
        return torch.argmax(logits + noise, -1)

    return act


def twoply_greedy_policy(cfg: Config) -> Policy:
    """argmax over 2-ply expectimax scores of the top-k 1-ply candidates
    (two_ply.py:44-90 semantics; greedy rather than sampled)."""
    k = cfg.twoply.top_k_candidates

    def act(params, state, moves, noise):
        v = _candidate_values(params, state, moves, cfg)
        v_masked = torch.where(moves.valid, v, _NEG)
        topv, topi = expectimax.topk_small(v_masked, k)
        top_valid = torch.gather(moves.valid, -1, topi)
        w_o = expectimax.weighted_opponent_response(
            params, board_take(moves.boards, topi), 1 - state.player, cfg
        )
        scores = torch.where(top_valid, cfg.twoply.alpha * topv - cfg.twoply.beta * w_o, _NEG)
        best = torch.argmax(scores, -1)
        act2 = torch.gather(topi, -1, best[..., None])[..., 0]
        act1 = torch.argmax(v_masked, -1)
        return torch.where(moves.count >= k, act2, act1)

    return act


def random_policy(cfg: Config) -> Policy:
    def act(params, state, moves, noise):
        logits = torch.where(moves.valid, 0.0, _NEG)
        return torch.argmax(logits + noise, -1)

    return act


class MatchResult(NamedTuple):
    winner: torch.Tensor  # int32 [B]: 0 side A, 1 side B, -1 unfinished
    win_type: torch.Tensor  # int8 [B]
    steps: torch.Tensor  # int32 [B]


class MatchNoise(NamedTuple):
    """All randomness of one match step, injectable for parity runs."""

    gumbel_a: torch.Tensor  # f32 [B, W] side A's sampling noise
    gumbel_b: torch.Tensor  # f32 [B, W] side B's sampling noise
    next_dice: torch.Tensor  # int [B, 2] dice adopted by advancing games


def noise_width(cfg: Config) -> int:
    """W, the merged legal-move width max(a_max, nd_dedup_k)."""
    return max(cfg.movegen.a_max, cfg.movegen.nd_dedup_k)


def draw_match_noise(batch: int, cfg: Config, gen: Optional[torch.Generator],
                     dev: torch.device) -> MatchNoise:
    """One step's noise from ``gen``, in the order side A, side B, dice
    (drawn whatever the policies, so the stream does not depend on them)."""
    w = noise_width(cfg)
    return MatchNoise(
        gumbel_a=gumbel((batch, w), gen, dev),
        gumbel_b=gumbel((batch, w), gen, dev),
        next_dice=vec_env.roll_dice(gen, (batch,), dev),
    )


class _Match(NamedTuple):
    """What a match step reads and writes."""

    state: vec_env.EnvState
    winner: torch.Tensor  # int32 [B]


def match_step(params_a, params_b, policy_a: Policy, policy_b: Policy, cfg: Config,
               m: _Match, nz: MatchNoise) -> _Match:
    """One lockstep step of every game: legal moves, both policies, each
    game taking its mover's action, the env step with the next dice, and
    the winner latched at the game's first win."""
    st = m.state
    moves = legal_moves(st.board, st.player, st.dice, cfg.movegen)
    a_act = policy_a(params_a, st, moves, nz.gumbel_a)
    b_act = policy_b(params_b, st, moves, nz.gumbel_b)
    action = torch.where(st.player == 0, a_act, b_act)
    res = vec_env.step(st, moves, action, nz.next_dice, cfg.env)
    winner = torch.where(res.done & (m.winner < 0), st.player, m.winner)
    return _Match(res.state, winner)


def _run_steps(params_a, params_b, policy_a, policy_b, cfg, m: _Match,
               noises: Sequence[MatchNoise]) -> _Match:
    for nz in noises:
        m = match_step(params_a, params_b, policy_a, policy_b, cfg, m, nz)
    return m


class MatchGraph:
    """``chunk`` match steps captured as one CUDA graph. Its static inputs
    are the match state (env state and winners) and one noise per step; the
    captured chunk ends by copying its final match state into those buffers,
    so the match carries over from one replay to the next. Built by running
    the first chunk eagerly on the capture stream (the warm-up, and real
    work: its result is in the buffers), then capturing. ``info`` has the
    capture's seconds and pool bytes."""

    def __init__(self, params_a, params_b, policy_a, policy_b, cfg: Config, chunk: int,
                 m: _Match, noises: Sequence[MatchNoise], dev: torch.device) -> None:
        run = lambda mm, nzs: _run_steps(params_a, params_b, policy_a, policy_b, cfg, mm, nzs)
        stream = capture_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            with syncs_raise():
                m = run(m, noises)
            self.match = tmap(torch.clone, m)
            self.noise = [tmap(torch.clone, nz) for nz in noises]

        def body() -> None:
            copy_into(self.match, run(self.match, self.noise))

        self.graph, self.launches, info = capture_graph(body, dev, f"{chunk} match steps")
        self.info = dict(chunk=chunk, batch=m.winner.shape[0], **info)

    def replay(self, noises: Sequence[MatchNoise]) -> None:
        """One chunk on the current stream from the match state the buffers
        hold; counts the launches it ran."""
        for buf, nz in zip(self.noise, noises):
            copy_into(buf, nz)
        self.graph.replay()
        self.launches.replayed()


def _graph_key(params_a, params_b, policy_a, policy_b, cfg, batch, chunk, dev) -> tuple:
    """A match graph is kept for (cfg, batch, chunk, policies, device, both
    params' storage); the key holds the policy objects, so each stays alive
    while its graph is kept."""
    return ("match", cfg, batch, chunk, policy_a, policy_b, str(dev),
            params_signature(params_a), params_signature(params_b))


@torch.no_grad()
def play_match(
    params_a,
    params_b,
    policy_a: Policy,
    policy_b: Policy,
    gen: Optional[torch.Generator],
    cfg: Config,
    batch: int,
    max_steps: int,
    device: DeviceLike = None,
    chunk: int = 16,
    noise: Optional[Sequence[MatchNoise]] = None,
    start: Optional[vec_env.EnvState] = None,
) -> MatchResult:
    """Play ``batch`` games for ``max_steps`` lockstep steps with side A as
    player 0 and side B as player 1, on ``device`` (default ``cuda``).

    The games start from a reset drawn from ``gen`` (or ``start``); each
    step's noise is then drawn from ``gen`` in step order (or taken from
    ``noise``, ``max_steps`` MatchNoise). Steps run ``c`` at a time, c the
    largest divisor of ``max_steps`` not above ``chunk``: one CUDA graph on
    a card, eager chunks on the CPU."""
    dev = resolve_device(device)
    for name, p in (("params_a", params_a), ("params_b", params_b)):
        check_on(p["w1"], dev, name)
    if max_steps < 1 or chunk < 1:
        raise ValueError(f"max_steps ({max_steps}) and chunk ({chunk}) must be positive")
    if noise is not None and len(noise) != max_steps:
        raise ValueError(f"noise has {len(noise)} steps, max_steps is {max_steps}")
    c = max(d for d in range(1, min(chunk, max_steps) + 1) if max_steps % d == 0)
    if start is None:
        start = vec_env.reset(batch, gen, device=dev)
    check_on(start.board.data, dev, "start")
    m = _Match(start, torch.full((batch,), -1, dtype=torch.int32, device=dev))

    def chunk_noise(i: int) -> List[MatchNoise]:
        if noise is not None:
            return [tmap(lambda t: t.to(dev), nz) for nz in noise[i * c:(i + 1) * c]]
        return [draw_match_noise(batch, cfg, gen, dev) for _ in range(c)]

    n_chunks = max_steps // c
    if dev.type != "cuda":
        for i in range(n_chunks):
            m = _run_steps(params_a, params_b, policy_a, policy_b, cfg, m, chunk_noise(i))
        return MatchResult(m.winner, m.state.win_type, m.state.step_count)

    g, first = cached_graph(
        _graph_key(params_a, params_b, policy_a, policy_b, cfg, batch, c, dev),
        lambda: MatchGraph(params_a, params_b, policy_a, policy_b, cfg, c, m, chunk_noise(0), dev))
    if not first:
        copy_into(g.match, m)
    for i in range(int(first), n_chunks):
        g.replay(chunk_noise(i))
    out = tmap(torch.clone, g.match)
    return MatchResult(out.winner, out.state.win_type, out.state.step_count)


def summarize(result: MatchResult) -> Dict[str, float]:
    w = np.asarray(result.winner.cpu())
    wt = np.asarray(result.win_type.cpu())
    n = len(w)
    finished = (w >= 0).sum()
    return {
        "games": n,
        "finished": int(finished),
        "win_rate_a": float((w == 0).sum() / max(finished, 1)),
        "win_rate_b": float((w == 1).sum() / max(finished, 1)),
        "unfinished": int((w < 0).sum()),
        "gammons": int((wt == 2).sum()),
        "backgammons": int((wt == 3).sum()),
    }
