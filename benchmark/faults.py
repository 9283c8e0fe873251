"""Faults planted in the program under test, to show that ``correct`` comes
out false when the timed path is broken underneath. Used by the
benchmark's tests and by ``control.py``; never by a benchmark run.

* ``stuck``: the learner's update returns the training state unchanged
  (its metrics are those of a real update on a copy);
* ``half``: the learner takes its loss over half of the batch's games and
  the mean over those alone;
* ``alter``: every eighth game's chosen afterstate is replaced, where the
  step produces it, by its neighbour game's;
* ``hot``: the actor samples at a third of the scheduled temperature
  (the final temperature in place of the initial one);
* ``noise_row``: each game draws with its neighbour game's Gumbel noise.

A cell on one card has no exchange between chips to leave out.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch

FAULTS = ("stuck", "half", "alter", "hot", "noise_row")


@contextlib.contextmanager
def planted(name: str) -> Iterator[None]:
    """The program with fault ``name`` for the duration; its captured graphs
    are dropped on entry and exit, so no graph outlives the fault."""
    from mlp_ppo_2ply_multi_tpu_torch.actor import rollout as actor
    from mlp_ppo_2ply_multi_tpu_torch.core.graphs import clear_graphs
    from mlp_ppo_2ply_multi_tpu_torch.core.tree import tmap
    from mlp_ppo_2ply_multi_tpu_torch.engine.board import Board
    from mlp_ppo_2ply_multi_tpu_torch.env import vec_env
    from mlp_ppo_2ply_multi_tpu_torch.learner import td
    from mlp_ppo_2ply_multi_tpu_torch.twoply import expectimax

    if name not in FAULTS:
        raise ValueError(f"no fault {name!r}; one of {FAULTS}")
    orig = (td.update, vec_env.step_chosen, actor._temperature, actor.sample,
            expectimax.sampled_logits_2ply)
    orig_update, orig_step, orig_temp, orig_sample, orig_s2 = orig

    def stuck(state, traj, cfg, device=None):
        copy = td.map_state(torch.clone, state)
        new, metrics = orig_update(copy, traj, cfg, device)
        return state._replace(version=new.version, episode_count=new.episode_count), metrics

    def half(state, traj, cfg, device=None):
        b = traj.reward.shape[1] // 2
        return orig_update(state, tmap(lambda x: x[:, :b], traj), cfg, device)

    def alter(state, count, chosen, next_dice, cfg):
        d = chosen.data
        games = torch.arange(d.shape[0], device=d.device)
        hit = (games % 8 == 3)[:, None]
        return orig_step(state, count, Board(data=torch.where(hit, d.roll(1, 0), d)), next_dice,
                         cfg)

    def hot(temperature, dev):
        return orig_temp(temperature, dev) / 3

    def noise_row(values, valid, sgn, g, t):
        return orig_sample(values, valid, sgn, g.roll(1, 0), t)

    def noise_row_2ply(params, state, moves, g2, g1, t, cfg):
        return orig_s2(params, state, moves, g2.roll(1, 0), g1.roll(1, 0), t, cfg)

    clear_graphs()
    if name == "stuck":
        td.update = stuck
    elif name == "half":
        td.update = half
    elif name == "alter":
        vec_env.step_chosen = alter
    elif name == "hot":
        actor._temperature = hot
    else:
        actor.sample, expectimax.sampled_logits_2ply = noise_row, noise_row_2ply
    try:
        yield
    finally:
        (td.update, vec_env.step_chosen, actor._temperature, actor.sample,
         expectimax.sampled_logits_2ply) = orig
        clear_graphs()
