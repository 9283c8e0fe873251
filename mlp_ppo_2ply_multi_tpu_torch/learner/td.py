"""TD(0) bootstrap-regression learner.

Port of ``mlp_ppo_2ply_multi_tpu/learner/td.py``; the reference semantics,
with their file:line, are in that module's docstring:

* target[t] = r[t] + gamma * V(obs[next recorded step]), detached; the last
  experience of an episode gets its raw reward; pass steps are skipped
  (``_episode_targets``, three ``td_mode``\\ s);
* masked per-episode MSE in f32, clip by global norm, Adam; one fused update
  over the [T, B] stack, or (``per_episode_updates``, quirk Q2) one Adam
  step per episode column in sequence;
* a linear temperature schedule in the update counter (Q12).

The optimizer is written out to optax's formulas (``clip_by_global_norm``
then ``adam``, with the staircase ``exponential_decay`` when ``lr_decay <
1``): the clip has no epsilon, unlike ``torch.nn.utils.clip_grad_norm_``.

Params change in place, through the tensors themselves (``add_`` under
``no_grad``), so ``ops.fused_value.packed_params`` sees each update through
the tensors' ``_version``; the params never require grad, so the actor
builds no graph. Counters are 0-d int64 tensors on the state's device: an
update never waits on the host. ``pack_metrics`` folds one update's metrics
into one float64 vector, one host pull, integer counters exact below 2^53
(the JAX package folds them through float32, exact only below 2^24).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mlp_ppo_2ply_multi_tpu_torch.actor.rollout import Transition
from mlp_ppo_2ply_multi_tpu_torch.core.config import Config
from mlp_ppo_2ply_multi_tpu_torch.core.device import DeviceLike, check_on, resolve_device
from mlp_ppo_2ply_multi_tpu_torch.encoder.features import encode_board
from mlp_ppo_2ply_multi_tpu_torch.engine.board import unpack_board
from mlp_ppo_2ply_multi_tpu_torch.model import value_net
from mlp_ppo_2ply_multi_tpu_torch.model.value_net import Params

# optax.adam's defaults
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


class AdamState(NamedTuple):
    """optax's ScaleByAdamState."""

    count: torch.Tensor  # int64 0-d: Adam steps taken
    mu: Params
    nu: Params


class TrainState(NamedTuple):
    params: Params
    opt_state: AdamState
    version: torch.Tensor  # int64 0-d update counter (== reference version - 1)
    episode_count: torch.Tensor  # int64 0-d total episodes consumed


def map_state(fn, state: TrainState) -> TrainState:
    """``fn`` applied to every tensor of the state."""
    tree = lambda d: {k: fn(v) for k, v in d.items()}
    o = state.opt_state
    return TrainState(
        params=tree(state.params),
        opt_state=AdamState(count=fn(o.count), mu=tree(o.mu), nu=tree(o.nu)),
        version=fn(state.version),
        episode_count=fn(state.episode_count),
    )


def _counter(n: int, device: torch.device) -> torch.Tensor:
    return torch.tensor(int(n), dtype=torch.int64, device=device)


def init_adam(params: Params) -> AdamState:
    return AdamState(
        count=_counter(0, next(iter(params.values())).device),
        mu={k: torch.zeros_like(v) for k, v in params.items()},
        nu={k: torch.zeros_like(v) for k, v in params.items()},
    )


def init_train_state(
    cfg: Config, generator: Optional[torch.Generator] = None, device: DeviceLike = None
) -> TrainState:
    """Fresh params (``value_net.init_params``: JAX's distribution, drawn
    from ``generator``), zero Adam moments and counters, on ``device``
    (default ``cuda``)."""
    dev = resolve_device(device)
    params = value_net.init_params(cfg.model, generator, dev)
    return TrainState(params, init_adam(params), _counter(0, dev), _counter(0, dev))


def train_state_from_jax(jax_state, device: DeviceLike = None) -> TrainState:
    """The JAX package's TrainState, fetched to numpy (``jax.device_get``),
    as the port's: params, the ``ScaleByAdamState`` found in its optax
    state (count, mu, nu), version and episode count."""
    dev = resolve_device(device)

    def adam(x):
        if hasattr(x, "mu") and hasattr(x, "nu"):
            return x
        for y in x if isinstance(x, (tuple, list)) else ():
            found = adam(y)
            if found is not None:
                return found
        return None

    a = adam(jax_state.opt_state)
    if a is None:
        raise ValueError("no Adam state (mu, nu) in the JAX optimizer state")
    to = lambda tree: value_net.params_from_jax(tree, dev)
    return TrainState(
        params=to(jax_state.params),
        opt_state=AdamState(count=_counter(np.asarray(a.count), dev), mu=to(a.mu), nu=to(a.nu)),
        version=_counter(np.asarray(jax_state.version), dev),
        episode_count=_counter(np.asarray(jax_state.episode_count), dev),
    )


# ---------------------------------------------------------------------------
# optimizer: optax.chain(clip_by_global_norm, adam(lr or schedule))
# ---------------------------------------------------------------------------


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: the leaves' sums of squares added in the order
    jax.tree.leaves gives a dict (sorted keys)."""
    total = None
    for k in sorted(tree):
        s = torch.sum(tree[k] * tree[k])
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(grads: Params, max_norm: float) -> Tuple[Params, torch.Tensor]:
    """optax.clip_by_global_norm: unchanged where the norm is below
    ``max_norm``, else ``g / norm * max_norm``. Returns (grads, norm)."""
    norm = global_norm(grads)
    keep = norm < max_norm
    return {k: torch.where(keep, g, (g / norm) * max_norm) for k, g in grads.items()}, norm


def learning_rate(count: torch.Tensor, cfg: Config) -> torch.Tensor:
    """The step's learning rate at Adam count ``count`` (before the step):
    ``lr * decay ** floor(count / steps)`` (optax.exponential_decay,
    staircase) when ``lr_decay < 1``, else ``lr``."""
    t = cfg.train
    lr = torch.tensor(t.learning_rate, dtype=torch.float32, device=count.device)
    if t.lr_decay >= 1.0 or t.lr_decay == 0 or t.lr_decay_steps <= 0:
        return lr  # optax's constant cases
    p = torch.floor(count.to(torch.float32) / t.lr_decay_steps)
    return torch.where(count <= 0, lr, t.learning_rate * torch.pow(t.lr_decay, p))


def apply_gradients(
    params: Params, grads: Params, opt: AdamState, cfg: Config
) -> Tuple[AdamState, torch.Tensor]:
    """One optimizer step: clip, Adam moments, bias correction at count + 1,
    ``mu_hat / (sqrt(nu_hat) + eps)`` scaled by ``-lr``, added to ``params``
    in place. Returns (new Adam state, the pre-clip global norm)."""
    with torch.no_grad():
        grads, norm = clip_by_global_norm(grads, cfg.train.grad_clip)
        count = opt.count + 1
        c = count.to(torch.float32)
        bc1 = 1 - ADAM_B1**c
        bc2 = 1 - ADAM_B2**c
        step = -learning_rate(opt.count, cfg)
        mu, nu = {}, {}
        for k, g in grads.items():
            mu[k] = (1 - ADAM_B1) * g + ADAM_B1 * opt.mu[k]
            nu[k] = (1 - ADAM_B2) * (g * g) + ADAM_B2 * opt.nu[k]
            params[k].add_(step * ((mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + ADAM_EPS)))
    return AdamState(count=count, mu=mu, nu=nu), norm


# ---------------------------------------------------------------------------
# targets, loss, update
# ---------------------------------------------------------------------------


def temperature(version, cfg: Config) -> torch.Tensor:
    """Linear schedule 1.5 -> 0.5 over 4000 updates (Q12)."""
    t = cfg.train
    v = torch.as_tensor(version).to(torch.float32)
    frac = torch.clamp(v / t.temperature_decay_updates, 0.0, 1.0)
    return t.initial_temperature - (t.initial_temperature - t.final_temperature) * frac


class _Plan(NamedTuple):
    """What the JAX reverse scan carries, apart from the values: per step,
    the signed reward, the index of the next recorded step, whether the
    target bootstraps from it, and the factor it is taken with."""

    reward: torch.Tensor
    nxt: torch.Tensor  # int64, clamped in range
    has: torch.Tensor  # bool
    coef: torch.Tensor  # f32: gamma, or +-gamma in negamax

    def column(self, b: int) -> "_Plan":
        return _Plan(*(x[:, b] for x in self))


def _plan(reward, recorded, boundary, gamma, td_mode="reference", player=None) -> _Plan:
    """The reverse scan of the JAX ``_episode_targets`` without v, over the
    time axis (axis 0): step t bootstraps from the first recorded step j > t
    when there is one and no episode boundary lies in [t, j)."""
    T = reward.shape[0]
    if player is None:
        player = torch.zeros_like(recorded, dtype=torch.int32)
    t = torch.arange(T, device=reward.device).view((T,) + (1,) * (reward.dim() - 1))

    def first_from(mask):  # first index >= t where mask holds, T where none
        idx = torch.where(mask, t, T)
        return torch.flip(torch.cummin(torch.flip(idx, [0]), 0).values, [0])

    rec = first_from(recorded)
    nxt = torch.cat([rec[1:], torch.full_like(rec[:1], T)])
    has = (nxt < T) & (first_from(boundary) >= nxt)
    nxt = nxt.clamp_max(T - 1)
    if td_mode == "side0":
        reward = torch.where(player == 0, reward, -reward)
    if td_mode == "negamax":
        same = player == torch.gather(player, 0, nxt)
        coef = torch.where(same, 1.0, -1.0) * gamma
    else:
        coef = torch.full_like(reward, gamma)
    return _Plan(reward, nxt, has, coef)


def _targets(v: torch.Tensor, plan: _Plan) -> torch.Tensor:
    boot = plan.coef * torch.gather(v, 0, plan.nxt)
    return plan.reward + torch.where(plan.has, boot, 0.0)


def _episode_targets(v, reward, recorded, boundary, gamma, td_mode="reference", player=None):
    """Per-column TD targets over the time axis (axis 0); the JAX function's
    contract (td_mode "reference", "negamax", "side0"; the carry resets at
    episode boundaries, Q9)."""
    return _targets(v, _plan(reward, recorded, boundary, gamma, td_mode, player))


def _loss(params, obs, recorded, plan: _Plan, cfg: Config):
    """Masked per-episode-mean MSE over [T, ...] data; always f32."""
    v = value_net.forward(params, obs, dataclasses.replace(cfg.model, dtype="float32"))
    targets = _targets(v.detach(), plan)
    m = recorded.to(torch.float32)
    n = torch.clamp(m.sum(0), min=1.0)
    err = (v - targets) * m
    loss = ((err * err).sum(0) / n).mean()
    aux = {
        "td_abs": (err.abs().sum(0) / n).mean().detach(),
        "v_mean": ((v * m).sum() / torch.clamp(m.sum(), min=1.0)).detach(),
    }
    return loss, aux


def episode_loss_and_metrics(params, obs, reward, recorded, boundary, cfg: Config, player=None):
    """(loss, {td_abs, v_mean}) as the JAX function computes them."""
    plan = _plan(reward, recorded, boundary, cfg.train.gamma, cfg.train.td_mode, player)
    return _loss(params, obs, recorded, plan, cfg)


def _grads(params: Params, obs, recorded, plan: _Plan, cfg: Config):
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    with torch.enable_grad():
        loss, aux = _loss(leaves, obs, recorded, plan, cfg)
        keys = sorted(leaves)
        gs = torch.autograd.grad(loss, [leaves[k] for k in keys])
    return loss.detach(), aux, dict(zip(keys, gs))


def encode_traj(traj: Transition, cfg: Config) -> torch.Tensor:
    return encode_board(unpack_board(traj.packed_board), traj.player)


def update(
    state: TrainState, traj: Transition, cfg: Config, device: DeviceLike = None
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One training batch over a [T, B] trajectory stack (each column one
    episode in sync mode). ``state`` and ``traj`` must lie on ``device``
    (default ``cuda``). ``state.params`` change in place; returns (new
    state, metrics as 0-d device tensors)."""
    dev = resolve_device(device)
    check_on(state.params["w1"], dev, "state")
    check_on(traj.reward, dev, "trajectory")
    obs = encode_traj(traj, cfg)  # [T, B, 198]
    plan = _plan(
        traj.reward, traj.recorded, traj.boundary, cfg.train.gamma, cfg.train.td_mode,
        traj.player,
    )
    params, opt = state.params, state.opt_state
    n_eps = traj.reward.shape[1]
    if cfg.train.per_episode_updates:
        # Q2 parity: one Adam step per episode column, in order
        rows = []
        for b in range(n_eps):
            loss, aux, grads = _grads(params, obs[:, b], traj.recorded[:, b], plan.column(b), cfg)
            opt, gnorm = apply_gradients(params, grads, opt, cfg)
            rows.append(torch.stack([loss, gnorm, aux["td_abs"], aux["v_mean"]]))
        means = torch.stack(rows).mean(0)
        metrics = dict(zip(("loss", "grad_norm", "td_abs", "v_mean"), means))
    else:
        loss, aux, grads = _grads(params, obs, traj.recorded, plan, cfg)
        opt, gnorm = apply_gradients(params, grads, opt, cfg)
        metrics = {"loss": loss, "grad_norm": gnorm, **aux}
    metrics.update(
        reward_per_episode=traj.reward.sum() / n_eps,
        episode_length=traj.recorded.to(torch.float32).sum() / n_eps,
        wins_regular=(traj.win_type == 1).sum(),
        wins_gammon=(traj.win_type == 2).sum(),
        wins_backgammon=(traj.win_type == 3).sum(),
        # Q4: true counts (the reference multiplies them by episode length)
        close_out_count=traj.close_out.sum(),
        prime_count=traj.prime.sum(),
        # decisions whose presented move set was width-truncated (Q7)
        width_overflow_count=traj.overflow.sum(),
    )
    new_state = TrainState(
        params=params,
        opt_state=opt,
        version=state.version + 1,
        episode_count=state.episode_count + n_eps,
    )
    return new_state, metrics


def pack_metrics(metrics: Dict[str, torch.Tensor]) -> Tuple[Tuple[str, ...], torch.Tensor]:
    """A dict of device metrics as ONE float64 vector (each leaf's mean),
    names in sorted order: one host pull an update, integer counters exact
    below 2^53. Unpack with ``dict(zip(names, vec.tolist()))``."""
    names = tuple(sorted(metrics))
    vec = torch.stack([torch.as_tensor(metrics[n]).to(torch.float64).mean() for n in names])
    return names, vec
