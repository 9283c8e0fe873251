"""{data, model} parallelism: the train step over a mesh of ranks.

Port of ``mlp_ppo_2ply_multi_tpu/parallel/sharding.py`` on
``torch.distributed``. The reference scales with 7 OS processes and a
parameter server (main.py:86-91, parameter_manager.py) and no collectives
(SURVEY.md §2.2). Here every rank runs one process of the same program:

  * **data axis**: the game batch is split; every rank plays its B / data
    games, computes its gradients, and one all-reduce over the axis
    averages them (JAX: ``pmean``);
  * **model axis**: tensor parallelism of the hidden layer. ``w1``/``b1``
    hold a column shard and ``w2`` a row shard, and the head's partial sum
    is all-reduced over the axis (``value_net.forward`` with
    ``cfg.model.model_axis`` set, through ``psum`` here). For the 198 ->
    128 -> 1 net the axis only proves the path; it defaults to 1.

The mesh is a ``DeviceMesh`` with dims ("data", "model") over the default
group (``make_mesh``); its per-axis groups carry the collectives, and
``axis_group`` finds them by the axis name the config carries. Weights are
replicated (or sharded) on every rank, "publish" is the updated params
entering the next rollout, staleness is zero.

JAX behaviours copied on purpose (ROADMAP §C):

  * JAX's mesh step runs ``shard_map(check_vma=False)``, where the
    transpose of the forward's ``psum`` is another ``psum``: under tp the
    gradients of w1, b1 and w2 come out model-size times the unsharded
    ones, b2's not. ``psum``'s backward all-reduces the cotangent, so the
    port computes the same gradients.
  * optax's clip inside ``shard_map`` clips each rank by the norm of its
    own shard (b2's replicated gradient included), while the reported
    ``grad_norm`` sums the squares over "model".

JAX's fused actor kernel has no ``psum`` (its ``ops/fused_value.py:151-166``),
so under tp its actor scores moves by a shard's partial value. The port
refuses tp with ``fused_actor_kernel`` instead.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mlp_ppo_2ply_multi_tpu_torch.actor import rollout as actor
from mlp_ppo_2ply_multi_tpu_torch.actor.rollout import Noise, Transition
from mlp_ppo_2ply_multi_tpu_torch.core.config import Config
from mlp_ppo_2ply_multi_tpu_torch.core.tree import tmap
from mlp_ppo_2ply_multi_tpu_torch.env import vec_env
from mlp_ppo_2ply_multi_tpu_torch.learner import td

DATA_AXIS = "data"
MODEL_AXIS = "model"

_MESH = None  # the mesh of the last make_mesh: axis_group's groups


def make_mesh(data: int, model: int = 1):
    """A ``DeviceMesh`` of shape (data, model) over the default process
    group, dims named ("data", "model"); ``data * model`` must be the world
    size. Its device type follows the backend (``cuda`` for NCCL, else
    ``cpu``): gloo ranks may hold CUDA tensors too. Collective: every rank
    calls it. Its axis groups become the ones ``axis_group`` finds."""
    global _MESH
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.distributed.init first")
    world = dist.get_world_size()
    if data * model != world:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} ranks, "
                         f"the world has {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    _MESH = init_device_mesh(device_type, (data, model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    return _MESH


def axis_group(name: str):
    """The process group of axis ``name`` of the current mesh."""
    if _MESH is None:
        raise RuntimeError(f"axis {name!r} used before make_mesh")
    return _MESH.get_group(name)


def axis_size(mesh, name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate along axis ``name`` (JAX ``axis_index``)."""
    return mesh.get_local_rank(name)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


class _Psum(torch.autograd.Function):
    """All-reduce (sum) whose backward all-reduces the cotangent: the
    transpose JAX gives ``psum`` under ``shard_map(check_vma=False)``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def psum(x: torch.Tensor, axis: str) -> torch.Tensor:
    """``jax.lax.psum(x, axis)`` over the current mesh's axis, with JAX's
    gradient (see the module docstring)."""
    return _Psum.apply(x, axis_group(axis))


# ---------------------------------------------------------------------------
# shards
# ---------------------------------------------------------------------------


def param_specs(tp: bool) -> Dict[str, Optional[int]]:
    """The dim of each param split over "model" (None: replicated). With
    tp the hidden axis is split: w1 columns, b1, w2 rows (JAX
    ``param_specs``). Adam's mu and nu follow their param; the counters
    (Adam count, version, episode count) are replicated."""
    if not tp:
        return {"w1": None, "b1": None, "w2": None, "b2": None}
    return {"w1": 1, "b1": 0, "w2": 0, "b2": None}


def _shard(t: torch.Tensor, dim: Optional[int], mesh) -> torch.Tensor:
    if dim is None:
        return t.clone()
    m, mi = axis_size(mesh, MODEL_AXIS), axis_index(mesh, MODEL_AXIS)
    if t.shape[dim] % m:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split {m} ways")
    return t.narrow(dim, mi * (t.shape[dim] // m), t.shape[dim] // m).clone()


def _on_each_param(state: td.TrainState, fn) -> td.TrainState:
    """``fn(tensor, key)`` on params, mu and nu; counters copied."""
    tree = lambda d: {k: fn(v, k) for k, v in d.items()}
    o = state.opt_state
    return td.TrainState(
        params=tree(state.params),
        opt_state=td.AdamState(count=o.count.clone(), mu=tree(o.mu), nu=tree(o.nu)),
        version=state.version.clone(),
        episode_count=state.episode_count.clone(),
    )


def shard_params(params: td.Params, mesh, tp: bool) -> td.Params:
    """This rank's copy of full params: its model shard under tp."""
    specs = param_specs(tp)
    return {k: _shard(v, specs[k], mesh) for k, v in params.items()}


def shard_train_state(state: td.TrainState, mesh, tp: bool) -> td.TrainState:
    """This rank's copy of a full TrainState (the same on every rank): its
    model shard under tp, a copy of everything otherwise. The shard owns
    its storage, so the rollout graph keyed by it is this rank's."""
    specs = param_specs(tp)
    return _on_each_param(state, lambda t, k: _shard(t, specs[k], mesh))


def _gather(t: torch.Tensor, dim: Optional[int], group) -> torch.Tensor:
    if dim is None:
        return t.clone()
    # gloo gathers CPU tensors only
    host = dist.get_backend(group) == "gloo"
    src = t.detach().cpu() if host else t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim).to(t.device)


def gather_train_state(state: td.TrainState, mesh, tp: bool) -> td.TrainState:
    """The full TrainState from every rank's shard (inverse of
    ``shard_train_state``): a copy without tp. Collective over "model"."""
    specs = param_specs(tp)
    group = mesh.get_group(MODEL_AXIS)
    return _on_each_param(state, lambda t, k: _gather(t, specs[k], group))


def _rows(n: int, mesh) -> slice:
    d, di = axis_size(mesh, DATA_AXIS), axis_index(mesh, DATA_AXIS)
    if n % d:
        raise ValueError(f"a batch of {n} games does not split {d} ways")
    return slice(di * (n // d), (di + 1) * (n // d))


def shard_env_state(state: vec_env.EnvState, mesh) -> vec_env.EnvState:
    """This rank's B / data games of a global batch that every rank reset
    from the shared seed, so world N plays world 1's games."""
    rows = _rows(state.player.shape[0], mesh)
    return tmap(lambda t: t[rows].clone(), state)


def shard_traj(traj: Transition, mesh) -> Transition:
    """This rank's game columns of a [T, B] trajectory (JAX's
    ``P(None, "data")``)."""
    cols = _rows(traj.reward.shape[1], mesh)
    return Transition(*(t[:, cols].clone() for t in traj))


def shard_noise(noises: Sequence[Noise], mesh) -> List[Noise]:
    """This rank's rows of step noises drawn for the global batch. Only
    per-game noise splits: the tier-2 noise of the two-tier actor is drawn
    for a sub-batch, so it raises."""
    out = []
    for nz in noises:
        if isinstance(nz, actor.StepNoise) and nz.gumbel_t2.shape[0]:
            raise ValueError("the two-tier actor's sub-batch noise does not split by game")
        rows = _rows(nz.next_dice.shape[0], mesh)
        out.append(type(nz)(*(t if t.shape[0] == 0 else t[rows] for t in nz)))
    return out


def data_generator(mesh, seed: int, device, start: int = 0) -> torch.Generator:
    """The rollout generator of this rank's data index: seeded from (seed,
    data index, start), JAX's ``fold_in(key, axis_index("data"))``. Ranks
    of one model group share it, so they take the same actions."""
    di = axis_index(mesh, DATA_AXIS)
    s = int(np.random.SeedSequence([seed, di, start]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(s)


def _tp_config(cfg: Config, tp: bool) -> Config:
    """The mesh step's config: ``model_axis`` set under tp, and always the
    fused batched update (the per-episode Adam scan of Q2 parity cannot be
    split over ranks; JAX documents the same divergence)."""
    model = dataclasses.replace(cfg.model, model_axis=MODEL_AXIS if tp else None)
    train = dataclasses.replace(cfg.train, per_episode_updates=False)
    return cfg.replace(model=model, train=train)


# ---------------------------------------------------------------------------
# the update and the train step
# ---------------------------------------------------------------------------

# summed over "data": JAX's psum'd metrics, from the trajectory
_COUNTS = ("episodes_done", "wins_regular", "wins_gammon", "wins_backgammon",
           "close_out_count", "prime_count", "reward_sum", "width_overflow_count")


def _counts(traj: Transition) -> torch.Tensor:
    return torch.stack([
        traj.boundary.sum(), (traj.win_type == 1).sum(), (traj.win_type == 2).sum(),
        (traj.win_type == 3).sum(), traj.close_out.sum(), traj.prime.sum(),
        traj.reward.sum(), traj.overflow.sum(),
    ]).to(torch.float64)


def _update(state: td.TrainState, traj: Transition, cfg: Config, mesh, tp: bool
            ) -> Tuple[td.TrainState, Dict[str, torch.Tensor]]:
    """JAX ``local_step``'s update on this rank's trajectory: the gradient
    of ``td.episode_loss_and_metrics``, grads, loss and aux averaged over
    "data" in one all-reduce, the grad norm (its squares summed over
    "model" under tp), clip + Adam in place, and the counts summed over
    "data" in a second all-reduce."""
    data_group = mesh.get_group(DATA_AXIS)
    n_data = axis_size(mesh, DATA_AXIS)
    obs = td.encode_traj(traj, cfg)
    loss, aux, grads = td.loss_and_grads(state.params, obs, traj, cfg)
    keys = sorted(grads)
    flat = torch.cat([grads[k].reshape(-1) for k in keys]
                     + [torch.stack([loss, aux["td_abs"], aux["v_mean"]])])
    flat = _all_reduce(flat, data_group) / n_data
    at = 0
    for k in keys:
        n = grads[k].numel()
        grads[k] = flat[at:at + n].view_as(grads[k])
        at += n
    loss, td_abs, v_mean = flat[at:]
    gnorm = td.global_norm(grads)
    if tp:
        gnorm = torch.sqrt(_all_reduce(gnorm * gnorm, mesh.get_group(MODEL_AXIS)))
    opt, _ = td.apply_gradients(state.params, grads, state.opt_state, cfg)
    counts = dict(zip(_COUNTS, _all_reduce(_counts(traj), data_group)))
    episodes = counts["episodes_done"].to(torch.int64)
    new_state = td.TrainState(
        params=state.params,
        opt_state=opt,
        version=state.version + 1,
        episode_count=state.episode_count + episodes,
    )
    metrics = {"loss": loss, "grad_norm": gnorm, "td_abs": td_abs, "v_mean": v_mean,
               **counts, "episodes_done": episodes}
    return new_state, metrics


def make_train_step(mesh, cfg: Config, num_steps: int, tp: bool = False):
    """The mesh train step:

        step(state, env_state, gen=None, noise=None) -> (state, env_state, metrics)

    ``num_steps`` lockstep steps in continuous mode on this rank's games
    (``actor.rollout`` semantics: chunk 4 where 4 divides num_steps), then
    one fused TD(0) update with the gradients averaged over "data"
    (``_update``). ``state`` is this rank's shard (``shard_train_state``),
    changed in place; ``env_state`` its games (``shard_env_state``). The
    rollout draws each step's noise from ``gen`` (``data_generator``), or
    takes ``noise`` (``num_steps`` local StepNoise or TwoPlyNoise,
    ``shard_noise``). ``metrics`` has JAX's keys (sharding.py:168-187) as
    0-d tensors, the same on every rank.

    Without tp the rollout is ``actor.rollout_chunked``: on a card a
    captured CUDA graph of the step, replayed, and only the update runs
    eagerly. Under tp every forward of the rollout all-reduces over
    "model", and those rollouts run eagerly: the collectives are not
    captured in a graph. tp with ``fused_actor_kernel`` raises (the module
    docstring says why)."""
    if tp and cfg.model.fused_actor_kernel:
        raise ValueError("tensor parallelism with fused_actor_kernel is refused: the fused "
                         "value kernel scores the full hidden layer (ROADMAP §C)")
    lcfg = _tp_config(cfg, tp)
    n_data = axis_size(mesh, DATA_AXIS)
    chunk = 4 if num_steps % 4 == 0 else 1

    def step(state: td.TrainState, env_state: vec_env.EnvState,
             gen: Optional[torch.Generator] = None, noise: Optional[Sequence[Noise]] = None):
        dev = state.params["w1"].device
        temp = td.temperature(state.version, lcfg)
        if tp:
            b = env_state.player.shape[0]
            noises = noise if noise is not None else [
                actor.draw_noise(b, lcfg, gen, dev) for _ in range(num_steps)]
            env_state, traj = actor.run_steps(state.params, env_state, temp, lcfg, True,
                                              [tmap(lambda t: t.to(dev), nz) for nz in noises],
                                              dev)
        else:
            env_state, traj = actor.rollout_chunked(
                state.params, env_state, temp, lcfg, num_steps, chunk=chunk, continuous=True,
                gen=gen, device=dev, noise=noise)
        state, metrics = _update(state, traj, lcfg, mesh, tp)
        b_global = traj.reward.shape[1] * n_data
        metrics["env_steps"] = torch.tensor(num_steps * b_global, dtype=torch.int64, device=dev)
        return state, env_state, metrics

    return step


def make_update_step(mesh, cfg: Config, tp: bool = False):
    """The update alone: ``step(state, traj) -> (state, metrics)`` on this
    rank's game columns of a trajectory (``shard_traj``). The average of
    the ranks' gradients equals the global batch's (equal shards, a
    per-episode-mean loss). ``metrics`` holds ``loss`` (what JAX's
    ``make_update_step`` returns), ``grad_norm``, ``td_abs``, ``v_mean``
    and the counts; the episode count grows by the boundaries, as in JAX."""
    lcfg = _tp_config(cfg, tp)

    def step(state: td.TrainState, traj: Transition):
        return _update(state, traj, lcfg, mesh, tp)

    return step
