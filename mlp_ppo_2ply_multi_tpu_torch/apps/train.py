"""Training CLI: on-device self-play and TD(0) updates, on one card or a
{data, model} mesh of ranks.

Port of ``mlp_ppo_2ply_multi_tpu/apps/train.py``. Two rollout modes
(TrainConfig.rollout_mode):

  * ``sync`` — reference episode semantics: reset B games, play them to
    completion (or the 300-step cap, Q9), then update. With
    --per-episode-updates one Adam step per episode (Q2).
  * ``continuous`` — finished games auto-reset, so every lockstep step does
    useful work; a fused update every --steps-per-update steps. With
    --data/--model above 1 (or --fused-rollout at 1 x 1) it runs the mesh
    train step of ``parallel.sharding`` (``train_continuous``).

The rollouts are the JAX CLI's: ``actor.rollout_chunked`` in continuous
mode (chunk 4 where 4 divides --steps-per-update, else 1) and
``actor.rollout`` in sync mode. On a card each is a captured CUDA graph of
the step: the first update captures it, and every later update replays it.

Randomness comes from one ``torch.Generator`` on the device, seeded with
--seed: params, resets and every rollout step draw from it, and checkpoints
keep its state. Each update makes one host pull: its metrics, the episode
counters and the temperature packed into one vector (``td.pack_metrics``).

Mesh runs: one process per rank, started by torchrun; the process group
is NCCL on cards and gloo with --device cpu. --data defaults to the world
size / --model. Each data index draws its rollout noise from its own
generator, seeded from (--seed, data index, the start version); the ranks
of one model group share it. Rank 0 alone writes metrics and checkpoints,
after gathering the model shards under tp. --fused-rollout at 1 x 1 runs
the mesh step on a one-rank group. --remote-dir mirrors runs/ and
checkpoints/ through fsspec. --tiered trains through the tiered two-plane
pipeline (``experimental.tiered``, a rejected experiment kept default-off):
nd_tier 96 and dd_tier (48, 96, 96) unless set, and the fused actor kernel
with a tier of 96, even without --production; --two-ply turns it off.

Exit status 2, with the reason: --model above 1 with the fused actor kernel (--production: the kernel
scores the full hidden layer, ROADMAP §C); a world size other than
--data x --model; --remote-dir where fsspec does not import.

Usage:
    python -m mlp_ppo_2ply_multi_tpu_torch.apps.train --production \\
        --mode continuous --batch-games 4096 --updates 1000 [--device cpu]
    torchrun --nproc-per-node 2 -m mlp_ppo_2ply_multi_tpu_torch.apps.train \\
        --device cpu --data 2 --small-movegen --batch-games 16 --updates 3
"""
from __future__ import annotations

import argparse
import dataclasses
import signal
import sys
import time

import torch

from mlp_ppo_2ply_multi_tpu_torch.actor import rollout as actor
from mlp_ppo_2ply_multi_tpu_torch.core.config import (
    Config,
    ModelConfig,
    MoveGenConfig,
    TrainConfig,
    TwoPlyConfig,
)
from mlp_ppo_2ply_multi_tpu_torch.core.device import resolve_device
from mlp_ppo_2ply_multi_tpu_torch.env import vec_env
from mlp_ppo_2ply_multi_tpu_torch.io import checkpoint as ckpt
from mlp_ppo_2ply_multi_tpu_torch.io import remote
from mlp_ppo_2ply_multi_tpu_torch.io.metrics import MetricsWriter, Throughput
from mlp_ppo_2ply_multi_tpu_torch.learner import td
from mlp_ppo_2ply_multi_tpu_torch.parallel import distributed, sharding
from mlp_ppo_2ply_multi_tpu_torch.utils.profiling import device_memory_stats

_STOP = False


def _request_stop(signum, frame):
    """SIGTERM/SIGINT: finish the current update, then save and exit — the
    checkpoint-restart fault-tolerance model (SURVEY.md §5.3; the reference
    terminates workers without saving, main.py:156-157)."""
    global _STOP
    _STOP = True
    print(f"signal {signum}: will checkpoint and exit after this update", flush=True)


def build_config(args) -> Config:
    """The run's Config from the CLI flags, as the JAX package builds it."""
    train = TrainConfig(
        batch_games=args.batch_games,
        per_episode_updates=args.per_episode_updates,
        td_mode=args.td_mode,
        rollout_mode=args.mode,
        seed=args.seed,
        checkpoint_every_episodes=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir,
        metrics_dir=args.metrics_dir,
    )
    cfg = Config(train=train)
    if args.small_movegen:
        cfg = cfg.replace(movegen=MoveGenConfig(w1=16, w2=32, w3=48, w4=64, a_max=64))
    if args.production:
        # fast movegen widths + the bf16 fused actor forward; the learner
        # stays f32. --full-widths keeps the parity widths under the
        # production model config (the fast-vs-full control arm).
        cfg = cfg.replace(
            movegen=MoveGenConfig() if args.full_widths else MoveGenConfig.fast(),
            model=ModelConfig(dtype="bfloat16", fused_actor_kernel=True, actor_tier_width=96),
        )
    if args.tiered:
        # the two-plane tiered pipeline needs the fused actor kernel, so it
        # is enabled here even without --production
        cfg = cfg.replace(
            movegen=dataclasses.replace(
                cfg.movegen, tiered=True, nd_tier=cfg.movegen.nd_tier or 96,
                dd_tier=cfg.movegen.dd_tier or (48, 96, 96),
            ),
            model=dataclasses.replace(
                cfg.model, fused_actor_kernel=True,
                actor_tier_width=cfg.model.actor_tier_width or 96,
            ),
        )
    if args.max_timesteps is not None:
        cfg = cfg.replace(env=dataclasses.replace(cfg.env, max_timesteps=args.max_timesteps))
    if args.two_ply:
        # 2-ply self-play: the tuned scorer with --production, else exact
        tw = TwoPlyConfig.tuned() if args.production else TwoPlyConfig(enabled=True)
        cfg = cfg.replace(twoply=tw, movegen=dataclasses.replace(cfg.movegen, tiered=False))
    return cfg


def _record(u, state, gen, metrics, temp, env_steps, cfg, args, writer, tput, last_saved,
            dev, memory, full_state=None):
    """Write one update's metrics (one host pull), histograms and, when due,
    a checkpoint; returns the episode count of the last checkpoint.

    ``env_steps`` None: the mesh step's metrics, which carry JAX's
    ``episodes_done`` and ``env_steps`` keys (and no temperature). Only a
    rank with a ``writer`` writes; ``full_state(state)`` (every rank calls
    it, a collective under tp) gives what histograms and checkpoints hold."""
    metrics["episode_count"] = state.episode_count
    if temp is not None:
        metrics["temperature"] = temp
    names, vec = td.pack_metrics(metrics)
    vals = dict(zip(names, vec.tolist()))
    ec = int(vals.pop("episode_count"))
    if env_steps is None:
        eps, env_steps = int(vals["episodes_done"]), int(vals["env_steps"])
    else:
        eps = int(vals.pop("episodes_done", cfg.train.batch_games))
    tput.add(episodes=eps, env_steps=env_steps)
    logged = u % max(1, args.log_every) == 0
    hist = bool(args.histograms_every) and u % args.histograms_every == 0
    save = ec - last_saved >= cfg.train.checkpoint_every_episodes
    full = full_state(state) if full_state is not None and (hist or save) else state
    if save:
        last_saved = ec
    if writer is None:
        return last_saved
    mem = device_memory_stats(dev) if memory and logged else {}
    writer.scalars(ec, {**vals, **tput.rates(), **mem})
    if hist:
        writer.param_histograms(ec, full.params)
    if save:
        ckpt.save(cfg.train.checkpoint_dir, full, gen)
    if logged:
        r = tput.rates()
        print(f"update {u} episodes {ec} loss {vals['loss']:.5f} "
              f"eps/s {r['eps_per_sec']:.1f} env-steps/s {r['env_steps_per_sec']:.0f}",
              flush=True)
    return last_saved


def start(cfg, dev):
    """(generator seeded with the run's seed, a fresh TrainState drawn from it)."""
    gen = torch.Generator(device=dev).manual_seed(cfg.train.seed)
    return gen, td.init_train_state(cfg, gen, dev)


def _resume(cfg, gen, dev):
    state, gen_state, step0 = ckpt.restore(cfg.train.checkpoint_dir, dev)
    gen.set_state(gen_state)
    print(f"resumed from step {step0}")
    return state


def sync_update(state, gen: torch.Generator, cfg: Config, dev: torch.device):
    """One episode-synchronous update: ``batch_games`` fresh games played to
    their end or the step cap by ``actor.rollout``, then ``td.update`` at
    the temperature of the state's version. Returns (state, metrics,
    temperature)."""
    B, T = cfg.train.batch_games, cfg.env.max_timesteps
    env_state = vec_env.reset(B, gen, dev)
    temp = td.temperature(state.version, cfg)
    _, traj = actor.rollout(
        state.params, env_state, temp, cfg, T, continuous=False, gen=gen, device=dev
    )
    state, metrics = td.update(state, traj, cfg, dev)
    return state, metrics, temp


def train_sync(cfg: Config, args, writer: MetricsWriter, dev: torch.device):
    """Episode-synchronous training (reference semantics)."""
    gen, state = start(cfg, dev)
    if args.resume:
        state = _resume(cfg, gen, dev)
    tput = Throughput()
    last_saved = int(state.episode_count)
    B, T = cfg.train.batch_games, cfg.env.max_timesteps
    for u in range(args.updates):
        if _STOP:
            break
        state, metrics, temp = sync_update(state, gen, cfg, dev)
        last_saved = _record(u, state, gen, metrics, temp, B * T, cfg, args, writer, tput,
                             last_saved, dev, memory=False)
    return state, gen


def train_continuous_single(cfg: Config, args, writer: MetricsWriter, dev: torch.device):
    """Continuous training on one card: ``actor.rollout_chunked`` of
    --steps-per-update steps (chunk 4 where 4 divides them, else 1, as the
    JAX CLI chunks), then the fused TD(0) update. A resume restores the
    learner and the generator and re-creates the games, as the JAX package
    does, so only a sync-mode resume repeats an uninterrupted run."""
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, per_episode_updates=False))
    gen, state = start(cfg, dev)
    env_state = vec_env.reset(cfg.train.batch_games, gen, dev)
    if args.resume:
        state = _resume(cfg, gen, dev)
    tput = Throughput()
    last_saved = int(state.episode_count)
    chunk = 4 if args.steps_per_update % 4 == 0 else 1
    for u in range(args.updates):
        if _STOP:
            break
        temp = td.temperature(state.version, cfg)
        env_state, traj = actor.rollout_chunked(
            state.params, env_state, temp, cfg, args.steps_per_update, chunk=chunk,
            continuous=True, gen=gen, device=dev,
        )
        state, metrics = td.update(state, traj, cfg, dev)
        metrics["episodes_done"] = traj.boundary.sum()
        del traj  # the next rollout's memory
        last_saved = _record(u, state, gen, metrics, temp,
                             cfg.train.batch_games * args.steps_per_update, cfg, args,
                             writer, tput, last_saved, dev, memory=True)
    return state, gen


def train_continuous(cfg: Config, args, writer: MetricsWriter, dev: torch.device):
    """Continuous training over a {data, model} mesh of every rank (JAX
    ``train_continuous``); at 1 x 1 without --fused-rollout, the single-card
    pipeline. Every rank makes the same start (params and the global batch
    from --seed), keeps its shard (``shard_train_state``,
    ``shard_env_state``) and runs ``sharding.make_train_step``. A resume
    restores the full state and shards it; the games are re-created. The
    checkpoint keeps rank 0's rollout generator, and a resumed rank seeds
    its own from the restored version. Returns (full state, generator)."""
    if args.data == 1 and args.model == 1 and not args.fused_rollout:
        return train_continuous_single(cfg, args, writer, dev)
    tp = args.model > 1
    mesh = distributed.global_mesh(args.model)
    gen0, state = start(cfg, dev)
    env_state = vec_env.reset(cfg.train.batch_games, gen0, dev)
    if args.resume:
        state = _resume(cfg, gen0, dev)
    state = sharding.shard_train_state(state, mesh, tp)
    env_state = sharding.shard_env_state(env_state, mesh)
    gen = sharding.data_generator(mesh, cfg.train.seed, dev, start=int(state.version))
    step = sharding.make_train_step(mesh, cfg, args.steps_per_update, tp=tp)
    full = lambda s: sharding.gather_train_state(s, mesh, tp) if tp else s
    tput = Throughput()
    last_saved = int(state.episode_count)
    for u in range(args.updates):
        if _STOP:
            break
        state, env_state, metrics = step(state, env_state, gen)
        last_saved = _record(u, state, gen, metrics, None, None, cfg, args, writer, tput,
                             last_saved, dev, memory=True, full_state=full)
    return full(state), gen


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mode", choices=("sync", "continuous"), default="continuous")
    ap.add_argument("--batch-games", type=int, default=256)
    ap.add_argument("--updates", type=int, default=100)
    ap.add_argument("--steps-per-update", type=int, default=64)
    ap.add_argument("--per-episode-updates", action="store_true",
                    help="Q2 parity: sequential Adam step per episode (sync mode)")
    ap.add_argument("--td-mode", choices=("reference", "negamax", "side0"),
                    default="reference",
                    help="TD semantics (RESULTS.md): reference = Q3 parity; "
                         "side0 = TD-Gammon fix (side-0 value, side 1 "
                         "minimizes); negamax kept as a negative result")
    ap.add_argument("--data", type=int, default=None,
                    help="data-axis mesh size (default: world size / --model)")
    ap.add_argument("--model", type=int, default=1,
                    help="model-axis mesh size: tensor parallelism of the hidden "
                         "layer (not with --production)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--checkpoint-dir", default="checkpoints")
    ap.add_argument("--checkpoint-every", type=int, default=50_000)
    ap.add_argument("--metrics-dir", default="runs")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--histograms-every", type=int, default=None,
                    help="write weight/bias histograms every N updates; 0 "
                         "disables. Default: 1 in sync mode (the reference "
                         "writes per update, trainer.py:222-226), 10 in "
                         "continuous mode")
    ap.add_argument("--small-movegen", action="store_true",
                    help="reduced enumeration widths (CPU smoke)")
    ap.add_argument("--production", action="store_true",
                    help="fast movegen widths + bf16 fused actor forward "
                         "(the fused_value kernel on a card; learner stays f32)")
    ap.add_argument("--tiered", action="store_true",
                    help="the tiered two-plane movegen pipeline (a rejected experiment; "
                         "enables the fused actor kernel)")
    ap.add_argument("--full-widths", action="store_true",
                    help="with --production: keep the full parity movegen "
                         "widths (fast-vs-full quality control arm)")
    ap.add_argument("--fused-rollout", action="store_true",
                    help="continuous mode at 1 x 1: the mesh train step on a "
                         "one-rank process group instead of the single-card "
                         "pipeline")
    ap.add_argument("--two-ply", action="store_true",
                    help="self-play with the 2-ply expectimax rerank policy")
    ap.add_argument("--remote-dir", default=None,
                    help="fsspec URI (gs://..., memory://...) mirrored with "
                         "metrics and checkpoints; needs fsspec")
    ap.add_argument("--max-timesteps", type=int, default=None,
                    help="override episode step cap (default 300, Q9)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to train; cuda without a card is an error")
    return ap


def _refused(args, cfg: Config, world: int):
    """Why this run is refused (exit status 2), or None."""
    if args.model > 1 and cfg.model.fused_actor_kernel:
        return ("--model above 1 with the fused actor kernel (--production) is refused: "
                "the kernel scores the full hidden layer (ROADMAP §C)")
    if args.data * args.model != world:
        return (f"--data {args.data} x --model {args.model} needs {args.data * args.model} "
                f"ranks; the world has {world} (start ranks with torchrun)")
    if args.remote_dir and not remote.available():
        return "--remote-dir needs fsspec, which does not import here"
    return None


def main(argv=None) -> int:
    global _STOP
    ap = _parser()
    args = ap.parse_args(argv)
    world = distributed.world_size()
    if args.data is None:
        args.data = max(1, world // args.model)
    if args.two_ply and args.mode == "continuous":
        args.fused_rollout = False  # as JAX: the 2-ply step's path is the chunked loop
    if args.histograms_every is None:
        args.histograms_every = 1 if args.mode == "sync" else 10
    cfg = build_config(args)
    refused = _refused(args, cfg, world)
    if refused:
        ap.error(refused)
    dev = distributed.local_device(resolve_device(args.device))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh_run = args.mode == "continuous" and (world > 1 or args.fused_rollout)
    made_group = distributed.init(device=dev, world_size=world) if mesh_run else False
    _STOP = False
    previous = {s: signal.signal(s, _request_stop) for s in (signal.SIGTERM, signal.SIGINT)}
    coordinator = distributed.is_coordinator()
    rem = args.remote_dir.rstrip("/") if args.remote_dir else None
    writer = None
    t0 = time.time()
    try:
        if coordinator:
            writer = MetricsWriter(cfg.train.metrics_dir,
                                   remote_uri=f"{rem}/runs" if rem else None)
        train = train_sync if args.mode == "sync" else train_continuous
        state, gen = train(cfg, args, writer, dev)
        if coordinator:
            ckpt.save(cfg.train.checkpoint_dir, state, gen)
    finally:
        if writer is not None:
            writer.close()
        for s, h in previous.items():
            signal.signal(s, h)
        if made_group:
            distributed.shutdown()
    if coordinator and rem:
        remote.sync_dir(cfg.train.checkpoint_dir, f"{rem}/checkpoints")
    print(f"done: {int(state.episode_count)} episodes, "
          f"{int(state.version)} updates in {time.time() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
