"""Training CLI: on-device self-play and TD(0) updates on one card.

Port of ``mlp_ppo_2ply_multi_tpu/apps/train.py``. Two rollout modes
(TrainConfig.rollout_mode):

  * ``sync`` — reference episode semantics: reset B games, play them to
    completion (or the 300-step cap, Q9), then update. With
    --per-episode-updates one Adam step per episode (Q2).
  * ``continuous`` — finished games auto-reset, so every lockstep step does
    useful work; a fused update every --steps-per-update steps.

The rollouts are the JAX CLI's: ``actor.rollout_chunked`` in continuous
mode (chunk 4 where 4 divides --steps-per-update, else 1) and
``actor.rollout`` in sync mode. On a card each is a captured CUDA graph of
the step: the first update captures it, and every later update replays it.

Randomness comes from one ``torch.Generator`` on the device, seeded with
--seed: params, resets and every rollout step draw from it, and checkpoints
keep its state. Each update makes one host pull: its metrics, the episode
counters and the temperature packed into one vector (``td.pack_metrics``).

Flags the port does not serve exit with status 2 and name the ROADMAP item:
--data/--model above 1 and --fused-rollout (A15), --tiered (A16) and
--remote-dir (A15).

Usage:
    python -m mlp_ppo_2ply_multi_tpu_torch.apps.train --production \\
        --mode continuous --batch-games 4096 --updates 1000 [--device cpu]
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
from mlp_ppo_2ply_multi_tpu_torch.io.metrics import (
    MetricsWriter,
    Throughput,
    device_memory_stats,
)
from mlp_ppo_2ply_multi_tpu_torch.learner import td

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
    if args.max_timesteps is not None:
        cfg = cfg.replace(env=dataclasses.replace(cfg.env, max_timesteps=args.max_timesteps))
    if args.two_ply:
        # 2-ply self-play: the tuned scorer with --production, else exact
        tw = TwoPlyConfig.tuned() if args.production else TwoPlyConfig(enabled=True)
        cfg = cfg.replace(twoply=tw, movegen=dataclasses.replace(cfg.movegen, tiered=False))
    return cfg


def _record(u, state, gen, metrics, temp, env_steps, cfg, args, writer, tput, last_saved,
            dev, memory):
    """Write one update's metrics (one host pull), histograms and, when due,
    a checkpoint; returns the episode count of the last checkpoint."""
    metrics["episode_count"] = state.episode_count
    metrics["temperature"] = temp
    names, vec = td.pack_metrics(metrics)
    vals = dict(zip(names, vec.tolist()))
    ec = int(vals.pop("episode_count"))
    eps = int(vals.pop("episodes_done", cfg.train.batch_games))
    tput.add(episodes=eps, env_steps=env_steps)
    logged = u % max(1, args.log_every) == 0
    mem = device_memory_stats(dev) if memory and logged else {}
    writer.scalars(ec, {**vals, **tput.rates(), **mem})
    if args.histograms_every and u % args.histograms_every == 0:
        writer.param_histograms(ec, state.params)
    if ec - last_saved >= cfg.train.checkpoint_every_episodes:
        ckpt.save(cfg.train.checkpoint_dir, state, gen)
        last_saved = ec
    if logged:
        r = tput.rates()
        print(f"update {u} episodes {ec} loss {vals['loss']:.5f} "
              f"eps/s {r['eps_per_sec']:.1f} env-steps/s {r['env_steps_per_sec']:.0f}",
              flush=True)
    return last_saved


def _start(cfg, dev):
    gen = torch.Generator(device=dev).manual_seed(cfg.train.seed)
    return gen, td.init_train_state(cfg, gen, dev)


def _resume(cfg, gen, dev):
    state, gen_state, step0 = ckpt.restore(cfg.train.checkpoint_dir, dev)
    gen.set_state(gen_state)
    print(f"resumed from step {step0}")
    return state


def train_sync(cfg: Config, args, writer: MetricsWriter, dev: torch.device):
    """Episode-synchronous training (reference semantics)."""
    gen, state = _start(cfg, dev)
    if args.resume:
        state = _resume(cfg, gen, dev)
    tput = Throughput()
    last_saved = int(state.episode_count)
    B, T = cfg.train.batch_games, cfg.env.max_timesteps
    for u in range(args.updates):
        if _STOP:
            break
        env_state = vec_env.reset(B, gen, dev)
        temp = td.temperature(state.version, cfg)
        _, traj = actor.rollout(
            state.params, env_state, temp, cfg, T, continuous=False, gen=gen, device=dev
        )
        state, metrics = td.update(state, traj, cfg, dev)
        del traj
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
    gen, state = _start(cfg, dev)
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
    ap.add_argument("--data", type=int, default=1, help="not ported above 1 (ROADMAP A15)")
    ap.add_argument("--model", type=int, default=1, help="not ported above 1 (ROADMAP A15)")
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
                    help="the rejected tiered pipeline: not ported (ROADMAP A16)")
    ap.add_argument("--full-widths", action="store_true",
                    help="with --production: keep the full parity movegen "
                         "widths (fast-vs-full quality control arm)")
    ap.add_argument("--fused-rollout", action="store_true",
                    help="the JAX package's fused mesh train step: not ported "
                         "(ROADMAP A15)")
    ap.add_argument("--two-ply", action="store_true",
                    help="self-play with the 2-ply expectimax rerank policy "
                         "(on a card only with --production)")
    ap.add_argument("--remote-dir", default=None,
                    help="fsspec mirror: not ported (ROADMAP A15)")
    ap.add_argument("--max-timesteps", type=int, default=None,
                    help="override episode step cap (default 300, Q9)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to train; cuda without a card is an error")
    return ap


def _unported(args):
    if args.data > 1 or args.model > 1:
        return "--data/--model above 1 are not ported (ROADMAP A15)"
    if args.fused_rollout:
        return "--fused-rollout is not ported (ROADMAP A15)"
    if args.tiered:
        return "--tiered is not ported (ROADMAP A16)"
    if args.remote_dir:
        return "--remote-dir is not ported (ROADMAP A15)"
    return None


def main(argv=None) -> int:
    global _STOP
    ap = _parser()
    args = ap.parse_args(argv)
    refused = _unported(args)
    if refused:
        ap.error(refused)
    dev = resolve_device(args.device)
    if args.histograms_every is None:
        args.histograms_every = 1 if args.mode == "sync" else 10
    cfg = build_config(args)
    _STOP = False
    previous = {s: signal.signal(s, _request_stop) for s in (signal.SIGTERM, signal.SIGINT)}
    writer = MetricsWriter(cfg.train.metrics_dir)
    t0 = time.time()
    try:
        train = train_sync if args.mode == "sync" else train_continuous_single
        state, gen = train(cfg, args, writer, dev)
        ckpt.save(cfg.train.checkpoint_dir, state, gen)
    finally:
        writer.close()
        for s, h in previous.items():
            signal.signal(s, h)
    print(f"done: {int(state.episode_count)} episodes, "
          f"{int(state.version)} updates in {time.time() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
