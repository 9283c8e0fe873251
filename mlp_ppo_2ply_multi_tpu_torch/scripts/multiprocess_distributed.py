"""Run the mesh train step on several ranks and hold it against one rank.

Port of ``scripts/multiprocess_distributed.py`` (JAX: two processes of
``jax.distributed`` against a single-process control). Here the ranks are
processes of a ``torch.distributed`` group, started with the ``spawn``
method (a fork after CUDA is initialised breaks): gloo on the CPU, and gloo
too with ``--device cuda``, where every rank uses card 0 (NCCL refuses two
ranks on one card; gloo stages CUDA tensors through the host).

Checks, each against a one-rank control in its own process:

  * train: ``sharding.make_train_step`` on a (2, 1) mesh for --updates
    updates of --steps steps, the global batch of --batch games from the
    shared seed and one injected noise stream split by game, against the
    control on all the games: both ranks' params identical, the control's
    within rtol 1e-5 / atol 1e-6, every integer field (and the reward) of
    the trajectories bit-equal;
  * tp: one ``make_update_step`` on a (1, 2) mesh (the hidden layer split,
    f32) on a --tp-batch trajectory against the update without tp (loss at
    rtol 1e-5) and against JAX's tp update written out on one rank
    (``jax_tp_update``: the full-batch gradients of w1, b1 and w2 times the
    model size, b2's not, each shard clipped by its own norm): params,
    Adam's mu and nu and the reported grad norm at rtol 1e-5.

Prints one JSON line of results; exit status 1 when a check fails.

Usage:
    python -m mlp_ppo_2ply_multi_tpu_torch.scripts.multiprocess_distributed \\
        [--device cpu] [--widths small|full] [--batch 16] [--tp-batch 16]
        [--steps 8] [--updates 3]

``--widths full`` is ``Config()`` (the widths of the evaluate CLI, f32
values of every slot); ``small`` the reduced widths of the tests. Both
value moves in f32, one row at a time, so splitting the batch changes no
decision; the two-tier actor's noise does not split by game, and a bf16
weight can round the other way after an update's last-bit difference.
``spawn`` and the ``job_*`` functions are also what the tests and
``chip_smoke.py`` run ranks with.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from mlp_ppo_2ply_multi_tpu_torch.actor import rollout as actor
from mlp_ppo_2ply_multi_tpu_torch.core.config import Config, MoveGenConfig, TrainConfig
from mlp_ppo_2ply_multi_tpu_torch.core.graphs import params_signature
from mlp_ppo_2ply_multi_tpu_torch.core.tree import tmap
from mlp_ppo_2ply_multi_tpu_torch.env import vec_env
from mlp_ppo_2ply_multi_tpu_torch.learner import td
from mlp_ppo_2ply_multi_tpu_torch.parallel import distributed, sharding

# the trajectory fields that must be bit-equal between meshes (value is a
# diagnostic float of the observation forward)
EXACT_FIELDS = tuple(f for f in actor.Transition._fields if f != "value")


def small_config(batch: int = 16) -> Config:
    """``tests/test_parallel.py``'s TINY: reduced movegen widths, f32."""
    return Config(
        movegen=MoveGenConfig(w1=16, w2=32, w3=48, w4=64, a_max=64),
        train=TrainConfig(batch_games=batch, per_episode_updates=False),
    )


def full_config(batch: int) -> Config:
    """``Config()``: full widths, f32 values of every slot."""
    return Config(train=TrainConfig(batch_games=batch, per_episode_updates=False))


# ---------------------------------------------------------------------------
# ranks
# ---------------------------------------------------------------------------


def _rank_main(rank: int, world: int, jobs, ports, device: str, out: str) -> None:
    """One rank: torchrun's environment, one torch thread, each job in turn
    (each starts and ends its own process group on its own port); the
    results go to ``out/<rank>.pt``."""
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost")
    results = []
    for (job, payload), port in zip(jobs, ports):
        os.environ["MASTER_PORT"] = str(port)
        results.append(job(payload, torch.device(device)))
    torch.save(results, os.path.join(out, f"{rank}.pt"))


def spawn(world: int, jobs: Sequence[Tuple[Callable, dict]], device: str = "cpu"
          ) -> List[list]:
    """Run ``jobs`` ((function, payload) pairs; each function takes
    (payload, device) and returns what pickles) in order on ``world``
    spawned ranks. Returns each rank's list of results, by rank. A rank that
    raises makes this raise."""
    import torch.multiprocessing as mp

    ports = [distributed.free_port() for _ in jobs]
    with tempfile.TemporaryDirectory(prefix="mpdist_") as out:
        mp.start_processes(_rank_main, args=(world, list(jobs), ports, device, out),
                           nprocs=world, start_method="spawn")
        return [torch.load(os.path.join(out, f"{r}.pt"), weights_only=False)
                for r in range(world)]


def _group(device: torch.device):
    """Start this job's process group: gloo, on ``device``'s tensors."""
    if device.type == "cuda":
        torch.cuda.set_device(distributed.local_device(device))
    distributed.init(backend="gloo", device=device, world_size=int(os.environ["WORLD_SIZE"]))


def _cpu(x):
    """A TrainState or a NamedTuple of tensors copied to the CPU."""
    cpu = lambda t: t.detach().cpu()
    return td.map_state(cpu, x) if isinstance(x, td.TrainState) else tmap(cpu, x)


def _tap(record: list):
    """Swap the rollouts the mesh step calls for recorders of their
    trajectories (the outermost call only: ``rollout_chunked`` runs
    ``run_steps`` on the CPU); returns a function that puts them back."""
    saved = actor.rollout_chunked, actor.run_steps
    depth = [0]

    def keep(fn):
        def run(*args, **kwargs):
            depth[0] += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                depth[0] -= 1
            if depth[0] == 0:
                record.append(out[1])
            return out
        return run

    def untap() -> None:
        actor.rollout_chunked, actor.run_steps = saved

    actor.rollout_chunked, actor.run_steps = keep(saved[0]), keep(saved[1])
    return untap


def _time_all_reduces(record: list, dev: torch.device):
    """Swap ``sharding._all_reduce`` for a timer (the device synchronised
    before and after each call) appending ms to ``record``; returns a
    function that puts it back."""
    real = sharding._all_reduce

    def timed(x, group):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = real(x, group)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        record.append((time.perf_counter() - t0) * 1e3)
        return out

    sharding._all_reduce = timed
    return lambda: setattr(sharding, "_all_reduce", real)


def global_noise(cfg: Config, batch: int, n: int, seed: int, device: torch.device):
    """``n`` steps of noise for the global batch from one seeded generator,
    the same in every process on one kind of device."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return [actor.draw_noise(batch, cfg, gen, device) for _ in range(n)]


def job_train(p: dict, device: torch.device) -> dict:
    """``make_train_step`` on a (p["data"], p["model"]) mesh: every rank
    makes the global start from p["seed"] and keeps its shard, then runs
    p["updates"] steps of p["steps"] rollout steps, with the global noise
    of ``global_noise`` split by game when p["noise"], else each data
    index's generator. Returns the gathered final state, each update's
    metrics and local trajectory fields, the mesh coordinates, whether the
    params kept their storage, the step's ms an update and each update's
    all-reduces (count, ms: synchronised timers around each, which the
    step's ms includes)."""
    _group(device)
    dev = distributed.local_device(device)
    try:
        cfg, batch, steps = p["cfg"], p["batch"], p["steps"]
        tp = p["model"] > 1
        mesh = sharding.make_mesh(p["data"], p["model"])
        gen = torch.Generator(device=dev).manual_seed(p["seed"])
        full = td.init_train_state(cfg, gen, dev)
        env = vec_env.reset(batch, gen, dev)
        state = sharding.shard_train_state(full, mesh, tp)
        env = sharding.shard_env_state(env, mesh)
        step = sharding.make_train_step(mesh, cfg, steps, tp=tp)
        rgen = sharding.data_generator(mesh, p["seed"], dev)
        noises = (global_noise(cfg, batch, steps * p["updates"], p["seed"] + 1, dev)
                  if p["noise"] else None)
        sig = params_signature(state.params)
        trajs, metrics, ms, reduces = [], [], [], []
        untap = _tap(trajs)
        try:
            for u in range(p["updates"]):
                nz = None if noises is None else sharding.shard_noise(
                    noises[u * steps:(u + 1) * steps], mesh)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                ar = []
                untime = _time_all_reduces(ar, dev)
                try:
                    state, env, m = step(state, env, rgen, nz)
                finally:
                    untime()
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                ms.append((time.perf_counter() - t0) * 1e3)
                reduces.append(dict(count=len(ar), ms=sum(ar)))
                metrics.append({k: float(v) for k, v in m.items()})
        finally:
            untap()
        same_storage = params_signature(state.params) == sig
        state = sharding.gather_train_state(state, mesh, tp)
        return dict(
            state=_cpu(state), metrics=metrics, same_storage=same_storage,
            traj=[{f: getattr(t, f).cpu() for f in EXACT_FIELDS} for t in trajs],
            data_index=sharding.axis_index(mesh, sharding.DATA_AXIS),
            model_index=sharding.axis_index(mesh, sharding.MODEL_AXIS),
            ms_per_update=ms, all_reduces=reduces,
        )
    finally:
        distributed.shutdown()


def job_update(p: dict, device: torch.device) -> list:
    """``make_update_step`` on each mesh of p["meshes"] ((data, model)
    pairs whose product is the world size) from the full state p["state"]
    on the trajectory p["traj"] (CPU tensors): each rank updates its shard
    on its game columns. Returns, per mesh, the gathered state and the
    metrics."""
    _group(device)
    dev = distributed.local_device(device)
    try:
        out = []
        for data, model in p["meshes"]:
            tp = model > 1
            mesh = sharding.make_mesh(data, model)
            full = td.map_state(lambda t: t.to(dev), p["state"])
            state = sharding.shard_train_state(full, mesh, tp)
            traj = sharding.shard_traj(tmap(lambda t: t.to(dev), p["traj"]), mesh)
            state, m = sharding.make_update_step(mesh, p["cfg"], tp=tp)(state, traj)
            out.append(dict(state=_cpu(sharding.gather_train_state(state, mesh, tp)),
                            metrics={k: float(v) for k, v in m.items()}))
        return out
    finally:
        distributed.shutdown()


def job_forward(p: dict, device: torch.device) -> dict:
    """The value net on a (1, world) mesh: the tp forward of this rank's
    shard of p["params"] on p["x"], and the full forward."""
    from mlp_ppo_2ply_multi_tpu_torch.model import value_net

    _group(device)
    dev = distributed.local_device(device)
    try:
        mesh = sharding.make_mesh(1, distributed.world_size())
        cfg = p["cfg"]
        params = {k: v.to(dev) for k, v in p["params"].items()}
        shard = sharding.shard_params(params, mesh, True)
        tp_cfg = dataclasses.replace(cfg.model, model_axis=sharding.MODEL_AXIS)
        x = p["x"].to(dev)
        return dict(tp=value_net.forward(shard, x, tp_cfg).cpu(),
                    full=value_net.forward(params, x, cfg.model).cpu())
    finally:
        distributed.shutdown()


def job_cli(p: dict, device: torch.device) -> int:
    """``apps.train.main(p["argv"])`` as torchrun would start it."""
    from mlp_ppo_2ply_multi_tpu_torch.apps import train

    return train.main(list(p["argv"]))


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------


def assert_state_close(got: td.TrainState, want: td.TrainState, what: str,
                       rtol: float = 1e-5) -> Dict[str, float]:
    """Params at ``rtol`` / atol 1e-6 (JAX's DP test), Adam's mu and nu at
    ``rtol`` / atol 1e-6 of each tensor's largest magnitude, counters
    equal. Returns the largest abs errors."""
    err = {}
    for name in ("params", "mu", "nu"):
        a = got.params if name == "params" else getattr(got.opt_state, name)
        b = want.params if name == "params" else getattr(want.opt_state, name)
        for k in b:
            atol = 1e-6 * (1.0 if name == "params" else float(b[k].abs().max()))
            np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=rtol, atol=atol,
                                       err_msg=f"{what}: {name} {k}")
        err[f"{name}_max_abs"] = max(float((a[k] - b[k]).abs().max()) for k in b)
    for k in ("version", "episode_count"):
        if int(getattr(got, k)) != int(getattr(want, k)):
            raise AssertionError(f"{what}: {k} differs")
    return err


def compare_train(ranks: List[dict], control: dict) -> Dict[str, float]:
    """Ranks of a data mesh against the one-rank control: ranks' params
    identical, the control's at rtol 1e-5 / atol 1e-6, trajectories (the
    ranks' columns side by side) bit-equal. Raises AssertionError."""
    by_data = sorted(ranks, key=lambda r: r["data_index"])
    for k, v in ranks[0]["state"].params.items():
        for r in ranks[1:]:
            if not torch.equal(r["state"].params[k], v):
                raise AssertionError(f"{k}: ranks differ")
    worst = 0.0
    for k, want in control["state"].params.items():
        got = ranks[0]["state"].params[k]
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=f"{k}: mesh vs one rank")
        worst = max(worst, float((got - want).abs().max()))
    for u, want in enumerate(control["traj"]):
        for f in EXACT_FIELDS:
            got = torch.cat([r["traj"][u][f] for r in by_data], 1)
            if not torch.equal(got, want[f]):
                raise AssertionError(f"update {u}: trajectory field {f} differs")
    return {"params_max_abs": worst}


def jax_tp_update(state: td.TrainState, traj, cfg: Config, model: int):
    """What JAX's tp update (a (1, model) mesh) computes, on one rank: the
    full-batch gradients, those of w1, b1 and w2 times ``model`` (the
    transpose of the forward's psum under ``check_vma=False``), b2's not;
    each shard's clip + Adam by its own norm; the reported norm the root of
    the shards' summed squares. Returns (full state, grad_norm)."""
    state = td.map_state(torch.clone, state)
    obs = td.encode_traj(traj, cfg)
    _, _, g = td.loss_and_grads(state.params, obs, traj, cfg)
    specs = sharding.param_specs(True)
    cut = lambda t, k, i: (t if specs[k] is None else t.chunk(model, specs[k])[i]).clone()
    shards, sq = [], 0.0
    for i in range(model):
        sub = lambda d: {k: cut(v, k, i) for k, v in d.items()}
        params, o = sub(state.params), state.opt_state
        grads = {k: cut(v, k, i) * (1 if specs[k] is None else model) for k, v in g.items()}
        sq = sq + td.global_norm(grads) ** 2
        opt, _ = td.apply_gradients(params, grads, td.AdamState(o.count, sub(o.mu), sub(o.nu)),
                                    cfg)
        shards.append((params, opt))
    join = lambda ds: {k: ds[0][k] if specs[k] is None else torch.cat([d[k] for d in ds], specs[k])
                       for k in ds[0]}
    full = td.TrainState(
        params=join([p for p, _ in shards]),
        opt_state=td.AdamState(shards[0][1].count, join([o.mu for _, o in shards]),
                               join([o.nu for _, o in shards])),
        version=state.version + 1,
        episode_count=state.episode_count + traj.boundary.sum(),
    )
    return full, torch.sqrt(sq)


def job_tp_control(p: dict, device: torch.device) -> dict:
    """The tp check's inputs and controls on one rank: a rollout of
    p["steps"] steps at p["batch"] games from p["seed"], then
    ``make_update_step`` on a (1, 1) mesh and ``jax_tp_update`` for a
    (1, 2) mesh. Returns the start state, the trajectory and both."""
    dev = distributed.local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    cfg = p["cfg"]
    gen = torch.Generator(device=dev).manual_seed(p["seed"])
    state = td.init_train_state(cfg, gen, dev)
    env = vec_env.reset(p["batch"], gen, dev)
    _, traj = actor.rollout_chunked(state.params, env, cfg.train.initial_temperature, cfg,
                                    p["steps"], chunk=1, gen=gen, device=dev)
    inputs = dict(state=_cpu(state), traj=_cpu(traj))
    want, gnorm = jax_tp_update(state, traj, sharding._tp_config(cfg, False), 2)
    (out,) = job_update({**inputs, "cfg": cfg, "meshes": [(1, 1)]}, device)
    return dict(inputs, update=out, jax_tp=_cpu(want), jax_tp_grad_norm=float(gnorm))


def run_checks(device: str, widths: str, batch: int, tp_batch: int, steps: int,
               updates: int) -> dict:
    """The train and tp checks (module docstring): two spawns, the one-rank
    controls and then the two ranks. Raises AssertionError on a miss."""
    cfg_of = small_config if widths == "small" else full_config
    tcfg = cfg_of(tp_batch)
    train = dict(cfg=cfg_of(batch), batch=batch, steps=steps, updates=updates, seed=0,
                 noise=True)
    t0 = time.perf_counter()
    ((control, tp_ctl),) = spawn(1, [(job_train, {**train, "data": 1, "model": 1}),
                                     (job_tp_control, dict(cfg=tcfg, batch=tp_batch,
                                                           steps=steps, seed=1))], device)
    upd = {"cfg": tcfg, "state": tp_ctl["state"], "traj": tp_ctl["traj"], "meshes": [(1, 2)]}
    two = spawn(2, [(job_train, {**train, "data": 2, "model": 1}), (job_update, upd)], device)
    ranks = [r[0] for r in two]
    res = {"train": compare_train(ranks, control)}
    res["train"].update(
        world1_ms_per_update=control["ms_per_update"],
        world2_ms_per_update=ranks[0]["ms_per_update"],
        world1_all_reduces=control["all_reduces"], world2_all_reduces=ranks[0]["all_reduces"],
        loss=[m["loss"] for m in control["metrics"]],
        loss_world2=[m["loss"] for m in ranks[0]["metrics"]])

    tp = [r[1][0] for r in two]
    for k, v in tp[0]["state"].params.items():
        if not torch.equal(tp[1]["state"].params[k], v):
            raise AssertionError(f"tp {k}: ranks differ")
    a, b, want = tp[0], tp_ctl["update"], tp_ctl["jax_tp"]
    np.testing.assert_allclose(a["metrics"]["loss"], b["metrics"]["loss"], rtol=1e-5)
    np.testing.assert_allclose(a["metrics"]["grad_norm"], tp_ctl["jax_tp_grad_norm"], rtol=1e-5)
    err = assert_state_close(a["state"], want, "tp vs JAX's tp update")
    mu_a, mu_b = a["state"].opt_state.mu["w1"], b["state"].opt_state.mu["w1"]
    big = mu_b.abs() > 1e-3 * mu_b.abs().max()
    res["tp"] = dict(
        loss=a["metrics"]["loss"], loss_no_tp=b["metrics"]["loss"],
        grad_norm=a["metrics"]["grad_norm"], grad_norm_no_tp=b["metrics"]["grad_norm"],
        grad_norm_jax_tp=tp_ctl["jax_tp_grad_norm"], **err,
        mu_w1_ratio_median=float((mu_a[big] / mu_b[big]).median()),
    )
    res["seconds"] = time.perf_counter() - t0
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--widths", choices=("small", "full"), default="small")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--tp-batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--updates", type=int, default=3)
    a = ap.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda without a card; pass --device cpu")
    try:
        res = run_checks(a.device, a.widths, a.batch, a.tp_batch, a.steps, a.updates)
    except AssertionError as e:
        print(json.dumps({"ok": False, "error": str(e)}))
        return 1
    print(json.dumps({"ok": True, "device": a.device, **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
