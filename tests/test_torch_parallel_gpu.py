"""The port's mesh train step on the card.

These tests need a CUDA card and skip elsewhere. The file imports torch and
the port only, so on the card it runs without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_parallel_gpu.py
"""
import dataclasses
import json

import pytest
import torch

from mlp_ppo_2ply_multi_tpu_torch.actor import rollout
from mlp_ppo_2ply_multi_tpu_torch.core import graphs
from mlp_ppo_2ply_multi_tpu_torch.core.config import Config
from mlp_ppo_2ply_multi_tpu_torch.env import vec_env
from mlp_ppo_2ply_multi_tpu_torch.learner import td
from mlp_ppo_2ply_multi_tpu_torch.parallel import distributed, sharding
from mlp_ppo_2ply_multi_tpu_torch.scripts import multiprocess_distributed as md
from tests.test_torch_kernel_gpu import _card

B = 256
STEPS = 8


def _production():
    cfg = Config.production()
    return cfg.replace(train=dataclasses.replace(cfg.train, per_episode_updates=False))


@pytest.mark.gpu
def test_world_one_nccl_mesh_step_equals_the_single_path(monkeypatch):
    """``make_train_step`` at (1, 1) on a one-rank NCCL group against
    ``rollout_chunked`` + ``td.update`` (the single-card loop) from the same
    state and generator: integer trajectory bit-equal, params within 1e-6;
    the rollout graph is captured at the first step and replayed after."""
    dev = _card()
    cfg = _production()
    made = []
    real = rollout.cached_graph
    monkeypatch.setattr(rollout, "cached_graph",
                        lambda key, make: (lambda g: made.append(g[1]) or g)(real(key, make)))
    graphs.clear_graphs()
    torch.cuda.set_device(distributed.local_device(dev))
    created = distributed.init(world_size=1, device=dev)
    try:
        mesh = sharding.make_mesh(1, 1)
        gen = torch.Generator(device=dev).manual_seed(0)
        full = td.init_train_state(cfg, gen, dev)
        env = vec_env.reset(B, gen, dev)
        state = sharding.shard_train_state(full, mesh, False)
        env_m = sharding.shard_env_state(env, mesh)
        step = sharding.make_train_step(mesh, cfg, STEPS)
        trajs = []
        untap = md._tap(trajs)
        try:
            rgen = torch.Generator(device=dev).manual_seed(7)
            for _ in range(3):
                state, env_m, metrics = step(state, env_m, rgen)
        finally:
            untap()
        assert made == [True, False, False]  # captured once, then replayed
        # the single path from the same start, generator and params
        single = td.map_state(torch.clone, full)
        sgen = torch.Generator(device=dev).manual_seed(7)
        for u in range(3):
            temp = td.temperature(single.version, cfg)
            env, traj = rollout.rollout_chunked(single.params, env, temp, cfg, STEPS, chunk=4,
                                                gen=sgen, device=dev)
            for f in md.EXACT_FIELDS:
                assert torch.equal(getattr(traj, f), getattr(trajs[u], f)), (u, f)
            single, _ = td.update(single, traj, cfg, dev)
        assert made[3:] == [True, False, False]  # the single path's own params
        for k, p in single.params.items():
            assert float((state.params[k] - p).abs().max()) <= 1e-6, k
        assert int(metrics["env_steps"]) == STEPS * B
    finally:
        if created:
            distributed.shutdown()
        graphs.clear_graphs()


@pytest.mark.gpu
def test_world_two_gloo_on_one_card_equals_world_one(capsys):
    """Two gloo ranks on card 0 (``scripts/multiprocess_distributed``):
    the (2, 1) train step against one rank on the same games and noise,
    and the (1, 2) tp update against JAX's rule written out."""
    _card()
    assert md.main(["--device", "cuda", "--batch", "64", "--tp-batch", "64",
                    "--updates", "2"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["ok"] and out["device"] == "cuda"
