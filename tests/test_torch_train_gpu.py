"""The port's learner and training loop on the card.

These tests need a CUDA card and skip elsewhere. The file imports torch and
the port only, so on the card it runs without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_train_gpu.py
"""
import dataclasses
import json
import math
import os

import pytest
import torch

from mlp_ppo_2ply_multi_tpu_torch.actor import rollout
from mlp_ppo_2ply_multi_tpu_torch.apps import train
from mlp_ppo_2ply_multi_tpu_torch.core.config import Config
from mlp_ppo_2ply_multi_tpu_torch.env import vec_env
from mlp_ppo_2ply_multi_tpu_torch.learner import td
from mlp_ppo_2ply_multi_tpu_torch.model import value_net
from mlp_ppo_2ply_multi_tpu_torch.ops import fused_value as fv
from tests.test_torch_kernel_gpu import CKPT, TOL, _card


def _fused_production():
    cfg = Config.production()
    return cfg.replace(
        train=dataclasses.replace(cfg.train, td_mode="side0", per_episode_updates=False))


def _trajectory(dev, batch=256, steps=8):
    cfg = _fused_production()
    gen = torch.Generator(device=dev).manual_seed(3)
    params = value_net.load_checkpoint(CKPT, device=dev)
    st = vec_env.reset(batch, gen, device=dev)
    _, traj = rollout.rollout_loop(params, st, 1.0, cfg, steps, True, gen=gen, device=dev)
    return cfg, params, traj


@pytest.mark.gpu
def test_update_on_the_card_matches_the_cpu():
    """One fused update from the same state on both devices, at the CPU
    tests' tolerances (TF32 off)."""
    dev = _card()
    cfg, params, traj = _trajectory(dev)
    state = td.init_train_state(cfg, device=dev)._replace(
        params=params, opt_state=td.init_adam(params))
    state, _ = td.update(state, traj, cfg, dev)  # non-zero moments
    cpu = torch.device("cpu")
    copy = lambda s, d: td.map_state(lambda t: t.detach().to(d, copy=True), s)
    g_state, g_m = td.update(copy(state, dev), traj, cfg, dev)
    c_state, c_m = td.update(copy(state, cpu), rollout.Transition(*(x.cpu() for x in traj)),
                             cfg, cpu)
    for k in ("loss", "grad_norm", "td_abs", "v_mean"):
        assert abs(float(g_m[k]) - float(c_m[k])) <= 1e-5 * abs(float(c_m[k])), k
    for k in ("wins_regular", "close_out_count", "prime_count", "width_overflow_count"):
        assert int(g_m[k]) == int(c_m[k]), k
    for k, p in c_state.params.items():
        assert float((g_state.params[k].cpu() - p).abs().max()) <= 1e-6, k
        for name in ("mu", "nu"):
            want = getattr(c_state.opt_state, name)[k]
            got = getattr(g_state.opt_state, name)[k].cpu()
            lim = 1e-4 * want.abs() + 1e-6 * float(want.abs().max())
            assert bool(((got - want).abs() <= lim).all()), (name, k)
    assert int(g_state.version) == int(c_state.version) == 2
    assert g_state.version.device.type == "cuda"


@pytest.mark.gpu
def test_fused_value_kernel_follows_the_optimizers_in_place_steps():
    """After Adam steps made by the port's own optimizer, the kernel (which
    reads packed params cached per tensor version) equals its plain
    version on the updated params, and its values moved."""
    dev = _card()
    cfg, params, traj = _trajectory(dev, steps=4)
    gen = torch.Generator(device=dev).manual_seed(0)
    boards = torch.randint(0, 16, (512, 96, 52), generator=gen, device=dev).to(torch.int8)
    flag = torch.randint(0, 2, (512, 1), generator=gen, device=dev)
    before = fv.fused_value(boards, flag, params)
    state = td.init_train_state(cfg, device=dev)._replace(
        params=params, opt_state=td.init_adam(params))
    for _ in range(3):
        state, _ = td.update(state, traj, cfg, dev)
    assert state.params["w1"] is params["w1"]
    got = fv.fused_value(boards, flag, params)
    want = fv.fused_value_plain(boards, flag, params)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= TOL
    assert float((got - before).abs().max()) > 0


@pytest.mark.gpu
def test_two_update_continuous_production_run(tmp_path):
    dev = _card()
    before = fv.KERNEL.launches
    rc = train.main([
        "--production", "--mode", "continuous", "--td-mode", "side0", "--batch-games", "256",
        "--steps-per-update", "8", "--updates", "2", "--device", "cuda",
        "--checkpoint-dir", str(tmp_path / "ck"), "--metrics-dir", str(tmp_path / "runs"),
    ])
    assert rc == 0 and fv.KERNEL.launches == before + 2 * 8 * 2
    (run,) = os.listdir(tmp_path / "runs")
    lines = [json.loads(x) for x in open(tmp_path / "runs" / run / "metrics.jsonl")]
    scalars = [r for r in lines if "hist" not in r]
    assert len(scalars) == 2 and all(math.isfinite(r["loss"]) for r in scalars)
    assert "hbm_used_mb" in scalars[0] and dev.type == "cuda"


@pytest.mark.gpu
def test_two_ply_without_production_runs_the_f32_scorer_on_the_card(tmp_path):
    """The exact (unfused) 2-ply scorer runs its f32 encode + forward on the
    card, as JAX runs it on any device, and the run launches no
    fused_value."""
    _card()
    before = fv.KERNEL.launches
    rc = train.main([
        "--two-ply", "--mode", "continuous", "--batch-games", "8",
        "--steps-per-update", "1", "--updates", "1", "--device", "cuda",
        "--checkpoint-dir", str(tmp_path / "ck"), "--metrics-dir", str(tmp_path / "runs"),
    ])
    assert rc == 0 and fv.KERNEL.launches == before
    assert os.listdir(tmp_path / "ck")
