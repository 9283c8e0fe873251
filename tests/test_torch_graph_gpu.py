"""The port's graphed rollouts (``rollout_chunked``, ``rollout``) on the
card against the eager loop.

These tests need a CUDA card and skip elsewhere (a CUDA graph has no CPU
mode). The file imports torch and the port only, so on the card it runs
without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_graph_gpu.py
"""
import dataclasses

import pytest
import torch

from mlp_ppo_2ply_multi_tpu_torch.actor import rollout
from mlp_ppo_2ply_multi_tpu_torch.core import graphs
from mlp_ppo_2ply_multi_tpu_torch.core.config import Config
from mlp_ppo_2ply_multi_tpu_torch.env import vec_env
from mlp_ppo_2ply_multi_tpu_torch.experimental import nd_tail
from mlp_ppo_2ply_multi_tpu_torch.learner import td
from mlp_ppo_2ply_multi_tpu_torch.model import value_net
from mlp_ppo_2ply_multi_tpu_torch.ops import fused_value as fv
from tests.test_torch_kernel_gpu import CKPT, _card

B = 64
STEPS, CHUNK = 8, 4


def _production(twoply=False):
    cfg = Config.production_twoply() if twoply else Config.production()
    return cfg.replace(
        train=dataclasses.replace(cfg.train, td_mode="side0", per_episode_updates=False))


def _leaves(x, prefix=""):
    out = {}
    for k in x._fields:
        v = getattr(x, k)
        out.update(_leaves(v, f"{prefix}{k}.") if hasattr(v, "_fields") else {prefix + k: v})
    return out


def _assert_same(eager, graphed):
    """Every integer and bool leaf of (state, trajectory) bit-equal; the
    observation values within an f32 rounding (cuBLAS may pick another
    algorithm for the obs product inside a capture)."""
    a = {**_leaves(eager[0], "state."), **_leaves(eager[1], "t.")}
    b = {**_leaves(graphed[0], "state."), **_leaves(graphed[1], "t.")}
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        if a[k].is_floating_point() and k == "t.value":
            assert float((a[k] - b[k]).abs().max()) <= 1e-5, k
        else:
            assert torch.equal(a[k], b[k]), k


def _both(params, cfg, dev, seed, steps=STEPS, chunk=CHUNK, batch=B):
    """The eager loop and the graphed rollout from one state and one
    generator seed; the fused_value launches of the graphed one."""
    out = []
    for graphed in (False, True):
        gen = torch.Generator(device=dev).manual_seed(seed)
        st = vec_env.reset(batch, gen, device=dev)
        before = fv.KERNEL.launches
        if graphed:
            out.append(rollout.rollout_chunked(params, st, 1.0, cfg, steps, chunk=chunk,
                                               gen=gen, device=dev))
        else:
            out.append(rollout.rollout_loop(params, st, 1.0, cfg, steps, True, gen=gen,
                                            device=dev))
        launches = fv.KERNEL.launches - before
    torch.cuda.synchronize()
    return out[0], out[1], launches


@pytest.mark.gpu
def test_graphed_rollout_equals_eager_before_and_after_an_adam_step():
    dev = _card()
    graphs.clear_graphs()
    cfg = _production()
    params = value_net.load_checkpoint(CKPT, device=dev)
    eager, graphed, launches = _both(params, cfg, dev, seed=1)  # captures
    _assert_same(eager, graphed)
    assert launches == 2 * STEPS and len(graphs.GRAPHS) == 1
    eager, graphed, launches = _both(params, cfg, dev, seed=2)  # replays only
    _assert_same(eager, graphed)
    assert launches == 2 * STEPS and len(graphs.GRAPHS) == 1
    # the optimizer's in-place step: the graph reads the new weights
    state = td.init_train_state(cfg, device=dev)._replace(
        params=params, opt_state=td.init_adam(params))
    for _ in range(3):
        state, _ = td.update(state, eager[1], cfg, dev)
    assert state.params["w1"] is params["w1"]
    moved, graphed, launches = _both(params, cfg, dev, seed=2)
    _assert_same(moved, graphed)
    assert len(graphs.GRAPHS) == 1
    assert float((moved[1].value - eager[1].value).abs().max()) > 0


@pytest.mark.gpu
def test_changed_param_storage_recaptures():
    dev = _card()
    graphs.clear_graphs()
    cfg = _production()
    params = value_net.load_checkpoint(CKPT, device=dev)
    _both(params, cfg, dev, seed=3)
    params["w1"] = params["w1"] * 0.5  # one tensor of the set in new storage
    eager, graphed, _ = _both(params, cfg, dev, seed=3)
    _assert_same(eager, graphed)
    fresh = {k: v.clone() for k, v in params.items()}
    eager2, graphed2, _ = _both(fresh, cfg, dev, seed=3)
    _assert_same(eager2, graphed2)
    assert len(graphs.GRAPHS) == 3


@pytest.mark.gpu
def test_graphed_two_ply_equals_eager_with_both_kernels():
    dev = _card()
    graphs.clear_graphs()
    cfg = _production(twoply=True)
    params = value_net.load_checkpoint(CKPT, device=dev)
    nd0 = nd_tail.KERNEL.launches
    eager, graphed, launches = _both(params, cfg, dev, seed=4, steps=4, chunk=2, batch=32)
    _assert_same(eager, graphed)
    assert launches == 22 * 4 and nd_tail.KERNEL.launches - nd0 == 2 * 15 * 4


@pytest.mark.gpu
def test_sync_mode_rollout_replays_the_episode():
    dev = _card()
    graphs.clear_graphs()
    cfg = _production()
    cfg = cfg.replace(env=dataclasses.replace(cfg.env, max_timesteps=12))
    params = value_net.load_checkpoint(CKPT, device=dev)
    out = []
    for fn in (rollout.rollout_loop, rollout.rollout):
        gen = torch.Generator(device=dev).manual_seed(5)
        st = vec_env.reset(B, gen, device=dev)
        out.append(fn(params, st, 1.0, cfg, 12, False, gen=gen, device=dev))
    _assert_same(*out)
    assert graphs.GRAPHS[next(reversed(graphs.GRAPHS))].info["chunk"] == 4


@pytest.mark.gpu
@pytest.mark.parametrize("twoply", [False, True], ids=["1ply", "2ply"])
def test_eager_steps_raise_no_sync(twoply):
    """No op of the step synchronises the host with the card (noise drawn
    ahead, a Python-float temperature)."""
    dev = _card()
    cfg = _production(twoply)
    params = value_net.load_checkpoint(CKPT, device=dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    st = vec_env.reset(32, gen, device=dev)
    st, _ = rollout.rollout_step(params, st, 1.0, cfg, True, gen=gen, device=dev)
    noise = rollout.draw_noise(32, cfg, gen, dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, t = rollout.rollout_step(params, st, 1.0, cfg, True, noise=noise, device=dev)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert bool(t.recorded.any())


@pytest.mark.gpu
def test_a_synchronising_op_in_the_step_raises(monkeypatch):
    """No quiet fallback to the eager loop: a step that synchronises cannot
    be captured, and the rollout raises naming the op."""
    dev = _card()
    graphs.clear_graphs()
    cfg = _production()
    params = value_net.load_checkpoint(CKPT, device=dev)
    real = vec_env.reset_where

    def syncing(mask, *args):
        bool(mask.any())  # a host pull
        return real(mask, *args)

    monkeypatch.setattr(vec_env, "reset_where", syncing)
    st = vec_env.reset(B, torch.Generator(device=dev).manual_seed(7), device=dev)
    with pytest.raises(RuntimeError, match="synchroniz"):
        rollout.rollout_chunked(params, st, 1.0, cfg, 4, device=dev)
    assert torch.cuda.get_sync_debug_mode() == 0
    assert len(graphs.GRAPHS) == 0
