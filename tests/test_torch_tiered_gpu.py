"""The tiered pipeline, the Gram dedup and the 2-ply scan scorer on the card.

These tests need a CUDA card and skip elsewhere (the kernels have no CPU
mode, a CUDA graph neither). The file imports torch and the port only, so
on the card it runs without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_tiered_gpu.py
"""
import dataclasses

import pytest
import torch

from mlp_ppo_2ply_multi_tpu_torch.actor import rollout
from mlp_ppo_2ply_multi_tpu_torch.core import graphs
from mlp_ppo_2ply_multi_tpu_torch.core.config import Config, TwoPlyConfig
from mlp_ppo_2ply_multi_tpu_torch.engine import board as bd
from mlp_ppo_2ply_multi_tpu_torch.engine import movegen2
from mlp_ppo_2ply_multi_tpu_torch.env import vec_env
from mlp_ppo_2ply_multi_tpu_torch.experimental import nd_tail
from mlp_ppo_2ply_multi_tpu_torch.experimental import tiered
from mlp_ppo_2ply_multi_tpu_torch.model import value_net
from mlp_ppo_2ply_multi_tpu_torch.ops import fused_value as fv
from mlp_ppo_2ply_multi_tpu_torch.twoply import expectimax
from tests.test_torch_graph_gpu import _assert_same
from tests.test_torch_kernel_gpu import CKPT, _card

B = 256


def tiered_config():
    """Config.production() with ``train --tiered``'s settings."""
    cfg = Config.production()
    return cfg.replace(
        movegen=dataclasses.replace(cfg.movegen, tiered=True, dd_tier=(48, 96, 96)),
        train=dataclasses.replace(cfg.train, td_mode="side0", per_episode_updates=False))


def _state(dev, seed, steps=4, cfg=None):
    """A batch a few production steps off the opening."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    cfg = cfg or tiered_config()
    params = value_net.load_checkpoint(CKPT, device=dev)
    st = vec_env.reset(B, gen, device=dev)
    for _ in range(steps):
        st, _ = rollout.rollout_step(params, st, 1.0, cfg, True, gen=gen, device=dev)
    return params, st, gen


@pytest.mark.gpu
def test_tiered_graph_equals_the_eager_loop():
    """rollout_chunked (chunk 4, 8 steps) against rollout_loop from one state
    and seed: every integer field bit-equal; 2 fused_value and 1 nd_tail
    launches a step (the narrow plane, the wide plane, the wide plane's
    single-pass tail), counted by replay."""
    dev = _card()
    graphs.clear_graphs()
    cfg = tiered_config()
    params = value_net.load_checkpoint(CKPT, device=dev)
    out, launches = [], []
    for graphed in (False, True):
        gen = torch.Generator(device=dev).manual_seed(7)
        st = vec_env.reset(B, gen, device=dev)
        f0, n0 = fv.KERNEL.launches, nd_tail.KERNEL.launches
        if graphed:
            out.append(rollout.rollout_chunked(params, st, 1.0, cfg, 8, chunk=4, gen=gen,
                                               device=dev))
        else:
            out.append(rollout.rollout_loop(params, st, 1.0, cfg, 8, True, gen=gen, device=dev))
        torch.cuda.synchronize()
        launches.append((fv.KERNEL.launches - f0, nd_tail.KERNEL.launches - n0))
    _assert_same(out[0], out[1])
    assert launches == [(16, 8), (16, 8)]
    assert len(graphs.GRAPHS) == 1


@pytest.mark.gpu
def test_tiered_moves_on_the_card_equal_the_cpu():
    dev = _card()
    _, st, _ = _state(dev, 8)
    mg = tiered_config().movegen
    got = tiered.legal_moves_tiered(st.board, st.player, st.dice, mg)
    cpu = tiered.legal_moves_tiered(bd.Board(st.board.data.cpu()), st.player.cpu(),
                                    st.dice.cpu(), mg)
    m = cpu.narrow_valid
    assert torch.equal(got.narrow_valid.cpu(), m)
    assert torch.equal(got.narrow_boards.data.cpu()[m], cpu.narrow_boards.data[m])
    w = cpu.wide.valid
    assert torch.equal(got.wide.valid.cpu(), w)
    assert torch.equal(got.wide.boards.data.cpu()[w], cpu.wide.boards.data[w])
    for f in ("wide_player", "in_wide", "wide_slot", "count", "overflow"):
        assert torch.equal(getattr(got, f).cpu(), getattr(cpu, f)), f


@pytest.mark.gpu
def test_gram_step_equals_the_sig_step():
    """One production step with nd_sig_dedup=False from the same state and
    noise as the signature step: identical decisions and state."""
    dev = _card()
    cfg = Config.production()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, td_mode="side0"))
    params, st, gen = _state(dev, 9, cfg=cfg)
    noise = rollout.draw_noise(B, cfg, gen, dev)
    gram = cfg.replace(movegen=dataclasses.replace(cfg.movegen, nd_sig_dedup=False))
    a = rollout.rollout_step(params, st, 1.0, cfg, True, noise=noise, device=dev)
    b = rollout.rollout_step(params, st, 1.0, gram, True, noise=noise, device=dev)
    _assert_same(a, b)
    sa = movegen2.legal_moves_split(st.board, st.player, st.dice, cfg.movegen)
    sb = movegen2.legal_moves_split(st.board, st.player, st.dice, gram.movegen)
    assert torch.equal(sa.valid, sb.valid) and torch.equal(sa.overflow, sb.overflow)


@pytest.mark.gpu
def test_scan_scorer_at_chunk_1_equals_the_unrolled_one_on_the_card():
    """Both kernels run in each; the scan folds its chunk of one roll into
    the same rows, so the scores are bit-equal; 15 nd_tail launches each."""
    dev = _card()
    cfg = Config.production().replace(twoply=TwoPlyConfig(enabled=True))
    params, st, _ = _state(dev, 10, cfg=Config.production())
    cand = bd.Board(st.board.data[:64, None].expand(64, 4, 52).contiguous())
    opp = st.player[:64]
    n0 = nd_tail.KERNEL.launches
    unrolled = expectimax.weighted_opponent_response(params, cand, opp, cfg)
    scan_cfg = cfg.replace(twoply=dataclasses.replace(cfg.twoply, unroll_rolls=False))
    scan = expectimax.weighted_opponent_response(params, cand, opp, scan_cfg)
    torch.cuda.synchronize()
    assert torch.equal(scan, unrolled)
    assert nd_tail.KERNEL.launches - n0 == 30


@pytest.mark.gpu
@pytest.mark.parametrize("twoply", [dict(roll_chunk=3), dict(value_first_m=16)],
                         ids=["scan_chunk3", "value_first16"])
def test_scan_scorers_stay_capturable(twoply):
    """The 2-ply step with the scan scorer or value-first replies captured
    in rollout_chunked's graph (4 steps, chunk 2) equals the eager loop."""
    dev = _card()
    graphs.clear_graphs()
    cfg = Config.production().replace(twoply=TwoPlyConfig(enabled=True, **twoply))
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, td_mode="side0"))
    params = value_net.load_checkpoint(CKPT, device=dev)
    out = []
    for graphed in (False, True):
        gen = torch.Generator(device=dev).manual_seed(11)
        st = vec_env.reset(32, gen, device=dev)
        fn = rollout.rollout_chunked if graphed else rollout.rollout_loop
        kw = dict(chunk=2) if graphed else dict(continuous=True)
        out.append(fn(params, st, 1.0, cfg, 4, gen=gen, device=dev, **kw))
    torch.cuda.synchronize()
    _assert_same(out[0], out[1])
