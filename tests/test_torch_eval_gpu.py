"""The port's row-take kernel, graphed matches and the f32 2-ply scorer on
the card.

These tests need a CUDA card and skip elsewhere (a CUDA kernel and a CUDA
graph have no CPU mode). The file imports torch and the port only, so on the
card it runs without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_eval_gpu.py
"""
import dataclasses

import pytest
import torch

from mlp_ppo_2ply_multi_tpu_torch.core import graphs
from mlp_ppo_2ply_multi_tpu_torch.core.config import Config, MoveGenConfig, TwoPlyConfig
from mlp_ppo_2ply_multi_tpu_torch.engine import board as B
from mlp_ppo_2ply_multi_tpu_torch.engine.movegen import legal_moves
from mlp_ppo_2ply_multi_tpu_torch.env import vec_env
from mlp_ppo_2ply_multi_tpu_torch.eval import arena
from mlp_ppo_2ply_multi_tpu_torch.experimental import nd_tail
from mlp_ppo_2ply_multi_tpu_torch.model import value_net
from mlp_ppo_2ply_multi_tpu_torch.ops import fused_value as fv
from mlp_ppo_2ply_multi_tpu_torch.ops import take_rows as tr
from mlp_ppo_2ply_multi_tpu_torch.twoply import expectimax
from tests.test_torch_kernel_gpu import CKPT, _card

SMALL = MoveGenConfig(w1=16, w2=32, w3=48, w4=64, a_max=64, nd_dedup_k=48, dd_subbatch_div=3)


def _take_inputs(n, w, k, dev, dtype=torch.int32, outside=0, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    boards = torch.randint(-128, 128, (n, w, 52), generator=gen, device=dev,
                           dtype=torch.int8)
    idx = torch.randint(0, w, (n, k), generator=gen, device=dev, dtype=dtype)
    if outside:
        flat = idx.view(-1)
        pos = torch.randint(0, flat.numel(), (outside,), generator=gen, device=dev)
        bad = torch.tensor([-1, w, w + 7, -(2**31)], device=dev, dtype=dtype)
        flat[pos] = bad[torch.arange(outside, device=dev) % 4]
    return boards, idx


@pytest.mark.gpu
@pytest.mark.parametrize("n,w,k,dtype,outside", [
    (4096, 128, 128, torch.int32, 0),  # the probe's shape
    (4097, 128, 128, torch.int32, 0),  # N a multiple of no block
    (4096, 448, 96, torch.int64, 0),  # the actor's tier-1 take shape
    (1000, 448, 96, torch.int32, 64),  # indices outside [0, W)
    (3, 5, 7, torch.int64, 5),
    (1, 1, 1, torch.int32, 0),
])
def test_take_rows_kernel_matches_plain(n, w, k, dtype, outside):
    dev = _card()
    boards, idx = _take_inputs(n, w, k, dev, dtype, outside)
    before = tr.KERNEL.launches
    got = tr.take_rows(boards, idx)
    assert tr.KERNEL.launches == before + 1
    want = tr.take_rows_plain(boards, idx)
    torch.cuda.synchronize()
    assert got.dtype == torch.int8 and got.shape == (n, k, 52)
    assert torch.equal(got, want)
    ok = (idx >= 0) & (idx < w)
    lib = torch.gather(boards, 1, idx.long().clamp(0, w - 1)[..., None].expand(n, k, 52))
    assert torch.equal(got[ok], lib[ok])
    assert not got[~ok].any()


@pytest.mark.gpu
def test_take_rows_kernel_refuses_what_it_does_not_take():
    dev = _card()
    boards, idx = _take_inputs(8, 16, 4, dev)
    with pytest.raises(ValueError):
        tr.take_rows(boards[:, :, :50].contiguous(), idx)  # C not a multiple of 4
    with pytest.raises(ValueError):
        tr.take_rows(boards.transpose(0, 1).contiguous().transpose(0, 1), idx)
    with pytest.raises(ValueError):
        tr.take_rows(boards, idx.t().contiguous().t())
    with pytest.raises(ValueError):
        tr.take_rows(boards, idx.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("pair", [("greedy", "random"), ("softmax", "greedy")])
def test_graphed_match_equals_the_eager_step_loop(pair):
    """``play_match`` on the card (captured chunk, replays) against
    ``match_step`` driven eagerly from the same generator draws: winner,
    win type and steps bit-equal; one nd_tail launch a step, by replay."""
    dev = _card()
    graphs.clear_graphs()
    cfg = Config(movegen=SMALL, train=dataclasses.replace(Config().train, td_mode="side0"))
    params = value_net.load_checkpoint(CKPT, device=dev)
    make = {"greedy": arena.greedy_policy(cfg), "random": arena.random_policy(cfg),
            "softmax": arena.softmax_policy(cfg, 0.5)}
    pa, pb = make[pair[0]], make[pair[1]]
    batch, steps = 64, 160  # long enough for games to finish
    for seed in (1, 2):  # capture, then replays only
        nd0 = nd_tail.KERNEL.launches
        res = arena.play_match(params, params, pa, pb, torch.Generator(device=dev).manual_seed(seed),
                               cfg, batch, steps, device=dev, chunk=16)
        torch.cuda.synchronize()
        assert nd_tail.KERNEL.launches - nd0 == steps
        gen = torch.Generator(device=dev).manual_seed(seed)
        m = arena._Match(vec_env.reset(batch, gen, device=dev),
                         torch.full((batch,), -1, dtype=torch.int32, device=dev))
        for _ in range(steps):
            m = arena.match_step(params, params, pa, pb, cfg, m,
                                 arena.draw_match_noise(batch, cfg, gen, dev))
        assert torch.equal(res.winner, m.winner)
        assert torch.equal(res.win_type, m.state.win_type)
        assert torch.equal(res.steps, m.state.step_count)
        assert bool(B.checker_conservation_ok(m.state.board).all())
        assert int((res.winner >= 0).sum()) > 0
    assert len(graphs.GRAPHS) == 1


@pytest.mark.gpu
def test_f32_two_ply_scorer_on_the_card_equals_the_cpu():
    """Without the fused kernel the 2-ply scorer values boards by the f32
    encode + forward on the card, as JAX does on any device, and launches
    no fused_value."""
    dev = _card()
    cfg = Config(movegen=SMALL, twoply=TwoPlyConfig(enabled=True, reply_a_max=32),
                 train=dataclasses.replace(Config().train, td_mode="side0"))
    assert not cfg.model.fused_actor_kernel
    params = value_net.load_checkpoint(CKPT, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    st = vec_env.reset(32, gen, device=dev)
    moves = legal_moves(st.board, st.player, st.dice, cfg.movegen)
    cand = B.Board(moves.boards.data[:, :4])
    opp = 1 - st.player
    before = fv.KERNEL.launches
    got = expectimax.weighted_opponent_response(params, cand, opp, cfg)
    cpu_params = {k: v.cpu() for k, v in params.items()}
    want = expectimax.weighted_opponent_response(
        cpu_params, B.Board(cand.data.cpu()), opp.cpu(), cfg)
    torch.cuda.synchronize()
    assert fv.KERNEL.launches == before
    assert got.shape == (32, 4) and torch.isfinite(got).all()
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-7)
    assert float(want.abs().max()) > 0.05  # the opening's replies: not all zero
